"""Live-serving walkthrough: warm-start refits on a simulated tick stream.

A production forecaster holds a rolling window per asset and refits on
every new tick.  The reference refits each backtest window from scratch;
here the previous fit's parameters seed the next one through
:func:`volt_tpu_torch.parallel.warm_start`, so each tick needs about a
tenth of the Adam steps for the same fit.

The loop below:

1. cold-fits a batch of assets on the first window (300+300+300 steps),
2. then, per arriving tick, slides every window by one, warm-starts from
   the previous parameters, refits with 30+30+30 steps, and forecasts a
   fresh quantile fan on the device.

Run:  python -m volt_tpu_torch.examples.live_serving [--assets 8
      --steps 200 --ticks 5] [--device cpu]
"""

from __future__ import annotations

import time

import torch

from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast_batch, warm_start
from ._common import parser


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--assets", type=int, default=8)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--ticks", type=int, default=5)
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--warm-iters", type=int, default=30)
    p.add_argument("--nsample", type=int, default=256)
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    dt = 1.0 / 252
    n = args.steps - 1          # return-grid length of each window
    train_x = torch.arange(n, dtype=torch.float32, device=dev) * dt
    test_x = (torch.arange(args.horizon, dtype=torch.float32, device=dev)
              * dt + train_x[-1] + dt)

    # the simulated stream: `ticks` extra observations beyond window 0
    f, _ = sabr_paths(steps=args.steps + args.ticks, seed=11,
                      n_paths=args.assets)
    stream = torch.tensor(f, device=dev)

    base = dict(mean_func="ewma", k=min(100, max(2, n // 4)),
                nsample=args.nsample, output="quantiles")
    cold = PipelineConfig(gpcv_iters=args.iters, vol_iters=args.iters,
                          data_iters=args.iters, **base)
    warm = PipelineConfig(gpcv_iters=args.warm_iters,
                          vol_iters=args.warm_iters,
                          data_iters=args.warm_iters, **base)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    t0 = time.perf_counter()
    fan, aux = fit_forecast_batch(gen(0), train_x, stream[:, :args.steps],
                                  test_x, cold)
    _sync(dev)
    print(f"cold fit      B={args.assets}  "
          f"{1e3 * (time.perf_counter() - t0):8.1f} ms  "
          f"ok={int(aux['ok'].sum())}/{args.assets}")

    refit_s = []
    for tick in range(1, args.ticks + 1):
        window = stream[:, tick:args.steps + tick]
        ip = warm_start(aux, shift=1, n=n)
        t0 = time.perf_counter()
        fan, aux = fit_forecast_batch(gen(tick), train_x, window, test_x,
                                      warm, init_params=ip)
        _sync(dev)
        refit_s.append(time.perf_counter() - t0)
        med = fan[:, fan.shape[1] // 2, -1]   # median log-price at horizon
        print(f"tick {tick:3d} refit  B={args.assets}  "
              f"{1e3 * refit_s[-1]:8.1f} ms  "
              f"ok={int(aux['ok'].sum())}/{args.assets}  "
              f"median@H: {float(torch.exp(med).mean()):.3f}")
    print("(the first warm call pays its first-use costs; later ticks do "
          "not)")
    return {"fan": fan, "ok": aux["ok"], "refit_s": refit_s}


if __name__ == "__main__":
    main()

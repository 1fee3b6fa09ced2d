"""Long-series forecasting: one asset, n in the tens of thousands.

The reference caps training length at n ~ 2000 (its GPCV, vol GP and
rollout factor dense n x n objects).  Here every stage is O(n) in time and
memory at any n:

* GPCV: the tridiagonal-precision variational family;
* vol GP: the closed-form min-kernel spectrum, projected with an FFT past
  n=4096 (no n x n basis is built);
* forecast: filtered-state Brownian sampling and the O(1)-per-step Markov
  rollout (no joint covariance).

Run:  python -m volt_tpu_torch.examples.long_series [--steps 20000
      --horizon 100] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast
from ._common import parser


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--nsample", type=int, default=512)
    p.add_argument("--k", type=int, default=100)
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    dt = 1.0 / 252
    n = args.steps - 1
    f, vol_true = sabr_paths(steps=args.steps, seed=7)  # (steps,) each
    prices = torch.tensor(f, device=dev)
    train_x = torch.arange(n, dtype=torch.float32, device=dev) * dt + dt
    test_x = train_x[-1] + dt * torch.arange(1, args.horizon + 1,
                                             dtype=torch.float32, device=dev)

    cfg = PipelineConfig(
        gpcv_iters=args.iters, vol_iters=args.iters, data_iters=args.iters,
        mean_func="ewma", k=min(args.k, n // 2), nsample=args.nsample,
        output="quantiles",
    )

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    fan, aux = fit_forecast(g, train_x, prices, test_x, cfg)
    fan = fan.cpu().numpy()  # the copy waits for the device
    wall = time.perf_counter() - t0
    if not (np.isfinite(fan).all() and bool(aux["ok"])):
        raise RuntimeError("non-finite fan or a failed fit")

    vol = aux["vol"].cpu().numpy()
    rel = float(np.mean(np.abs(vol - vol_true[1:]) / vol_true[1:]))
    print(f"n={n}: fit+forecast in {wall:.2f}s "
          f"(first call includes first-use costs)")
    print(f"vol-path recovery rel-err vs the SABR oracle: {rel:.3f}")
    med = fan[len(cfg.quantile_levels) // 2]
    print(f"long-series quantile fan: median day-1 {med[0]:+.4f}, "
          f"day-{args.horizon} {med[-1]:+.4f} (log-price)")
    return {"fan": fan, "vol_rel_err": rel, "seconds": wall}


if __name__ == "__main__":
    main()

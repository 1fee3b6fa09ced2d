"""Multi-asset walkthrough: the batch pipeline and the correlated
(Kronecker multitask) chain.

Two ways to forecast a universe of tickers:

1. **Independent assets, one batched call**: ``fit_forecast_batch`` runs
   GPCV -> vol GP -> Volt -> Monte-Carlo rollout for every asset at once
   (and shards over a mesh with ``mesh=``); ``output="quantiles"`` returns
   the quantile fan, computed on the device, instead of the paths.

2. **Correlated assets**: the ``T x N`` constructor of the high-level
   :class:`volt_tpu_torch.Volt` API couples assets through a Kronecker
   multitask vol GP (the reference's ``Volt.py:30-33,64-71``) and samples
   jointly correlated vol forecasts.

Run:  python -m volt_tpu_torch.examples.multi_asset [--assets 8
      --steps 200] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import sabr_paths
from ..models.volt_api import Volt
from ..parallel import PipelineConfig, fit_forecast_batch
from ._common import parser


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--assets", type=int, default=8)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--iters", type=int, default=150)
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    dt = 1.0 / 252
    n = args.steps - 1
    h = 50
    f, _ = sabr_paths(steps=args.steps, seed=0, n_paths=args.assets)
    prices = torch.tensor(f, device=dev)
    train_x = torch.arange(n, dtype=torch.float32, device=dev) * dt
    test_x = train_x[-1] + dt * torch.arange(1, h + 1, dtype=torch.float32,
                                             device=dev)

    # --- 1. independent assets: one batched call, quantile delivery ---
    cfg = PipelineConfig(gpcv_iters=args.iters, vol_iters=args.iters,
                         data_iters=args.iters, mean_func="ewma", k=50,
                         nsample=256, output="quantiles")
    g = torch.Generator(device=dev).manual_seed(0)
    fan, aux = fit_forecast_batch(g, train_x, prices, test_x, cfg)
    fan = fan.cpu().numpy()  # (assets, levels, H) log-price quantiles
    ok = aux["ok"].cpu().numpy()
    print(f"batch pipeline: {args.assets} assets, ok={ok.sum()}/{len(ok)}")
    med = np.exp(fan[:, len(cfg.quantile_levels) // 2, -1])
    lo = np.exp(fan[:, 0, -1])
    hi = np.exp(fan[:, -1, -1])
    for a in range(min(args.assets, 4)):
        print(f"  asset {a}: spot {f[a, -1]:8.2f} -> {h}d median "
              f"{med[a]:8.2f}  [{lo[a]:.2f}, {hi[a]:.2f}] 95% band")

    # --- 2. correlated assets: T x N Volt -> multitask chain ---
    v = Volt(torch.cat([train_x[:1] - dt, train_x]), torch.log(prices),
             mean="ewma", k=50)
    if not v.batched:
        raise RuntimeError("T x N data must take the multitask chain")
    v.Train(gpcv_iters=args.iters, vol_mod_iters=args.iters,
            data_mod_iters=args.iters, generator=g)
    samples = v.Forecast(test_x, nsample=128,
                         generator=torch.Generator(device=dev).manual_seed(1))
    samples = samples.cpu().numpy()  # (T, S, H)
    print(f"\nmultitask chain: forecast {samples.shape} finite="
          f"{np.isfinite(samples).all()}")
    # correlated vol propagates into cross-asset forecast correlation
    corr = np.corrcoef(samples[:, :, -1])
    off = np.abs(corr - np.eye(len(corr)))
    print(f"cross-asset forecast correlation: max off-diag {off.max():.3f}")
    return {"fan": fan, "ok": ok, "samples": samples}


if __name__ == "__main__":
    main()

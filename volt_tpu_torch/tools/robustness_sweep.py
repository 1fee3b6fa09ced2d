"""Robustness at production scale: the per-asset ``ok`` rate and the
finite-forecast rate of ``fit_forecast_batch`` at 500 assets.

Runs the full pipeline over several independent synthetic SABR universes
(one per seed) and reports each run's ``ok`` count and whether its fan is
finite: the evidence that the per-asset failure lanes
(``parallel/pipeline.py``) hold at scale, not only in unit tests (port of
the JAX package's ``tools/robustness_sweep.py``).

Run::

    python -m volt_tpu_torch.tools.robustness_sweep [--seeds 1 2 3 4]
        [--device cuda]

Prints one JSON line per seed and a total line.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast_batch
from ._common import f32, numpy, parser, seeded

__all__ = ["main"]


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--assets", type=int, default=500)
    p.add_argument("--ntrain", type=int, default=1000)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--nsample", type=int, default=1000)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    dt = 1.0 / 252
    n = a.ntrain - 1
    train_x = torch.arange(n, dtype=torch.float32, device=dev) * dt
    test_x = train_x[-1] + dt * torch.arange(1, 101, dtype=torch.float32,
                                             device=dev)
    cfg = PipelineConfig(gpcv_iters=a.iters, vol_iters=a.iters,
                         data_iters=a.iters, mean_func="ewma", k=100,
                         nsample=a.nsample, output="quantiles")

    rows, total_ok, total = [], 0, 0
    for seed in a.seeds:
        f, _ = sabr_paths(steps=a.ntrain, seed=seed, n_paths=a.assets)
        t0 = time.perf_counter()
        fan, aux = fit_forecast_batch(seeded(dev, seed), train_x,
                                      f32(f, dev), test_x, cfg)
        fan, ok = numpy(fan), numpy(aux["ok"])
        el = time.perf_counter() - t0
        total_ok += int(ok.sum())
        total += len(ok)
        row = {"seed": seed, "assets": a.assets, "ok": int(ok.sum()),
               "fan_finite": bool(np.isfinite(fan).all()),
               "sec": round(el, 2)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"total_ok": total_ok, "total": total,
               "ok_rate": round(total_ok / total, 5)}
    print(json.dumps(summary), flush=True)
    return {"seeds": rows, **summary}


if __name__ == "__main__":
    main()

"""Warm-refit latency at the north-star shape: the live-serving loop (port
of the JAX package's ``tools/bench_refit.py``).

A production forecaster refits every asset at each new tick.
:func:`volt_tpu_torch.parallel.warm_start` seeds the Adam loops from the
previous window's fitted parameters, so the refit runs about ten times
fewer iterations.  This tool times the cold fit and the warm refit of a
batch (each the least of ``--reps`` calls after a first call, whose time
is printed beside it), and measures the warm refit's vol paths against a
cold fit of the same slid window.  Prints one JSON line.

Run::

    python -m volt_tpu_torch.tools.bench_refit [--assets 64] [--ntrain 1000]
        [--horizon 100] [--iters 300] [--warm-iters 30] [--shift 1]
        [--nsample 1000] [--reps 3] [--device cuda]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast_batch, warm_start
from ..utils.profiling import timed_cold_best
from ._common import backend, f32, grids, numpy, parser, seeded

__all__ = ["main", "vol_rel_err"]


def vol_rel_err(warm_vol, cold_vol) -> dict:
    """The warm refit's vol paths against the cold fit's: the mean and the
    largest relative difference, as the JSON line rounds them."""
    vw, vc = numpy(warm_vol), numpy(cold_vol)
    rel = np.abs(vw - vc) / vc
    return {"vol_rel_err_mean": round(float(rel.mean()), 4),
            "vol_rel_err_max": round(float(rel.max()), 4)}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--assets", type=int, default=64)
    p.add_argument("--ntrain", type=int, default=1000)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--warm-iters", type=int, default=30)
    p.add_argument("--shift", type=int, default=1)
    p.add_argument("--nsample", type=int, default=1000)
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    n = a.ntrain - 1
    # shift extra steps so that the slid window exists
    f, _ = sabr_paths(steps=a.ntrain + a.shift, seed=0, n_paths=a.assets)
    prices = f32(f, dev)
    train_x, test_x = grids(a.ntrain, a.horizon, dev)
    base = dict(mean_func="ewma", k=min(100, max(2, n // 4)),
                nsample=a.nsample, output="quantiles")
    cold_cfg = PipelineConfig(gpcv_iters=a.iters, vol_iters=a.iters,
                              data_iters=a.iters, **base)
    w = a.warm_iters
    warm_cfg = PipelineConfig(gpcv_iters=w, vol_iters=w, data_iters=w,
                              **base)

    (_, aux0), cold_s, cold_first = timed_cold_best(
        lambda: fit_forecast_batch(seeded(dev, 0), train_x,
                                   prices[:, :a.ntrain], test_x, cold_cfg),
        repeats=a.reps)
    ip = warm_start(aux0, shift=a.shift, n=n)
    slid = prices[:, a.shift:a.ntrain + a.shift]
    (_, aux_w), warm_s, warm_first = timed_cold_best(
        lambda: fit_forecast_batch(seeded(dev, 1), train_x, slid, test_x,
                                   warm_cfg, init_params=ip),
        repeats=a.reps)
    # quality: the warm refit against a full cold fit of the slid window
    _, aux_c = fit_forecast_batch(seeded(dev, 1), train_x, slid, test_x,
                                  cold_cfg)
    rec = {
        "stage": "warm_refit", "assets": a.assets, "ntrain": a.ntrain,
        "backend": backend(dev),
        "cold_ms": round(1e3 * cold_s, 1),
        "warm_ms": round(1e3 * warm_s, 1),
        "speedup": round(cold_s / warm_s, 2),
        "iters": a.iters, "warm_iters": w, "shift": a.shift,
        **vol_rel_err(aux_w["vol"], aux_c["vol"]),
        "ok": bool(numpy(aux_w["ok"]).all()),
        "cold_first_ms": round(1e3 * cold_first, 1),
        "warm_first_ms": round(1e3 * warm_first, 1),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()

"""Warm-refit latency of the multitask (Kronecker) pipeline at scale (port
of the JAX package's ``tools/bench_refit_multitask.py``).

The multitask analogue of :mod:`volt_tpu_torch.tools.bench_refit`: a
live-serving loop refits all ``T`` coupled tasks at each new tick, and
:func:`volt_tpu_torch.parallel.warm_start_multitask` re-seeds the joint
GPCV, the Kronecker vol GP and the per-task Volt fits from the previous
window's state, with about ten times fewer iterations.  Times the cold
fit and the warm refit (each the least of ``--reps`` calls after a first
call, whose time is printed beside it) and measures the warm refit's vol
paths against a cold fit of the same slid window.  Prints one JSON line.

Run::

    python -m volt_tpu_torch.tools.bench_refit_multitask [--tasks 505]
        [--ntrain 1000] [--horizon 100] [--iters 300] [--warm-iters 30]
        [--shift 1] [--nsample 100] [--reps 3] [--device cuda]
"""

from __future__ import annotations

import json

import torch

from ..data import sabr_paths
from ..parallel import (MultitaskPipelineConfig, fit_forecast_multitask,
                        warm_start_multitask)
from ..utils.profiling import timed_cold_best
from ._common import DT, backend, f32, numpy, parser, seeded
from .bench_refit import vol_rel_err

__all__ = ["refit", "main"]


def refit(prices, train_x, test_x, cold_cfg, warm_cfg, shift: int,
          reps: int, init_params=(None, None)) -> dict:
    """The cold fit of the first window of ``prices (T, n + 1 + shift)``
    and the warm refit of the window slid by ``shift``, timed, and the
    warm refit's vol paths against a cold fit of the slid window.
    ``init_params``: the two cold fits' initial values (as
    ``fit_forecast_multitask`` takes them), else their generators'."""
    dev, ntrain = prices.device, train_x.shape[-1] + 1
    cold_init, refit_init = init_params
    (_, aux0), cold_s, cold_first = timed_cold_best(
        lambda: fit_forecast_multitask(seeded(dev, 0), train_x,
                                       prices[:, :ntrain], test_x, cold_cfg,
                                       init_params=cold_init), repeats=reps)
    ip = warm_start_multitask(aux0, shift=shift, n=ntrain - 1)
    slid = prices[:, shift:ntrain + shift]
    (_, aux_w), warm_s, warm_first = timed_cold_best(
        lambda: fit_forecast_multitask(seeded(dev, 1), train_x, slid,
                                       test_x, warm_cfg, init_params=ip),
        repeats=reps)
    # quality: the warm refit against a full cold fit of the slid window
    _, aux_c = fit_forecast_multitask(seeded(dev, 1), train_x, slid, test_x,
                                      cold_cfg, init_params=refit_init)
    return {"cold_s": cold_s, "warm_s": warm_s, "cold_first_s": cold_first,
            "warm_first_s": warm_first,
            **vol_rel_err(aux_w["vols"], aux_c["vols"]),
            "ok": bool(numpy(aux_w["ok"]).all())}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--tasks", type=int, default=505)
    p.add_argument("--ntrain", type=int, default=1000)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--warm-iters", type=int, default=30)
    p.add_argument("--shift", type=int, default=1)
    p.add_argument("--nsample", type=int, default=100)
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    n = a.ntrain - 1
    f, _ = sabr_paths(steps=a.ntrain + a.shift, seed=0, n_paths=a.tasks)
    prices = f32(f, dev)
    # the return grid from DT (the first price at 0)
    train_x = torch.arange(n, dtype=torch.float32, device=dev) * DT + DT
    test_x = (torch.arange(a.horizon, dtype=torch.float32, device=dev) * DT
              + train_x[-1] + DT)
    base = dict(nsample=a.nsample, output="quantiles",
                k=min(25, max(2, n // 4)))
    cold_cfg = MultitaskPipelineConfig(gpcv_iters=a.iters,
                                       vol_iters=a.iters,
                                       data_iters=a.iters, **base)
    w = a.warm_iters
    warm_cfg = MultitaskPipelineConfig(gpcv_iters=w, vol_iters=w,
                                       data_iters=w, **base)

    r = refit(prices, train_x, test_x, cold_cfg, warm_cfg, a.shift, a.reps)
    rec = {
        "stage": "warm_refit_multitask", "tasks": a.tasks,
        "ntrain": a.ntrain, "backend": backend(dev),
        "cold_ms": round(1e3 * r["cold_s"], 1),
        "warm_ms": round(1e3 * r["warm_s"], 1),
        "speedup": round(r["cold_s"] / r["warm_s"], 2),
        "iters": a.iters, "warm_iters": w, "shift": a.shift,
        "vol_rel_err_mean": r["vol_rel_err_mean"],
        "vol_rel_err_max": r["vol_rel_err_max"], "ok": r["ok"],
        "cold_first_ms": round(1e3 * r["cold_first_s"], 1),
        "warm_first_ms": round(1e3 * r["warm_first_s"], 1),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()

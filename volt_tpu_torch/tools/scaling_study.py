"""Sequence-length scaling of the whole pipeline at batch B (port of the
JAX package's ``tools/scaling_study.py``).

Run::

    python -m volt_tpu_torch.tools.scaling_study [--device cuda]

with ``SCALE_ASSETS`` (16), ``SCALE_ITERS`` (300), ``SCALE_NSAMPLE``
(1000), ``SCALE_NTRAIN`` (``400,1000,2000,4000,8000``) and
``BENCH_OUTPUT`` (``samples``) read from the environment.  Prints one
markdown row per ntrain, ``| ntrain | seconds | assets/s | first call (s)
|``: ``fit_forecast_batch``'s least time of three calls after a first
call, whose time is the last column.
"""

from __future__ import annotations

import os

import torch

from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast_batch
from ..utils.profiling import timed_cold_best
from ._common import backend, check_finite, f32, grids, parser, seeded

__all__ = ["main"]


def main(argv=None):
    a = parser(__doc__).parse_args(argv)
    dev = torch.device(a.device)
    b = int(os.environ.get("SCALE_ASSETS", "16"))
    iters = int(os.environ.get("SCALE_ITERS", "300"))
    nsample = int(os.environ.get("SCALE_NSAMPLE", "1000"))
    cfg = PipelineConfig(gpcv_iters=iters, vol_iters=iters,
                         data_iters=iters, mean_func="ewma", k=100,
                         nsample=nsample,
                         output=os.environ.get("BENCH_OUTPUT", "samples"))
    sizes = tuple(int(s) for s in os.environ.get(
        "SCALE_NTRAIN", "400,1000,2000,4000,8000").split(","))
    print(f"scaling_study on {backend(dev)}: B={b}, {iters} iters a stage, "
          f"{nsample} paths, output={cfg.output}", flush=True)
    rows = []
    for ntrain in sizes:
        f, _ = sabr_paths(steps=ntrain, seed=0, n_paths=b)
        train_x, test_x = grids(ntrain, 100, dev)
        ys = f32(f, dev)
        got, best, first = timed_cold_best(
            lambda: fit_forecast_batch(seeded(dev, 0), train_x, ys, test_x,
                                       cfg)[0], repeats=3)
        check_finite(got, f"ntrain={ntrain}")
        rows.append({"ntrain": ntrain, "seconds": best,
                     "assets_per_s": b / best, "first_call_s": first})
        print(f"| {ntrain} | {best:.3f} | {b / best:.1f} | {first:.3f} |",
              flush=True)
    return {"backend": backend(dev), "assets": b, "rows": rows}


if __name__ == "__main__":
    main()

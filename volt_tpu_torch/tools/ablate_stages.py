"""Stage ablation at the north-star shape: ``fit_forecast_batch`` timed
with one stage's iterations cut to one (or the rollout to one path), to
split the call's cost by stage (port of the JAX package's
``tools/ablate_stages.py``).

Run::

    python -m volt_tpu_torch.tools.ablate_stages [n_assets] [ntrain]
        [--device cuda]

with ``ABLATE_ITERS`` (300), ``ABLATE_NSAMPLE`` (1000) and
``BENCH_OUTPUT`` (``samples``) read from the environment.  Prints each
variant's least time of three calls, after a first call whose time is
printed beside it, then each stage's cost (the full call less its ablated
variant), the residual and the throughput.
"""

from __future__ import annotations

import os

import torch

from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast_batch
from ..utils.profiling import timed_cold_best
from ._common import backend, check_finite, f32, grids, parser, seeded

__all__ = ["VARIANTS", "configs", "main"]

# each variant's change to the base configuration
VARIANTS = {
    "full": {},
    "gpcv_1": {"gpcv_iters": 1},
    "vol_1": {"vol_iters": 1},
    "data_1": {"data_iters": 1},
    "mc_1path": {"nsample": 1},
}


def configs(iters: int, nsample: int, output: str) -> dict:
    """Each variant's ``PipelineConfig``: ``iters`` Adam steps a stage,
    EWMA k=100, ``nsample`` paths, then the variant's change."""
    base = dict(gpcv_iters=iters, vol_iters=iters, data_iters=iters,
                mean_func="ewma", k=100, nsample=nsample, output=output)
    return {name: PipelineConfig(**{**base, **delta})
            for name, delta in VARIANTS.items()}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("n_assets", nargs="?", type=int, default=64)
    p.add_argument("ntrain", nargs="?", type=int, default=1000)
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    iters = int(os.environ.get("ABLATE_ITERS", "300"))
    nsample = int(os.environ.get("ABLATE_NSAMPLE", "1000"))
    output = os.environ.get("BENCH_OUTPUT", "samples")

    f, _ = sabr_paths(steps=a.ntrain, seed=0, n_paths=a.n_assets)
    train_x, test_x = grids(a.ntrain, 100, dev)
    ys = f32(f, dev)
    print(f"ablate_stages on {backend(dev)}: {a.n_assets} assets, ntrain "
          f"{a.ntrain}, {iters} iters a stage, {nsample} paths, "
          f"output={output}", flush=True)

    best, first = {}, {}
    for name, cfg in configs(iters, nsample, output).items():
        got, best[name], first[name] = timed_cold_best(
            lambda: fit_forecast_batch(seeded(dev, 0), train_x, ys, test_x,
                                       cfg)[0], repeats=3)
        check_finite(got, name)
        print(f"{name:10s} {best[name] * 1e3:9.1f} ms  (first call "
              f"{first[name] * 1e3:.1f} ms)", flush=True)

    full = best["full"]
    print("\nstage cost estimates (full minus ablated):")
    stages = {}
    for name in ("gpcv_1", "vol_1", "data_1", "mc_1path"):
        stages[name] = full - best[name]
        print(f"  {name:10s} {stages[name] * 1e3:9.1f} ms")
    residual = sum(best[name] for name in stages) - 3 * full
    print(f"  residual   {residual * 1e3:9.1f} ms (overhead-ish)")
    throughput = a.n_assets / full
    print(f"\nthroughput: {throughput:.1f} assets/sec/chip at "
          f"ntrain={a.ntrain}")
    return {"backend": backend(dev), "best_s": best, "first_s": first,
            "stage_s": stages, "residual_s": residual,
            "assets_per_s": throughput}


if __name__ == "__main__":
    main()

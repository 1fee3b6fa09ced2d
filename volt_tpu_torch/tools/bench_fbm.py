"""The FBM-kernel pipeline's cost per n (port of the JAX package's
``tools/bench_fbm.py``).

With ``kernel="fbm"`` there is no Markov or spectral shortcut: the GPCV
ELBO factors the dense prior every step and the vol GP pays a dense MLL,
the only per-iteration factorisations left in the package.  This tool
times the pipeline per ntrain, to give the FBM path's practical n cap on
the device: the first call (``warm_compile_sec``), then the least of
``--repeats`` calls after one more.  Prints one JSON line per ntrain.

Run::

    python -m volt_tpu_torch.tools.bench_fbm [--ntrain 400 1000 2000]
        [--assets 8] [--horizon 100] [--nsample 1000] [--iters 300]
        [--repeats 2] [--device cuda]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast_batch
from ..utils.profiling import timed, timed_best
from ._common import DT, f32, numpy, parser, seeded

__all__ = ["main"]


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--ntrain", type=int, nargs="+",
                   default=[400, 1000, 2000])
    p.add_argument("--assets", type=int, default=8)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--nsample", type=int, default=1000)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--repeats", type=int, default=2)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    records = []
    for ntrain in a.ntrain:
        n = ntrain - 1
        cfg = PipelineConfig(
            gpcv_iters=a.iters, vol_iters=a.iters, data_iters=a.iters,
            kernel="fbm", mean_func="ewma", k=100, nsample=a.nsample)
        f, _ = sabr_paths(steps=ntrain, seed=0, n_paths=a.assets)
        ys = f32(f, dev)
        train_x = torch.arange(n, dtype=torch.float32, device=dev) * DT
        test_x = train_x[-1] + DT * torch.arange(
            1, a.horizon + 1, dtype=torch.float32, device=dev)

        def run(seed):
            s, aux = fit_forecast_batch(seeded(dev, seed), train_x, ys,
                                        test_x, cfg)
            return s, aux["ok"]

        _, warm = timed(run, 0, warmup=0)  # the first call
        (out, ok), best = timed_best(lambda: run(1), repeats=a.repeats)
        out, ok = numpy(out), numpy(ok)
        rec = {"kernel": "fbm", "ntrain": ntrain, "assets": a.assets,
               "iters_per_stage": a.iters,
               "batch_sec": round(best, 2),
               "assets_per_sec": round(a.assets / best, 3),
               "warm_compile_sec": round(warm, 1),
               "finite": bool(np.isfinite(out).all()),
               "ok_frac": float(np.mean(ok))}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()

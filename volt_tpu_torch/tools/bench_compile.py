"""Time to first forecast against the steady state (port of the JAX
package's ``tools/bench_compile.py``, without its scan-unroll axis).

A user's first call in a fresh process pays for what a warm call finds
ready: here the ``nvcc`` build of the kernels and the load of their
library, the CUDA modules of every operation on its first launch, the
cuBLAS and cuSOLVER handles, the allocator's first blocks and the first
optimizer step.  Per batch size this tool copies the package into a
temporary directory without its ``_build/`` and runs
``fit_forecast_batch`` on SABR series in a fresh child process that
imports that copy, so the child builds the kernels as a first run does.
It prints one JSON line per batch size:

  * ``first_s``   — wall of the first call, ``torch.cuda.synchronize()``
                    included (time to first forecast);
  * ``build_s``   — the part of ``first_s`` spent building and loading the
                    kernel library (0 on the CPU, where nothing is built);
  * ``steady_ms`` — the least of ``--reps`` calls after a warm one.

A child that fails or times out prints an ``error`` line instead.
``tests/torch_first_call_profile.py`` profiles the same call's first and
steady runs.

Run::

    python -m volt_tpu_torch.tools.bench_compile [--assets 64,500]
        [--ntrain 1000] [--horizon 100] [--iters 300] [--nsample 1000]
        [--reps 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ._common import backend, f32, grids, parser, seeded

__all__ = ["main", "pipeline_call"]

_PACKAGE = Path(__file__).resolve().parent.parent
_CHILD_TIMEOUT_S = 2400


def pipeline_call(assets: int, ntrain: int, horizon: int, iters: int,
                  nsample: int, device):
    """The timed call: ``fit_forecast_batch`` on ``assets`` SABR series of
    ``ntrain`` prices (seed 0) with ``iters`` Adam steps a stage, EWMA
    ``k = min(100, n // 4)``, ``nsample`` paths of ``horizon`` steps, the
    quantile fan; a function of no arguments returning ``(fan, aux)``."""
    from ..data import sabr_paths
    from ..parallel import PipelineConfig, fit_forecast_batch

    dev = torch.device(device)
    n = ntrain - 1
    f, _ = sabr_paths(steps=ntrain, seed=0, n_paths=assets)
    train_x, test_x = grids(ntrain, horizon, dev)
    train_ys = f32(f, dev)
    cfg = PipelineConfig(gpcv_iters=iters, vol_iters=iters,
                         data_iters=iters, mean_func="ewma",
                         k=min(100, max(2, n // 4)), nsample=nsample,
                         output="quantiles")
    return lambda: fit_forecast_batch(seeded(dev, 0), train_x, train_ys,
                                      test_x, cfg)


def _child(a):
    """One batch size in this process: the first call, then the steady
    state; prints the JSON line."""
    from .. import native
    from ..utils.profiling import timed_best

    dev = torch.device(a.device)
    run = pipeline_call(a.assets, a.ntrain, a.horizon, a.iters, a.nsample,
                        dev)
    # the build a first call would start at its first kernel launch,
    # started here so that its share of the first call is seen
    t0 = time.perf_counter()
    if dev.type == "cuda":
        native.library()
    build_s = time.perf_counter() - t0
    out, _ = run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("first call: non-finite fan")
    _, steady_s = timed_best(run, repeats=a.reps)
    rec = {"assets": a.assets, "ntrain": a.ntrain, "backend": backend(dev),
           "first_s": round(first_s, 2), "build_s": round(build_s, 2),
           "steady_ms": round(1e3 * steady_s, 1)}
    print(json.dumps(rec), flush=True)
    return rec


def _run_child(a, assets: int) -> dict:
    """The child for ``assets`` on a copy of the package without
    ``_build/``; its JSON line, or an ``error`` record."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(_PACKAGE, Path(tmp) / _PACKAGE.name,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        cmd = [sys.executable, "-m", __spec__.name,
               "--child-assets", str(assets), "--device", a.device]
        for flag in ("ntrain", "horizon", "iters", "nsample", "reps"):
            cmd += [f"--{flag}", str(getattr(a, flag))]
        try:
            # ``-m`` puts the working directory first on the child's path,
            # so it imports the copy
            r = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                               timeout=_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            return {"assets": assets,
                    "error": f"timeout after {_CHILD_TIMEOUT_S} s"}
    out = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or not out:
        return {"assets": assets, "error": (r.stderr or r.stdout)[-400:]}
    return json.loads(out[-1])


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--assets", default="64,500")
    p.add_argument("--ntrain", type=int, default=1000)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--nsample", type=int, default=1000)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--child-assets", type=int, default=0,
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)

    if a.child_assets:
        a.assets = a.child_assets
        return _child(a)
    # the device is touched here, so that without a card the tool raises
    # rather than print an error line for each child
    torch.empty(0, device=torch.device(a.device))
    recs = []
    for b in [int(x) for x in a.assets.split(",")]:
        recs.append(_run_child(a, b))
        print(json.dumps(recs[-1]), flush=True)
    return recs


if __name__ == "__main__":
    main()

"""Sparse-GPCV quality against the full-resolution family on the SABR
oracle.

At an n where both families run, how much vol-recovery accuracy does the
m-inducing-point family (``learn_gpcv_sparse``, O(n m^2) a step) give up
against the full-resolution tridiagonal fit (``learn_gpcv``), as a
function of m?  One SABR path (``data.sabr_paths``) at n points; the error
is the mean relative deviation from the true latent vol path (port of the
JAX package's ``tools/sparse_quality.py``).

Run::

    python -m volt_tpu_torch.tools.sparse_quality [--n 2000]
        [--ms 64,128,256] [--iters 400] [--spot-n 0] [--seed 2019]
        [--device cuda]

``--spot-n 16000`` adds a sparse-only row at that length.  Prints one JSON
object.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..data import sabr_paths
from ..train import learn_gpcv, learn_gpcv_sparse
from ._common import f32, numpy, parser

__all__ = ["rel_err", "make_oracle", "main"]


def rel_err(vol_hat, v_true):
    """The mean of |vol_hat - v_true| / v_true."""
    return float(np.mean(np.abs(numpy(vol_hat) - v_true) / v_true))


def make_oracle(n: int, seed: int, device):
    """A SABR path of n + 1 steps over one year (a finer discretisation of
    the same tutorial oracle as n grows): the grid, the prices and the
    true vol at the return points."""
    f, v = sabr_paths(steps=n + 1, seed=seed)
    dt = 1.0 / (n + 1)
    train_x = torch.linspace(0.0, 1.0, n, dtype=torch.float32,
                             device=device) + dt
    return train_x, f32(f, device), v[1:]


def _timed(fn):
    t0 = time.perf_counter()
    out = numpy(fn())  # the copy to the host waits for the device
    return out, round(time.perf_counter() - t0, 2)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--ms", default="64,128,256")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--spot-n", type=int, default=0)
    p.add_argument("--seed", type=int, default=2019)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    train_x, f, v_true = make_oracle(a.n, a.seed, dev)
    out = {"n": a.n, "iters": a.iters, "seed": a.seed}
    vol, secs = _timed(lambda: learn_gpcv(train_x, f, train_iters=a.iters))
    out["dense"] = {"rel_err": rel_err(vol, v_true), "secs": secs}

    out["sparse"] = {}
    for m in [int(s) for s in a.ms.split(",")]:
        vol_m, secs = _timed(lambda: learn_gpcv_sparse(
            train_x, f, num_inducing=m, train_iters=a.iters))
        err = rel_err(vol_m, v_true)
        out["sparse"][str(m)] = {
            "rel_err": err,
            "ratio_vs_dense": round(err / out["dense"]["rel_err"], 3),
            "secs": secs}

    if a.spot_n:
        sx, sf, sv = make_oracle(a.spot_n, a.seed, dev)
        vol_s, secs = _timed(lambda: learn_gpcv_sparse(
            sx, sf, num_inducing=256, train_iters=a.iters))
        out["spot"] = {"n": a.spot_n, "m": 256, "rel_err": rel_err(vol_s, sv),
                       "secs": secs}

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""The full-resolution GPCV's convergence against n.

A 64-inducing-point sparse fit once beat the full-resolution tridiagonal
family at n=2000 on the SABR oracle, though the latter contains the
former's optimum.  This tool separates the explanations
(under-convergence at the iteration budget, an init that degrades with n,
a learning rate mis-scaled with n, or a regularising bottleneck): for each
n and learning rate it fits the full-resolution family in chunks and
records the relative vol error and the ELBO after each chunk, and the
error of the init itself (port of the JAX package's
``tools/gpcv_convergence.py``; the same oracle as ``sparse_quality``).

Run::

    python -m volt_tpu_torch.tools.gpcv_convergence [--ns 500,1000,2000]
        [--lrs 0.01,0.03] [--chunks 400,600,1000,2000] [--opt adam|ngvi]
        [--seed 2019] [--device cuda]

Prints one JSON line per run on stderr and one JSON object on stdout.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import torch

from ..models.gpcv import GPCVModel, GPCVState
from ..train import _fit_gpcv, scaled_returns
from ._common import parser
from .sparse_quality import make_oracle, rel_err

__all__ = ["main"]


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--ns", default="500,1000,2000")
    p.add_argument("--lrs", default="0.01,0.03")
    p.add_argument("--chunks", default="400,600,1000,2000",
                   help="iteration increments; the cumulative budgets are "
                        "their running sums")
    p.add_argument("--opt", default="adam", choices=["adam", "ngvi"])
    p.add_argument("--seed", type=int, default=2019)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    ns = [int(s) for s in a.ns.split(",")]
    lrs = [float(s) for s in a.lrs.split(",")]
    chunks = [int(s) for s in a.chunks.split(",")]

    out = {"seed": a.seed, "opt": a.opt, "runs": []}
    for n in ns:
        train_x, f, v_true = make_oracle(n, a.seed, dev)
        yy = scaled_returns(train_x, f)
        module0 = GPCVModel(kernel="bm", q="tridiag").init(train_x, yy)

        def scale(module):
            with torch.no_grad():
                return GPCVState(module=module, train_x=train_x,
                                 targets=yy).predicted_scale()

        init_err = rel_err(scale(module0), v_true)
        for lr in lrs:
            module = copy.deepcopy(module0)  # each rate from the same init
            row = {"n": n, "lr": lr, "init_rel_err": round(init_err, 4),
                   "trace": []}
            total = 0
            t0 = time.perf_counter()
            for c in chunks:
                losses = _fit_gpcv(module, train_x, yy, c, lr, a.opt)
                total += c
                row["trace"].append({
                    "iters": total,
                    "rel_err": round(rel_err(scale(module), v_true), 4),
                    "elbo": round(-float(losses[-1]), 5)})
            row["secs"] = round(time.perf_counter() - t0, 2)
            out["runs"].append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

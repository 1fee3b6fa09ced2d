"""The floating-point work of one call of the FBM entry
(``entries/fbm.py``): ``counts.call_ops`` and, beyond it, the dense GPCV
family's work in each Adam step, counted as a lower bound that any
implementation of the family must do, whatever solver it uses.

In each GPCV step the root ``(n, n)`` of ``q`` has ``n (n + 1) / 2``
entries that the forward (the marginals' squares and sums), the backward
and Adam's update each touch, with a few operations apiece; and the KL's
trace term applies the prior's inverse to the root's ``n`` columns.  The
FBM increments' Gram is Toeplitz on an equispaced grid, so a fast
Toeplitz solve does a column in about ``n log2 n`` operations, and the
backward about twice the forward.  The ``n^3`` of the Cholesky route that
the program takes is not counted: a structured solver may avoid it, and a
share of a peak built on these counts then still cannot pass 100%.
"""

from __future__ import annotations

import math

import counts

# the forward's square and add, the backward's two, Adam's update six
ROOT_OPS_PER_ENTRY = 2 + 2 + 6
# the prior's solve: the forward, and a backward of twice its work
PRIOR_SOLVE_PASSES = 1 + 2


def dense_gpcv_step_ops(assets: int, n: int) -> float:
    """Operations of one dense GPCV Adam step beyond the per-datum count
    of ``counts.call_ops``."""
    root = ROOT_OPS_PER_ENTRY * n * (n + 1) / 2
    solve = PRIOR_SOLVE_PASSES * n * n * math.log2(n)
    return assets * (root + solve)


def call_ops(assets: int, n: int, horizon: int, nsample: int,
             iters: tuple) -> float:
    """Floating-point operations of one call of the FBM entry: ``iters``
    the Adam steps of the GPCV, vol and data stages."""
    return (counts.call_ops(assets, n, horizon, nsample, iters)
            + iters[0] * dense_gpcv_step_ops(assets, n))

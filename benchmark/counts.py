"""The yardstick's arithmetic: published peaks, the bytes and operations
of the port's kernels K1 and S1 (frozen from ``chip_smoke.py``), and the
floating-point work a call needs, for ``mfu``.

The counts are of what the algorithm needs at the cell's shapes, whatever
implements it: each input read once, each output written once, and the
arithmetic of one pass of each formula (a scan done by doubling, or a
recomputation, counts once).  They are lower bounds, so a share of a peak
built on them cannot pass 100% unless a time is short of the work.
"""

from __future__ import annotations

# One H100 SXM, NVIDIA's data sheet, dense rates (the card at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def k1_bound_s(rows: int, t: int) -> float:
    """K1, the EWMA filter ``(rows, t) -> (rows, t + 1)``: reads ``y``,
    writes the output, three float64 operations an output."""
    return bound_s(4 * (rows * t + rows * (t + 1)), 3 * rows * t,
                   FP64_OPS_PER_S)


def s1_forward_bound_s(b: int, n: int) -> float:
    """S1 forward: reads delta, resid, s2, writes ll, mean, var and the
    saved (m, P); about 40 float64 operations a step."""
    return bound_s(4 * (4 * b * n + 4 * b), 40 * b * n, FP64_OPS_PER_S)


def s1_backward_bound_s(b: int, n: int) -> float:
    """S1 adjoint: reads delta, resid, m, P, s2 and three cotangents,
    writes d/d delta, d/d resid, d/d s2; about 50 float64 operations a
    step."""
    return bound_s(4 * (6 * b * n + 5 * b), 50 * b * n, FP64_OPS_PER_S)


# Operations a datum of one Adam step's loss needs, forward and backward
# (a backward costs about twice its forward), counted from the formulas:
# GPCV: the closed-form expected log-likelihood of the exp vol model (6)
# and the tridiagonal KL to the BM prior (about 4 a datum for the log
# pivots, the trace and the quadratic form); the vol GP: the spectral MLL,
# one term per eigenvalue (5); the data model: S1 (40 forward, 50
# adjoint) with the vol integral and the residual (4 forward).
GPCV_OPS_PER_DATUM = 3 * (6 + 4)
VOL_OPS_PER_DATUM = 3 * 5
DATA_OPS_PER_DATUM = 40 + 50 + 3 * 4
# The rollout: a vol path step (a normal scaled and added, an exp) and a
# price step (the Markov mean, the increment's std, the draw): about 10
# operations a path-step; the fan's mean and std, 4 a sample.
ROLLOUT_OPS_PER_STEP = 10
FAN_OPS_PER_SAMPLE = 4


def call_ops(assets: int, n: int, horizon: int, nsample: int,
             iters: tuple) -> float:
    """Floating-point operations of one call of either entry: ``iters``
    the Adam steps of the GPCV, vol and data stages; the multitask chain
    couples the tasks through ``T x T`` blocks of rank 1, whose work is
    of the order of the per-task terms, so it counts the same."""
    g, v, d = iters
    fit = assets * n * (g * GPCV_OPS_PER_DATUM + v * VOL_OPS_PER_DATUM
                        + d * DATA_OPS_PER_DATUM)
    paths = assets * nsample * horizon
    return fit + paths * (ROLLOUT_OPS_PER_STEP + FAN_OPS_PER_SAMPLE)

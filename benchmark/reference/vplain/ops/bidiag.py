"""Bidiagonal-Cholesky (tridiagonal-precision) Gaussian algebra (port of
:mod:`volt_tpu.ops.bidiag`).

The GPCV stage's variational family ``q = N(m, (L L^T)^{-1})`` with ``L``
lower bidiagonal: marginal variances by the Takahashi recursion and the
closed-form KL against the Brownian prior, all O(n).

JAX runs the first-order recurrences as ``lax.associative_scan``; PyTorch
has no such primitive, so :func:`affine_scan` is a log-depth doubling
(Hillis–Steele) scan written in plain tensor ops: ``ceil(log2 n)`` rounds
of a shifted combine, which autograd differentiates like any other ops.
"""

from __future__ import annotations

import torch
from .tridiag import tridiag_ldl_pivots


def affine_scan(alpha, beta, reverse: bool = False):
    """Solve ``z_i = alpha_i z_{i-1} + beta_i`` (``z_{-1} = 0``) along the
    last axis with a doubling scan over the pairs ``(alpha, beta)``,
    combined as ``(a_x a_y, a_y b_x + b_y)`` (``x`` before ``y``)."""
    a, b = torch.broadcast_tensors(alpha, beta)
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    n = a.shape[-1]
    off = 1
    while off < n:
        b = torch.cat([b[..., :off], a[..., off:] * b[..., :-off]
                       + b[..., off:]], dim=-1)
        a = torch.cat([a[..., :off], a[..., :-off] * a[..., off:]], dim=-1)
        off *= 2
    return b.flip(-1) if reverse else b


def bidiag_chol_from_tridiag(diag, off):
    """Cholesky ``(d, e)`` of an SPD tridiagonal ``T = L L^T``
    (``L[i, i] = d_i``, ``L[i+1, i] = e_i``) from its LDL pivots."""
    p, _ = tridiag_ldl_pivots(diag, off)
    d = torch.sqrt(p)
    return d, off / d[..., :-1]


def takahashi_band(d, e):
    """Diagonal and first off-diagonal of ``(L L^T)^{-1}``:

        ``var_{n-1} = 1/d_{n-1}^2``
        ``var_j = 1/d_j^2 + (e_j / d_j)^2 var_{j+1}``
        ``cov_j = -(e_j / d_j) var_{j+1}``
    """
    a = 1.0 / (d * d)
    r = e / d[..., :-1]
    alpha = torch.cat([r * r, torch.zeros_like(d[..., :1])], dim=-1)
    var = affine_scan(alpha, a, reverse=True)
    cov = -r * var[..., 1:]
    return var, cov


def min_precision(x, jitter=0.0):
    """Tridiagonal precision of ``min(x)`` (unit vol), increments floored
    at ``jitter`` (a float, or a tensor with the batch shape):

        ``A_ii = 1/dx_i + 1/dx_{i+1}`` (last: ``1/dx_n``),
        ``A_{i,i+1} = -1/dx_{i+1}``.

    Returns ``(diag, off, dx)``.
    """
    dx = torch.diff(x, dim=-1, prepend=torch.zeros_like(x[..., :1]))
    if torch.is_tensor(jitter):
        dx = torch.maximum(dx, jitter[..., None])
    else:
        dx = torch.clamp(dx, min=jitter)
    inv = 1.0 / dx
    diag = inv + torch.cat([inv[..., 1:], torch.zeros_like(inv[..., :1])],
                           dim=-1)
    return diag, -inv[..., 1:], dx


def tridiag_q_kl_bm_prior(x, vol, mean_q, q_d, q_e, mean_p,
                          jitter: float = 1e-6):
    """``KL(N(mean_q, (L L^T)^{-1}) || N(mean_p, vol * min(x)))`` in O(n).

    ``vol``: ``(..., 1)`` (the kernel parameter's shape); the prior's
    singular first increment on grids starting at 0 is floored at
    ``jitter / vol`` as in the JAX package.
    """
    n = mean_q.shape[-1]
    vol0 = vol[..., 0]
    a_diag, a_off, dx = min_precision(x, jitter / vol0)

    var, cov = takahashi_band(q_d, q_e)
    trace = (torch.sum(a_diag * var, dim=-1)
             + 2.0 * torch.sum(a_off * cov, dim=-1)) / vol0

    diff = torch.diff(mean_p - mean_q, dim=-1,
                      prepend=torch.zeros_like(mean_q[..., :1]))
    quad = torch.sum(diff * diff / dx, dim=-1) / vol0

    logdet_p = n * torch.log(vol0) + torch.sum(torch.log(dx), dim=-1)
    logdet_q_cov = -2.0 * torch.sum(torch.log(q_d), dim=-1)
    return 0.5 * (trace + quad - n + logdet_p - logdet_q_cov)

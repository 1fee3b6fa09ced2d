"""Kronecker-structured MVN algebra for the multitask GPs (port of
:mod:`volt_tpu.gp.kronecker`).

The multitask models put ``K = K_data (x) K_task`` over ``N x T``
observations, laid out ``(..., N, T)`` with the tasks fastest in
``vec``.  The ``NT x NT`` matrix is never built for training: with
``K_d = Q_d L_d Q_d^T`` and ``K_t = Q_t L_t Q_t^T``, ``K + s I`` has the
eigenvalues ``l_d l_t + s`` in the basis ``Q_d (x) Q_t``; the KL between
two Kronecker MVNs splits into per-factor traces and log-determinants.

:func:`kron_mvn_log_prob` is an autograd ``Function`` whose backward is
the JAX package's closed form: the autograd of ``torch.linalg.eigh``
divides by eigenvalue gaps, and the task covariance is born degenerate
(``F F^T + c I`` has ``T - rank`` equal eigenvalues).  Its forward's
``eigh`` bases differ between LAPACK and cuSOLVER (signs, order within a
degenerate eigenspace); every output here is invariant to them.

Dense products are ``torch.matmul`` / ``einsum`` in float32 (TF32 off);
factors go through :func:`..ops.chol.psd_safe_cholesky`.
"""

from __future__ import annotations

import math
import torch
from ..ops.bidiag import min_precision, takahashi_band
from ..ops.chol import (cholesky_solve, psd_safe_cholesky, solve_lower_triangular)

_LOG_2PI = math.log(2.0 * math.pi)


def _tri_logdet(tri):
    """``2 sum log |diag|`` of a triangular factor."""
    return 2.0 * torch.sum(torch.log(torch.abs(
        torch.diagonal(tri, dim1=-2, dim2=-1))), dim=-1)


def _woodbury_ll(r_tilde, z, v, s_mat, c, k_task, logdet_blocks):
    """The offset coupling's Woodbury terms, written so that ``c = 0``
    needs no ``K_t^{-1}``: ``quad -= c v^T K_t (I + c S K_t)^{-1} v``,
    ``logdet += log|I + c S K_t|``; then the log-density."""
    n, t = r_tilde.shape[-2], r_tilde.shape[-1]
    eye_t = torch.eye(t, dtype=r_tilde.dtype, device=r_tilde.device)
    m = eye_t + c * (s_mat @ k_task)
    kv = (k_task @ v[..., None])
    corr = torch.linalg.solve(m, kv)[..., 0]
    quad = torch.sum(r_tilde * z, dim=(-2, -1)) - c * torch.sum(v * corr,
                                                                 dim=-1)
    logdet = logdet_blocks + torch.linalg.slogdet(m)[1]
    return -0.5 * (quad + logdet + n * t * _LOG_2PI)


def kron_mvn_log_prob_blockdiag_lowrank(r_tilde, ld, c, factor, task_diag,
                                        noise, w):
    """:func:`kron_mvn_log_prob_blockdiag` for the ``IndexKernel``'s
    ``K_t = F F^T + diag(v)`` (``factor (T, r)``, ``task_diag (T,)``):
    each block ``ld_i K_t + s I = diag(ld_i v + s) + ld_i F F^T`` is
    diagonal plus rank ``r``, so Woodbury and the determinant lemma give
    its solves and log-determinant in O(T r^2): O(N T r^2 + N T^2 r) a
    step instead of O(N T^3).  The offset coupling keeps one dense
    ``T x T`` solve."""
    t = r_tilde.shape[-1]
    r = factor.shape[-1]
    eye_t = torch.eye(t, dtype=r_tilde.dtype, device=r_tilde.device)
    k_task = factor @ factor.mT + task_diag[..., :, None] * eye_t
    ld_ = ld[..., :, None]  # (..., N, 1)
    dinv = 1.0 / (ld_ * task_diag + noise)  # (..., N, T)
    fdf = torch.einsum("...nt,ta,tb->...nab", dinv, factor, factor)
    m_i = torch.eye(r, dtype=r_tilde.dtype, device=r_tilde.device) \
        + ld_[..., None] * fdf
    chol_r = psd_safe_cholesky(m_i)  # (..., N, r, r)

    du = dinv * r_tilde
    fu = torch.einsum("ta,...nt->...na", factor, du)
    sol = cholesky_solve(chol_r, fu[..., None])[..., 0]
    z = du - ld_ * dinv * torch.einsum("ta,...na->...nt", factor, sol)

    # S = sum_i w_i^2 B_i^{-1} = diag(sum_i w_i^2 dinv_i)
    #     - sum_i w_i^2 ld_i H_i H_i^T,  H_i = Dinv_i F L_i^{-T}
    w2 = w * w
    s_diag = torch.einsum("...n,...nt->...t", w2, dinv)
    g = dinv[..., None] * factor  # (..., N, T, r)
    h = solve_lower_triangular(chol_r, g.mT).mT
    s_corr = torch.einsum("...n,...nta,...nua->...tu", w2 * ld, h, h)
    s_mat = s_diag[..., :, None] * eye_t - s_corr
    v = torch.sum(w[..., None] * z, dim=-2)
    # log|B_i| = sum_t log(ld_i v_t + s) + log|M_i|
    logdet_blocks = -torch.sum(torch.log(dinv), dim=(-2, -1)) \
        + 2.0 * torch.sum(torch.log(torch.diagonal(chol_r, dim1=-2, dim2=-1)),
                          dim=(-2, -1))
    return _woodbury_ll(r_tilde, z, v, s_mat, c, k_task, logdet_blocks)


def _vol0(vol):
    return vol[..., 0] if torch.is_tensor(vol) and vol.dim() else vol


def kron_kl_bm_prior_tridiag(mean_q, q_d, q_e, root_t, mean_p, x, vol,
                             k_task, jitter: float = 1e-6):
    """:func:`kron_kl_bm_prior` with a tridiagonal-precision data factor
    ``Sx = (Lx Lx^T)^{-1}``, ``Lx`` lower bidiagonal ``(q_d, q_e)``: the
    trace by Takahashi band marginals against the tridiagonal
    ``min(x)^{-1}``, the quadratic by differencing, ``log|Sx| = -2 sum log
    q_d``; O(n) on the data side."""
    n, t = mean_q.shape[-2], mean_q.shape[-1]
    vol0 = _vol0(vol)
    a_diag, a_off, dx = min_precision(x, jitter / vol0)
    lt = psd_safe_cholesky(k_task)
    rt = torch.tril(root_t)
    var, cov = takahashi_band(q_d, q_e)
    tr_x = (torch.sum(a_diag * var, dim=-1)
            + 2.0 * torch.sum(a_off * cov, dim=-1)) / vol0
    at = solve_lower_triangular(lt, rt)
    trace = tr_x * torch.sum(at * at, dim=(-2, -1))
    diff = mean_p - mean_q
    half = torch.diff(diff, dim=-2, prepend=torch.zeros_like(
        diff[..., :1, :])) / torch.sqrt(dx)[..., :, None]
    half = solve_lower_triangular(lt, half.mT)
    quad = torch.sum(half * half, dim=(-2, -1)) / vol0
    logdet_p = t * (n * torch.log(torch.as_tensor(vol0))
                    + torch.sum(torch.log(dx), dim=-1)) + n * _tri_logdet(lt)
    logdet_q = t * (-2.0 * torch.sum(torch.log(q_d), dim=-1)) \
        + n * _tri_logdet(rt)
    return 0.5 * (trace + quad - n * t + logdet_p - logdet_q)


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
from ..ops.chol import cholesky_solve, psd_safe_cholesky, \
    solve_lower_triangular
from ..utils.profiling import annotate

__all__ = [
    "kron_mvn_log_prob",
    "kron_mvn_log_prob_blockdiag",
    "kron_mvn_log_prob_blockdiag_lowrank",
    "kron_kl_bm_prior",
    "kron_kl_bm_prior_tridiag",
    "kron_kl",
    "kron_posterior",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _sym(m):
    return 0.5 * (m + m.mT)


def _tri_logdet(tri):
    """``2 sum log |diag|`` of a triangular factor."""
    return 2.0 * torch.sum(torch.log(torch.abs(
        torch.diagonal(tri, dim1=-2, dim2=-1))), dim=-1)


def _kron_pieces(y, mean, k_data, k_task, noise):
    n, t = y.shape[-2], y.shape[-1]
    ld, qd = torch.linalg.eigh(k_data)
    lt, qt = torch.linalg.eigh(k_task)
    ld, lt = torch.clamp(ld, min=0.0), torch.clamp(lt, min=0.0)
    rot = qd.mT @ ((y - mean) @ qt)  # Q_d^T r Q_t
    denom = ld[..., :, None] * lt[..., None, :] + noise[..., None, None]
    quad = torch.sum(rot * rot / denom, dim=(-2, -1))
    logdet = torch.sum(torch.log(denom), dim=(-2, -1))
    ll = -0.5 * (quad + logdet + n * t * _LOG_2PI)
    return ll, (ld, qd, lt, qt, rot, denom)


class _KronMVNLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mean, k_data, k_task, noise):
        ll, pieces = _kron_pieces(y, mean, k_data, k_task, noise)
        ctx.save_for_backward(*pieces, k_data, k_task)
        ctx.noise_shape = noise.shape
        return ll

    @staticmethod
    def backward(ctx, g):
        ld, qd, lt, qt, rot, denom, k_data, k_task = ctx.saved_tensors
        alpha = qd @ ((rot / denom) @ qt.mT)  # Sigma^{-1} r, (N, T)
        g_ = g[..., None, None]
        inv = 1.0 / denom
        # the log-determinant's spectral terms
        trace_d = torch.sum(lt[..., None, :] * inv, dim=-1)  # (..., N)
        trace_t = torch.sum(ld[..., :, None] * inv, dim=-2)  # (..., T)
        gkd_logdet = (qd * trace_d[..., None, :]) @ qd.mT
        gkt_logdet = (qt * trace_t[..., None, :]) @ qt.mT
        # the quadratic form's alpha K alpha^T terms
        gkd_quad = (alpha @ k_task) @ alpha.mT
        gkt_quad = alpha.mT @ (k_data @ alpha)
        d_kd = (-0.5 * g_) * _sym(gkd_logdet - gkd_quad)
        d_kt = (-0.5 * g_) * _sym(gkt_logdet - gkt_quad)
        d_noise = -0.5 * g * (torch.sum(inv, dim=(-2, -1))
                              - torch.sum(alpha * alpha, dim=(-2, -1)))
        return (-g_) * alpha, g_ * alpha, d_kd, d_kt, \
            d_noise.sum_to_size(ctx.noise_shape)


def kron_mvn_log_prob(y, mean, k_data, k_task, noise):
    """``log N(vec(y); vec(mean), K_data (x) K_task + noise I)``; ``y`` and
    ``mean`` ``(..., N, T)``, ``noise`` a scalar (tensor or float).

    The gradient is the closed form
    ``dL/dK_d = -1/2 (Q_d diag_i(sum_a lt_a / D_ia) Q_d^T - alpha K_t
    alpha^T)`` (and its task twin) with ``alpha = Sigma^{-1} r``: spectral
    functions and alpha-quadratics only, finite where eigenvalues repeat.
    """
    noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
    mean = torch.broadcast_to(mean, y.shape)
    return _KronMVNLogProb.apply(y, mean, k_data, k_task, noise)


def kron_mvn_log_prob_blockdiag(r_tilde, ld, c, k_task, noise, w):
    """The Kronecker log-density with a known data-side eigenbasis, no
    ``eigh``: for ``Sigma = (c 11^T + A) (x) K_t + s I`` with ``A``'s
    eigenpairs ``(ld, U)``, rotating the data side by ``U`` gives ``N``
    blocks ``ld_i K_t + s I`` (a batched Cholesky) plus the rank-``T``
    coupling ``c (w w^T) (x) K_t`` (one Woodbury ``T x T`` solve).

    ``r_tilde (..., N, T) = U^T (y - mean)``, ``ld (..., N)``, ``c``
    scalar (0 or negative allowed), ``k_task (..., T, T)``, ``noise``
    scalar, ``w (..., N) = U^T 1``.  Plain autograd throughout."""
    n, t = r_tilde.shape[-2], r_tilde.shape[-1]
    eye_t = torch.eye(t, dtype=r_tilde.dtype, device=r_tilde.device)
    blocks = ld[..., :, None, None] * k_task[..., None, :, :] + noise * eye_t
    chol = psd_safe_cholesky(blocks)  # (..., N, T, T)
    z = cholesky_solve(chol, r_tilde[..., None])[..., 0]
    inv_blocks = cholesky_solve(chol, eye_t.expand(blocks.shape))
    s_mat = torch.sum((w * w)[..., None, None] * inv_blocks, dim=-3)
    v = torch.sum(w[..., None] * z, dim=-2)  # V^T B^{-1} r
    return _woodbury_ll(r_tilde, z, v, s_mat, c, k_task,
                        2.0 * torch.sum(torch.log(torch.diagonal(
                            chol, dim1=-2, dim2=-1)), dim=(-2, -1)))


def _woodbury_ll(r_tilde, z, v, s_mat, c, k_task, logdet_blocks):
    """The offset coupling's Woodbury terms, written so that ``c = 0``
    needs no ``K_t^{-1}``: ``quad -= c v^T K_t (I + c S K_t)^{-1} v``,
    ``logdet += log|I + c S K_t|``; then the log-density."""
    n, t = r_tilde.shape[-2], r_tilde.shape[-1]
    eye_t = torch.eye(t, dtype=r_tilde.dtype, device=r_tilde.device)
    m = eye_t + c * (s_mat @ k_task)
    kv = (k_task @ v[..., None])
    # the solve's error check waits for the device
    with annotate("sync:solve"):
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


def kron_kl_bm_prior(mean_q, root_x, root_t, mean_p, x, vol, k_task,
                     jitter: float = 1e-6):
    """:func:`kron_kl` for the BM data prior ``vol min(x)``: its Cholesky
    is the closed-form difference-and-scale operator, so O(n^2)
    differencing of the root's columns replaces an ``N x N`` factor.
    Increments are floored at ``jitter / vol``, as in
    :func:`..ops.brownian.bm_kl_against_prior`."""
    n, t = mean_q.shape[-2], mean_q.shape[-1]
    vol0 = _vol0(vol)
    dx = torch.diff(x, dim=-1, prepend=torch.zeros_like(x[..., :1]))
    dx = torch.maximum(dx, torch.as_tensor(jitter / vol0))
    sqrt_dx = torch.sqrt(dx)
    rx, rt = torch.tril(root_x), torch.tril(root_t)
    lt = psd_safe_cholesky(k_task)
    # tr(Kd^{-1} Sx) tr(Kt^{-1} St), Kd = vol min(x)
    ax = torch.diff(rx, dim=-2, prepend=torch.zeros_like(rx[..., :1, :])) \
        / sqrt_dx[..., :, None]
    at = solve_lower_triangular(lt, rt)
    trace = torch.sum(ax * ax, dim=(-2, -1)) / vol0 \
        * torch.sum(at * at, dim=(-2, -1))
    diff = mean_p - mean_q
    half = torch.diff(diff, dim=-2, prepend=torch.zeros_like(
        diff[..., :1, :])) / sqrt_dx[..., :, None]
    half = solve_lower_triangular(lt, half.mT)
    quad = torch.sum(half * half, dim=(-2, -1)) / vol0
    logdet_p = t * (n * torch.log(torch.as_tensor(vol0))
                    + torch.sum(torch.log(dx), dim=-1)) + n * _tri_logdet(lt)
    logdet_q = t * _tri_logdet(rx) + n * _tri_logdet(rt)
    return 0.5 * (trace + quad - n * t + logdet_p - logdet_q)


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


def kron_kl(mean_q, root_x, root_t, mean_p, k_data, k_task, chol_data=None):
    """``KL(N(vec(m_q), Sx (x) St) || N(vec(m_p), Kd (x) Kt))`` with the
    lower roots ``Sx = Rx Rx^T``, ``St = Rt Rt^T``; means ``(..., N, T)``.
    ``chol_data`` optionally gives the data kernel's factor (the FBM
    kernel's increment-domain one)."""
    n, t = mean_q.shape[-2], mean_q.shape[-1]
    rx, rt = torch.tril(root_x), torch.tril(root_t)
    ld = chol_data if chol_data is not None else psd_safe_cholesky(k_data)
    lt = psd_safe_cholesky(k_task)
    ax = solve_lower_triangular(ld, rx)
    at = solve_lower_triangular(lt, rt)
    trace = torch.sum(ax * ax, dim=(-2, -1)) * torch.sum(at * at,
                                                         dim=(-2, -1))
    half = solve_lower_triangular(ld, mean_p - mean_q)
    half = solve_lower_triangular(lt, half.mT)
    quad = torch.sum(half * half, dim=(-2, -1))
    logdet_p = t * _tri_logdet(ld) + n * _tri_logdet(lt)
    logdet_q = t * _tri_logdet(rx) + n * _tri_logdet(rt)
    return 0.5 * (trace + quad - n * t + logdet_p - logdet_q)


def kron_posterior(k_data_tr, k_data_cross, k_data_te, k_task, resid, noise):
    """The multitask exact-GP posterior of ``M`` test points given ``NT``
    train residuals ``resid (..., N, T)`` under ``K_d (x) K_t + noise
    I``: ``mean (..., M, T)`` and the joint ``cov (..., M T, M T)``, rows
    in (point, task) order."""
    m = k_data_cross.shape[-1]
    t = k_task.shape[-1]
    ld, qd = torch.linalg.eigh(k_data_tr)
    lt, qt = torch.linalg.eigh(k_task)
    ld, lt = torch.clamp(ld, min=0.0), torch.clamp(lt, min=0.0)
    denom = ld[..., :, None] * lt[..., None, :] + noise
    rot = (qd.mT @ (resid @ qt)) / denom
    alpha = qd @ (rot @ qt.mT)  # K^{-1} r
    mean = k_data_cross.mT @ (alpha @ k_task)
    # cov = Kte (x) Kt - sum_a (q_a q_a^T) (x) G_a, with G_a the data gram
    # of the cross block down-weighted per task eigenvalue
    cross_rot = qd.mT @ k_data_cross  # (N, M)
    g = torch.einsum("...ni,...nj,...nt->...tij", cross_rot, cross_rot,
                     lt[..., None, :] ** 2 / denom)
    k_te_full = torch.einsum("...ij,...ab->...iajb", k_data_te, k_task)
    correction = torch.einsum("...tij,...at,...bt->...iajb", g, qt, qt)
    cov = (k_te_full - correction).reshape(*k_te_full.shape[:-4], m * t,
                                           m * t)
    return mean, cov

"""Dense multivariate-normal algebra (the port's ``ops/mvn.py``,
``gp/exact.posterior`` and ``gp/variational``'s dense pieces, trimmed to
what the FBM cell runs): the log-density, the KL, the noisy posterior, the
sampler, and the dense family's Laplace init and ELBO at inducing ==
train points."""

from __future__ import annotations

import math

import torch

from .chol import (add_jitter, cholesky_solve, psd_safe_cholesky,
                   solve_lower_triangular)

_LOG_2PI = math.log(2.0 * math.pi)


def mvn_log_prob_chol(y, mean, chol):
    """``log N(y; mean, L L^T)`` given the lower factor."""
    n = y.shape[-1]
    w = solve_lower_triangular(chol, (y - mean)[..., None])
    quad = torch.sum(w * w, dim=-2)[..., 0]
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + logdet + n * _LOG_2PI)


def mvn_kl(mean_q, chol_q, mean_p, chol_p):
    """``KL(N(mean_q, Lq Lq^T) || N(mean_p, Lp Lp^T))``: the trace and
    quadratic terms by triangular solves, the log-determinants from the
    diagonals (``|diag(Lq)|``: a raw root's diagonal may go negative)."""
    n = mean_q.shape[-1]
    a = solve_lower_triangular(chol_p, chol_q)
    trace = torch.sum(a * a, dim=(-2, -1))
    w = solve_lower_triangular(chol_p, (mean_p - mean_q)[..., None])
    quad = torch.sum(w * w, dim=(-2, -1))
    logdet_p = 2.0 * torch.sum(torch.log(
        torch.diagonal(chol_p, dim1=-2, dim2=-1)), dim=-1)
    logdet_q = 2.0 * torch.sum(torch.log(torch.abs(
        torch.diagonal(chol_q, dim1=-2, dim2=-1))), dim=-1)
    return 0.5 * (trace + quad - n + logdet_p - logdet_q)


def posterior(k_tr_te, k_te, residual, chol_tr):
    """The latent posterior ``(mean*, cov*)`` at the test points given the
    factor ``chol_tr`` of ``K + noise I``."""
    k_te_tr = k_tr_te.mT
    cond_mean = k_te_tr @ cholesky_solve(chol_tr, residual[..., None])
    cond_cov = k_te - k_te_tr @ cholesky_solve(chol_tr, k_tr_te)
    return cond_mean[..., 0], cond_cov


def sample_mvn(mean, cov, noise, jitter: float, per_lane: bool = False):
    """``mean + L z`` for the standard normals ``noise`` ``(S, *mean.shape)``
    (``L``: the ladder's factor of ``cov``, per lane where ``per_lane``)."""
    chol = psd_safe_cholesky(cov, jitter, per_lane=per_lane)
    return mean + (chol @ noise[..., None])[..., 0]


def elbo_at_inducing(mean_q, root, prior_mean, y, expected_log_prob_fn,
                     chol_p):
    """``mean_i E_q[log p(y_i | f_i)] - KL(q || p) / n`` with inducing ==
    train == query points, ``q = N(mean_q, tril(root) tril(root)^T)`` and
    the prior's factor ``chol_p``."""
    chol_q = torch.tril(root)
    marg_var = torch.sum(chol_q * chol_q, dim=-1)
    ell = expected_log_prob_fn(y, mean_q, marg_var)
    kl = mvn_kl(mean_q, chol_q, prior_mean, chol_p)
    return torch.mean(ell, dim=-1) - kl / y.shape[-1]


def laplace_initialize(chol_kuu, y, f, root_scale: float, jitter: float,
                       per_lane: bool = False):
    """The reference's Laplace-style variational init with the exp
    curvature clamped after ``diag_embed`` (the off-diagonal zeros raised
    to 1e-4): ``S = L (L^T M L + I)^{-1} L^T``, ``L = chol_kuu``; the root
    ``tril(chol(S)) * root_scale``."""
    inv_hess = torch.clamp(0.5 * y ** -2.0 * torch.exp(2.0 * f), min=1e-4,
                           max=1000.0)
    n = inv_hess.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=inv_hess.device)
    dense_m = torch.where(eye, inv_hess[..., :, None],
                          torch.tensor(1e-4, dtype=inv_hess.dtype,
                                       device=inv_hess.device))

    def chol(a):
        return psd_safe_cholesky(a, jitter, per_lane=per_lane)

    inner = add_jitter(chol_kuu.mT @ (dense_m @ chol_kuu), 1.0)
    s = chol_kuu @ cholesky_solve(chol(inner), chol_kuu.mT)
    return torch.tril(chol(s)) * root_scale

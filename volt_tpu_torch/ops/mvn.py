"""Dense multivariate-normal algebra: log-density, KL, Gaussian conditionals
and sampling (port of :mod:`volt_tpu.ops.mvn`).  Every factor goes through
:func:`.chol.psd_safe_cholesky`; leading batch dims broadcast.  Matrix
products are float32 on the card only while TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32``, False by default)."""

from __future__ import annotations

import math

import torch

from .chol import (cholesky_solve, psd_safe_cholesky, solve_lower_triangular,
                   tril_inverse_quad)

__all__ = ["mvn_log_prob", "mvn_log_prob_chol", "mvn_kl", "conditional",
           "sample_mvn"]

_LOG_2PI = math.log(2.0 * math.pi)


def mvn_log_prob_chol(y, mean, chol):
    """``log N(y; mean, L L^T)`` given the lower factor."""
    n = y.shape[-1]
    quad = tril_inverse_quad(chol, y - mean)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + logdet + n * _LOG_2PI)


def mvn_log_prob(y, mean, cov, jitter: float | None = None):
    """``log N(y; mean, cov)`` through the psd-safe factor."""
    return mvn_log_prob_chol(y, mean, psd_safe_cholesky(cov, jitter=jitter))


def mvn_kl(mean_q, chol_q, mean_p, chol_p):
    """``KL(N(mean_q, Lq Lq^T) || N(mean_p, Lp Lp^T))``: the trace and
    quadratic terms by triangular solves, the log-determinants from the
    diagonals.  ``log|Sq|`` takes the absolute diagonal of ``Lq``: a raw
    variational root's diagonal can go negative under Adam, leaving
    ``Lq Lq^T`` and the gradients unchanged."""
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


def conditional(k_tr, k_tr_te, k_te, residual, jitter: float | None = None,
                chol_tr=None):
    """Gaussian conditional of test points given exact train values:
    ``mean = K_te,tr K_tr^{-1} residual``,
    ``cov = K_te - K_te,tr K_tr^{-1} K_tr,te``; ``chol_tr`` optionally
    gives the factor of ``K_tr``.  Returns ``(mean (..., m), cov (..., m,
    m))``."""
    chol = chol_tr if chol_tr is not None \
        else psd_safe_cholesky(k_tr, jitter=jitter)
    k_te_tr = k_tr_te.mT
    cond_mean = k_te_tr @ cholesky_solve(chol, residual[..., None])
    cond_cov = k_te - k_te_tr @ cholesky_solve(chol, k_tr_te)
    return cond_mean[..., 0], cond_cov


def sample_mvn(mean, cov, sample_shape=(), jitter: float | None = None,
               generator=None, noise=None, per_lane: bool = False):
    """Samples ``(*sample_shape, *mean.shape)`` of ``N(mean, cov)``:
    ``mean + L z``.  ``noise`` optionally gives the standard normals ``z``
    of that shape; otherwise they are drawn from ``generator``.
    ``per_lane``: each covariance of the batch climbs its own jitter
    ladder."""
    chol = psd_safe_cholesky(cov, jitter=jitter, per_lane=per_lane)
    if noise is None:
        noise = torch.randn(*sample_shape, *mean.shape, dtype=mean.dtype,
                            device=mean.device, generator=generator)
    return mean + (chol @ noise[..., None])[..., 0]

"""Exact-GP marginal likelihood and posterior (port of
:mod:`volt_tpu.gp.exact`): the MVN log-density of the targets under
``K + noise I`` divided by the number of points (gpytorch's
``ExactMarginalLogLikelihood``), and noisy conditioning.

The same MLL against a covariance that stays fixed over a fit (the Volt
data model's, whose vol path is frozen) is also evaluated through one
eigendecomposition: ``make_fixed_cov_cache`` factors ``K`` once, and each
``exact_mll_fixed_cov`` is then O(n^2)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.chol import psd_safe_cholesky
from ..ops.mvn import conditional, mvn_log_prob_chol

__all__ = ["exact_mll", "posterior", "FixedCovCache", "make_fixed_cov_cache",
           "exact_mll_fixed_cov"]

_LOG_2PI = math.log(2.0 * math.pi)


def _noise_vector(noise, like):
    """``noise`` as a tensor on ``like``'s device, a trailing dim of 1
    dropped."""
    noise = torch.as_tensor(noise, dtype=like.dtype, device=like.device)
    return noise[..., 0] if noise.dim() and noise.shape[-1] == 1 else noise


def _add_noise(cov, noise):
    noise = _noise_vector(noise, cov)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return cov + noise[..., None, None] * eye


def exact_mll(y, mean, cov, noise, jitter: float | None = None):
    """``log N(y; mean, cov + noise I) / n``; leading batch dims broadcast."""
    chol = psd_safe_cholesky(_add_noise(cov, noise), jitter=jitter)
    return mvn_log_prob_chol(y, mean, chol) / y.shape[-1]


def posterior(k_tr, k_tr_te, k_te, residual, noise,
              jitter: float | None = None, chol_tr=None):
    """Latent posterior ``p(f* | y)``: ``(mean*, cov*)`` of
    ``K_*^T (K + noise I)^{-1} residual`` and
    ``K_** - K_*^T (K + noise I)^{-1} K_*`` (add the test prior mean
    yourself)."""
    return conditional(_add_noise(k_tr, noise), k_tr_te, k_te, residual,
                       jitter=jitter, chol_tr=chol_tr)


class FixedCovCache(NamedTuple):
    """Eigendecomposition of a fixed train covariance
    ``K = Q diag(evals) Q^T``."""

    evals: torch.Tensor  # (..., n)
    evecs: torch.Tensor  # (..., n, n)


def _eigh(cov):
    """``torch.linalg.eigh``, on CUDA through MAGMA where torch has it.

    The smallest eigenvalues of a Volt covariance carry errors of about
    eps x lambda_max, beside a noise near its 1e-4 floor.  On the fitted
    states of ``chip_smoke.py``'s main path, (64, 999, 999) float32 on an
    NVIDIA H100 80GB HBM3 at 700 W (``tests/torch_fixed_cov_states.py
    routes``), cuSOLVER's (torch's default) puts the MLL 1.49e-3 from its
    float64 value, MAGMA's 3.9e-4, LAPACK's on the CPU (as the JAX
    package's) 4.8e-4; MAGMA takes 6.7-14.3 s for the batch against
    cuSOLVER's 0.77 s.  The form is a check, so it takes the more accurate
    one."""
    if cov.device.type != "cuda" or not torch.cuda.has_magma:
        return torch.linalg.eigh(cov)
    backend = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        return torch.linalg.eigh(cov)
    finally:
        torch.backends.cuda.preferred_linalg_library(backend)


def make_fixed_cov_cache(cov) -> FixedCovCache:
    """Factor ``cov`` once (``torch.linalg.eigh``, eigenvalues clamped at
    0) for every MLL step of a fit."""
    evals, evecs = _eigh(cov)
    return FixedCovCache(evals=torch.clamp(evals, min=0.0), evecs=evecs)


def exact_mll_fixed_cov(y, mean, cache: FixedCovCache, noise):
    """:func:`exact_mll` against a pre-eigendecomposed covariance, O(n^2):
    ``logdet(K + s I) = sum log(evals + s)`` and the quadratic form
    ``sum (Q^T r)^2 / (evals + s)``.  The gradient reaches ``y``, ``mean``
    and ``noise``; the cache is a constant of the fit."""
    n = y.shape[-1]
    noise = _noise_vector(noise, y)
    rot = torch.einsum("...ij,...i->...j", cache.evecs, y - mean)
    denom = cache.evals + noise[..., None]
    quad = torch.sum(rot * rot / denom, dim=-1)
    logdet = torch.sum(torch.log(denom), dim=-1)
    return -0.5 * (quad + logdet + n * _LOG_2PI) / n

"""Exact-GP marginal likelihood and posterior (port of the dense part of
:mod:`volt_tpu.gp.exact`): the MVN log-density of the targets under
``K + noise I`` divided by the number of points (gpytorch's
``ExactMarginalLogLikelihood``), and noisy conditioning."""

from __future__ import annotations

import torch

from ..ops.chol import psd_safe_cholesky
from ..ops.mvn import conditional, mvn_log_prob_chol

__all__ = ["exact_mll", "posterior"]


def _add_noise(cov, noise):
    noise = torch.as_tensor(noise, dtype=cov.dtype, device=cov.device)
    if noise.dim() and noise.shape[-1] == 1:
        noise = noise[..., 0]
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

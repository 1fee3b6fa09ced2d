"""Well-conditioned factors of the fractional-BM covariance (port of
:mod:`volt_tpu.ops.fbm`).

The FBM Gram ``K(s, t) = (s^{2H} + t^{2H} - |s - t|^{2H}) / 2`` on an
increasing grid factors through the increments ``g_i = B(t_i) -
B(t_{i-1})`` (``t_0 := 0``): ``K = A G A^T`` with ``A`` the lower ones
matrix and

    ``G[i, j] = (|t_i - t_{j-1}|^{2H} + |t_{i-1} - t_j|^{2H}
                 - |t_i - t_j|^{2H} - |t_{i-1} - t_{j-1}|^{2H}) / 2``,

so ``chol(K) = A chol(G) = cumsum(chol(G), axis=-2)``.  ``G`` (fractional
Gaussian noise on an equispaced grid) has a condition number of at most
about 1.5e3 for H in [0.1, 0.9] and n up to 2000, where ``K``'s reaches
1.5e8 and a float64 Cholesky of ``K`` fails at H = 0.9; so the factor is
taken in the increment domain.  A noise term maps to ``G + c D D^T`` with
``D = A^{-1}`` the first-difference matrix (``D D^T`` tridiagonal
``[-1, 2, -1]``, first diagonal entry 1).

Each factor takes ``per_lane`` for :func:`.chol.psd_safe_cholesky`: the
batched pipeline climbs the jitter ladder per asset, as ``jax.vmap`` of
the JAX function does.  Torch's ``pow`` gives ``0`` for the exponent's
gradient where the base is 0 (the diagonal of the last term, the first
row and column of the others), as JAX's does.  Each factor (the Gram, its
ladder and the cumulative sum) is an ``fbm_factor`` span.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate
from .chol import psd_safe_cholesky

__all__ = ["fbm_increment_cov", "fbm_cholesky", "fbm_noise_cholesky"]


def _trailing_matrix(a):
    """``(..., 1)`` -> ``(..., 1, 1)``, so it broadcasts against a Gram."""
    a = torch.as_tensor(a)
    return a[..., None] if a.dim() and a.shape[-1] == 1 else a


def fbm_increment_cov(x, two_h):
    """Covariance ``(..., n, n)`` of the fBm increments on the increasing
    positive grid ``x`` (``(..., n)``); ``two_h`` is ``2 H``, ``(..., 1)``
    or broadcastable against ``(..., 1, 1)``.  Exact on any grid."""
    two_h = _trailing_matrix(two_h)
    xp = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    ti, tim = x[..., :, None], xp[..., :, None]
    tj, tjm = x[..., None, :], xp[..., None, :]
    return 0.5 * (torch.abs(ti - tjm) ** two_h
                  + torch.abs(tim - tj) ** two_h
                  - torch.abs(ti - tj) ** two_h
                  - torch.abs(tim - tjm) ** two_h)


def fbm_cholesky(x, two_h, jitter: float | None = None, max_tries: int = 3,
                 per_lane: bool = False):
    """Lower Cholesky factor of the FBM Gram, ``cumsum(chol(G))``.  The
    jitter ladder runs on ``G``, so jitter perturbs ``K`` by ``eps A A^T``
    (a BM ridge), not ``eps I``; the factor is exact for that matrix."""
    with annotate("fbm_factor"):
        lg = psd_safe_cholesky(fbm_increment_cov(x, two_h), jitter=jitter,
                               max_tries=max_tries, per_lane=per_lane)
        return torch.cumsum(lg, dim=-2)


def fbm_noise_cholesky(x, two_h, noise, jitter: float | None = None,
                       max_tries: int = 3, per_lane: bool = False):
    """Lower Cholesky factor of ``K + noise I`` through ``G + noise D D^T``;
    ``noise`` is ``(..., 1)`` or broadcastable against ``(..., 1, 1)``."""
    n = x.shape[-1]
    with annotate("fbm_factor"):
        # D D^T made on the device: writing a host scalar into a card
        # tensor would wait for the card at every factor
        ones = torch.ones(n, dtype=x.dtype, device=x.device)
        diag, off = torch.cat([ones[:1], 2.0 * ones[1:]]), ones[1:]
        ddt = torch.diag(diag) - torch.diag(off, 1) - torch.diag(off, -1)
        g = fbm_increment_cov(x, two_h) + _trailing_matrix(noise) * ddt
        lg = psd_safe_cholesky(g, jitter=jitter, max_tries=max_tries,
                               per_lane=per_lane)
        return torch.cumsum(lg, dim=-2)

"""The fractional-BM kernel and its well-conditioned factors (the port's
``ops/fbm.py`` and ``kernels.FBMKernel``).

The FBM Gram ``K(s, t) = (s^{2H} + t^{2H} - |s - t|^{2H}) / 2`` on an
increasing grid factors through the increments ``g_i = B(t_i) -
B(t_{i-1})`` (``t_0 := 0``): ``K = A G A^T`` with ``A`` the lower ones
matrix and

    ``G[i, j] = (|t_i - t_{j-1}|^{2H} + |t_{i-1} - t_j|^{2H}
                 - |t_i - t_j|^{2H} - |t_{i-1} - t_{j-1}|^{2H}) / 2``,

so ``chol(K) = cumsum(chol(G), axis=-2)``.  A noise term maps to ``G + c
D D^T`` with ``D = A^{-1}`` the first-difference matrix (``D D^T``
tridiagonal ``[-1, 2, -1]``, first diagonal entry 1).  The jitter ladder
runs on ``G``, per asset where ``per_lane``.
"""

from __future__ import annotations

import torch

from reference.vplain.kernels.kernels import _ScalarParamKernel

from .chol import psd_safe_cholesky


def _trailing_matrix(a):
    """``(..., 1)`` -> ``(..., 1, 1)``, so it broadcasts against a Gram."""
    a = torch.as_tensor(a)
    return a[..., None] if a.dim() and a.shape[-1] == 1 else a


def fbm_increment_cov(x, two_h):
    """Covariance ``(..., n, n)`` of the fBm increments on the increasing
    positive grid ``x`` (``(..., n)``); ``two_h`` is ``2 H``, ``(..., 1)``
    or broadcastable against ``(..., 1, 1)``."""
    two_h = _trailing_matrix(two_h)
    xp = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    ti, tim = x[..., :, None], xp[..., :, None]
    tj, tjm = x[..., None, :], xp[..., None, :]
    return 0.5 * (torch.abs(ti - tjm) ** two_h
                  + torch.abs(tim - tj) ** two_h
                  - torch.abs(ti - tj) ** two_h
                  - torch.abs(tim - tjm) ** two_h)


def fbm_cholesky(x, two_h, jitter: float, max_tries: int = 3,
                 per_lane: bool = False):
    """Lower Cholesky factor of the FBM Gram, ``cumsum(chol(G))``."""
    lg = psd_safe_cholesky(fbm_increment_cov(x, two_h), jitter=jitter,
                           max_tries=max_tries, per_lane=per_lane)
    return torch.cumsum(lg, dim=-2)


def fbm_noise_cholesky(x, two_h, noise, jitter: float, max_tries: int = 3,
                       per_lane: bool = False):
    """Lower Cholesky factor of ``K + noise I`` through ``G + noise D
    D^T``; ``noise`` is ``(..., 1)``."""
    n = x.shape[-1]
    diag = torch.full((n,), 2.0, dtype=x.dtype, device=x.device)
    diag[0] = 1.0
    off = torch.ones(n - 1, dtype=x.dtype, device=x.device)
    ddt = torch.diag(diag) - torch.diag(off, 1) - torch.diag(off, -1)
    g = fbm_increment_cov(x, two_h) + _trailing_matrix(noise) * ddt
    lg = psd_safe_cholesky(g, jitter=jitter, max_tries=max_tries,
                           per_lane=per_lane)
    return torch.cumsum(lg, dim=-2)


class FBMKernel(_ScalarParamKernel):
    """Fractional-BM covariance ``K(s, t) = (|s|^{2H} + |t|^{2H} - |s -
    t|^{2H}) / 2`` with the Hurst parameter ``H`` stored as ``raw_vol``
    ``(*batch, 1)`` under ``Interval(0, 1)`` (default 0.2); :meth:`vol`
    returns ``H``."""

    def forward(self, x1, x2=None):
        """``(*batch, n1, n2)`` covariance."""
        x2 = x1 if x2 is None else x2
        two_h = (2.0 * self.vol())[..., None]
        s = torch.abs(x1[..., :, None])
        t = torch.abs(x2[..., None, :])
        d = torch.abs(x1[..., :, None] - x2[..., None, :])
        return 0.5 * (s ** two_h + t ** two_h - d ** two_h)

    def prior_cholesky(self, x, jitter: float, per_lane: bool = False):
        """Lower Cholesky factor of ``K(x, x)``, in the increment domain."""
        return fbm_cholesky(x, 2.0 * self.vol(), jitter, per_lane=per_lane)

    def noise_cholesky(self, x, noise, jitter: float,
                       per_lane: bool = False):
        """Lower Cholesky factor of ``K(x, x) + noise I``."""
        return fbm_noise_cholesky(x, 2.0 * self.vol(), noise, jitter,
                                  per_lane=per_lane)

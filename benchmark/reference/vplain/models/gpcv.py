"""GPCV: the stage-1 variational volatility model (the port's
``models/gpcv.py``, trimmed to what the cells run).

A variational GP with the BM kernel, a constant prior mean and the exp
volatility likelihood, inducing points at the training inputs, in the
tridiagonal family: ``q = N(m, (L L^T)^{-1})``, ``L`` lower bidiagonal
with diagonal ``exp(q_log_d)`` and subdiagonal ``q_e``.  Its ELBO is
O(n): Takahashi marginals, the closed-form tridiagonal KL to the BM prior
and the closed-form expected log-likelihood.  The stage's output is the
posterior-mean predicted scale, the inferred volatility path.
"""

from __future__ import annotations

import torch
from torch import nn
from ..gp.variational import exp_laplace_inv_hessian, running_std_latent_init
from ..kernels import BMKernel
from ..likelihoods import VolatilityGaussianLikelihood
from ..means import ConstantMean
from ..ops.bidiag import (bidiag_chol_from_tridiag, min_precision, takahashi_band, tridiag_q_kl_bm_prior)
from ..ops.quadrature import DEFAULT_NUM_LOCS


class GPCVModel(nn.Module):
    """Parameters (after :meth:`init`), each with a leading batch shape:
    ``kernel.raw_vol``, ``mean.constant``, ``variational_mean``,
    ``q_log_d`` ``(..., n)`` and ``q_e`` ``(..., n-1)``."""

    _KL_JITTER = 1e-6

    def __init__(self, kernel: str = "bm", num_locs: int = DEFAULT_NUM_LOCS,
                 q: str = "tridiag"):
        super().__init__()
        if kernel != "bm" or q != "tridiag":
            raise ValueError("the reference has the BM kernel's "
                             "tridiagonal family only")
        self.num_locs = num_locs
        self.kernel = BMKernel()
        self.mean = ConstantMean()
        self.likelihood = VolatilityGaussianLikelihood(param="exp")

    def _set(self, mean_const, m, **root):
        self.mean.constant = nn.Parameter(mean_const[..., None])
        self.variational_mean = nn.Parameter(m)
        for name, value in root.items():
            setattr(self, name, nn.Parameter(value))
        return self

    @torch.no_grad()
    def init(self, train_x, y, generator=None, per_lane: bool = False):
        """The Laplace-style init: ``S = (K^{-1} + diag(inv_hess))^{-1}``,
        exactly representable in the family."""
        batch = y.shape[:-1]
        self.kernel.init(batch, y.dtype, y.device)
        self.likelihood.init(batch, y.dtype, y.device, generator)
        f, rs = running_std_latent_init(y)
        mean_const = torch.log(torch.mean(rs, dim=-1))
        inv_hess = exp_laplace_inv_hessian(y, f)
        vol = self.kernel.vol()[..., 0]
        a_diag, a_off, _ = min_precision(train_x, self._KL_JITTER / vol)
        q_diag = a_diag / vol[..., None] + inv_hess
        q_off = a_off / vol[..., None]
        d, e = bidiag_chol_from_tridiag(q_diag, q_off)
        return self._set(mean_const, f, q_log_d=torch.log(d), q_e=e)

    def elbo(self, train_x, y):
        """Per-asset ELBO at inducing == train == query points, ``(...)``."""
        n = y.shape[-1]
        m = self.variational_mean
        prior_mean = self.mean(train_x)
        d = torch.exp(self.q_log_d)
        marg_var, _ = takahashi_band(d, self.q_e)
        kl = tridiag_q_kl_bm_prior(train_x, self.kernel.vol(), m, d,
                                   self.q_e, prior_mean,
                                   jitter=self._KL_JITTER)
        ell = self.likelihood.expected_log_prob(y, m, marg_var,
                                                num_locs=self.num_locs)
        return torch.mean(ell, dim=-1) - kl / n

    def predicted_scale(self):
        """The stage output ``E_f[scale(f)]`` at the train points (by
        Gauss–Hermite).  The variance is clamped at 1e-8."""
        m = self.variational_mean
        var = takahashi_band(torch.exp(self.q_log_d), self.q_e)[0]
        return self.likelihood.expected_scale(m, torch.clamp(var, min=1e-8))

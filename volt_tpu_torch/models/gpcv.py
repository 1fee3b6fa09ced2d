"""GPCV: the stage-1 variational volatility model (port of
:mod:`volt_tpu.models.gpcv`, the slice's configuration).

A variational GP with the BM kernel, a constant prior mean, the exp
volatility likelihood and the tridiagonal-precision family
``q = N(m, (L L^T)^{-1})``, ``L`` lower bidiagonal with diagonal
``exp(q_log_d)`` and subdiagonal ``q_e``.  Its ELBO is O(n): Takahashi
marginals, the exp expected log-likelihood (closed form, or with
``ell_method="quadrature"`` the reference's GH-75 term, kernel K3 on
CUDA) and the closed-form tridiagonal KL.  The stage's output is the
posterior-mean predicted scale, the inferred volatility path.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..gp.variational import exp_laplace_inv_hessian, running_std_latent_init
from ..kernels import BMKernel
from ..likelihoods import VolatilityGaussianLikelihood
from ..means import ConstantMean
from ..ops.bidiag import (bidiag_chol_from_tridiag, min_precision,
                          takahashi_band, tridiag_q_kl_bm_prior)
from ..ops.quadrature import DEFAULT_NUM_LOCS

__all__ = ["GPCVModel", "GPCVState"]


@dataclasses.dataclass
class GPCVState:
    """A fitted GPCV model (holding its parameters), its return grid and
    the scaled returns it was fitted to."""

    module: "GPCVModel"
    train_x: torch.Tensor
    targets: torch.Tensor

    def latent_marginals(self):
        return self.module.latent_marginals()

    def predicted_scale(self, mc_samples=None, generator=None, noise=None):
        return self.module.predicted_scale(mc_samples, generator, noise)


class GPCVModel(nn.Module):
    """Parameters (after :meth:`init`), each with a leading batch shape:
    ``kernel.raw_vol``, ``mean.constant``, ``variational_mean``,
    ``q_log_d`` ``(..., n)`` and ``q_e`` ``(..., n-1)``."""

    _KL_JITTER = 1e-6

    def __init__(self, kernel: str = "bm", param: str = "exp",
                 num_locs: int = DEFAULT_NUM_LOCS, q: str = "tridiag",
                 ell_method: str | None = None):
        super().__init__()
        if kernel == "fbm":
            raise NotImplementedError("GPCVModel(kernel='fbm') is not ported "
                                      "yet (ROADMAP slice C, item 16)")
        if kernel != "bm":
            raise ValueError("kernel must be 'bm' or 'fbm'")
        if q == "full":
            raise NotImplementedError("GPCVModel(q='full') is not ported yet "
                                      "(ROADMAP slice B, item 11)")
        if q != "tridiag":
            raise ValueError("q must be 'full' or 'tridiag'")
        if ell_method not in (None, "quadrature", "analytic"):
            raise ValueError("ell_method must be None, 'quadrature' or "
                             "'analytic'")
        self.q = q
        self.num_locs = num_locs
        # "quadrature" is the reference's GH term (train_utils.py:52);
        # None keeps the closed form
        self.ell_method = ell_method
        self.kernel = BMKernel()
        self.mean = ConstantMean()
        self.likelihood = VolatilityGaussianLikelihood(param=param)

    @torch.no_grad()
    def init(self, train_x, y):
        """Laplace init: ``S = (K^{-1} + diag(inv_hess))^{-1}``, exactly
        representable in the tridiagonal-precision family."""
        batch = y.shape[:-1]
        self.kernel.init(batch, y.dtype, y.device)
        f, rs = running_std_latent_init(y)
        inv_hess = exp_laplace_inv_hessian(y, f)
        vol = self.kernel.vol()[..., 0]
        a_diag, a_off, _ = min_precision(train_x, self._KL_JITTER / vol)
        q_diag = a_diag / vol[..., None] + inv_hess
        q_off = a_off / vol[..., None]
        d, e = bidiag_chol_from_tridiag(q_diag, q_off)
        self.mean.constant = nn.Parameter(
            torch.log(torch.mean(rs, dim=-1))[..., None])
        self.variational_mean = nn.Parameter(f)
        self.q_log_d = nn.Parameter(torch.log(d))
        self.q_e = nn.Parameter(e)
        return self

    def elbo(self, train_x, y):
        """Per-asset ELBO at inducing == train == query points, ``(...)``."""
        n = y.shape[-1]
        d = torch.exp(self.q_log_d)
        m = self.variational_mean
        marg_var, _ = takahashi_band(d, self.q_e)
        ell = self.likelihood.expected_log_prob(
            y, m, marg_var, num_locs=self.num_locs, method=self.ell_method)
        kl = tridiag_q_kl_bm_prior(train_x, self.kernel.vol(), m, d, self.q_e,
                                   self.mean(train_x), jitter=self._KL_JITTER)
        return torch.mean(ell, dim=-1) - kl / n

    def latent_marginals(self):
        """``(mean, var)`` of the latent at the train points (``q`` itself)."""
        d = torch.exp(self.q_log_d)
        return self.variational_mean, takahashi_band(d, self.q_e)[0]

    def predicted_scale(self, mc_samples=None, generator=None, noise=None):
        """The stage output ``E_f[scale(f)]`` at the train points
        (Gauss–Hermite, or ``mc_samples`` Monte-Carlo draws)."""
        mean, var = self.latent_marginals()
        return self.likelihood.expected_scale(
            mean, torch.clamp(var, min=1e-8), mc_samples, generator, noise)

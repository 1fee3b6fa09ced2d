"""GPCV: the stage-1 variational volatility model (port of
:mod:`volt_tpu.models.gpcv`).

A variational GP with the BM (or FBM) kernel, a constant prior mean and
the volatility likelihood (``param="exp"`` or the reference's ``"cv"``
softplus mixture), inducing points at the training inputs.  Two
variational families (``q``):

* ``"full"`` (the default, the reference's): ``q = N(m, C C^T)`` with a
  dense raw root ``chol_variational_covar`` ``(..., n, n)``; its ELBO
  takes the BM prior's closed-form KL (``ops.brownian``), O(n^2) a step;
* ``"tridiag"``: ``q = N(m, (L L^T)^{-1})``, ``L`` lower bidiagonal with
  diagonal ``exp(q_log_d)`` and subdiagonal ``q_e``; its ELBO is O(n):
  Takahashi marginals and the closed-form tridiagonal KL; BM kernel only
  (it rests on the Markov prior).

With the FBM kernel the prior's factor comes from the increment domain
(:mod:`..ops.fbm`, the jitter ladder per asset), the KL is the dense MVN
KL against it, and the init's root is not inflated x10 (against the FBM
prior the inflated init diverges, as the JAX package records).

The expected log-likelihood is the closed form for ``"exp"`` (with
``ell_method="quadrature"`` the reference's GH-75 term, kernel K3 on
CUDA) and the GH-75 node sum for ``"cv"``.  :meth:`GPCVModel.init_sparse`
and :meth:`GPCVModel.elbo_sparse` are the inducing-point (SVGP) form for
long series.  The stage's output is the posterior-mean predicted scale,
the inferred volatility path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import native
from ..convert import load_jax_params
from ..gp.variational import (VariationalState, elbo_at_inducing,
                              exp_laplace_inv_hessian, laplace_initialize,
                              running_std_latent_init, variational_predict)
from ..kernels import BMKernel, FBMKernel
from ..likelihoods import VolatilityGaussianLikelihood
from ..means import ConstantMean
from ..ops.bidiag import (bidiag_chol_from_tridiag, bidiag_solve_lower,
                          min_precision, takahashi_band,
                          tridiag_q_kl_bm_prior)
from ..ops.brownian import bm_kl_against_prior
from ..ops.chol import cholesky_solve, psd_safe_cholesky
from ..ops.gpcv_elbo import tridiag_elbo
from ..ops.mvn import mvn_kl
from ..ops.quadrature import DEFAULT_NUM_LOCS

__all__ = ["GPCVModel", "GPCVState"]


@dataclasses.dataclass
class GPCVState:
    """A fitted GPCV model (holding its parameters), its return grid and
    the scaled returns it was fitted to; a sparse fit also carries its
    inducing grid, from which it predicts onto ``train_x``."""

    module: "GPCVModel"
    train_x: torch.Tensor
    targets: torch.Tensor
    inducing_x: Optional[torch.Tensor] = None

    def _grids(self, test_x=None):
        """``(the grid q lives on, the query grid or None)``."""
        if self.inducing_x is None:
            return self.train_x, test_x
        return self.inducing_x, self.train_x if test_x is None else test_x

    def latent_marginals(self, test_x=None):
        return self.module.latent_marginals(*self._grids(test_x))

    def predicted_scale(self, mc_samples=None, generator=None, noise=None):
        return self.module.predicted_scale(
            *self._grids(), mc_samples=mc_samples, generator=generator,
            noise=noise)


class GPCVModel(nn.Module):
    """Parameters (after :meth:`init`), each with a leading batch shape:
    ``kernel.raw_vol``, ``mean.constant``, ``likelihood.raw_{a,b,c}``
    (``param="cv"``), ``variational_mean`` and either
    ``chol_variational_covar`` ``(..., n, n)`` (``q="full"``) or ``q_log_d``
    ``(..., n)`` and ``q_e`` ``(..., n-1)`` (``q="tridiag"``)."""

    _KL_JITTER = 1e-6

    def __init__(self, kernel: str = "bm", param: str = "exp",
                 num_locs: int = DEFAULT_NUM_LOCS, q: str = "full",
                 ell_method: str | None = None):
        super().__init__()
        if kernel not in ("bm", "fbm"):
            raise ValueError("kernel must be 'bm' or 'fbm'")
        if q not in ("full", "tridiag"):
            raise ValueError("q must be 'full' or 'tridiag'")
        if q == "tridiag" and kernel != "bm":
            # the tridiagonal-precision family rests on the BM prior's
            # Markov property
            raise ValueError("q='tridiag' requires the BM kernel")
        if ell_method not in (None, "quadrature", "analytic"):
            raise ValueError("ell_method must be None, 'quadrature' or "
                             "'analytic'")
        self.q = q
        self.num_locs = num_locs
        # "quadrature" is the reference's GH term (train_utils.py:52);
        # None keeps the likelihood's default (the closed form for exp)
        self.ell_method = ell_method
        self.kernel = BMKernel() if kernel == "bm" else FBMKernel()
        self.mean = ConstantMean()
        self.likelihood = VolatilityGaussianLikelihood(param=param)

    def _start(self, y, generator, likelihood_params):
        batch = y.shape[:-1]
        self.kernel.init(batch, y.dtype, y.device)
        self.likelihood.init(batch, y.dtype, y.device, generator)
        if likelihood_params is not None:
            load_jax_params(self.likelihood, likelihood_params, y.device)

    def _set(self, mean_const, m, **root):
        self.mean.constant = nn.Parameter(mean_const[..., None])
        self.variational_mean = nn.Parameter(m)
        for name, value in root.items():
            setattr(self, name, nn.Parameter(value))
        return self

    @torch.no_grad()
    def init(self, train_x, y, generator=None, per_lane: bool = False,
             likelihood_params=None):
        """The Laplace-style init.  ``q="full"``: the reference's
        :func:`~volt_tpu_torch.gp.variational.laplace_initialize` with its
        x10 root inflation and (exp) the dense clamp-after-``diag_embed``
        curvature; ``per_lane`` runs its three jitter ladders per asset
        (the batched pipeline).  ``q="tridiag"``: ``S = (K^{-1} +
        diag(inv_hess))^{-1}``, exactly representable in the family, not
        inflated.  ``generator`` draws the cv triplets' random init;
        ``likelihood_params`` (``{"raw_a": ..., ...}``, e.g. the JAX
        package's draw) replaces it."""
        self._start(y, generator, likelihood_params)
        if self.q == "tridiag":
            return self._init_tridiag(train_x, y)
        chol_kuu = self._prior_chol(train_x, per_lane)
        kuu = self.kernel(train_x) if chol_kuu is None else None
        # the reference's x10 root inflation for BM only: against the FBM
        # prior the inflated init diverges (the JAX package's measurement)
        root_scale = 10.0 if isinstance(self.kernel, BMKernel) else 1.0
        if self.likelihood.param == "cv":
            f, mean_const, inv_hess = self._cv_laplace_pieces(y)
            state, _ = laplace_initialize(kuu, y, f=f, inv_hess=inv_hess,
                                          root_scale=root_scale,
                                          chol_kuu=chol_kuu, per_lane=per_lane)
        else:
            state, mean_const = laplace_initialize(
                kuu, y, root_scale=root_scale, chol_kuu=chol_kuu,
                per_lane=per_lane)
        return self._set(mean_const, state.variational_mean,
                         chol_variational_covar=state.chol_variational_covar)

    def _prior_chol(self, x, per_lane: bool = True):
        """The FBM prior's factor from the increment domain, or ``None``
        for the BM kernel (whose prior is never factored)."""
        if isinstance(self.kernel, FBMKernel):
            return self.kernel.prior_cholesky(x, per_lane=per_lane)
        return None

    def _cv_laplace_pieces(self, y):
        """The cv Laplace ingredients: the latent from inverting ``scale(f)
        = running std``, the constant mean likewise from the mean running
        std, and the clamped inverse of the exact autodiff Hessian."""
        lik = self.likelihood
        _, rs = running_std_latent_init(y)
        f = lik.latent_from_scale(rs)
        mean_const = lik.latent_from_scale(
            torch.mean(rs, dim=-1)[..., None])[..., 0]
        return f, mean_const, lik.laplace_inv_hessian(y, f)

    def _init_tridiag(self, train_x, y):
        if self.likelihood.param == "cv":
            f, mean_const, inv_hess = self._cv_laplace_pieces(y)
        else:
            f, rs = running_std_latent_init(y)
            mean_const = torch.log(torch.mean(rs, dim=-1))
            inv_hess = exp_laplace_inv_hessian(y, f)
        vol = self.kernel.vol()[..., 0]
        a_diag, a_off, _ = min_precision(train_x, self._KL_JITTER / vol)
        q_diag = a_diag / vol[..., None] + inv_hess
        q_off = a_off / vol[..., None]
        d, e = bidiag_chol_from_tridiag(q_diag, q_off)
        return self._set(mean_const, f, q_log_d=torch.log(d), q_e=e)

    def _var_state(self):
        return VariationalState(self.variational_mean,
                                self.chol_variational_covar)

    def _ell(self, y, mean, var):
        return self.likelihood.expected_log_prob(
            y, mean, var, num_locs=self.num_locs, method=self.ell_method)

    def _takes_g1(self, train_x, y) -> bool:
        """Whether :meth:`elbo` runs kernel G1: the tridiagonal family, the
        BM kernel and the closed-form exp term, on the card
        (:func:`~volt_tpu_torch.native.on_card`; G1's wrapper raises on
        what it does not take)."""
        return (self.q == "tridiag" and isinstance(self.kernel, BMKernel)
                and self.likelihood.param == "exp"
                and self.ell_method in (None, "analytic")
                and native.on_card(y))

    def elbo(self, train_x, y):
        """Per-asset ELBO at inducing == train == query points, ``(...)``;
        with the BM kernel both families' KLs are the prior's closed forms,
        with the FBM kernel the dense KL against its increment-domain
        factor.  The tridiagonal family's, with the BM kernel and the
        closed-form exp term, is kernel G1 on the card (one launch for the
        ELBO and its gradient) and the plain composition on the CPU."""
        n = y.shape[-1]
        m = self.variational_mean
        if self._takes_g1(train_x, y):
            return tridiag_elbo(train_x, y, m, self.q_log_d, self.q_e,
                                self.mean.constant, self.kernel.vol())
        prior_mean = self.mean(train_x)
        if isinstance(self.kernel, FBMKernel):
            return elbo_at_inducing(self._var_state(), prior_mean, None, y,
                                    self._ell,
                                    chol_p=self._prior_chol(train_x))
        if self.q == "tridiag":
            d = torch.exp(self.q_log_d)
            marg_var, _ = takahashi_band(d, self.q_e)
            kl = tridiag_q_kl_bm_prior(train_x, self.kernel.vol(), m, d,
                                       self.q_e, prior_mean,
                                       jitter=self._KL_JITTER)
        else:
            chol_q = torch.tril(self.chol_variational_covar)
            marg_var = torch.sum(chol_q * chol_q, dim=-1)
            kl = bm_kl_against_prior(train_x, self.kernel.vol(), m, chol_q,
                                     prior_mean)
        return torch.mean(self._ell(y, m, marg_var), dim=-1) - kl / n

    @torch.no_grad()
    def init_sparse(self, train_x, inducing_x, y, generator=None,
                    likelihood_params=None):
        """The sparse (inducing-point) init for long series: the Laplace
        init on the ``m`` inducing points, the latent from the running std
        at the train points nearest them (``searchsorted``); the plain
        Laplace covariance (no x10 inflation) and the plain diagonal exp
        curvature.  ``generator`` and ``likelihood_params`` as in
        :meth:`init`."""
        self._start(y, generator, likelihood_params)
        lik = self.likelihood
        chol_kuu = self._prior_chol(inducing_x)
        kuu = self.kernel(inducing_x) if chol_kuu is None else None
        f_exp, rs = running_std_latent_init(y)
        n = train_x.shape[-1]
        take = torch.clamp(torch.searchsorted(train_x, inducing_x), 0, n - 1)
        if lik.param == "cv":
            f_m = lik.latent_from_scale(rs)[..., take]
            inv_hess = lik.laplace_inv_hessian(y[..., take], f_m)
            mean_const = lik.latent_from_scale(
                torch.mean(rs, dim=-1)[..., None])[..., 0]
        else:
            f_m = f_exp[..., take]
            inv_hess = None  # the exp form inside laplace_initialize
            mean_const = torch.log(torch.mean(rs, dim=-1))
        state, _ = laplace_initialize(kuu, y[..., take], f=f_m,
                                      root_scale=1.0, inv_hess=inv_hess,
                                      chol_kuu=chol_kuu, exp_hessian="diag")
        return self._set(mean_const, state.variational_mean,
                         chol_variational_covar=state.chol_variational_covar)

    def elbo_sparse(self, train_x, inducing_x, y):
        """The SVGP ELBO: the expected log-likelihood of the unwhitened
        predictive marginals at the ``n`` train points, less the KL over
        the ``m`` inducing points, per datum."""
        chol_kuu = self._prior_chol(inducing_x)
        mean, var = variational_predict(
            self._var_state(), self.mean(inducing_x),
            self.kernel(inducing_x), self.kernel(inducing_x, train_x),
            self.mean(train_x), kxx_diag=self.kernel(train_x, diag=True),
            chol_kuu=chol_kuu)
        ell = self._ell(y, mean, torch.clamp(var, min=1e-8))
        chol_q = torch.tril(self.chol_variational_covar)
        if chol_kuu is None:
            kl = bm_kl_against_prior(inducing_x, self.kernel.vol(),
                                     self.variational_mean, chol_q,
                                     self.mean(inducing_x))
        else:
            kl = mvn_kl(self.variational_mean, chol_q, self.mean(inducing_x),
                        chol_kuu)
        return torch.mean(ell, dim=-1) - kl / y.shape[-1]

    def latent_marginals(self, train_x=None, test_x=None):
        """``(mean, var)`` of the latent: at the train points ``q`` itself;
        at ``test_x`` the unwhitened predictive from ``train_x``."""
        m = self.variational_mean
        if self.q == "tridiag":
            d = torch.exp(self.q_log_d)
            if test_x is None:
                return m, takahashi_band(d, self.q_e)[0]
            return self._predict_tridiag(d, self.q_e, m, train_x, test_x)
        if test_x is None:
            chol_q = torch.tril(self.chol_variational_covar)
            return m, torch.sum(chol_q * chol_q, dim=-1)
        return variational_predict(
            self._var_state(), self.mean(train_x), self.kernel(train_x),
            self.kernel(train_x, test_x), self.mean(test_x),
            kxx_diag=self.kernel(test_x, diag=True),
            chol_kuu=self._prior_chol(train_x))

    def _predict_tridiag(self, d, e, m, train_x, test_x):
        """The unwhitened predictive with the tridiagonal q: the algebra of
        ``variational_predict``, ``diag(B^T S B)`` as ``||L^{-1} b_j||^2``
        per column (one bidiagonal solve of each)."""
        kuu = self.kernel(train_x)
        kux = self.kernel(train_x, test_x)
        kuu_inv_kux = cholesky_solve(psd_safe_cholesky(kuu), kux)
        diff = (m - self.mean(train_x))[..., None]
        mean = (kuu_inv_kux.mT @ diff)[..., 0] + self.mean(test_x)
        data_term = torch.sum(kux * kuu_inv_kux, dim=-2)
        bt = kuu_inv_kux.mT  # (..., n_x, n_u)
        d_b = d[..., None, :].expand(bt.shape)
        e_b = e[..., None, :].expand(*bt.shape[:-1], bt.shape[-1] - 1)
        half = bidiag_solve_lower(d_b, e_b, bt)
        s_term = torch.sum(half * half, dim=-1)
        return mean, self.kernel(test_x, diag=True) - data_term + s_term

    def predicted_scale(self, train_x=None, test_x=None, mc_samples=None,
                        generator=None, noise=None):
        """The stage output ``E_f[scale(f)]`` at the train points, or at
        ``test_x`` from ``train_x`` (Gauss–Hermite, or ``mc_samples``
        Monte-Carlo draws).  The predictive variance, a float32
        cancellation ``kxx - data + s``, is clamped at 1e-8."""
        mean, var = self.latent_marginals(train_x, test_x)
        return self.likelihood.expected_scale(
            mean, torch.clamp(var, min=1e-8), mc_samples, generator, noise)

"""The FBM cell's GPCV and vol GP (the port's ``models/gpcv.py`` and
``models/bmgp.py``, trimmed to their FBM branches).

``GPCVModel``: a variational GP with the FBM kernel, a constant prior
mean and the exp volatility likelihood, inducing points at the training
inputs, in the dense family ``q = N(m, C C^T)`` (a raw root ``(..., n,
n)``); its ELBO takes the dense KL against the FBM prior's factor from the
increment domain, its init the reference's Laplace start without the x10
root inflation.  ``BMGP``: the exact GP over log vol with the FBM kernel
and the drift mean ``-0.5 H^2 t``: the dense MLL through the factor of
``K + noise I`` and the dense posterior sampler, each factor's jitter
ladder per asset.  Both take the ladders' first rung ``jitter``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from reference.vplain.gp.variational import running_std_latent_init
from reference.vplain.likelihoods import (GaussianLikelihood,
                                          VolatilityGaussianLikelihood)
from reference.vplain.means import ConstantMean
from reference.vplain.ops.quadrature import DEFAULT_NUM_LOCS

from .fbm import FBMKernel
from .mvn import (elbo_at_inducing, laplace_initialize, mvn_log_prob_chol,
                  posterior, sample_mvn)


class GPCVModel(nn.Module):
    """Parameters (after :meth:`init`), each with a leading batch shape:
    ``kernel.raw_vol``, ``mean.constant``, ``variational_mean`` ``(...,
    n)`` and ``chol_variational_covar`` ``(..., n, n)``."""

    def __init__(self, jitter: float, num_locs: int = DEFAULT_NUM_LOCS):
        super().__init__()
        self.jitter, self.num_locs = jitter, num_locs
        self.kernel = FBMKernel()
        self.mean = ConstantMean()
        self.likelihood = VolatilityGaussianLikelihood(param="exp")

    @torch.no_grad()
    def init(self, train_x, y, per_lane: bool = False):
        batch = y.shape[:-1]
        self.kernel.init(batch, y.dtype, y.device)
        self.likelihood.init(batch, y.dtype, y.device)
        f, rs = running_std_latent_init(y)
        mean_const = torch.log(torch.mean(rs, dim=-1))
        chol_kuu = self.kernel.prior_cholesky(train_x, self.jitter,
                                              per_lane=per_lane)
        # no x10 inflation against the FBM prior
        root = laplace_initialize(chol_kuu, y, f, 1.0, self.jitter,
                                  per_lane=per_lane)
        self.mean.constant = nn.Parameter(mean_const[..., None])
        self.variational_mean = nn.Parameter(f)
        self.chol_variational_covar = nn.Parameter(root)
        return self

    def elbo(self, train_x, y):
        """Per-asset ELBO, ``(...)``."""
        return elbo_at_inducing(
            self.variational_mean, self.chol_variational_covar,
            self.mean(train_x), y,
            lambda y, m, v: self.likelihood.expected_log_prob(
                y, m, v, num_locs=self.num_locs),
            self.kernel.prior_cholesky(train_x, self.jitter, per_lane=True))

    def predicted_scale(self):
        """The stage output ``E_f[scale(f)]`` at the train points (by
        Gauss–Hermite); the variance clamped at 1e-8."""
        chol_q = torch.tril(self.chol_variational_covar)
        var = torch.sum(chol_q * chol_q, dim=-1)
        return self.likelihood.expected_scale(self.variational_mean,
                                              torch.clamp(var, min=1e-8))


@dataclasses.dataclass
class BMGPState:
    """Fitted vol GP: the module plus the conditioning data ``train_x
    (n,)``, ``train_y (..., n)`` (log vol)."""

    module: "BMGP"
    train_x: torch.Tensor
    train_y: torch.Tensor

    def sample(self, test_x, sample_shape=(), generator=None, noise=None):
        return self.module.sample(self.train_x, self.train_y, test_x, noise)


class BMGP(nn.Module):
    """Parameters (after :meth:`init`): ``kernel.raw_vol`` (the Hurst
    parameter) and ``likelihood.raw_noise``, each ``(*batch, 1)``."""

    def __init__(self, jitter: float):
        super().__init__()
        self.jitter = jitter
        self.kernel = FBMKernel()
        self.likelihood = GaussianLikelihood()

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        self.kernel.init(batch_shape, dtype, device)
        self.likelihood.init(batch_shape, dtype, device)
        return self

    def mean(self, x):
        """Analytic drift ``-0.5 H^2 t``."""
        return -0.5 * self.kernel.vol() ** 2.0 * x

    def _noise_chol(self, x):
        return self.kernel.noise_cholesky(x, self.likelihood.noise(),
                                          self.jitter, per_lane=True)

    def mll(self, x, y):
        """The dense exact MLL / n through the factor of ``K + noise I``."""
        return mvn_log_prob_chol(y, self.mean(x),
                                 self._noise_chol(x)) / y.shape[-1]

    def sample(self, train_x, train_y, test_x, noise):
        """Joint posterior samples ``(S, ..., H)`` of the latent log vol for
        the standard normals ``noise`` of that shape."""
        mean, cov = posterior(self.kernel(train_x, test_x),
                              self.kernel(test_x),
                              train_y - self.mean(train_x),
                              self._noise_chol(train_x))
        return sample_mvn(mean + self.mean(test_x), cov, noise, self.jitter,
                          per_lane=True)

    def fit_state(self, train_x, train_y) -> BMGPState:
        return BMGPState(module=self, train_x=train_x, train_y=train_y)

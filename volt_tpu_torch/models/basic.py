"""The baseline exact GPs (port of :mod:`volt_tpu.models.basic`): a
scaled-Matérn GP and a spectral-mixture GP over log prices, with any of
the means (the reference's ``models/BasicGPModels.py`` and the mean
overrides of ``train_utils.TrainBasicModel``).

The MLL and the joint posterior are the dense exact-GP algebra of
:mod:`..gp.exact`; a history (Magpie) mean takes its train values from the
EWMA filter (kernel K1 on CUDA).  Magpie-mean baselines forecast through
:func:`volt_tpu_torch.rollouts.nonvol_rollouts`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..gp.exact import exact_mll, posterior
from ..kernels import MaternKernel, ScaleKernel, SpectralMixtureKernel
from ..likelihoods import GaussianLikelihood
from ..means import ConstantMean
from ..ops.mvn import sample_mvn

__all__ = ["BasicGP", "BasicGPState", "MaternGP", "SMGP"]


@dataclasses.dataclass
class BasicGPState:
    """A fitted baseline: the module (holding its parameters), its grid
    ``train_x (n,)`` and the log prices ``train_y (n,)`` it was fitted to."""

    module: "BasicGP"
    train_x: torch.Tensor
    train_y: torch.Tensor

    def posterior(self, test_x):
        return self.module.posterior(self.train_x, self.train_y, test_x)

    def sample(self, generator, test_x, sample_shape=(), noise=None):
        """Joint posterior samples ``(*sample_shape, H)``; ``noise``
        optionally gives their standard normals."""
        with torch.no_grad():
            mean, cov = self.posterior(test_x)
            return sample_mvn(mean, cov, sample_shape, generator=generator,
                              noise=noise)


class BasicGP(nn.Module):
    """Exact GP with a pluggable kernel and mean and a Gaussian likelihood;
    parameters under ``kernel``, ``mean`` and ``likelihood`` (the JAX
    parameter tree's keys)."""

    def __init__(self, kernel: nn.Module, mean: nn.Module | None = None):
        super().__init__()
        self.kernel = kernel
        self.mean = mean if mean is not None else ConstantMean()
        self.likelihood = GaussianLikelihood()

    def init(self, dtype=torch.float32, device=None, generator=None):
        """The kernel's and mean's initial values (the spectral mixture's
        and a linear mean's drawn from ``generator``), the noise at raw 0."""
        self.kernel.init((), dtype, device, generator)
        self.mean.init((), dtype, device, generator)
        self.likelihood.init((), dtype, device)
        return self

    def train_mean(self, x, y):
        """Mean over the train grid (a Magpie mean filters ``y``)."""
        if self.mean.is_history_dependent:
            return self.mean.train_values(y)
        return self.mean(x)

    def mll(self, x, y):
        """Exact MLL / n of the log prices ``y`` on ``x``."""
        return exact_mll(y, self.train_mean(x, y), self.kernel(x),
                         self.likelihood.noise())

    def posterior(self, train_x, train_y, test_x):
        """``(mean (H,), cov (H, H))`` of the latent at ``test_x``."""
        if self.mean.is_history_dependent:
            raise ValueError(
                "joint posteriors need a deterministic mean; Magpie-mean "
                "baselines forecast through nonvol_rollouts (reference "
                "BasicWind.py:70-76)")
        k_tr = self.kernel(train_x)
        k_tr_te = self.kernel(train_x, test_x)
        k_te = self.kernel(test_x)
        resid = train_y - self.mean(train_x)
        mean, cov = posterior(k_tr, k_tr_te, k_te, resid,
                              self.likelihood.noise())
        return mean + self.mean(test_x), cov

    def fit_state(self, train_x, train_y) -> BasicGPState:
        return BasicGPState(module=self, train_x=train_x, train_y=train_y)


def MaternGP(mean=None) -> BasicGP:
    """Scaled Matérn baseline (reference ``BasicGPModels.py:7-16``)."""
    return BasicGP(ScaleKernel(MaternKernel()), mean)


def SMGP(num_mixtures: int = 10, mean=None) -> BasicGP:
    """Spectral-mixture baseline (reference ``BasicGPModels.py:18-27``)."""
    return BasicGP(SpectralMixtureKernel(num_mixtures=num_mixtures), mean)

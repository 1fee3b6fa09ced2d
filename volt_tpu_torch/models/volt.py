"""The Volt price model (port of :mod:`volt_tpu.models.volt`): an exact GP
whose covariance is the running integral of the squared vol path,
parameterised by its mean module.  The fitted state carries the frozen vol
path and the nested vol GP; the forecast lives in
:mod:`volt_tpu_torch.rollouts`.

The dense MLL builds the covariance (kernel K2 on CUDA) and factors it;
the Kalman MLL (kernel S1) is the same function in O(n), which the data
fit trains on.  The covariance is fixed while the data model fits (the
vol path is frozen), so the same MLL can also be taken against one
eigendecomposition of it, O(n^2) a step (:meth:`VoltGP.make_cov_cache`
and :meth:`VoltGP.mll_fixed_cov`): no fit uses that form; it is kept as
an independent check of the Kalman values."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..gp.exact import exact_mll, exact_mll_fixed_cov, make_fixed_cov_cache
from ..kernels import VolatilityKernel
from ..likelihoods import GaussianLikelihood
from ..means import (ConstantMean, DEWMAMean, EWMAMean, LinearMean,
                     LogLinearMean, MeanRevertingEMAMean, TEWMAMean)
from ..ops.tridiag import brownian_noise_mll_kalman
from .bmgp import BMGPState

__all__ = ["VoltGP", "VoltState", "make_mean"]


def make_mean(name: str, k: int = 25, theta: float = 0.5):
    """Mean selection by name (reference ``train_utils.py:196-220``)."""
    name = name.lower()
    if name == "ewma":
        return EWMAMean(k)
    if name == "dewma":
        return DEWMAMean(k)
    if name == "tewma":
        return TEWMAMean(k)
    if name == "meanrevert":
        return MeanRevertingEMAMean(k, theta)
    if name == "constant":
        return ConstantMean()
    if name == "loglinear":
        return LogLinearMean(1)
    if name == "linear":
        return LinearMean(1)
    raise ValueError(f"unknown mean function {name!r}")


@dataclasses.dataclass
class VoltState:
    """A fitted Volt model: everything a forecast needs."""

    module: "VoltGP"
    train_x: torch.Tensor       # (n,) uniform time grid
    train_y: torch.Tensor       # (..., n) log prices
    log_vol_path: torch.Tensor  # (..., n)
    vol_state: Optional[BMGPState] = None

    def update_vol_path(self, vol_path):
        """Reference ``UpdateVolPath``: the same state on a new vol path."""
        return dataclasses.replace(self, log_vol_path=torch.log(vol_path))

    def train_mean(self):
        return self.module.train_mean(self.train_x, self.train_y)

    def mll(self):
        """Dense exact MLL / n of the price GP."""
        return self.module.mll(self.train_x, self.train_y,
                               torch.exp(self.log_vol_path))

    def mll_kalman(self):
        """The same MLL by the Kalman filter (kernel S1 on CUDA)."""
        return self.module.mll_kalman(self.train_x, self.train_y,
                                      torch.exp(self.log_vol_path))

    def vol_mll(self):
        """Dense exact MLL of the nested vol GP on its log-vol path
        (reference ``VolMLL``)."""
        if self.vol_state is None:
            raise ValueError("no fitted vol GP attached")
        return self.vol_state.mll()


class VoltGP(nn.Module):
    """Parameters (after :meth:`init`): ``likelihood.raw_noise`` and the
    mean's (e.g. ``mean.constant``, ``mean.weights``/``mean.bias``)."""

    def __init__(self, mean=None, integral_rule: str = "reference"):
        super().__init__()
        self.mean = mean if mean is not None else LinearMean(1)
        self.kernel = VolatilityKernel(integral_rule=integral_rule)
        self.likelihood = GaussianLikelihood()

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        # raw_noise 1e-5: the reference's noise pin (noise ~0.6932)
        self.mean.init(batch_shape, dtype, device, generator)
        self.likelihood.init(batch_shape, dtype, device, raw_noise_init=1e-5)
        return self

    def train_mean(self, x, y):
        """Mean over the train grid."""
        if self.mean.is_history_dependent:
            return self.mean.train_values(y)
        return self.mean(x)

    def train_cov(self, x, vol_path):
        return self.kernel(x, vol_path)

    def mll(self, x, y, vol_path):
        noise = self.likelihood.noise()
        return exact_mll(y, self.train_mean(x, y), self.train_cov(x, vol_path),
                         noise)

    def mll_kalman(self, x, y, vol_path):
        noise = self.likelihood.noise()[..., 0]
        return brownian_noise_mll_kalman(self.kernel.integral(x, vol_path),
                                         noise, y - self.train_mean(x, y))

    def make_cov_cache(self, x, vol_path):
        """The eigendecomposition of the train covariance (kernel K2 on
        CUDA, then ``eigh``) for :meth:`mll_fixed_cov`."""
        return make_fixed_cov_cache(self.train_cov(x, vol_path))

    def mll_fixed_cov(self, cache, x, y):
        """The MLL against a pre-factorised covariance: the Kalman MLL's
        independent O(n^2)-a-step twin (see the module docstring)."""
        return exact_mll_fixed_cov(y, self.train_mean(x, y), cache,
                                   self.likelihood.noise())

    def fit_state(self, train_x, train_y, vol_path,
                  vol_state: Optional[BMGPState] = None) -> VoltState:
        return VoltState(module=self, train_x=train_x, train_y=train_y,
                         log_vol_path=torch.log(vol_path), vol_state=vol_state)

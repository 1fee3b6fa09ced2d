"""The Volt price model (port of the slice's part of
:mod:`volt_tpu.models.volt`): an exact GP whose covariance is the running
integral of the squared vol path, parameterised by its mean module.  The
fitted state carries the frozen vol path and the nested vol GP; the
forecast lives in :mod:`volt_tpu_torch.rollouts`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..kernels import VolatilityKernel
from ..likelihoods import GaussianLikelihood
from ..means import ConstantMean, EWMAMean
from .bmgp import BMGPState

__all__ = ["VoltGP", "VoltState", "make_mean"]

_NOT_PORTED_MEANS = ("dewma", "tewma", "meanrevert", "loglinear", "linear")


def make_mean(name: str, k: int = 25):
    """Mean selection by name (the slice has ``ewma`` and ``constant``)."""
    name = name.lower()
    if name == "ewma":
        return EWMAMean(k)
    if name == "constant":
        return ConstantMean()
    if name in _NOT_PORTED_MEANS:
        raise NotImplementedError(f"mean function {name!r} is not ported yet "
                                  "(ROADMAP slice B, item 10)")
    raise ValueError(f"unknown mean function {name!r}")


@dataclasses.dataclass
class VoltState:
    """A fitted Volt model: everything a forecast needs."""

    module: "VoltGP"
    train_x: torch.Tensor       # (n,) uniform time grid
    train_y: torch.Tensor       # (..., n) log prices
    log_vol_path: torch.Tensor  # (..., n)
    vol_state: Optional[BMGPState] = None


class VoltGP(nn.Module):
    """Parameters (after :meth:`init`): ``likelihood.raw_noise`` and the
    mean's (``mean.constant`` for the constant mean)."""

    def __init__(self, mean, integral_rule: str = "reference"):
        super().__init__()
        self.mean = mean
        self.kernel = VolatilityKernel(integral_rule=integral_rule)
        self.likelihood = GaussianLikelihood()

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        # raw_noise 1e-5: the reference's noise pin (noise ~0.6932)
        self.mean.init(batch_shape, dtype, device)
        self.likelihood.init(batch_shape, dtype, device, raw_noise_init=1e-5)
        return self

    def train_mean(self, x, y):
        """Mean over the train grid."""
        if self.mean.is_history_dependent:
            return self.mean.train_values(y)
        return self.mean(x)

    def fit_state(self, train_x, train_y, vol_path,
                  vol_state: Optional[BMGPState] = None) -> VoltState:
        return VoltState(module=self, train_x=train_x, train_y=train_y,
                         log_vol_path=torch.log(vol_path), vol_state=vol_state)

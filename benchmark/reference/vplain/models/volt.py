"""The Volt price model (the port's ``models/volt.py``, trimmed to what
the cells run): an exact GP whose covariance is the running integral of
the squared vol path, with the EWMA mean.  The fitted state carries the
frozen vol path and the nested vol GP; the forecast lives in
:mod:`..rollouts`.  The data fit trains on the Kalman MLL
(:mod:`..train`)."""

from __future__ import annotations

import dataclasses
from typing import Optional
import torch
from torch import nn
from ..kernels import VolatilityKernel
from ..likelihoods import GaussianLikelihood
from ..means import EWMAMean
from .bmgp import BMGPState


def make_mean(name: str, k: int = 25, theta: float = 0.5):
    """The mean by name: the cells run ``"ewma"`` alone."""
    if name.lower() != "ewma":
        raise ValueError(f"the reference has the EWMA mean only, not "
                         f"{name!r}")
    return EWMAMean(k)


@dataclasses.dataclass
class VoltState:
    """A fitted Volt model: everything a forecast needs."""

    module: "VoltGP"
    train_x: torch.Tensor       # (n,) uniform time grid
    train_y: torch.Tensor       # (..., n) log prices
    log_vol_path: torch.Tensor  # (..., n)
    vol_state: Optional[BMGPState] = None


class VoltGP(nn.Module):
    """Parameters (after :meth:`init`): ``likelihood.raw_noise`` (the EWMA
    mean has none)."""

    def __init__(self, mean, integral_rule: str = "reference"):
        super().__init__()
        self.mean = mean
        self.kernel = VolatilityKernel(integral_rule=integral_rule)
        self.likelihood = GaussianLikelihood()

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        # raw_noise 1e-5: the reference's noise pin (noise ~0.6932)
        self.mean.init(batch_shape, dtype, device, generator)
        self.likelihood.init(batch_shape, dtype, device, raw_noise_init=1e-5)
        return self

    def train_mean(self, x, y):
        """Mean over the train grid: the EWMA of the log prices."""
        return self.mean.train_values(y)

    def fit_state(self, train_x, train_y, vol_path,
                  vol_state: Optional[BMGPState] = None) -> VoltState:
        return VoltState(module=self, train_x=train_x, train_y=train_y,
                         log_vol_path=torch.log(vol_path), vol_state=vol_state)

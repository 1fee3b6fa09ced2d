"""Likelihoods of the slice (port of :mod:`volt_tpu.likelihoods.likelihoods`)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.constraints import GreaterThan
from ..ops.quadrature import expected_value

__all__ = ["GaussianLikelihood", "VolatilityGaussianLikelihood"]

_LOG_2PI = math.log(2.0 * math.pi)


class GaussianLikelihood(nn.Module):
    """Homoskedastic Gaussian noise, ``noise = softplus(raw_noise) + 1e-4``;
    parameter ``raw_noise`` ``(*batch, 1)``."""

    def __init__(self, noise_constraint=None):
        super().__init__()
        self.constraint = noise_constraint or GreaterThan(1e-4)

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             raw_noise_init: float = 0.0):
        self.raw_noise = nn.Parameter(torch.full(
            (*batch_shape, 1), raw_noise_init, dtype=dtype, device=device))
        return self

    def noise(self):
        return self.constraint.forward(self.raw_noise)


class VolatilityGaussianLikelihood(nn.Module):
    """``y ~ N(0, scale(f)^2)`` with ``scale = max(exp(min(f, 80)), 1e-3)``
    (the ``"exp"`` parameterisation; no parameters)."""

    def __init__(self, param: str = "exp"):
        super().__init__()
        if param == "cv":
            raise NotImplementedError(
                "VolatilityGaussianLikelihood(param='cv') is not ported yet "
                "(ROADMAP slice B, item 11: GPCV families)")
        if param != "exp":
            raise ValueError("param must be 'cv' or 'exp'")
        self.param = param

    def scale(self, f):
        """Observation std; ``f`` capped at 80 so GH tail nodes of a wide
        ``q`` cannot overflow ``exp``."""
        return torch.clamp(torch.exp(torch.clamp(f, max=80.0)), min=1e-3)

    def expected_log_prob(self, y, mean, var):
        """``E_{f ~ N(mean, var)}[log N(y; 0, scale(f)^2)]`` in closed form
        (lognormal moments): ``-y^2/2 e^{-2 mean + 2 var} - mean -
        log(2 pi)/2``, the exponent capped at 80."""
        e = torch.exp(torch.clamp(-2.0 * mean + 2.0 * var, max=80.0))
        return -0.5 * y * y * e - mean - 0.5 * _LOG_2PI

    def expected_scale(self, mean, var):
        """Posterior-mean predicted scale ``E_f[scale(f)]`` by 75-node
        Gauss–Hermite."""
        return expected_value(self.scale, mean, var)

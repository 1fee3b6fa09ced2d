"""Likelihoods of the slice (port of :mod:`volt_tpu.likelihoods.likelihoods`)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.constraints import GreaterThan
from ..ops.gh_ell import exp_log_prob, exp_scale, gh_expected_log_prob
from ..ops.quadrature import DEFAULT_NUM_LOCS, expected_value

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
        return exp_scale(f)

    def log_prob(self, y, f):
        """``log N(y; 0, scale(f)^2)`` elementwise."""
        return exp_log_prob(y, f)

    def expected_log_prob(self, y, mean, var,
                          num_locs: int = DEFAULT_NUM_LOCS,
                          method: str | None = None):
        """``E_{f ~ N(mean, var)}[log p(y | f)]``.

        ``method=None`` or ``"analytic"``: the closed form (lognormal
        moments) ``-y^2/2 e^{-2 mean + 2 var} - mean - log(2 pi)/2``, the
        exponent capped at 80.  ``"quadrature"``: the reference's
        ``num_locs``-node Gauss–Hermite term (kernel K3 on CUDA tensors).
        The two differ below float32 resolution outside the clamp regions
        (``scale >= 1e-3``, ``f <= 80``)."""
        if method is None:
            method = "analytic"
        if method == "analytic":
            e = torch.exp(torch.clamp(-2.0 * mean + 2.0 * var, max=80.0))
            return -0.5 * y * y * e - mean - 0.5 * _LOG_2PI
        if method == "quadrature":
            return gh_expected_log_prob(y, mean, var, num_locs)
        raise ValueError("method must be None, 'analytic' or 'quadrature'")

    def expected_scale(self, mean, var, mc_samples: int | None = None,
                       generator=None, noise=None):
        """Posterior-mean predicted scale ``E_f[scale(f)]``: 75-node
        Gauss–Hermite, or with ``mc_samples`` the reference's Monte-Carlo
        estimate from ``(mc_samples, *mean.shape)`` standard normals
        (``noise``, else drawn from ``generator``)."""
        if mc_samples is None:
            return expected_value(self.scale, mean, var)
        if noise is None:
            noise = torch.randn(mc_samples, *mean.shape, dtype=mean.dtype,
                                device=mean.device, generator=generator)
        return torch.mean(self.scale(noise * torch.sqrt(var) + mean), dim=0)

"""Likelihoods (the port's ``likelihoods/likelihoods.py``, trimmed to
what the cells run)."""

from __future__ import annotations

import math
import torch
from torch import nn
from ..ops.constraints import GreaterThan
from ..ops.quadrature import DEFAULT_NUM_LOCS, expected_value

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

    def init_with_noise(self, noise: float, batch_shape=(),
                        dtype=torch.float32, device=None):
        """Init from a transformed noise value (the working setter)."""
        raw = self.constraint.inverse(torch.tensor(noise, dtype=dtype))
        return self.init(batch_shape, dtype, device, raw.item())

    def noise(self):
        return self.constraint.forward(self.raw_noise)


class MultitaskGaussianLikelihood(GaussianLikelihood):
    """One noise shared by ``num_tasks`` outputs (the reference sets it to
    1e-3 through the working setter, ``models/VoltronGP.py:47-48``)."""

    def __init__(self, num_tasks: int, noise_constraint=None):
        super().__init__(noise_constraint)
        self.num_tasks = num_tasks


class VolatilityGaussianLikelihood(nn.Module):
    """Heteroscedastic volatility observations ``y ~ N(0, scale(f)^2)``
    with ``scale = max(exp(min(f, 80)), 1e-3)`` (``param="exp"``, no
    parameters).  ``f`` carries a trailing data axis ``(*batch, n)``."""

    def __init__(self, param: str = "exp"):
        super().__init__()
        if param != "exp":
            raise ValueError("the reference has param='exp' only")
        self.param = param

    def init(self, batch_shape=None, dtype=torch.float32, device=None,
             generator=None):
        return self

    def scale(self, f):
        """Observation std; the cap at 80 keeps Gauss–Hermite tail nodes
        of a wide ``q`` from overflowing ``exp``.  At either kink the
        derivative is the clamped side's (0); NaN passes through."""
        ef = torch.exp(torch.where(f >= 80.0, 80.0, f))
        return torch.where(ef <= 1e-3, 1e-3, ef)

    def expected_log_prob(self, y, mean, var,
                          num_locs: int = DEFAULT_NUM_LOCS):
        """``E_{f ~ N(mean, var)}[log p(y | f)]`` in closed form: the
        lognormal moments ``-y^2/2 e^{-2 mean + 2 var} - mean - log(2
        pi)/2``, the exponent capped at 80."""
        e = torch.exp(torch.clamp(-2.0 * mean + 2.0 * var, max=80.0))
        return -0.5 * y * y * e - mean - 0.5 * _LOG_2PI

    def expected_scale(self, mean, var):
        """Posterior-mean predicted scale ``E_f[scale(f)]`` by 75-node
        Gauss–Hermite."""
        return expected_value(self.scale, mean, var)

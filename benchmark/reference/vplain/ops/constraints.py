"""Constrained-parameter bijectors (port of :mod:`volt_tpu.ops.constraints`).

Parameters are stored unconstrained ("raw") and mapped to their
constrained value at use time, with the same transforms as the JAX
package so raw values are exchangeable between the two.
"""

from __future__ import annotations

import dataclasses
import torch
import torch.nn.functional as F


def _tensor(x):
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float32)


def softplus(x):
    """Numerically stable ``log(1 + exp(x))``."""
    return F.softplus(x)


def inv_softplus(y):
    """Inverse of :func:`softplus`: ``y + log(-expm1(-y))``."""
    y = _tensor(y)
    return y + torch.log(-torch.expm1(-y))


def _logit(p):
    p = _tensor(p)
    return torch.log(p) - torch.log1p(-p)


@dataclasses.dataclass(frozen=True)
class Interval:
    """``value = lower + (upper - lower) * sigmoid(raw)``."""

    lower: float = 0.0
    upper: float = 1.0

    def forward(self, raw):
        return self.lower + (self.upper - self.lower) * torch.sigmoid(raw)

    def inverse(self, value):
        return _logit((_tensor(value) - self.lower) / (self.upper - self.lower))


@dataclasses.dataclass(frozen=True)
class Positive:
    """``value = softplus(raw)``."""

    def forward(self, raw):
        return softplus(raw)

@dataclasses.dataclass(frozen=True)
class GreaterThan:
    """``value = softplus(raw) + lower_bound`` (the Gaussian noise
    transform; a raw init of ``1e-5`` gives a noise of ``~0.6932``)."""

    lower_bound: float = 1e-4

    def forward(self, raw):
        return softplus(raw) + self.lower_bound

    def inverse(self, value):
        return inv_softplus(_tensor(value) - self.lower_bound)

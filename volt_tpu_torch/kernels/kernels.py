"""Covariance functions of the slice (port of :mod:`volt_tpu.kernels.kernels`).

Kernels with learnable state are ``nn.Module``s whose parameters carry the
JAX leaf names with a leading batch (asset) shape; :meth:`init` creates
them.  Time inputs are 1-D grids ``(n,)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.constraints import Interval
from ..ops.volint import min_index_covariance, vol_integral
from ..ops.volt_cov import volt_covariance

__all__ = ["BMKernel", "VolatilityKernel"]


class BMKernel(nn.Module):
    """Brownian-motion covariance ``K(s, t) = vol * min(s, t)``, ``vol`` in
    ``Interval(0, 1)`` (sigmoid), default 0.2; parameter ``raw_vol``
    ``(*batch, 1)``.  Note the covariance scales with ``vol``, not
    ``vol**2``."""

    def __init__(self, vol: float = 0.2,
                 vol_constraint: Optional[Interval] = None):
        super().__init__()
        self.constraint = vol_constraint or Interval(0.0, 1.0)
        self._init_vol = vol

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        raw = self.constraint.inverse(torch.tensor(self._init_vol, dtype=dtype))
        self.raw_vol = nn.Parameter(torch.full((*batch_shape, 1), raw.item(),
                                               dtype=dtype, device=device))
        return self

    def vol(self):
        return self.constraint.forward(self.raw_vol)

    def forward(self, x1, x2=None, diag: bool = False):
        """``(*batch, n1, n2)`` covariance, or its diagonal with ``diag``."""
        x2 = x1 if x2 is None else x2
        vol = self.vol()
        if diag:
            return vol * torch.minimum(x1, x2)
        cov = torch.minimum(x1[..., :, None], x2[..., None, :])
        return vol[..., None] * cov


class VolatilityKernel:
    """The Volt covariance ``K[i, j] = I[min(i, j)]`` with ``I`` the running
    integral of ``vol**2`` on the joint grid ``x`` (callers slice the
    train and test blocks).  No trainable parameters: the vol path is data,
    passed per call."""

    def __init__(self, integral_rule: str = "reference"):
        if integral_rule not in ("reference", "trapezoid"):
            raise ValueError("integral_rule must be 'reference' or "
                             "'trapezoid'")
        self.integral_rule = integral_rule

    def __call__(self, x, vol_path, diag: bool = False):
        """``(..., n, n)`` covariance, or with ``diag`` its diagonal (the
        integral).  Under the reference rule a CUDA tensor goes to kernel
        K2; the trapezoid rule and CPU tensors take the plain build."""
        if diag:
            return self.integral(x, vol_path)
        if self.integral_rule == "reference" and x.dim() == 1:
            return volt_covariance(x, vol_path)
        return min_index_covariance(self.integral(x, vol_path))

    def integral(self, x, vol_path):
        """The running integral for closed-form consumers."""
        return vol_integral(x, vol_path, self.integral_rule)

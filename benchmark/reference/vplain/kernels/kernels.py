"""Covariance functions (the port's ``kernels/kernels.py``, trimmed to
what the cells run): the BM kernel's parameter, the Volt covariance's
running integral and the multitask ``IndexKernel``.

Kernels with learnable state are ``nn.Module``s whose parameters carry a
leading batch (asset) shape; :meth:`init` creates them.
"""

from __future__ import annotations

from typing import Optional
import torch
from torch import nn
from ..ops.constraints import Interval, Positive
from ..ops.volint import vol_integral


class _ScalarParamKernel(nn.Module):
    """A kernel of one parameter ``raw_vol`` ``(*batch, 1)`` under
    ``Interval(0, 1)`` (sigmoid), default 0.2."""

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


class BMKernel(_ScalarParamKernel):
    """Brownian-motion covariance ``K(s, t) = vol * min(s, t)``, ``vol`` in
    ``Interval(0, 1)`` (sigmoid), default 0.2; parameter ``raw_vol``
    ``(*batch, 1)``.  Note the covariance scales with ``vol``, not
    ``vol**2``."""

class VolatilityKernel:
    """The Volt covariance ``K[i, j] = I[min(i, j)]`` with ``I`` the running
    integral of ``vol**2`` on the grid ``x``, of which the cells need the
    integral alone.  No trainable parameters: the vol path is data."""

    def __init__(self, integral_rule: str = "reference"):
        if integral_rule not in ("reference", "trapezoid"):
            raise ValueError("integral_rule must be 'reference' or "
                             "'trapezoid'")
        self.integral_rule = integral_rule

    def integral(self, x, vol_path):
        """The running integral for closed-form consumers."""
        return vol_integral(x, vol_path, self.integral_rule)


class IndexKernel(nn.Module):
    """Low-rank-plus-diagonal task covariance ``B = F F^T + diag(v)``, the
    multitask models' task kernel: parameters ``covar_factor`` ``F``
    ``(T, rank)`` and ``raw_var`` ``(T,)``, ``v = softplus(raw_var)``."""

    def __init__(self, num_tasks: int, rank: int = 1):
        super().__init__()
        self.num_tasks = num_tasks
        self.rank = rank
        self.constraint = Positive()

    def init(self, dtype=torch.float32, device=None, generator=None):
        """``F`` standard normal from ``generator`` (default: a CPU
        generator seeded 0), ``raw_var`` zero."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # drawn in float32, as the program draws it, then cast
        factor = torch.randn(self.num_tasks, self.rank, dtype=torch.float32,
                             generator=generator, device=generator.device)
        self.covar_factor = nn.Parameter(factor.to(device, dtype))
        self.raw_var = nn.Parameter(torch.zeros(self.num_tasks, dtype=dtype,
                                                device=device))
        return self

    def factor_and_diag(self):
        """``(F, v)`` of ``B = F F^T + diag(v)``."""
        return self.covar_factor, self.constraint.forward(self.raw_var)

    def covar_matrix(self):
        f, v = self.factor_and_diag()
        return f @ f.mT + torch.diag_embed(v)

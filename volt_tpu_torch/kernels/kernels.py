"""Covariance functions (port of :mod:`volt_tpu.kernels.kernels`): the BM
and FBM kernels, the Volt covariance and the multitask ``IndexKernel``.

Kernels with learnable state are ``nn.Module``s whose parameters carry the
JAX leaf names with a leading batch (asset) shape; :meth:`init` creates
them.  Time inputs are 1-D grids ``(n,)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.constraints import Interval, Positive
from ..ops.fbm import fbm_cholesky, fbm_noise_cholesky
from ..ops.volint import min_index_covariance, vol_integral
from ..ops.volt_cov import volt_covariance

__all__ = ["BMKernel", "FBMKernel", "VolatilityKernel", "IndexKernel"]


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

    def forward(self, x1, x2=None, diag: bool = False):
        """``(*batch, n1, n2)`` covariance, or its diagonal with ``diag``."""
        x2 = x1 if x2 is None else x2
        vol = self.vol()
        if diag:
            return vol * torch.minimum(x1, x2)
        cov = torch.minimum(x1[..., :, None], x2[..., None, :])
        return vol[..., None] * cov


class FBMKernel(_ScalarParamKernel):
    """Fractional-BM covariance ``K(s, t) = (|s|^{2H} + |t|^{2H} - |s -
    t|^{2H}) / 2`` with the Hurst parameter ``H`` stored as ``raw_vol``
    ``(*batch, 1)`` under ``Interval(0, 1)`` (default 0.2), as the BM
    kernel stores its vol; :meth:`vol` returns ``H``."""

    def forward(self, x1, x2=None, diag: bool = False):
        """``(*batch, n1, n2)`` covariance, or its diagonal with ``diag``
        (elementwise, no matrix)."""
        x2 = x1 if x2 is None else x2
        two_h = 2.0 * self.vol()  # (*batch, 1)
        if diag:
            return 0.5 * (torch.abs(x1) ** two_h + torch.abs(x2) ** two_h
                          - torch.abs(x1 - x2) ** two_h)
        two_h = two_h[..., None]
        s = torch.abs(x1[..., :, None])
        t = torch.abs(x2[..., None, :])
        d = torch.abs(x1[..., :, None] - x2[..., None, :])
        return 0.5 * (s ** two_h + t ** two_h - d ** two_h)

    def prior_cholesky(self, x, jitter=None, max_tries: int = 3,
                       per_lane: bool = False):
        """Lower Cholesky factor of ``K(x, x)`` on an increasing grid from
        0 or later, through the increment domain (:mod:`..ops.fbm`)."""
        return fbm_cholesky(x, 2.0 * self.vol(), jitter, max_tries,
                            per_lane)

    def noise_cholesky(self, x, noise, jitter=None, max_tries: int = 3,
                       per_lane: bool = False):
        """Lower Cholesky factor of ``K(x, x) + noise I`` (``noise``
        ``(*batch, 1)``), through the increment domain."""
        return fbm_noise_cholesky(x, 2.0 * self.vol(), noise, jitter,
                                  max_tries, per_lane)


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
        factor = torch.randn(self.num_tasks, self.rank, dtype=dtype,
                             generator=generator, device=generator.device)
        self.covar_factor = nn.Parameter(factor.to(device))
        self.raw_var = nn.Parameter(torch.zeros(self.num_tasks, dtype=dtype,
                                                device=device))
        return self

    def factor_and_diag(self):
        """``(F, v)`` of ``B = F F^T + diag(v)``."""
        return self.covar_factor, self.constraint.forward(self.raw_var)

    def covar_matrix(self):
        f, v = self.factor_and_diag()
        return f @ f.mT + torch.diag_embed(v)

    def forward(self, i1=None, i2=None, diag: bool = False):
        """``B``, or its entries at task indices ``(i1, i2)`` (a block, or
        with ``diag`` the entries ``B[i1, i2]``)."""
        b = self.covar_matrix()
        if i1 is None:
            return b
        if diag:
            return b[..., i1, i1 if i2 is None else i2]
        i2 = i1 if i2 is None else i2
        return b[..., i1[:, None], i2[None, :]]

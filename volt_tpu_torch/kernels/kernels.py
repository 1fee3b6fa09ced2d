"""Covariance functions (port of :mod:`volt_tpu.kernels.kernels`): the BM
and FBM kernels, the Volt covariance, the multitask ``IndexKernel`` and
the baselines' stationary kernels (OU, RBF, Matérn, scaled, spectral
mixture).

Kernels with learnable state are ``nn.Module``s whose parameters carry the
JAX leaf names with a leading batch (asset) shape; :meth:`init` creates
them.  Time inputs are 1-D grids ``(n,)``; ``diag=True`` gives the
elementwise values ``k(x1[i], x2[i])`` without a matrix.
"""

from __future__ import annotations

from typing import Optional

import math

import torch
from torch import nn

from ..ops.constraints import Interval, Positive
from ..ops.fbm import fbm_cholesky, fbm_noise_cholesky
from ..ops.volint import min_index_covariance, vol_integral
from ..ops.volt_cov import volt_covariance

__all__ = ["BMKernel", "FBMKernel", "OUKernel", "VolatilityKernel",
           "RBFKernel", "MaternKernel", "ScaleKernel", "SpectralMixtureKernel",
           "IndexKernel"]


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


class _LengthscaleKernel(nn.Module):
    """A stationary kernel of one parameter ``raw_lengthscale`` ``(*batch,
    1)`` under ``Positive`` (softplus), default 0.6931, as a function of
    the scaled distance ``(x1 - x2) / lengthscale``."""

    def __init__(self, lengthscale: float = 0.6931):
        super().__init__()
        self.constraint = Positive()
        self._init_lengthscale = lengthscale

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        raw = self.constraint.inverse(torch.tensor(self._init_lengthscale,
                                                   dtype=dtype))
        self.raw_lengthscale = nn.Parameter(torch.full(
            (*batch_shape, 1), raw.item(), dtype=dtype, device=device))
        return self

    def lengthscale(self):
        return self.constraint.forward(self.raw_lengthscale)

    def _from_scaled(self, d):
        raise NotImplementedError

    def forward(self, x1, x2=None, diag: bool = False):
        """``(*batch, n1, n2)`` covariance, or its diagonal with ``diag``."""
        x2 = x1 if x2 is None else x2
        ell = self.lengthscale()
        if diag:
            return self._from_scaled((x1 - x2) / ell)
        return self._from_scaled((x1[..., :, None] - x2[..., None, :])
                                 / ell[..., None])


class OUKernel(_LengthscaleKernel):
    """Ornstein–Uhlenbeck kernel ``exp(-|s - t| / l / 2)`` (the reference
    divides the unsquared distance by the lengthscale, then halves)."""

    def _from_scaled(self, d):
        return torch.exp(-torch.abs(d) / 2.0)


class RBFKernel(_LengthscaleKernel):
    """``exp(-(s - t)^2 / (2 l^2))``."""

    def _from_scaled(self, d):
        return torch.exp(-0.5 * d * d)


class MaternKernel(_LengthscaleKernel):
    """Matérn covariance with ``nu`` in {0.5, 1.5, 2.5} (default 2.5,
    gpytorch's)."""

    def __init__(self, nu: float = 2.5, lengthscale: float = 0.6931):
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError("nu must be one of 0.5, 1.5, 2.5")
        super().__init__(lengthscale)
        self.nu = nu

    def _from_scaled(self, d):
        d = torch.abs(d)
        if self.nu == 0.5:
            return torch.exp(-d)
        if self.nu == 1.5:
            s = math.sqrt(3.0) * d
            return (1.0 + s) * torch.exp(-s)
        s = math.sqrt(5.0) * d
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)


class ScaleKernel(nn.Module):
    """``outputscale * base``: parameter ``raw_outputscale`` ``(*batch,)``
    under ``Positive`` (default 0.6931), the base kernel's under
    ``base``."""

    def __init__(self, base_kernel: nn.Module, outputscale: float = 0.6931):
        super().__init__()
        self.base = base_kernel
        self.constraint = Positive()
        self._init_outputscale = outputscale

    @property
    def base_kernel(self):
        return self.base

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        raw = self.constraint.inverse(torch.tensor(self._init_outputscale,
                                                   dtype=dtype))
        self.raw_outputscale = nn.Parameter(torch.full(
            tuple(batch_shape), raw.item(), dtype=dtype, device=device))
        self.base.init(batch_shape, dtype, device, generator)
        return self

    def outputscale(self):
        return self.constraint.forward(self.raw_outputscale)

    def forward(self, x1, x2=None, diag: bool = False):
        base = self.base(x1, x2, diag=diag)
        extra = 1 if diag else 2
        return self.outputscale()[(...,) + (None,) * extra] * base


class SpectralMixtureKernel(nn.Module):
    """Spectral mixture (Wilson & Adams 2013) on 1-D inputs,
    ``K(tau) = sum_q w_q exp(-2 pi^2 tau^2 s_q^2) cos(2 pi tau mu_q)``;
    parameters ``raw_weights``, ``raw_means``, ``raw_scales`` ``(*batch,
    q)``, each under ``Positive``."""

    def __init__(self, num_mixtures: int = 10):
        super().__init__()
        self.num_mixtures = num_mixtures
        self.constraint = Positive()

    def _set(self, weights, means, scales):
        inv = self.constraint.inverse
        self.raw_weights = nn.Parameter(inv(weights))
        self.raw_means = nn.Parameter(inv(means))
        self.raw_scales = nn.Parameter(inv(scales))
        return self

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        """Means and scales standard exponential, weights uniform on
        ``[0.5, 1.5) / q``, drawn from ``generator``."""
        shape = (*batch_shape, self.num_mixtures)
        kw = dict(dtype=dtype, device=device)

        def draw(fill):
            return fill(torch.empty(shape, **kw))

        means = draw(lambda t: t.exponential_(generator=generator))
        scales = draw(lambda t: t.exponential_(generator=generator))
        weights = draw(lambda t: t.uniform_(0.5, 1.5, generator=generator)) \
            / self.num_mixtures
        return self._set(weights, means, scales)

    @torch.no_grad()
    def initialize_from_data(self, x, y, generator=None):
        """gpytorch's data-driven init: scales the reciprocal of ``|z|
        max_dist`` (heavy-tailed; ``|z|`` floored at 1e-6), means uniform
        below the Nyquist frequency of the smallest spacing, weights
        ``std(y) / q`` (biased std)."""
        shape = (*self.raw_weights.shape[:-1], self.num_mixtures)
        xs = torch.sort(x, dim=-1).values
        spacing = torch.diff(xs, dim=-1)
        min_dist = torch.min(torch.where(spacing > 0, spacing,
                                         torch.full_like(spacing, math.inf)),
                             dim=-1).values
        max_dist = xs[..., -1] - xs[..., 0]
        kw = dict(dtype=x.dtype, device=x.device, generator=generator)
        z = torch.abs(torch.randn(shape, **kw))
        scales = 1.0 / (torch.clamp(z, min=1e-6) * max_dist[..., None])
        means = (torch.rand(shape, **kw) * 0.5
                 / torch.clamp(min_dist[..., None], min=1e-12))
        weights = (torch.std(y, dim=-1, correction=0)[..., None]
                   / self.num_mixtures).expand(shape)
        return self._set(weights.clone(), means, scales)

    def forward(self, x1, x2=None, diag: bool = False):
        """``(*batch, n1, n2)`` covariance (through the ``(*batch, n1, n2,
        q)`` components), or its diagonal with ``diag``."""
        x2 = x1 if x2 is None else x2
        w = self.constraint.forward(self.raw_weights)
        mu = self.constraint.forward(self.raw_means)
        s = self.constraint.forward(self.raw_scales)
        if diag:
            tau = (x1 - x2)[..., None]  # (..., n, q)
            sq, mq, wq = s[..., None, :], mu[..., None, :], w[..., None, :]
        else:
            tau = (x1[..., :, None] - x2[..., None, :])[..., None]
            sq, mq = s[..., None, None, :], mu[..., None, None, :]
            wq = w[..., None, None, :]
        comp = torch.exp(-2.0 * math.pi ** 2 * tau ** 2 * sq ** 2) \
            * torch.cos(2.0 * math.pi * tau * mq)
        return torch.sum(wq * comp, dim=-1)


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

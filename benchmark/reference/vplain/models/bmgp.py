"""Exact GP over log-volatility with the Brownian drift mean (the port's
``models/bmgp.py``, trimmed to what the cells run).

Stage 2: fit ``log(vol)`` with the BM kernel and the Itô drift mean
``-0.5 vol^2 t`` through the closed-form spectral MLL (elementwise O(n)
per step on an equispaced grid), then forecast vol paths from the
filtered last-point state (S1's filter, here its plain scan) plus
independent Brownian increments.
"""

from __future__ import annotations

import dataclasses
import math
import torch
from torch import nn
from ..kernels import BMKernel
from ..likelihoods import GaussianLikelihood
from ..ops.brownian import (future_grid_ok, min_kernel_eigenvalues, min_kernel_project, nan_poison)
from ..ops.tridiag import brownian_noise_filter


@dataclasses.dataclass
class BMGPState:
    """Fitted vol GP: the module (holding its parameters) plus the
    conditioning data ``train_x (n,)``, ``train_y (..., n)`` (log vol)."""

    module: "BMGP"
    train_x: torch.Tensor
    train_y: torch.Tensor

    def sample_forecast(self, test_x, nsample: int, generator=None,
                        noise=None):
        return self.module.sample_forecast(self.train_x, self.train_y, test_x,
                                           nsample, generator, noise)


class BMGP(nn.Module):
    """Parameters (after :meth:`init`): ``kernel.raw_vol`` and
    ``likelihood.raw_noise``, each ``(*batch, 1)``."""

    def __init__(self, kernel: str = "bm"):
        super().__init__()
        if kernel != "bm":
            raise ValueError("the reference has the BM kernel only")
        self.kernel = BMKernel()
        self.likelihood = GaussianLikelihood()

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        # raw_noise starts at 0 (the reference's vol-noise pin is a no-op)
        self.kernel.init(batch_shape, dtype, device)
        self.likelihood.init(batch_shape, dtype, device)
        return self

    def mean(self, x):
        """Analytic drift ``-0.5 vol^2 t``."""
        return -0.5 * self.kernel.vol() ** 2.0 * x

    def spectral_cache(self, x, y):
        """Closed-form eigensystem of ``min(x)`` on an equispaced grid
        ``x (n,)`` and the projections of ``y (..., n)``, ``x`` and ``1``
        onto it: computed once per fit."""
        n = x.shape[-1]
        return {
            "mu": min_kernel_eigenvalues(n, x.dtype, x.device),
            "dx": x[..., 1] - x[..., 0],
            "x0": x[..., 0],
            "p_y": min_kernel_project(y),
            "p_t": min_kernel_project(x),
            "w": min_kernel_project(torch.ones(n, dtype=x.dtype,
                                               device=x.device)),
        }

    def mll_spectral(self, cache):
        """Exact per-asset MLL from :meth:`spectral_cache`:
        ``K + s I = diag(vol dx mu + s) + vol (x0 - dx) w w^T`` in the
        eigenbasis, so Sherman–Morrison and the determinant lemma give the
        quadratic form and the log-determinant elementwise."""
        mu, dx, x0 = cache["mu"], cache["dx"], cache["x0"]
        p_y, p_t, w = cache["p_y"], cache["p_t"], cache["w"]
        n = mu.shape[-1]
        vol = self.kernel.vol()[..., 0]
        noise = self.likelihood.noise()[..., 0]

        d = vol[..., None] * dx[..., None] * mu + noise[..., None]
        p_r = p_y + 0.5 * (vol ** 2.0)[..., None] * p_t
        a = vol * (x0 - dx)
        wd = w / d
        s = 1.0 + a * torch.sum(w * wd, dim=-1)
        quad = (torch.sum(p_r * p_r / d, dim=-1)
                - a * torch.sum(wd * p_r, dim=-1) ** 2 / s)
        logdet = torch.sum(torch.log(d), dim=-1) + torch.log(s)
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi)) / n

    def forecast_state(self, train_x, train_y):
        """Filtered ``(mean, var)`` of the latent residual at the last train
        point given all observations (the Kalman filter, kernel S1 on
        CUDA)."""
        vol = self.kernel.vol()[..., 0]
        noise = self.likelihood.noise()[..., 0]
        resid = train_y - self.mean(train_x)
        return brownian_noise_filter(vol[..., None] * train_x, noise, resid)

    def sample_forecast(self, train_x, train_y, test_x, nsample: int,
                        generator=None, noise=None):
        """``(..., nsample, H)`` joint posterior samples of the log vol at
        strictly-future ``test_x``: the filtered state plus independent
        Brownian increments.  Grids that break that contract come back
        all-NaN.  ``noise`` optionally gives the standard normals
        ``(r0 (..., S), z (..., S, H))``; otherwise they are drawn from
        ``generator``."""
        mu, p = self.forecast_state(train_x, train_y)
        vol = self.kernel.vol()[..., 0]
        incs = vol[..., None] * torch.diff(test_x, dim=-1,
                                           prepend=train_x[..., -1:])
        batch = torch.broadcast_shapes(mu.shape, incs.shape[:-1])
        h = test_x.shape[-1]
        if noise is None:
            kw = dict(dtype=train_y.dtype, device=train_y.device,
                      generator=generator)
            r0_noise = torch.randn(*batch, nsample, **kw)
            z = torch.randn(*batch, nsample, h, **kw)
        else:
            r0_noise, z = noise
        r0 = mu[..., None] + torch.sqrt(p)[..., None] * r0_noise
        r = r0[..., None] + torch.cumsum(torch.sqrt(incs)[..., None, :] * z,
                                         dim=-1)
        ok = future_grid_ok(test_x, train_x)
        return nan_poison(r + self.mean(test_x)[..., None, :],
                          ok[..., None, None])

    def fit_state(self, train_x, train_y) -> BMGPState:
        return BMGPState(module=self, train_x=train_x, train_y=train_y)

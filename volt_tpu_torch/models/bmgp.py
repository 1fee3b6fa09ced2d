"""Exact GP over log-volatility with the Brownian drift mean (port of
:mod:`volt_tpu.models.bmgp`).

Stage 2: fit ``log(vol)`` with the BM kernel and the Itô drift mean
``-0.5 vol^2 t`` through the closed-form spectral MLL (elementwise O(n)
per step on an equispaced grid) or the Kalman MLL (kernel S1, any grid),
then forecast vol paths from the filtered last-point state plus
independent Brownian increments.  The dense MLL, posterior and sampler
serve the reference API, grids that are not strictly future and the FBM
kernel (``kernel="fbm"``), whose ``K + noise I`` is factored in the
increment domain (:mod:`..ops.fbm`) with a jitter ladder per asset.  The
Markov closed forms (``forecast_state``, ``posterior_forecast``,
``sample_forecast``) refuse the FBM kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import native
from ..gp.exact import exact_mll, posterior
from ..kernels import BMKernel, FBMKernel
from ..likelihoods import GaussianLikelihood
from ..ops.bm_vol_mll import bm_vol_mll
from ..ops.brownian import (future_grid_ok, min_kernel_eigenvalues,
                            min_kernel_project, nan_poison)
from ..ops.mvn import mvn_log_prob_chol, sample_mvn
from ..ops.tridiag import brownian_noise_filter, brownian_noise_mll_kalman
from ..utils.profiling import annotate

__all__ = ["BMGP", "BMGPState"]


@dataclasses.dataclass
class BMGPState:
    """Fitted vol GP: the module (holding its parameters) plus the
    conditioning data ``train_x (n,)``, ``train_y (..., n)`` (log vol)."""

    module: "BMGP"
    train_x: torch.Tensor
    train_y: torch.Tensor

    def mll(self):
        return self.module.mll(self.train_x, self.train_y)

    def posterior(self, test_x):
        return self.module.posterior(self.train_x, self.train_y, test_x)

    def sample(self, test_x, sample_shape=(), generator=None, noise=None):
        return self.module.sample(self.train_x, self.train_y, test_x,
                                  sample_shape, generator, noise)

    def sample_forecast(self, test_x, nsample: int, generator=None,
                        noise=None):
        return self.module.sample_forecast(self.train_x, self.train_y, test_x,
                                           nsample, generator, noise)


class BMGP(nn.Module):
    """Parameters (after :meth:`init`): ``kernel.raw_vol`` (the BM vol, or
    the FBM kernel's Hurst parameter) and ``likelihood.raw_noise``, each
    ``(*batch, 1)``."""

    def __init__(self, kernel: str = "bm"):
        super().__init__()
        if kernel == "bm":
            self.kernel = BMKernel()
        elif kernel == "fbm":
            self.kernel = FBMKernel()
        else:
            raise ValueError("kernel must be 'bm' or 'fbm'")
        self.likelihood = GaussianLikelihood()

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        # raw_noise starts at 0 (the reference's vol-noise pin is a no-op)
        self.kernel.init(batch_shape, dtype, device)
        self.likelihood.init(batch_shape, dtype, device)
        return self

    def mean(self, x):
        """Analytic drift ``-0.5 vol^2 t``."""
        return -0.5 * self.kernel.vol() ** 2.0 * x

    def _require_bm(self, method: str):
        """The Markov closed forms hold for the BM kernel only; on the FBM
        kernel they would run and be silently wrong."""
        if not isinstance(self.kernel, BMKernel):
            raise ValueError(
                f"{method} requires the BM kernel (Markov closed forms); "
                f"use posterior/sample for {type(self.kernel).__name__}")

    def _fbm_noise_chol(self, x):
        """Lower factor of ``K + noise I`` for the FBM kernel, in the
        increment domain, the jitter ladder per asset."""
        return self.kernel.noise_cholesky(x, self.likelihood.noise(),
                                          per_lane=True)

    def mll(self, x, y):
        """Dense exact MLL / n: a Cholesky of ``vol min(x) + noise I``, or
        for the FBM kernel the increment-domain factor of ``K + noise
        I`` (a ``dense_mll`` span)."""
        if isinstance(self.kernel, FBMKernel):
            with annotate("dense_mll"):
                chol = self._fbm_noise_chol(x)
                return mvn_log_prob_chol(y, self.mean(x), chol) / y.shape[-1]
        return exact_mll(y, self.mean(x), self.kernel(x),
                         self.likelihood.noise())

    def mll_kalman(self, x, y):
        """The same MLL in O(n) by the Kalman filter (kernel S1 on CUDA):
        ``vol min(x) + noise I`` is a random walk with increments
        ``vol dx`` observed in noise; any grid."""
        vol = self.kernel.vol()[..., 0]
        noise = self.likelihood.noise()[..., 0]
        return brownian_noise_mll_kalman(vol[..., None] * x, noise,
                                         y - self.mean(x))

    def posterior(self, train_x, train_y, test_x):
        """Latent posterior ``(mean (..., H), cov (..., H, H))`` at any
        ``test_x`` by noisy dense conditioning on the train points (the FBM
        kernel's train factor from the increment domain)."""
        chol_tr = (self._fbm_noise_chol(train_x)
                   if isinstance(self.kernel, FBMKernel) else None)
        mean, cov = posterior(self.kernel(train_x), self.kernel(train_x, test_x),
                              self.kernel(test_x), train_y - self.mean(train_x),
                              self.likelihood.noise(), chol_tr=chol_tr)
        return mean + self.mean(test_x), cov

    def sample(self, train_x, train_y, test_x, sample_shape=(),
               generator=None, noise=None):
        """Joint posterior samples ``(*sample_shape, ..., H)`` of the latent
        log vol (``noise``: the standard normals of that shape); a
        ``dense_sample`` span."""
        with annotate("dense_sample"):
            mean, cov = self.posterior(train_x, train_y, test_x)
            # the FBM kernel samples here in the batched pipeline, one
            # asset a lane, so its posterior factors climb their jitter
            # ladders apart
            return sample_mvn(mean, cov, sample_shape, generator=generator,
                              noise=noise,
                              per_lane=isinstance(self.kernel, FBMKernel))

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
        quadratic form and the log-determinant elementwise.  Kernel G2 on
        the card (one launch for the MLL and its gradient; it raises on
        float64 and on a gradient wanted for the cache), the plain
        composition on the CPU."""
        mu, dx, x0 = cache["mu"], cache["dx"], cache["x0"]
        p_y, p_t, w = cache["p_y"], cache["p_t"], cache["w"]
        n = mu.shape[-1]
        vol = self.kernel.vol()
        noise = self.likelihood.noise()
        if native.on_card(p_y):
            return bm_vol_mll(p_y, p_t, mu, w, dx, x0, vol, noise)
        vol = vol[..., 0]
        noise = noise[..., 0]

        d = vol[..., None] * dx[..., None] * mu + noise[..., None]
        p_r = p_y + 0.5 * (vol ** 2.0)[..., None] * p_t
        a = vol * (x0 - dx)
        wd = w / d
        s = 1.0 + a * torch.sum(w * wd, dim=-1)
        quad = (torch.sum(p_r * p_r / d, dim=-1)
                - a * torch.sum(wd * p_r, dim=-1) ** 2 / s)
        logdet = torch.sum(torch.log(d), dim=-1) + torch.log(s)
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi)) / n

    def grid_cache(self, x):
        """``(evals, evecs)`` of ``min(x)`` (the eigenvalues clamped at 0),
        one ``eigh`` per grid, for :meth:`mll_fast`; ``None`` for the FBM
        kernel.  Not on the fit path (the spectral and Kalman MLLs are):
        an independent form of the same MLL."""
        if not isinstance(self.kernel, BMKernel):
            return None
        evals, evecs = torch.linalg.eigh(
            torch.minimum(x[..., :, None], x[..., None, :]))
        return torch.clamp(evals, min=0.0), evecs

    def mll_fast(self, x, y, cache):
        """The dense MLL / n in O(n^2) a step from :meth:`grid_cache`:
        ``K + s I = vol M + s I`` is diagonal in the eigenbasis of the fixed
        ``M = min(x)``."""
        evals, evecs = cache
        n = y.shape[-1]
        vol = self.kernel.vol()[..., 0]
        noise = self.likelihood.noise()[..., 0]
        rot = torch.einsum("...ij,...i->...j", evecs, y - self.mean(x))
        denom = vol[..., None] * evals + noise[..., None]
        quad = torch.sum(rot * rot / denom, dim=-1)
        logdet = torch.sum(torch.log(denom), dim=-1)
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi)) / n

    def forecast_state(self, train_x, train_y):
        """Filtered ``(mean, var)`` of the latent residual at the last train
        point given all observations (the Kalman filter, kernel S1 on
        CUDA; BM kernel only)."""
        self._require_bm("forecast_state")
        vol = self.kernel.vol()[..., 0]
        noise = self.likelihood.noise()[..., 0]
        resid = train_y - self.mean(train_x)
        return brownian_noise_filter(vol[..., None] * train_x, noise, resid)

    def posterior_forecast(self, train_x, train_y, test_x):
        """The joint posterior ``(mean (..., H), cov (..., H, H))`` at
        strictly-future ``test_x`` in closed form: the filtered last-point
        state plus Brownian spread, ``cov_jk = P_n + vol (min(x*_j, x*_k) -
        x_n)``.  Grids that break the contract come back all-NaN.  BM
        kernel only."""
        self._require_bm("posterior_forecast")
        mu, p = self.forecast_state(train_x, train_y)
        vol = self.kernel.vol()[..., 0]
        mean = self.mean(test_x) + mu[..., None]
        gap = torch.minimum(test_x[..., :, None], test_x[..., None, :]) \
            - train_x[..., -1:, None]
        cov = p[..., None, None] + vol[..., None, None] * gap
        ok = future_grid_ok(test_x, train_x)
        return (nan_poison(mean, ok[..., None]),
                nan_poison(cov, ok[..., None, None]))

    def sample_forecast(self, train_x, train_y, test_x, nsample: int,
                        generator=None, noise=None):
        """``(..., nsample, H)`` joint posterior samples of the log vol at
        strictly-future ``test_x``: the filtered state plus independent
        Brownian increments.  Grids that break that contract come back
        all-NaN.  ``noise`` optionally gives the standard normals
        ``(r0 (..., S), z (..., S, H))``; otherwise they are drawn from
        ``generator``.  BM kernel only."""
        self._require_bm("sample_forecast")
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

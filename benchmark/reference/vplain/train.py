"""The fits of the pipelines' stages (the port's ``train.py``, trimmed to
what the cells run): Adam on each stage's per-asset losses."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from .convert import load_params
from .likelihoods import VolatilityGaussianLikelihood
from .models.bmgp import BMGP
from .models.gpcv import GPCVModel
from .models.multitask import MultitaskBMGP, MultitaskVariationalGP
from .models.volt import VoltGP
from .ops.tridiag import brownian_noise_mll_kalman
from .optim import Adam


def scaled_returns(train_x, train_y):
    """``(y[t+1] - y[t]) / y[t] / sqrt(dt)``; ``train_y`` holds prices on a
    grid one point longer than ``train_x``."""
    if train_y.shape[-1] != train_x.shape[-1] + 1:
        raise ValueError(
            f"expected len(train_y) == len(train_x) + 1 (prices vs. return "
            f"grid), got {train_y.shape[-1]} vs {train_x.shape[-1]}")
    dt = train_x[..., 1] - train_x[..., 0]
    diffs = train_y[..., 1:] - train_y[..., :-1]
    return diffs / train_y[..., :-1] / torch.sqrt(dt)[..., None]


def adam_loop(module, loss_fn, iters: int, lr: float):
    """Minimise the per-asset losses ``loss_fn()`` ``(*batch)`` with Adam
    over every parameter of ``module``; returns the losses ``(iters,
    *batch)``, each taken before its step's update.  With no steps, the
    loss at the given state as one row ``(1, *batch)``: a forecast from a
    fitted state, which the benchmark's check runs (the port returns an
    empty ``(0, *batch)`` there).

    One Adam on the summed losses equals one Adam per asset: the
    gradient of the sum w.r.t. an asset's parameters is that asset's own
    gradient, and Adam updates elementwise (optax's defaults and
    arithmetic, :class:`volt_tpu_torch.optim.Adam`).  Every op of the
    losses is per asset, so a non-finite asset leaves the others
    untouched.
    """
    opt = Adam(module.parameters(), lr, iters)
    losses = []
    for _ in range(iters):
        opt.zero_grad()
        loss = loss_fn()
        loss.sum().backward()
        opt.step()
        losses.append(loss.detach())
    if not losses:
        with torch.no_grad():
            return loss_fn().detach()[None]
    return torch.stack(losses)


def _fit_gpcv(module: GPCVModel, train_x, yy, iters: int, lr: float):
    """Fit an initialised GPCV module in place; the losses ``(iters, ...)``."""
    return adam_loop(module, lambda: -module.elbo(train_x, yy), iters, lr)


class _Packed(nn.Module):
    """The multitask GPCV's variational GP and likelihood trained as one
    module: ``params_tree`` gives the JAX package's ``{"model": ...,
    "lik": ...}``."""

    def __init__(self, model: nn.Module, lik: nn.Module):
        super().__init__()
        self.model = model
        self.lik = lik


def _multitask_gpcv(train_x, yy, rank: int, q: str, param: str,
                    generator, init_params):
    """The multitask GPCV module initialised: ``init_params`` (a JAX
    ``{"model", "lik"}`` tree) loaded as it is, else the random init from
    ``generator`` then the Laplace init."""
    lik = VolatilityGaussianLikelihood(param=param)
    model = MultitaskVariationalGP(num_tasks=yy.shape[-1], rank=rank, q=q)
    packed = _Packed(model, lik)
    if init_params is not None:
        return load_params(packed, init_params, yy.device)
    lik.init((), yy.dtype, yy.device, generator)
    model.init(train_x, yy.dtype, generator)
    model.initialize_variational_parameters(lik, train_x, yy)
    return packed


def _multitask_scale(packed):
    """The multitask GPCV's predicted scale ``(T, n)``."""
    with torch.no_grad():
        model = packed.model
        return packed.lik.expected_scale(model.variational_mean,
                                         model.marginal_variances()).T


def _is_equispaced(x) -> bool:
    """Uniform grid within ``max(1e-3 relative, 4 eps_f32 max|x|)``; grids
    of fewer than 3 points do not count."""
    xv = np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)
    if xv.ndim != 1 or xv.shape[0] < 3:
        return False
    d = np.diff(np.asarray(xv, np.float64))
    med = float(np.median(d))
    tol = max(1e-3 * abs(med),
              4.0 * float(np.finfo(np.float32).eps) * float(np.max(np.abs(xv))))
    return bool(np.all(np.abs(d - med) <= tol))


def _fit_bmgp(module: BMGP, train_x, log_vol, iters: int, lr: float):
    """Adam on the vol GP's spectral MLL (an equispaced grid)."""
    cache = module.spectral_cache(train_x, log_vol)
    return adam_loop(module, lambda: -module.mll_spectral(cache), iters, lr)


def _fit_volt(volt: VoltGP, train_x, log_y, vol, iters: int, lr: float):
    """Adam on the Kalman MLL of the Volt data model.  The EWMA mean is
    parameter-free in its train values, so it is computed once outside the
    loss."""
    v_integral = volt.kernel.integral(train_x, vol)
    resid = log_y - volt.train_mean(train_x, log_y)

    def data_loss():
        noise = volt.likelihood.noise()[..., 0]
        return -brownian_noise_mll_kalman(v_integral, noise, resid)

    return adam_loop(volt, data_loss, iters, lr)


def _fit_multitask_vol(mt: MultitaskBMGP, train_x, log_vols_nt, iters: int,
                       lr: float):
    """Adam on the multitask vol GP's spectral MLL: the closed-form data
    spectrum with the low-rank task blocks on an equispaced grid."""
    n, t = log_vols_nt.shape
    cache = mt.spectral_cache(train_x, log_vols_nt)
    return adam_loop(mt, lambda: -mt.mll_spectral(cache, n, t), iters, lr)

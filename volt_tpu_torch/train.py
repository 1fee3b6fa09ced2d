"""Training entry points (port of :mod:`volt_tpu.train`), with the JAX
package's defaults and the reference-style aliases.

* ``learn_gpcv``       — stage 1: the tridiagonal GPCV by NGVI (default) or
                         Adam(0.01), or the dense family by Adam; returns
                         the predicted scale (``learn_gpcv_sparse``: on
                         inducing points, for long series);
* ``train_vol_model``  — stage 2: Adam(0.01) on the vol GP's spectral MLL
                         (equispaced grids) or Kalman MLL (any grid);
* ``train_data_model`` — stage 3: Adam(0.1) on the Volt MLL, log-linear
                         mean initialised from the data;
* ``train_volt_magpie``— stage 3 with the mean selected by name.

Each fit minimises the per-asset losses of a module that holds its own
parameters, so leading batch (asset) dims train as independent fits.
The data-model loss is the O(n) Kalman MLL (kernel S1 on CUDA), the same
function as the dense :meth:`VoltGP.mll`.  ``generator`` replaces the JAX
``key``: it draws the only random initial values (``LinearMean``'s), and
``init_params`` can set them instead (e.g. the JAX package's, through
:mod:`volt_tpu_torch.convert`).
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import load_jax_params
from .gp.natural import ngvi_tridiag_fit
from .means import LogLinearMean
from .models.bmgp import BMGP, BMGPState
from .models.gpcv import GPCVModel, GPCVState
from .models.volt import VoltGP, VoltState, make_mean
from .ops.tridiag import brownian_noise_mll_kalman
from .optim import Adam

__all__ = [
    "scaled_returns",
    "adam_loop",
    "learn_gpcv",
    "learn_gpcv_sparse",
    "learn_gpcv_multitask",
    "train_vol_model",
    "train_data_model",
    "train_volt_magpie",
    "train_basic_model",
    "train_volt_multitask",
    "LearnGPCV",
    "TrainVolModel",
    "TrainDataModel",
    "TrainVoltMagpieModel",
]


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
    *batch)``, each taken before its step's update.

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
    return torch.stack(losses)


def _print_losses(losses, iters):
    for i in range(0, iters, 50):
        print(f"Iter {i + 1}/{iters} - Loss: {float(losses[i].mean()):.3f}")


def _not_ported(name, item):
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# Stage 1: GPCV
# ---------------------------------------------------------------------------


def _fit_gpcv(module: GPCVModel, train_x, yy, iters: int, lr: float,
              opt: str = "adam"):
    """Fit an initialised GPCV module in place; the losses ``(iters, ...)``."""
    if opt == "ngvi":
        return ngvi_tridiag_fit(module, train_x, yy, iters, lr)
    return adam_loop(module, lambda: -module.elbo(train_x, yy), iters, lr)


def learn_gpcv(train_x, train_y, train_iters: int = 1000,
               printing: bool = False, kernel: str = "bm", lr: float = 0.01,
               return_model: bool = False, generator=None,
               mc_scale_samples=None, q: str | None = None,
               param: str = "exp", opt: str | None = None,
               ell_method: str | None = None, noise=None,
               init_params=None):
    """Infer the volatility path from prices ``train_y`` (one longer than
    the return grid ``train_x``).  Returns the predicted scale, and with
    ``return_model`` the fitted :class:`GPCVState`.

    ``q`` defaults to ``"tridiag"`` (``"full"`` is the reference's dense
    family) and ``opt`` to ``"ngvi"`` for it (``"adam"``, the reference's
    single-Adam loop, is the only choice for ``"full"``); ``param`` is
    the likelihood (``"exp"`` or ``"cv"``); ``ell_method="quadrature"``
    trains the exp likelihood on the reference's GH-75 term.
    ``generator`` draws the cv triplets' init and, with
    ``mc_scale_samples``, the Monte-Carlo scale estimate (or the standard
    normals ``noise``) instead of Gauss–Hermite.  ``init_params``
    (``{"likelihood": {"raw_a": ..., ...}}``, e.g. the JAX package's
    draw through :mod:`volt_tpu_torch.convert`) replaces the cv triplets'
    random init before the Laplace init.
    """
    if q is None:
        q = "tridiag" if kernel == "bm" else "full"
    if opt is None:
        opt = "ngvi" if q == "tridiag" else "adam"
    if opt not in ("ngvi", "adam"):
        raise ValueError("opt must be None, 'ngvi' or 'adam'")
    if opt == "ngvi" and q != "tridiag":
        raise ValueError("opt='ngvi' requires the tridiag family")
    yy = scaled_returns(train_x, train_y)
    module = GPCVModel(kernel=kernel, param=param, q=q,
                       ell_method=ell_method).init(
        train_x, yy, generator,
        likelihood_params=(init_params or {}).get("likelihood"))
    losses = _fit_gpcv(module, train_x, yy, train_iters, lr, opt)
    if printing:
        _print_losses(losses, train_iters)
    state = GPCVState(module=module, train_x=train_x, targets=yy)
    with torch.no_grad():
        pred_scale = state.predicted_scale(mc_scale_samples, generator, noise)
    return (pred_scale, state) if return_model else pred_scale


def learn_gpcv_sparse(train_x, train_y, num_inducing: int = 256,
                      train_iters: int = 1000, kernel: str = "bm",
                      lr: float = 0.01, return_model: bool = False,
                      generator=None):
    """Sparse-GPCV volatility inference for long series: the dense family
    on ``m = num_inducing`` inducing points (the train grid at the
    rounded, deduplicated ``linspace(0, n-1, m)``), Adam on the SVGP ELBO,
    O(n m^2) a step.  Returns the predicted scale on the whole train grid,
    and with ``return_model`` a :class:`GPCVState` carrying the inducing
    grid, whose ``predicted_scale()`` gives the same values."""
    yy = scaled_returns(train_x, train_y)
    n = train_x.shape[-1]
    m = min(num_inducing, n)
    idx = np.unique(np.round(np.linspace(0, n - 1, m)).astype(np.int64))
    inducing_x = train_x[..., torch.as_tensor(idx, device=train_x.device)]
    module = GPCVModel(kernel=kernel).init_sparse(train_x, inducing_x, yy,
                                                  generator)
    adam_loop(module, lambda: -module.elbo_sparse(train_x, inducing_x, yy),
              train_iters, lr)
    state = GPCVState(module=module, train_x=train_x, targets=yy,
                      inducing_x=inducing_x)
    with torch.no_grad():
        pred_scale = state.predicted_scale()
    return (pred_scale, state) if return_model else pred_scale


def learn_gpcv_multitask(*args, **kwargs):
    _not_ported("learn_gpcv_multitask", "slice D, item 20")


# ---------------------------------------------------------------------------
# Stage 2: vol GP
# ---------------------------------------------------------------------------


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


def _fit_bmgp(module: BMGP, train_x, log_vol, iters: int, lr: float,
              spectral: bool):
    if spectral:
        cache = module.spectral_cache(train_x, log_vol)
        return adam_loop(module, lambda: -module.mll_spectral(cache), iters,
                         lr)
    return adam_loop(module, lambda: -module.mll_kalman(train_x, log_vol),
                     iters, lr)


def train_vol_model(train_x, vol_path, train_iters: int = 1000,
                    printing: bool = False, kernel: str = "bm",
                    lr: float = 0.01, vol_mll: str | None = None) -> BMGPState:
    """Fit the BM GP to ``log(vol_path)``.  ``vol_mll``: ``"spectral"``
    (the caller asserts an equispaced grid), ``"kalman"`` (any grid) or
    ``None`` (spectral iff the grid checks equispaced)."""
    log_vol = torch.log(vol_path)
    if vol_mll is None:
        spectral = _is_equispaced(train_x)
    elif vol_mll in ("spectral", "kalman"):
        spectral = vol_mll == "spectral"
    else:
        raise ValueError("vol_mll must be None, 'spectral' or 'kalman'")
    module = BMGP(kernel=kernel).init(log_vol.shape[:-1], log_vol.dtype,
                                      log_vol.device)
    losses = _fit_bmgp(module, train_x, log_vol, train_iters, lr, spectral)
    if printing:
        _print_losses(losses, train_iters)
    return module.fit_state(train_x, log_vol)


# ---------------------------------------------------------------------------
# Stage 3: Volt data model
# ---------------------------------------------------------------------------


def _fit_volt(volt: VoltGP, train_x, log_y, vol, iters: int, lr: float):
    """Adam on the Kalman MLL of the Volt data model.  A history mean is
    parameter-free in its train values, so it is computed once outside the
    loss."""
    v_integral = volt.kernel.integral(train_x, vol)
    if volt.mean.is_history_dependent:
        resid = log_y - volt.train_mean(train_x, log_y)

        def data_loss():
            noise = volt.likelihood.noise()[..., 0]
            return -brownian_noise_mll_kalman(v_integral, noise, resid)
    else:
        def data_loss():
            noise = volt.likelihood.noise()[..., 0]
            mv = volt.train_mean(train_x, log_y)
            return -brownian_noise_mll_kalman(v_integral, noise, log_y - mv)

    return adam_loop(volt, data_loss, iters, lr)


def _fit_volt_state(module: VoltGP, train_x, log_y, vol_path, vol_state,
                    iters, lr, printing, init_mean_from_data, generator,
                    init_params):
    module.init(log_y.shape[:-1], log_y.dtype, log_y.device, generator)
    if init_params is not None:
        load_jax_params(module, init_params, log_y.device)
    if init_mean_from_data and isinstance(module.mean, LogLinearMean):
        module.mean.initialize_from_data(train_x, log_y)
    losses = _fit_volt(module, train_x, log_y, vol_path, iters, lr)
    if printing:
        _print_losses(losses, iters)
    return module.fit_state(train_x, log_y, vol_path, vol_state)


def train_data_model(train_x, train_y, vol_state: BMGPState, vol_path,
                     train_iters: int = 1000, printing: bool = False,
                     lr: float = 0.1, generator=None,
                     init_params=None) -> VoltState:
    """Volt with a log-linear mean whose bias starts at the mean price
    (``train_y`` holds prices on the return grid).  ``init_params``
    (``{"mean": ..., "likelihood": ...}``) replaces the random initial
    weights before the bias is set from the data."""
    module = VoltGP(mean=LogLinearMean(1))
    return _fit_volt_state(module, train_x, torch.log(train_y), vol_path,
                           vol_state, train_iters, lr, printing, True,
                           generator, init_params)


def train_volt_magpie(train_x, train_y, vol_state: BMGPState, vol_path,
                      train_iters: int = 1000, printing: bool = False,
                      k: int = 25, theta: float = 0.5,
                      mean_func: str = "ewma", lr: float = 0.1,
                      generator=None, integral_rule: str = "reference",
                      init_params=None) -> VoltState:
    """Volt with the mean selected by name (``train_y`` holds prices on the
    return grid); ``integral_rule`` is the vol-integral quadrature
    (``"reference"`` or ``"trapezoid"``)."""
    module = VoltGP(mean=make_mean(mean_func, k=k, theta=theta),
                    integral_rule=integral_rule)
    return _fit_volt_state(module, train_x, torch.log(train_y), vol_path,
                           vol_state, train_iters, lr, printing,
                           mean_func == "loglinear", generator, init_params)


def train_basic_model(*args, **kwargs):
    _not_ported("train_basic_model", "slice C, item 17")


def train_volt_multitask(*args, **kwargs):
    _not_ported("train_volt_multitask", "slice D, item 20")


# Reference-style aliases
LearnGPCV = learn_gpcv
TrainVolModel = train_vol_model
TrainDataModel = train_data_model
TrainVoltMagpieModel = train_volt_magpie

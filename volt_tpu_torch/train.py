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
* ``train_volt_magpie``— stage 3 with the mean selected by name;
* ``learn_gpcv_multitask`` / ``train_volt_multitask`` — the Kronecker
                         multitask chain: one variational vol model over
                         ``T`` assets, per-task Volt fits and one
                         multitask vol GP;
* ``train_basic_model``— Adam(0.1) on the exact MLL of a Matérn or
                         spectral-mixture baseline over log prices.

Each fit minimises the per-asset losses of a module that holds its own
parameters, so leading batch (asset) dims train as independent fits.
The data-model loss is the O(n) Kalman MLL (kernel S1 on CUDA), the same
function as the dense :meth:`VoltGP.mll`.  ``generator`` replaces the JAX
``key``: it draws the random initial values (``LinearMean``'s, the
spectral mixture's), and ``init_params`` can set them instead (e.g. the JAX package's, through
:mod:`volt_tpu_torch.convert`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .convert import load_jax_params
from .gp.natural import ngvi_tridiag_fit
from .kernels import BMKernel, SpectralMixtureKernel
from .likelihoods import VolatilityGaussianLikelihood
from .means import LogLinearMean
from .models.basic import SMGP, BasicGP, BasicGPState, MaternGP
from .models.bmgp import BMGP, BMGPState
from .models.gpcv import GPCVModel, GPCVState
from .models.multitask import MultitaskBMGP, MultitaskVariationalGP
from .models.volt import VoltGP, VoltState, make_mean
from .ops.tridiag import brownian_noise_mll_kalman
from .optim import Adam
from .utils.profiling import annotate

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
    "TrainBasicModel",
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
    *batch)``, each taken before its step's update (with no steps, an
    empty ``(0, *batch)`` on the losses' device, as JAX's scan returns).

    One Adam on the summed losses equals one Adam per asset: the
    gradient of the sum w.r.t. an asset's parameters is that asset's own
    gradient, and Adam updates elementwise (optax's defaults and
    arithmetic, :class:`volt_tpu_torch.optim.Adam`).  Every op of the
    losses is per asset, so a non-finite asset leaves the others
    untouched.

    Each step is an ``adam_step`` span of ``forward`` (``loss_fn()``),
    ``backward`` and ``update`` (``opt.step()``).
    """
    opt = Adam(module.parameters(), lr, iters)
    losses = []
    for _ in range(iters):
        with annotate("adam_step"):
            opt.zero_grad()
            with annotate("forward"):
                loss = loss_fn()
            with annotate("backward"):
                loss.sum().backward()
            with annotate("update"):
                opt.step()
            losses.append(loss.detach())
    if not losses:
        with torch.no_grad():
            loss = loss_fn()
        return loss.new_empty((0, *loss.shape))
    return torch.stack(losses)


def _print_losses(losses, iters):
    for i in range(0, iters, 50):
        print(f"Iter {i + 1}/{iters} - Loss: {float(losses[i].mean()):.3f}")


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
        return load_jax_params(packed, init_params, yy.device)
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


def learn_gpcv_multitask(train_x, train_ys, train_iters: int = 1000,
                         rank: int = 1, lr: float = 0.01,
                         num_locs: int = 75, return_model: bool = False,
                         generator=None, param: str = "exp",
                         q: str = "full", init_params=None):
    """Kronecker multitask GPCV: one variational vol model coupling ``T``
    assets, ``train_ys (T, n+1)`` prices.  Adam on the ELBO of the
    variational GP and the likelihood together; returns the per-task
    predicted scales ``(T, n)``, and with ``return_model`` the fitted
    ``(MultitaskVariationalGP, likelihood)``.  ``generator`` draws the
    random init (the task factor, the variational mean, the cv triplets);
    ``init_params`` (``{"model": ..., "lik": ...}``, e.g. the JAX
    package's initialised parameters) replaces the whole init."""
    yy = scaled_returns(train_x, train_ys).T  # (n, T)
    packed = _multitask_gpcv(train_x, yy, rank, q, param, generator,
                             init_params)
    adam_loop(packed, lambda: -packed.model.elbo(train_x, yy, packed.lik,
                                                 num_locs=num_locs),
              train_iters, lr)
    pred_scale = _multitask_scale(packed)
    return (pred_scale, (packed.model, packed.lik)) if return_model \
        else pred_scale


# ---------------------------------------------------------------------------
# Stage 2: vol GP
# ---------------------------------------------------------------------------


def _is_equispaced(x) -> bool:
    """Uniform grid within ``max(1e-3 relative, 4 eps_f32 max|x|)``; grids
    of fewer than 3 points do not count."""
    with annotate("sync:equispaced"):
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
    """Adam on the vol GP's MLL: for the BM kernel the spectral (an
    equispaced grid) or the Kalman form, for the FBM kernel the dense
    one through the increment-domain factor."""
    if not isinstance(module.kernel, BMKernel):
        return adam_loop(module, lambda: -module.mll(train_x, log_vol),
                         iters, lr)
    if spectral:
        with annotate("spectral_cache"):
            cache = module.spectral_cache(train_x, log_vol)
        return adam_loop(module, lambda: -module.mll_spectral(cache), iters,
                         lr)
    return adam_loop(module, lambda: -module.mll_kalman(train_x, log_vol),
                     iters, lr)


def train_vol_model(train_x, vol_path, train_iters: int = 1000,
                    printing: bool = False, kernel: str = "bm",
                    lr: float = 0.01, vol_mll: str | None = None) -> BMGPState:
    """Fit the vol GP to ``log(vol_path)``.  ``vol_mll`` (BM kernel):
    ``"spectral"`` (the caller asserts an equispaced grid), ``"kalman"``
    (any grid) or ``None`` (spectral iff the grid checks equispaced);
    ``kernel="fbm"`` takes the dense MLL."""
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
    with annotate("integral"):
        v_integral = volt.kernel.integral(train_x, vol)
    if volt.mean.is_history_dependent:
        with annotate("train_mean"):
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


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def _fit_basic(module: BasicGP, train_x, log_y, iters: int, lr: float):
    """Adam on the baseline's exact MLL; the losses ``(iters,)``."""
    return adam_loop(module, lambda: -module.mll(train_x, log_y), iters, lr)


def train_basic_model(train_x, train_y, train_iters: int = 1000,
                      printing: bool = False, model_type: str = "matern",
                      num_mixtures: int = 10, mean_func: str = "loglinear",
                      lr: float = 0.1, generator=None,
                      init_params=None) -> BasicGPState:
    """Matérn (``model_type="matern"``) or spectral-mixture baseline on the
    log of the prices ``train_y``, with a log-linear mean whose bias starts
    at the mean price (``mean_func="loglinear"``) or a constant one.
    ``generator`` draws the random init (the spectral mixture's, then its
    data-driven re-init; the linear mean's weights); ``init_params``
    (``{"kernel", "mean", "likelihood"}``, e.g. the JAX package's
    initialised tree) replaces the whole init."""
    log_y = torch.log(train_y)
    mean = LogLinearMean(1) if mean_func == "loglinear" else None
    module = (MaternGP(mean) if model_type == "matern"
              else SMGP(num_mixtures, mean))
    module.init(log_y.dtype, log_y.device, generator)
    if init_params is not None:
        load_jax_params(module, init_params, log_y.device)
    else:
        if isinstance(module.kernel, SpectralMixtureKernel):
            module.kernel.initialize_from_data(train_x, log_y, generator)
        if mean_func == "loglinear":
            module.mean.initialize_from_data(train_x, log_y)
        module.likelihood.init((), log_y.dtype, log_y.device,
                               raw_noise_init=1e-5)
    losses = _fit_basic(module, train_x, log_y, train_iters, lr)
    if printing:
        _print_losses(losses, train_iters)
    return module.fit_state(train_x, log_y)


def _fit_multitask_vol(mt: MultitaskBMGP, train_x, log_vols_nt, iters: int,
                       lr: float, spectral: bool):
    """Adam on the multitask vol GP's MLL: the closed-form data spectrum
    with the low-rank task blocks on an equispaced grid, else one
    ``eigh`` of each factor a step."""
    if spectral:
        n, t = log_vols_nt.shape
        with annotate("spectral_cache"):
            cache = mt.spectral_cache(train_x, log_vols_nt)
        return adam_loop(mt, lambda: -mt.mll_spectral(cache, n, t), iters,
                         lr)
    return adam_loop(mt, lambda: -mt.mll(train_x, log_vols_nt), iters, lr)


def train_volt_multitask(train_x, train_ys, vol_paths, train_iters: int = 400,
                         vol_iters: int = 400, k: int = 25,
                         theta: float = 0.5, mean_func: str = "ewma",
                         lr: float = 0.1, vol_lr: float = 0.01,
                         rank: int = 1, printing: bool = False,
                         generator=None, init_params=None):
    """Per-task Volt price models and one Kronecker multitask vol GP over
    the log vols (the reference's batched ``VoltronGP``, ``VoltronGP.py:
    43-50``).  ``train_ys (T, n)`` prices on the return grid,
    ``vol_paths (T, n)``.  Returns ``(volt_state, mt_vol_state)``; the Volt
    state carries the task axis as its batch.  ``generator`` draws the task
    factor's init; ``init_params`` (``{"volt": ..., "vol": ...}``, e.g. the
    JAX package's) replaces the inits."""
    log_ys = torch.log(train_ys)
    num_tasks = log_ys.shape[0]
    init_params = init_params or {}
    volt = VoltGP(mean=make_mean(mean_func, k=k, theta=theta))
    volt.init((num_tasks,), log_ys.dtype, log_ys.device, generator)
    if "volt" in init_params:
        load_jax_params(volt, init_params["volt"], log_ys.device)
    losses = _fit_volt(volt, train_x, log_ys, vol_paths, train_iters, lr)
    if printing:
        print("data-model final losses:", losses[-1].tolist()
              if train_iters else "(no iters)")
    mt = MultitaskBMGP(num_tasks=num_tasks, rank=rank)
    if "vol" in init_params:
        load_jax_params(mt, init_params["vol"], log_ys.device)
    else:
        mt.init(log_ys.dtype, log_ys.device, generator)
    log_vols_nt = torch.log(vol_paths).T  # (n, T)
    _fit_multitask_vol(mt, train_x, log_vols_nt, vol_iters, vol_lr,
                       _is_equispaced(train_x))
    volt_state = VoltState(module=volt, train_x=train_x, train_y=log_ys,
                           log_vol_path=torch.log(vol_paths))
    return volt_state, mt.fit_state(train_x, log_vols_nt)


# Reference-style aliases
LearnGPCV = learn_gpcv
TrainVolModel = train_vol_model
TrainDataModel = train_data_model
TrainVoltMagpieModel = train_volt_magpie
TrainBasicModel = train_basic_model

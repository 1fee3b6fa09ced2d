"""The Kronecker multitask Volt pipeline (the port's
``parallel/pipeline_multitask.py``, trimmed to what the cells run).

``fit_forecast_multitask`` runs, for ``T`` correlated assets on one
device:

1. the joint (Kronecker) GPCV over all tasks: Adam on the ELBO of the
   variational GP and the likelihood together -> the vol paths ``(T, n)``;
2. the multitask vol GP: Adam on its spectral MLL (the closed-form data
   spectrum, projected once a fit; the low-rank task blocks);
3. the per-task Volt data models: Adam on the Kalman MLL (S1 in the
   program, here its scan form) with the EWMA train mean, the task axis
   as the batch;
4. the correlated vol forecast (Matheron's rule) and the per-task Markov
   rollouts, then the quantile fan or the paths.

Per-task ``ok`` flags: a non-finite joint stage fails every task.
:func:`warm_start_multitask` seeds a refit from a previous fit's ``aux``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional
import torch
from ..convert import load_params, params_tree
from ..models.multitask import MultitaskBMGP
from ..models.volt import VoltGP, VoltState, make_mean
from ..rollouts import _rollout_volt_scan
from ..train import (_fit_multitask_vol, _fit_volt, _multitask_gpcv, _multitask_scale, adam_loop, scaled_returns)
from .pipeline import (_StageClock, _check_min_length, _check_spectral_grid, _shift_tail)


@dataclasses.dataclass(frozen=True)
class MultitaskPipelineConfig:
    """Static configuration of the multitask pipeline (the JAX package's
    fields and defaults: k=25, theta=0.5, the single-task iteration and
    learning-rate split).  The kernel is BM: the Matheron sampler and the
    tridiagonal family rest on the Markov min kernel."""

    gpcv_iters: int = 300
    vol_iters: int = 300
    data_iters: int = 300
    rank: int = 1
    mean_func: str = "ewma"
    k: int = 25
    theta: Optional[float] = 0.5
    nsample: int = 1000
    gpcv_lr: float = 0.01
    vol_lr: float = 0.01
    data_lr: float = 0.1
    num_locs: int = 75
    gpcv_q: str = "tridiag"
    gpcv_param: str = "exp"
    vol_mll: str = "spectral"
    output: str = "samples"
    quantile_levels: tuple = (0.025, 0.05, 0.25, 0.5, 0.75, 0.95, 0.975)
    integral_rule: str = "reference"


def _check_config(config: MultitaskPipelineConfig):
    for field, values in (("gpcv_q", ("tridiag",)),
                          ("gpcv_param", ("exp",)),
                          ("vol_mll", ("spectral",)),
                          ("output", ("samples", "quantiles"))):
        if getattr(config, field) not in values:
            raise ValueError(f"the reference runs MultitaskPipelineConfig."
                             f"{field} in {values} only, got "
                             f"{getattr(config, field)!r}")


def fit_forecast_multitask(generator, train_x, train_ys, test_x,
                           config: MultitaskPipelineConfig, init_params=None,
                           noise=None):
    """Fit + forecast ``T`` correlated assets.

    ``train_x (n,)`` is the shared return grid, ``train_ys (T, n+1)`` the
    prices, ``test_x (H,)`` the strictly-future forecast grid, all on one
    device.  ``generator`` draws the random init and the Monte-Carlo
    normals unless ``init_params`` / ``noise`` give them: ``noise =
    {"vol_z": (S, n+H, T), "vol_eps": (S, n, T), "zs": (T, S, H)}`` (the
    Matheron sampler's and the rollout's).

    Returns ``(out, aux)``: ``out`` the paths ``(T, S, H)`` or, with
    ``output="quantiles"``, the fan ``(T, L, H)`` (``aux`` then also holds
    ``forecast_mean``/``forecast_std`` ``(T, H)``).  ``aux``: per-task
    ``ok``, the vol paths ``vols (T, n)``, the final and per-step losses,
    the fitted parameters as nested dicts (the JAX layout:
    ``gpcv_params = {"model", "lik"}``, ``vol_params``, ``volt_params``
    with the task axis) and ``stage_seconds``.

    ``init_params``: ``{"gpcv", "vol", "volt"}``, e.g.
    :func:`warm_start_multitask` of a previous ``aux``.
    """
    _check_config(config)
    _check_min_length(train_x)
    _check_spectral_grid(train_x, config)
    device, dtype = train_ys.device, train_ys.dtype
    num_tasks = train_ys.shape[0]
    clock = _StageClock(device)
    nsample, draw_generator = config.nsample, generator

    # ---- stage 1: joint (Kronecker) GPCV over all T tasks ------------------
    yy = scaled_returns(train_x, train_ys).T  # (n, T)
    packed = _multitask_gpcv(train_x, yy, config.rank, config.gpcv_q,
                             config.gpcv_param, generator,
                             None if init_params is None
                             else init_params["gpcv"])
    gpcv_losses = adam_loop(
        packed, lambda: -packed.model.elbo(train_x, yy, packed.lik,
                                           num_locs=config.num_locs),
        config.gpcv_iters, config.gpcv_lr)
    vols = _multitask_scale(packed)  # (T, n)
    clock.mark("gpcv")

    # ---- stage 2: the multitask vol GP ------------------------------------
    mt_vol = MultitaskBMGP(num_tasks=num_tasks, rank=config.rank)
    if init_params is None:
        mt_vol.init(dtype, device, generator)
    else:
        load_params(mt_vol, init_params["vol"], device)
    log_vols_nt = torch.log(vols).T  # (n, T)
    vol_losses = _fit_multitask_vol(mt_vol, train_x, log_vols_nt,
                                    config.vol_iters, config.vol_lr)
    mt_state = mt_vol.fit_state(train_x, log_vols_nt)
    clock.mark("vol")

    # ---- stage 3: per-task Volt data models (Kalman MLL) -------------------
    volt = VoltGP(mean=make_mean(
        config.mean_func, k=config.k,
        theta=config.theta if config.theta is not None else 0.5),
        integral_rule=config.integral_rule)
    volt.init((num_tasks,), dtype, device, generator)
    if init_params is not None:
        load_params(volt, init_params["volt"], device)
    log_ys = torch.log(train_ys[..., 1:])  # (tasks, n)
    data_losses = _fit_volt(volt, train_x, log_ys, vols, config.data_iters,
                            config.data_lr)
    clock.mark("data")

    # ---- stage 4: correlated vol forecast + per-task Markov rollouts -------
    with torch.no_grad():
        h = test_x.shape[-1]
        log_vol_draws = mt_state.sample_forecast(
            test_x, config.nsample, generator,
            None if noise is None else (noise["vol_z"], noise["vol_eps"]))
        pred_vol = torch.exp(log_vol_draws.movedim(-1, 0))  # (T, S, H)
        if noise is None:
            zs = torch.randn(len(train_ys), nsample, h, dtype=dtype,
                             device=device, generator=draw_generator)
        else:
            zs = noise["zs"]
        use_theta = config.theta is not None
        latent = (torch.mean(torch.log(train_ys), dim=-1) if use_theta
                  else torch.zeros(len(train_ys), dtype=dtype,
                                   device=device))
        volt_state = VoltState(module=volt, train_x=train_x, train_y=log_ys,
                               log_vol_path=torch.log(vols))
        samples = _rollout_volt_scan(volt_state, latent, test_x, pred_vol,
                                     zs, use_theta,
                                     config.theta if use_theta else 0.0)
        bad = ~torch.all(torch.isfinite(samples).flatten(-2), dim=-1)
        ok = (~bad & torch.isfinite(data_losses[-1])
              & torch.isfinite(gpcv_losses[-1])
              & torch.isfinite(vol_losses[-1]))
        if config.output == "quantiles":
            levels = torch.tensor(config.quantile_levels, dtype=dtype,
                                  device=device)
            out = torch.quantile(samples, levels, dim=-2).movedim(0, -2)
        else:
            out = samples
    clock.mark("rollout")

    aux = {
        "ok": ok,
        "vols": vols,
        "gpcv_loss": gpcv_losses[-1],
        "vol_loss": vol_losses[-1],
        "data_losses": data_losses[-1],
        "gpcv_losses": gpcv_losses,
        "vol_losses": vol_losses,
        "data_loss_trajs": data_losses.movedim(0, -1),
        "gpcv_params": params_tree(packed),
        "vol_params": params_tree(mt_vol),
        "volt_params": params_tree(volt),
        "stage_seconds": clock.seconds,
    }
    if config.output == "quantiles":
        aux["forecast_mean"] = torch.mean(samples, dim=-2)
        aux["forecast_std"] = torch.std(samples, dim=-2, correction=0)
    return out, aux


def warm_start_multitask(aux, shift: int = 0, n: int | None = None):
    """``init_params`` for :func:`fit_forecast_multitask` from a previous
    fit's ``aux``.  ``shift=0`` re-seeds the same window; ``shift>0``
    slides it forward ``shift`` ticks at the same length ``n`` (the return
    grid's): the ``(n, T)`` variational mean shifts along its datum axis,
    the tridiagonal factor's interior ``q_log_d`` and ``q_e`` shift (the
    boundary entry stays at the boundary); task-level leaves and the vol and data
    models' parameters carry over."""
    packed = aux["gpcv_params"]
    model = dict(packed["model"])
    if shift:
        if n is None:
            raise ValueError("warm_start_multitask(shift>0) needs n (the "
                             "return-grid length train_x.shape[-1])")
        model["variational_mean"] = _shift_tail(
            model["variational_mean"].mT, shift).mT
        v = model["q_log_d"]
        model["q_log_d"] = torch.cat([_shift_tail(v[..., :-1], shift),
                                      v[..., -1:]], dim=-1)
        model["q_e"] = _shift_tail(model["q_e"], shift)
    return {"gpcv": {"model": model, "lik": packed["lik"]},
            "vol": aux["vol_params"], "volt": aux["volt_params"]}

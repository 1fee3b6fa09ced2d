"""The Kronecker multitask Volt pipeline (port of
:mod:`volt_tpu.parallel.pipeline_multitask`).

``fit_forecast_multitask`` runs, for ``T`` correlated assets on one
device:

1. the joint (Kronecker) GPCV over all tasks: Adam on the ELBO of the
   variational GP and the likelihood together -> the vol paths ``(T, n)``;
2. the multitask vol GP: Adam on its spectral MLL (the closed-form data
   spectrum, projected once a fit; the low-rank task blocks) or its dense
   Kronecker MLL;
3. the per-task Volt data models: Adam on the Kalman MLL (kernel S1 on
   CUDA) with the EWMA train mean (kernel K1 on CUDA), the task axis as
   the batch;
4. the correlated vol forecast (Matheron's rule) and the per-task Markov
   rollouts, then the quantile fan or the paths.

Per-task ``ok`` flags: a non-finite joint stage fails every task.
:func:`warm_start_multitask` seeds a refit from a previous fit's ``aux``.

On a mesh the joint stages (1, 2 and the correlated vol draws of 4) run
alike on every rank, since their coupling is ``T x T``; the per-task Volt
fits and the rollout take the rank's tasks (the ``asset`` axis) and its
share of the paths (the ``path`` axis).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..convert import load_jax_params, params_tree
from ..models.multitask import MultitaskBMGP
from ..models.volt import VoltGP, VoltState, make_mean
from ..rollouts import _rollout
from ..train import (_fit_multitask_vol, _fit_volt, _multitask_gpcv,
                     _multitask_scale, adam_loop, scaled_returns)
from ..utils.profiling import annotate, annotated, stage
from .pipeline import (_check_fields, _check_min_length, _check_spectral_grid,
                       _fan, _local_paths, _shard_rows, _shift_interior,
                       _shift_root, _shift_tail)

__all__ = ["MultitaskPipelineConfig", "fit_forecast_multitask",
           "warm_start_multitask"]


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


_FIELDS = (
    ("gpcv_q", ("tridiag", "full")),
    ("gpcv_param", ("exp", "cv")),
    ("vol_mll", ("spectral", "kalman")),
    ("output", ("samples", "quantiles")),
)


@annotated("call")
def fit_forecast_multitask(generator, train_x, train_ys, test_x,
                           config: MultitaskPipelineConfig, init_params=None,
                           noise=None, mesh=None):
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
    with the task axis) and ``stage_seconds`` (as
    :func:`~volt_tpu_torch.parallel.fit_forecast_batch` times them, and
    ``sample_vol``: the correlated vol draws, a part of ``rollout``).

    ``init_params``: ``{"gpcv", "vol", "volt"}``, e.g.
    :func:`warm_start_multitask` of a previous ``aux``.

    ``mesh``: an ``(asset, path)`` :class:`~volt_tpu_torch.parallel.Mesh`;
    every rank passes the global inputs.  ``T`` must divide by the
    ``asset`` axis and ``nsample`` by the ``path`` axis.  The joint GPCV,
    the multitask vol GP and the correlated vol draws run on every rank
    alike (their generator is fixed by ``generator.initial_seed()``); the
    rank fits the Volt models of its ``T / asset`` tasks (``init_params
    ["volt"]`` global, or the rank's block as its ``aux`` holds it) and
    rolls out ``nsample / path`` paths of each (a generator alone: from a
    stream fixed by the seed and its coordinates, so the draws depend on
    the mesh's shape).  ``out`` and the per-task entries of ``aux`` are the
    rank's block, the fan of all the paths; the joint parameters are
    whole.  With ``noise`` the result equals the unsharded call's.
    """
    _check_fields(config, _FIELDS)
    _check_min_length(train_x)
    _check_spectral_grid(train_x, config)
    device, dtype = train_ys.device, train_ys.dtype
    num_tasks = train_ys.shape[0]
    seconds = {}
    nsample, draw_generator = config.nsample, generator
    if mesh is not None:
        nsample = _local_paths(mesh, config.nsample)
        draw_generator = mesh.seeded(generator, ("asset", "path"))
        generator = mesh.seeded(generator, ())

    # ---- stage 1: joint (Kronecker) GPCV over all T tasks ------------------
    with stage("gpcv", seconds, device):
        yy = scaled_returns(train_x, train_ys).T  # (n, T)
        with annotate("init"):
            packed = _multitask_gpcv(train_x, yy, config.rank,
                                     config.gpcv_q, config.gpcv_param,
                                     generator, None if init_params is None
                                     else init_params["gpcv"])
        gpcv_losses = adam_loop(
            packed, lambda: -packed.model.elbo(train_x, yy, packed.lik,
                                               num_locs=config.num_locs),
            config.gpcv_iters, config.gpcv_lr)
        with annotate("scale"):
            vols = _multitask_scale(packed)  # (T, n)

    # ---- stage 2: the multitask vol GP ------------------------------------
    with stage("vol", seconds, device):
        mt_vol = MultitaskBMGP(num_tasks=num_tasks, rank=config.rank)
        with annotate("init"):
            if init_params is None:
                mt_vol.init(dtype, device, generator)
            else:
                load_jax_params(mt_vol, init_params["vol"], device)
        log_vols_nt = torch.log(vols).T  # (n, T)
        vol_losses = _fit_multitask_vol(mt_vol, train_x, log_vols_nt,
                                        config.vol_iters, config.vol_lr,
                                        config.vol_mll == "spectral")
        with annotate("fit_state"):
            mt_state = mt_vol.fit_state(train_x, log_vols_nt)

    # ---- stage 3: per-task Volt data models (Kalman MLL) -------------------
    with stage("data", seconds, device):
        volt = VoltGP(mean=make_mean(
            config.mean_func, k=config.k,
            theta=config.theta if config.theta is not None else 0.5),
            integral_rule=config.integral_rule)
        with annotate("init"):
            volt.init((num_tasks,), dtype, device, generator)
            if mesh is not None:  # the rank's tasks of the whole init
                load_jax_params(volt, _shard_rows(mesh, params_tree(volt),
                                                  num_tasks), device)
            if init_params is not None:
                load_jax_params(volt, init_params["volt"] if mesh is None
                                else _shard_rows(mesh, init_params["volt"],
                                                 num_tasks), device)
        if mesh is not None:
            train_ys, vols = (mesh.shard(a, ("asset",))
                              for a in (train_ys, vols))
        log_ys = torch.log(train_ys[..., 1:])  # (tasks, n)
        data_losses = _fit_volt(volt, train_x, log_ys, vols,
                                config.data_iters, config.data_lr)

    # ---- stage 4: correlated vol forecast + per-task Markov rollouts -------
    with stage("rollout", seconds, device), torch.no_grad():
        h = test_x.shape[-1]
        with stage("sample_vol", seconds, device):
            # every task's and every path's draws, alike on every rank
            log_vol_draws = mt_state.sample_forecast(
                test_x, config.nsample, generator,
                None if noise is None else (noise["vol_z"],
                                            noise["vol_eps"]))
            pred_vol = torch.exp(log_vol_draws.movedim(-1, 0))  # (T, S, H)
            if mesh is not None:
                pred_vol = mesh.shard(pred_vol, ("asset", "path"))
        with annotate("scan"):
            if noise is None:
                zs = torch.randn(len(train_ys), nsample, h, dtype=dtype,
                                 device=device, generator=draw_generator)
            else:
                zs = (noise["zs"] if mesh is None
                      else mesh.shard(noise["zs"], ("asset", "path")))
            volt_state = VoltState(module=volt, train_x=train_x,
                                   train_y=log_ys,
                                   log_vol_path=torch.log(vols))
            samples = _rollout(volt_state, train_ys, test_x, pred_vol, zs,
                               config.theta)
        out, ok, stats = _fan(samples, (data_losses[-1], gpcv_losses[-1],
                                        vol_losses[-1]), config, mesh)

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
        "stage_seconds": seconds,
        **stats,
    }
    return out, aux


@annotated("warm_start")
def warm_start_multitask(aux, shift: int = 0, n: int | None = None):
    """``init_params`` for :func:`fit_forecast_multitask` from a previous
    fit's ``aux``.  ``shift=0`` re-seeds the same window; ``shift>0``
    slides it forward ``shift`` ticks at the same length ``n`` (the return
    grid's): the ``(n, T)`` variational mean shifts along its datum axis,
    the tridiagonal factor's interior ``q_log_d`` and ``q_e`` shift (the
    boundary entry stays at the boundary), the dense ``(n, n)`` root along
    both axes, re-``tril``'d; task-level leaves and the vol and data
    models' parameters carry over."""
    packed = aux["gpcv_params"]
    model = dict(packed["model"])
    if shift:
        if n is None:
            raise ValueError("warm_start_multitask(shift>0) needs n (the "
                             "return-grid length train_x.shape[-1])")
        model["variational_mean"] = _shift_tail(
            model["variational_mean"].mT, shift).mT
        if "q_log_d" in model:
            model["q_log_d"] = _shift_interior(model["q_log_d"], shift)
            model["q_e"] = _shift_tail(model["q_e"], shift)
        if "variational_covar_root" in model:
            model["variational_covar_root"] = _shift_root(
                model["variational_covar_root"], shift)
    return {"gpcv": {"model": model, "lik": packed["lik"]},
            "vol": aux["vol_params"], "volt": aux["volt_params"]}

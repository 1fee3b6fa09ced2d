"""The Volt pipeline with the FBM vol kernel, batched over assets (the
port's ``parallel/pipeline.py``, its FBM branch).

``fit_forecast_batch`` runs, for ``B`` assets at once on one device:

1. GPCV: Adam on the dense family's ELBO against the FBM prior -> the vol
   path;
2. the vol GP: Adam on the dense FBM MLL of ``log(vol)``;
3. the Volt data model: ``reference.vplain``'s Kalman MLL fit with the
   EWMA train mean;
4. the dense posterior vol sampler, ``reference.vplain``'s Markov price
   rollout, then the quantile fan or the paths.

Every tensor has a leading asset axis and each Adam loop minimises the
summed per-asset losses, which updates every asset exactly as its own
Adam would.

Each jitter ladder starts at ``PipelineConfig.jitter``, where the port
takes its computing precision's rung (1e-6 in float32, 1e-8 in float64).
The rung is part of the model, not of its arithmetic: the FBM Gram's first
increment on a grid from 0 has zero variance, so every prior factor climbs
to the first rung, and the KL's first term scales with its inverse.  The
cell's reference therefore runs in float64 with the float32 program's
rung.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reference.vplain.convert import load_params, params_tree
from reference.vplain.models.volt import VoltGP, make_mean
from reference.vplain.parallel.pipeline import _StageClock, _shift_tail
from reference.vplain.rollouts import _rollout_volt_scan, sample_vol_paths
from reference.vplain.train import _fit_volt, adam_loop, scaled_returns

from .chol import default_jitter
from .models import BMGP, GPCVModel


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the pipeline (the port's fields and
    defaults)."""

    gpcv_iters: int = 300
    vol_iters: int = 300
    data_iters: int = 300
    kernel: str = "fbm"
    mean_func: str = "ewma"
    k: int = 300
    theta: Optional[float] = None
    nsample: int = 1000
    gpcv_lr: float = 0.01
    vol_lr: float = 0.01
    data_lr: float = 0.1
    num_locs: int = 75
    gpcv_q: str = "full"
    gpcv_opt: str = "adam"
    vol_mll: str = "kalman"
    output: str = "samples"
    quantile_levels: tuple = (0.025, 0.05, 0.25, 0.5, 0.75, 0.95, 0.975)
    integral_rule: str = "reference"
    jitter: Optional[float] = None  # None: the computing precision's rung


_ONLY = {"kernel": "fbm", "gpcv_q": "full", "gpcv_opt": "adam",
         "vol_mll": "kalman"}


def _resolve_config(config: PipelineConfig) -> PipelineConfig:
    """``ValueError`` for a setting that the FBM cell does not run."""
    for field, value in _ONLY.items():
        if getattr(config, field) != value:
            raise ValueError(f"the reference runs PipelineConfig.{field}="
                             f"{value!r} only, got {getattr(config, field)!r}")
    if config.output not in ("samples", "quantiles"):
        raise ValueError(f"unknown output {config.output!r}")
    make_mean(config.mean_func, k=config.k)  # raises for other means
    return config


def fit_forecast_batch(generator, train_x, train_ys, test_x,
                       config: PipelineConfig, init_params=None, noise=None):
    """Fit + forecast a batch of assets: ``train_x (n,)`` the return grid,
    ``train_ys (B, n+1)`` the prices, ``test_x (H,)`` the strictly-future
    forecast grid; ``noise``: ``{"vol_z": (B, S, H), "zs": (B, S, H)}``,
    the dense vol sampler's and the rollout's standard normals
    (``generator`` is not read).  Returns ``(out, aux)`` as the port's
    ``fit_forecast_batch``; ``init_params`` a warm start
    ``{"gpcv", "vol", "volt"}`` (:func:`warm_start`)."""
    config = _resolve_config(config)
    if train_x.shape[-1] < 11:
        raise ValueError("the pipeline needs at least 11 train points")
    device, dtype = train_ys.device, train_ys.dtype
    batch = train_ys.shape[:-1]
    nsample = config.nsample
    jitter = (default_jitter(dtype) if config.jitter is None
              else config.jitter)
    clock = _StageClock(device)

    def start(module, key, init):
        if init_params is None:
            return init()
        return load_params(module, init_params[key], device)

    # ---- stage 1: GPCV (the dense family, the FBM prior) ------------------
    yy = scaled_returns(train_x, train_ys)
    gpcv = GPCVModel(jitter, num_locs=config.num_locs)
    start(gpcv, "gpcv", lambda: gpcv.init(train_x, yy, per_lane=True))
    gpcv_losses = adam_loop(gpcv, lambda: -gpcv.elbo(train_x, yy),
                            config.gpcv_iters, config.gpcv_lr)
    with torch.no_grad():
        vol = gpcv.predicted_scale()
    clock.mark("gpcv")

    # ---- stage 2: vol GP (the dense FBM MLL) ------------------------------
    log_vol = torch.log(vol)
    bm = BMGP(jitter)
    start(bm, "vol", lambda: bm.init(batch, dtype, device))
    vol_losses = adam_loop(bm, lambda: -bm.mll(train_x, log_vol),
                           config.vol_iters, config.vol_lr)
    vol_state = bm.fit_state(train_x, log_vol)
    clock.mark("vol")

    # ---- stage 3: Volt data model (Kalman MLL) ----------------------------
    log_y = torch.log(train_ys[..., 1:])
    volt = VoltGP(mean=make_mean(config.mean_func, k=config.k),
                  integral_rule=config.integral_rule)
    start(volt, "volt", lambda: volt.init(batch, dtype, device, generator))
    data_losses = _fit_volt(volt, train_x, log_y, vol, config.data_iters,
                            config.data_lr)
    model = volt.fit_state(train_x, log_y, vol, vol_state)
    clock.mark("data")

    # ---- stage 4: the dense vol sampler, the rollout, the fan -------------
    with torch.no_grad():
        use_theta = config.theta is not None
        latent_mean = (torch.mean(torch.log(train_ys), dim=-1) if use_theta
                       else torch.zeros((), dtype=dtype, device=device))
        pred_vol = sample_vol_paths(vol_state, test_x, nsample, None,
                                    noise["vol_z"].movedim(-2, 0),
                                    assume_future=True)
        samples = _rollout_volt_scan(model, latent_mean, test_x, pred_vol,
                                     noise["zs"], use_theta,
                                     config.theta if use_theta else 0.0)
        bad = ~torch.all(torch.isfinite(samples).flatten(-2), dim=-1)
        ok = (~bad & torch.isfinite(gpcv_losses[-1])
              & torch.isfinite(vol_losses[-1])
              & torch.isfinite(data_losses[-1]))
        if config.output == "quantiles":
            levels = torch.tensor(config.quantile_levels, dtype=dtype,
                                  device=device)
            out = torch.quantile(samples, levels, dim=-2).movedim(0, -2)
        else:
            out = samples
    clock.mark("rollout")

    aux = {
        "ok": ok,
        "vol": vol,
        "gpcv_loss": gpcv_losses[-1],
        "vol_loss": vol_losses[-1],
        "data_loss": data_losses[-1],
        "gpcv_losses": gpcv_losses.movedim(0, -1),
        "vol_losses": vol_losses.movedim(0, -1),
        "data_losses": data_losses.movedim(0, -1),
        "volt_params": params_tree(volt),
        "vol_params": params_tree(bm),
        "gpcv_params": params_tree(gpcv),
        "stage_seconds": clock.seconds,
    }
    if config.output == "quantiles":
        aux["forecast_mean"] = torch.mean(samples, dim=-2)
        aux["forecast_std"] = torch.std(samples, dim=-2, correction=0)
    return out, aux


def _shift_root(root, shift: int):
    """Shift a dense root along both axes, then re-``tril`` it."""
    return torch.tril(_shift_tail(_shift_tail(root, shift).mT, shift).mT)


def warm_start(aux, shift: int = 0, n: int | None = None):
    """``init_params`` for :func:`fit_forecast_batch` from a previous fit's
    ``aux``: with ``shift > 0`` (``n`` the return grid's length) the
    per-datum GPCV leaves slide with the window, the new tail starting
    from the last entry, and the dense root ``chol_variational_covar``
    slides along both axes, then is re-``tril``'d; the scalar and the
    vol / data-model parameters carry over unchanged."""
    gpcv = dict(aux["gpcv_params"])
    if shift:
        if n is None:
            raise ValueError("warm_start(shift>0) needs n")
        for k, v in gpcv.items():
            if not torch.is_tensor(v) or v.dim() == 0:
                continue
            if k == "chol_variational_covar":
                gpcv[k] = _shift_root(v, shift)
            elif v.shape[-1] in (n, n - 1):  # per-datum vectors
                gpcv[k] = _shift_tail(v, shift)
    return {"gpcv": gpcv, "vol": aux["vol_params"],
            "volt": aux["volt_params"]}

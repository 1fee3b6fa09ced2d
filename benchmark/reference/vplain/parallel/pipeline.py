"""The whole Volt pipeline, batched over assets (the port's
``parallel/pipeline.py``, trimmed to what the cells run).

``fit_forecast_batch`` runs, for ``B`` assets at once on one device:

1. GPCV: Adam on the tridiagonal-precision ELBO -> the vol path;
2. the vol GP: Adam on the spectral MLL of ``log(vol)``;
3. the Volt data model: Adam on the Kalman MLL (S1 in the program, here
   its scan form), with the EWMA train mean (K1 in the program, here its
   ``conv1d``) computed once outside the loss;
4. the Markov Monte-Carlo rollout, then the quantile fan or the paths.

Every tensor has a leading asset axis and each Adam loop minimises the
summed per-asset losses, which updates every asset exactly as its own
Adam would.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional
import torch
from ..convert import load_params, params_tree
from ..models.bmgp import BMGP
from ..models.gpcv import GPCVModel
from ..models.volt import VoltGP, make_mean
from ..rollouts import _rollout_volt_scan, sample_vol_paths
from ..train import (_fit_bmgp, _fit_gpcv, _fit_volt, _is_equispaced, scaled_returns)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the pipeline (the JAX package's fields and
    defaults)."""

    gpcv_iters: int = 300
    vol_iters: int = 300
    data_iters: int = 300
    kernel: str = "bm"
    mean_func: str = "ewma"
    k: int = 300
    theta: Optional[float] = None
    nsample: int = 1000
    gpcv_lr: float = 0.01
    vol_lr: float = 0.01
    data_lr: float = 0.1
    num_locs: int = 75
    gpcv_q: str = "tridiag"
    gpcv_opt: str = "adam"
    vol_mll: str = "spectral"
    output: str = "samples"
    quantile_levels: tuple = (0.025, 0.05, 0.25, 0.5, 0.75, 0.95, 0.975)
    integral_rule: str = "reference"


_ONLY = {"kernel": "bm", "gpcv_q": "tridiag", "gpcv_opt": "adam",
         "vol_mll": "spectral"}


def _resolve_config(config: PipelineConfig) -> PipelineConfig:
    """``ValueError`` for a setting that the cells do not run."""
    for field, value in _ONLY.items():
        if getattr(config, field) != value:
            raise ValueError(f"the reference runs PipelineConfig.{field}="
                             f"{value!r} only, got {getattr(config, field)!r}")
    if config.output not in ("samples", "quantiles"):
        raise ValueError(f"unknown output {config.output!r}")
    make_mean(config.mean_func, k=config.k)  # raises for other means
    return config


def _check_min_length(train_x):
    """The running-std init pins its first 10 entries to the 11th."""
    n = train_x.shape[-1]
    if n < 11:
        raise ValueError(f"the pipeline needs at least 11 train points (the "
                         f"GPCV running-std init uses the 11th entry), got "
                         f"n={n}")


def _check_spectral_grid(train_x, config: PipelineConfig):
    """The spectral vol MLL assumes an equispaced ``train_x``."""
    if config.vol_mll == "spectral" and not _is_equispaced(train_x):
        raise ValueError("vol_mll='spectral' requires an equispaced train_x")


class _StageClock:
    """Wall seconds per stage; on a CUDA device each mark first waits for
    the device, so a stage's time includes the work it queued."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = {}
        self._last = self._now()

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str):
        now = self._now()
        self.seconds[stage] = now - self._last
        self._last = now


def fit_forecast_batch(generator, train_x, train_ys, test_x,
                       config: PipelineConfig, init_params=None, noise=None):
    """Fit + forecast a batch of assets.

    ``train_x (n,)`` is the return grid, ``train_ys (B, n+1)`` the prices,
    ``test_x (H,)`` the strictly-future forecast grid, all on one device.
    ``generator`` (a ``torch.Generator`` on that device) draws the Monte
    Carlo normals unless ``noise`` gives them:
    ``{"vol_r0": (B, S), "vol_z": (B, S, H), "zs": (B, S, H)}``.

    Returns ``(out, aux)``: ``out`` is the paths ``(B, S, H)`` or, with
    ``output="quantiles"``, the fan ``(B, L, H)`` (``aux`` then also holds
    ``forecast_mean``/``forecast_std`` ``(B, H)``).  ``aux`` holds the
    per-asset ``ok`` flags, the vol path, the final and per-step losses
    ``(B, iters)``, the fitted parameters as nested dicts (the JAX
    pytree layout, leading asset axis) and ``stage_seconds``.

    ``init_params``: optional warm start ``{"gpcv", "vol", "volt"}``, e.g.
    :func:`warm_start` of a previous ``aux``.
    """
    config = _resolve_config(config)
    _check_min_length(train_x)
    _check_spectral_grid(train_x, config)
    fit_generator = draw_generator = generator
    nsample = config.nsample
    device, dtype = train_ys.device, train_ys.dtype
    batch = train_ys.shape[:-1]
    clock = _StageClock(device)

    def start(module, key, init):
        if init_params is None:
            return init()
        return load_params(module, init_params[key], device)

    # ---- stage 1: GPCV ----------------------------------------------------
    yy = scaled_returns(train_x, train_ys)
    gpcv = GPCVModel(kernel=config.kernel, num_locs=config.num_locs,
                     q=config.gpcv_q)
    start(gpcv, "gpcv", lambda: gpcv.init(train_x, yy, per_lane=True))
    gpcv_losses = _fit_gpcv(gpcv, train_x, yy, config.gpcv_iters,
                            config.gpcv_lr)
    with torch.no_grad():
        vol = gpcv.predicted_scale()
    clock.mark("gpcv")

    # ---- stage 2: vol GP (spectral MLL) -----------------------------------
    log_vol = torch.log(vol)
    bm = BMGP(kernel=config.kernel)
    start(bm, "vol", lambda: bm.init(batch, dtype, device))
    vol_losses = _fit_bmgp(bm, train_x, log_vol, config.vol_iters,
                           config.vol_lr)
    vol_state = bm.fit_state(train_x, log_vol)
    clock.mark("vol")

    # ---- stage 3: Volt data model (Kalman MLL) ----------------------------
    log_y = torch.log(train_ys[..., 1:])
    volt = VoltGP(mean=make_mean(config.mean_func, k=config.k),
                  integral_rule=config.integral_rule)
    start(volt, "volt", lambda: volt.init(batch, dtype, device,
                                          fit_generator))
    data_losses = _fit_volt(volt, train_x, log_y, vol, config.data_iters,
                            config.data_lr)
    model = volt.fit_state(train_x, log_y, vol, vol_state)
    clock.mark("data")

    # ---- stage 4: Monte-Carlo rollout -------------------------------------
    with torch.no_grad():
        use_theta = config.theta is not None
        latent_mean = (torch.mean(torch.log(train_ys), dim=-1) if use_theta
                       else torch.zeros((), dtype=dtype, device=device))
        h = test_x.shape[-1]
        vol_noise = (None if noise is None
                     else (noise["vol_r0"], noise["vol_z"]))
        pred_vol = sample_vol_paths(vol_state, test_x, nsample,
                                    draw_generator, vol_noise,
                                    assume_future=True)
        zs = (torch.randn(*batch, nsample, h, dtype=dtype, device=device,
                          generator=draw_generator) if noise is None
              else noise["zs"])
        samples = _rollout_volt_scan(model, latent_mean, test_x, pred_vol,
                                     zs, use_theta,
                                     config.theta if use_theta else 0.0)
        # per-asset failure flag: a diverged asset stays in its own lanes
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


def _shift_tail(a, shift: int):
    """Roll the last axis left by ``shift``, replicating the final entry."""
    pad = a[..., -1:].expand(*a.shape[:-1], shift)
    return torch.cat([a[..., shift:], pad], dim=-1)


def warm_start(aux, shift: int = 0, n: int | None = None):
    """``init_params`` for :func:`fit_forecast_batch` from a previous fit's
    ``aux``.

    ``shift=0`` re-seeds a fit of the same window.  ``shift>0`` slides the
    window forward ``shift`` ticks at the same length (``n``, the return
    grid's length, must be given): per-datum GPCV leaves shift with the
    window, the new tail starting from the last entry; the boundary entry
    of ``q_log_d`` (the bidiagonal factor's last row) stays at the
    boundary; scalar hyperparameters and the vol/data-model parameters
    carry over unchanged.
    """
    gpcv = dict(aux["gpcv_params"])
    if shift:
        if n is None:
            raise ValueError("warm_start(shift>0) needs n (the return-grid "
                             "length train_x.shape[-1])")
        for k, v in gpcv.items():
            if not torch.is_tensor(v) or v.dim() == 0:
                continue
            if k == "q_log_d" and v.shape[-1] == n:
                interior = _shift_tail(v[..., :-1], shift)
                gpcv[k] = torch.cat([interior, v[..., -1:]], dim=-1)
            elif v.shape[-1] in (n, n - 1):  # per-datum vectors
                gpcv[k] = _shift_tail(v, shift)
    return {"gpcv": gpcv, "vol": aux["vol_params"],
            "volt": aux["volt_params"]}

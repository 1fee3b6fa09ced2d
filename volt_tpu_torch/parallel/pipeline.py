"""The whole Volt pipeline, batched over assets (port of
:mod:`volt_tpu.parallel.pipeline`).

``fit_forecast_batch`` runs, for ``B`` assets at once on one device:

1. GPCV: Adam (or NGVI) on the tridiagonal-precision ELBO, or Adam on
   the dense family's (``gpcv_q="full"``) -> the vol path;
2. the vol GP: Adam on the spectral (or Kalman) MLL of ``log(vol)``, or
   with ``kernel="fbm"`` on the dense MLL through the increment-domain
   factor;
3. the Volt data model: Adam on the Kalman MLL (kernel S1 on CUDA), with
   a Magpie train mean (kernel K1 on CUDA) computed once outside the loss;
4. the Markov Monte-Carlo rollout (the FBM kernel's vol paths from the
   dense posterior sampler), then the quantile fan or the paths.

JAX ``vmap``s one asset's program over the batch; here every tensor has a
leading asset axis and each Adam loop minimises the summed per-asset
losses, which updates every asset exactly as its own Adam would.  The
dense GPCV init's and the FBM kernel's Cholesky jitter ladders run per
asset, as each asset's own program does under ``vmap``.

With ``mesh=`` (:func:`volt_tpu_torch.parallel.make_mesh`) each rank fits
its block of assets and rolls out its share of the paths; the fan needs
every path of an asset, so the paths are gathered over the ``path`` axis
before the quantiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..convert import load_jax_params, params_tree
from ..models.bmgp import BMGP
from ..models.gpcv import GPCVModel
from ..models.volt import VoltGP, make_mean
from ..rollouts import _rollout, sample_vol_paths
from ..train import (_fit_bmgp, _fit_gpcv, _fit_volt, _is_equispaced,
                     scaled_returns)
from ..utils.profiling import annotate, annotated, device_constant, stage

__all__ = ["PipelineConfig", "fit_forecast", "fit_forecast_batch",
           "shard_batch", "warm_start"]


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


# (field, its values)
_FIELDS = (
    ("kernel", ("bm", "fbm")),
    ("gpcv_q", ("tridiag", "full")),
    ("gpcv_opt", ("adam", "ngvi")),
    ("vol_mll", ("spectral", "kalman")),
    ("output", ("samples", "quantiles")),
)


def _check_fields(config, fields):
    """``ValueError`` for a field outside its values in ``fields``."""
    for field, values in fields:
        value = getattr(config, field)
        if value not in values:
            raise ValueError(f"{type(config).__name__}.{field} must be one "
                             f"of {values}, got {value!r}")


def _resolve_config(config: PipelineConfig) -> PipelineConfig:
    """The JAX package's downgrades (a non-BM kernel takes the dense GPCV
    family and the Kalman vol MLL; NGVI needs the BM kernel and the
    tridiagonal family, else Adam), then ``ValueError`` for a value the
    JAX package does not know either."""
    if config.kernel != "bm":
        repl = {}
        if config.gpcv_q == "tridiag":
            repl["gpcv_q"] = "full"
        if config.vol_mll == "spectral":
            repl["vol_mll"] = "kalman"
        if repl:
            config = dataclasses.replace(config, **repl)
    if config.gpcv_opt == "ngvi" and (config.kernel != "bm"
                                      or config.gpcv_q != "tridiag"):
        config = dataclasses.replace(config, gpcv_opt="adam")
    _check_fields(config, _FIELDS)
    make_mean(config.mean_func, k=config.k)  # raises for unknown means
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


def shard_batch(mesh, output: str = "samples"):
    """``(in, out)`` layouts of the batched pipeline on an ``(asset, path)``
    mesh, as :meth:`Mesh.shard` / :meth:`Mesh.gather` take them: the
    per-asset inputs split over ``asset``; the paths ``(B, S, H)`` over
    ``(asset, path)``; a quantile fan carries no path axis (the paths were
    reduced) and splits over ``asset`` only.  The layouts name the mesh's
    axes, so they are the same on every mesh."""
    return ("asset",), (("asset",) if output == "quantiles"
                        else ("asset", "path"))


def _shard_rows(mesh, tree, rows: int):
    """The rank's asset rows of every leaf of ``tree``: a leaf with ``rows``
    leading entries is global and split; one with ``rows / asset`` is
    already the rank's block (a sharded call's ``aux``)."""
    if isinstance(tree, dict):
        return {k: _shard_rows(mesh, v, rows) for k, v in tree.items()}
    if tree.shape[0] == rows:
        return mesh.shard(tree, ("asset",))
    if tree.shape[0] * mesh.axis_size("asset") == rows:
        return tree
    raise ValueError(f"a per-asset leaf of {tree.shape[0]} rows fits neither "
                     f"the batch of {rows} nor its shard")


def _local_paths(mesh, nsample: int) -> int:
    paths = mesh.axis_size("path")
    if nsample % paths:
        raise ValueError(f"nsample={nsample} does not split over the "
                         f"{paths}-way 'path' mesh axis")
    return nsample // paths


@annotated("fan")
def _fan(samples, losses, config, mesh):
    """Both entries' tail: ``(out, ok, stats)``, the paths or the fan and
    its ``aux`` entries.  ``ok``: an asset's paths (a diverged asset stays
    in its lanes) and each final loss in ``losses`` finite, a scalar loss
    for every asset."""
    quantiles = config.output == "quantiles"
    if quantiles and mesh is not None:
        samples = mesh.gather(samples, (None, "path"))
    bad = ~torch.all(torch.isfinite(samples).flatten(-2), dim=-1)
    if not quantiles and mesh is not None:
        bad = mesh.all_reduce(bad.to(samples.dtype), "path") > 0
    ok = ~bad
    for loss in losses:
        ok = ok & torch.isfinite(loss)
    if not quantiles:
        return samples, ok, {}
    levels = device_constant("levels", tuple, config.quantile_levels,
                             dtype=samples.dtype, device=samples.device)
    return (torch.quantile(samples, levels, dim=-2).movedim(0, -2), ok,
            {"forecast_mean": torch.mean(samples, dim=-2),
             "forecast_std": torch.std(samples, dim=-2, correction=0)})


@annotated("call")
def fit_forecast_batch(generator, train_x, train_ys, test_x,
                       config: PipelineConfig, init_params=None, noise=None,
                       mesh=None):
    """Fit + forecast a batch of assets.

    ``train_x (n,)`` is the return grid, ``train_ys (B, n+1)`` the prices,
    ``test_x (H,)`` the strictly-future forecast grid, all on one device.
    ``generator`` (a ``torch.Generator`` on that device) draws the Monte
    Carlo normals unless ``noise`` gives them:
    ``{"vol_r0": (B, S), "vol_z": (B, S, H), "zs": (B, S, H)}``; with
    ``kernel="fbm"`` ``vol_z`` are the dense vol sampler's normals and
    ``vol_r0`` is not read.

    Returns ``(out, aux)``: ``out`` is the paths ``(B, S, H)`` or, with
    ``output="quantiles"``, the fan ``(B, L, H)`` (``aux`` then also holds
    ``forecast_mean``/``forecast_std`` ``(B, H)``).  ``aux`` holds the
    per-asset ``ok`` flags, the vol path, the final and per-step losses
    ``(B, iters)``, the fitted parameters as nested dicts (the JAX
    pytree layout, leading asset axis) and ``stage_seconds``, the wall
    seconds of each stage (``utils.profiling.stage``), which wait for the
    card, so each holds the work its stage queued.

    ``init_params``: optional warm start ``{"gpcv", "vol", "volt"}``, e.g.
    :func:`warm_start` of a previous ``aux``.

    ``mesh``: an ``(asset, path)`` :class:`~volt_tpu_torch.parallel.Mesh`.
    Every rank passes the global ``train_ys``, ``init_params`` and
    ``noise`` (or, for ``init_params``, its own block, as its sharded
    ``aux`` gives it to :func:`warm_start`) and takes its rows: ``B`` must
    divide by the ``asset`` axis and ``nsample`` by the ``path`` axis.  It
    fits its ``B / asset`` assets (repeated alike on each rank of the
    ``path`` axis) and rolls out ``nsample / path`` paths of each.
    ``out`` is the rank's block, ``(B / asset, S / path, H)`` paths or the
    ``(B / asset, L, H)`` fan of all the paths (gathered over ``path``
    first), and ``aux`` holds the rank's assets; ``mesh.gather(out,
    shard_batch(mesh, output)[1])`` is the global ``out``.  With ``noise``
    the result equals the unsharded call's.  With a ``generator`` alone a
    rank's draws come from a stream fixed by ``generator.initial_seed()``
    and its coordinates (the initial values by its ``asset`` coordinate,
    the paths by both), so they depend on the mesh's shape, unlike JAX's
    key.
    """
    config = _resolve_config(config)
    _check_min_length(train_x)
    _check_spectral_grid(train_x, config)
    # the initial values' and the paths' generators, and the paths to draw
    fit_generator = draw_generator = generator
    nsample = config.nsample
    if mesh is not None:  # the rank's assets and paths
        rows = train_ys.shape[0]
        nsample = _local_paths(mesh, config.nsample)
        train_ys = mesh.shard(train_ys, ("asset",))
        if init_params is not None:
            init_params = _shard_rows(mesh, init_params, rows)
        if noise is not None:
            noise = {k: mesh.shard(v, ("asset", "path"))
                     for k, v in noise.items()}
        fit_generator = mesh.seeded(generator, ("asset",))
        draw_generator = mesh.seeded(generator, ("asset", "path"))
    device, dtype = train_ys.device, train_ys.dtype
    batch = train_ys.shape[:-1]
    seconds = {}

    def start(module, key, init):
        with annotate("init"):
            if init_params is None:
                return init()
            return load_jax_params(module, init_params[key], device)

    # ---- stage 1: GPCV ----------------------------------------------------
    with stage("gpcv", seconds, device):
        yy = scaled_returns(train_x, train_ys)
        gpcv = GPCVModel(kernel=config.kernel, num_locs=config.num_locs,
                         q=config.gpcv_q)
        start(gpcv, "gpcv", lambda: gpcv.init(train_x, yy, per_lane=True))
        gpcv_losses = _fit_gpcv(gpcv, train_x, yy, config.gpcv_iters,
                                config.gpcv_lr, config.gpcv_opt)
        with torch.no_grad(), annotate("scale"):
            vol = gpcv.predicted_scale()

    # ---- stage 2: vol GP (spectral or Kalman MLL) -------------------------
    with stage("vol", seconds, device):
        log_vol = torch.log(vol)
        bm = BMGP(kernel=config.kernel)
        start(bm, "vol", lambda: bm.init(batch, dtype, device))
        vol_losses = _fit_bmgp(bm, train_x, log_vol, config.vol_iters,
                               config.vol_lr, config.vol_mll == "spectral")
        with annotate("fit_state"):
            vol_state = bm.fit_state(train_x, log_vol)

    # ---- stage 3: Volt data model (Kalman MLL) ----------------------------
    with stage("data", seconds, device):
        log_y = torch.log(train_ys[..., 1:])
        volt = VoltGP(mean=make_mean(config.mean_func, k=config.k),
                      integral_rule=config.integral_rule)
        start(volt, "volt", lambda: volt.init(batch, dtype, device,
                                              fit_generator))
        data_losses = _fit_volt(volt, train_x, log_y, vol,
                                config.data_iters, config.data_lr)
        with annotate("fit_state"):
            model = volt.fit_state(train_x, log_y, vol, vol_state)

    # ---- stage 4: Monte-Carlo rollout -------------------------------------
    with stage("rollout", seconds, device), torch.no_grad():
        h = test_x.shape[-1]
        if noise is None:
            vol_noise = None
        elif config.kernel == "bm":
            vol_noise = (noise["vol_r0"], noise["vol_z"])
        else:  # the dense sampler's normals, (S, B, H)
            vol_noise = noise["vol_z"].movedim(-2, 0)
        with annotate("sample_vol"):
            pred_vol = sample_vol_paths(vol_state, test_x, nsample,
                                        draw_generator, vol_noise,
                                        assume_future=True)
        with annotate("scan"):
            zs = (torch.randn(*batch, nsample, h, dtype=dtype,
                              device=device, generator=draw_generator)
                  if noise is None else noise["zs"])
            samples = _rollout(model, train_ys, test_x, pred_vol, zs,
                               config.theta)
        out, ok, stats = _fan(samples, (gpcv_losses[-1], vol_losses[-1],
                                        data_losses[-1]), config, mesh)

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
        "stage_seconds": seconds,
        **stats,
    }
    return out, aux


def fit_forecast(generator, train_x, train_y, test_x, config: PipelineConfig,
                 init_params=None, noise=None):
    """Fit + forecast one asset: :func:`fit_forecast_batch` on a batch of
    one (``train_y (n+1,)``; ``noise`` and ``init_params`` without the
    asset axis), with the asset axis removed from every output."""
    def add_axis(tree):
        if isinstance(tree, dict):
            return {k: add_axis(v) for k, v in tree.items()}
        return torch.as_tensor(tree)[None]

    def drop_axis(tree):
        if isinstance(tree, dict):
            return {k: drop_axis(v) for k, v in tree.items()}
        return tree[0] if torch.is_tensor(tree) else tree

    out, aux = fit_forecast_batch(
        generator, train_x, train_y[None], test_x, config,
        None if init_params is None else add_axis(init_params),
        None if noise is None else add_axis(noise))
    return out[0], drop_axis(aux)


def _shift_tail(a, shift: int):
    """Roll the last axis left by ``shift``, replicating the final entry."""
    pad = a[..., -1:].expand(*a.shape[:-1], shift)
    return torch.cat([a[..., shift:], pad], dim=-1)


def _shift_interior(q_log_d, shift: int):
    """Shift ``q_log_d``'s interior; its boundary (last) entry stays."""
    return torch.cat([_shift_tail(q_log_d[..., :-1], shift),
                      q_log_d[..., -1:]], dim=-1)


def _shift_root(root, shift: int):
    """Shift a dense root along both axes, then re-``tril`` it."""
    return torch.tril(_shift_tail(_shift_tail(root, shift).mT, shift).mT)


@annotated("warm_start")
def warm_start(aux, shift: int = 0, n: int | None = None):
    """``init_params`` for :func:`fit_forecast_batch` from a previous fit's
    ``aux``.

    ``shift=0`` re-seeds a fit of the same window.  ``shift>0`` slides the
    window forward ``shift`` ticks at the same length (``n``, the return
    grid's length, must be given): per-datum GPCV leaves shift with the
    window, the new tail starting from the last entry; the dense root
    ``chol_variational_covar`` shifts along both data axes, then is
    re-``tril``'d; the boundary entry of ``q_log_d`` (the bidiagonal
    factor's last row) stays at the boundary; scalar hyperparameters and
    the vol/data-model parameters carry over unchanged.
    """
    gpcv = dict(aux["gpcv_params"])
    if shift:
        if n is None:
            raise ValueError("warm_start(shift>0) needs n (the return-grid "
                             "length train_x.shape[-1])")
        for k, v in gpcv.items():
            if not torch.is_tensor(v) or v.dim() == 0:
                continue
            if k == "chol_variational_covar":
                # by name: its last axis is also n
                gpcv[k] = _shift_root(v, shift)
            elif k == "q_log_d" and v.shape[-1] == n:
                gpcv[k] = _shift_interior(v, shift)
            elif v.shape[-1] in (n, n - 1):  # per-datum vectors
                gpcv[k] = _shift_tail(v, shift)
    return {"gpcv": gpcv, "vol": aux["vol_params"],
            "volt": aux["volt_params"]}

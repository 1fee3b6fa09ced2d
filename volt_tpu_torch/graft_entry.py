"""The graft entry points (port of ``__graft_entry__.py``):
one forward step of a fitted Volt model on one device, and a dry run of
the batched pipelines over a mesh of several ranks.

``python -m volt_tpu_torch.graft_entry`` runs the step once on the card
and prints its output shapes.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """``(step, args)``: ``step(*args)`` is the Volt MLL, the vol state, the
    vol sampler and the Markov rollout of a Volt model with an EWMA mean
    (k=25) on a series of n=128 log prices, 32 paths of 16 steps, on
    ``device``; it returns ``(mll, samples (32, 16))``.  On the card it
    runs kernels K1 (the EWMA mean) and S1 (the Kalman MLL and filter)."""
    from .models.bmgp import BMGP
    from .models.volt import VoltGP, make_mean
    from .rollouts import _rollout, sample_vol_paths

    n, h, s = 128, 16, 32
    dt = 1.0 / 252
    device = torch.device(device)
    train_x = torch.arange(n, dtype=torch.float32, device=device) * dt
    test_x = (torch.arange(h, dtype=torch.float32, device=device) * dt
              + train_x[-1] + dt)
    generator = torch.Generator(device=device).manual_seed(0)
    train_y = torch.cumsum(0.01 * torch.randn(n, device=device,
                                              generator=generator),
                           dim=0) + 2.0  # log prices
    vol = torch.full((n,), 0.2, device=device)

    def step(generator, train_x, train_y, vol, test_x):
        with torch.no_grad():
            volt = VoltGP(mean=make_mean("ewma", k=25)).init(
                (), torch.float32, device)
            mll = volt.mll_kalman(train_x, train_y, vol)
            vol_state = BMGP().init((), torch.float32, device).fit_state(
                train_x, torch.log(vol))
            model = volt.fit_state(train_x, train_y, vol, vol_state)
            pred_vol = sample_vol_paths(vol_state, test_x, s, generator,
                                        assume_future=True)
            zs = torch.randn(s, h, device=device, generator=generator)
            samples = _rollout(model, None, test_x, pred_vol, zs, None)
        return mll, samples

    return step, (generator, train_x, train_y, vol, test_x)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(rank, n_devices, device):
    """One rank of :func:`dryrun_multichip`."""
    from .data import sabr_paths
    from .parallel import (MultitaskPipelineConfig, PipelineConfig,
                           fit_forecast_batch, fit_forecast_multitask,
                           make_mesh, price_options_batch, shard_batch,
                           warm_start_multitask)

    path_dim = 2 if n_devices % 2 == 0 else 1
    asset_dim = n_devices // path_dim
    if device == "cuda":  # the ranks spread over the visible cards
        devices = [f"cuda:{r % torch.cuda.device_count()}"
                   for r in range(n_devices)]
        device = devices[rank]
    else:
        devices = [device] * n_devices
    mesh = make_mesh((asset_dim, path_dim), devices=devices, backend="gloo")

    n, h = 48, 4
    n_assets = 2 * asset_dim
    nsample = 4 * path_dim
    cfg = PipelineConfig(gpcv_iters=3, vol_iters=3, data_iters=3, k=10,
                         nsample=nsample, theta=0.01)
    f, _ = sabr_paths(steps=n + 1, seed=0, n_paths=n_assets)
    ys = torch.tensor(f, device=device)
    dt = 1.0 / 252
    train_x = torch.arange(n, dtype=torch.float32, device=device) * dt
    test_x = (torch.arange(h, dtype=torch.float32, device=device) * dt
              + train_x[-1] + dt)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def whole(out, config):
        return mesh.gather(out, shard_batch(mesh, config.output)[1])

    samples, _ = fit_forecast_batch(gen(0), train_x, ys, test_x, cfg,
                                    mesh=mesh)
    _check(samples.shape == (n_assets // asset_dim, nsample // path_dim, h),
           f"shard shape {tuple(samples.shape)}")
    samples = whole(samples, cfg)
    _check(samples.shape == (n_assets, nsample, h)
           and bool(torch.isfinite(samples).all()), "non-finite forecast")

    # the on-device quantile fan, sharded over assets only
    qcfg = dataclasses.replace(cfg, output="quantiles")
    fan, _ = fit_forecast_batch(gen(0), train_x, ys, test_x, qcfg, mesh=mesh)
    fan = whole(fan, qcfg)
    _check(fan.shape == (n_assets, len(qcfg.quantile_levels), h)
           and bool(torch.isfinite(fan).all()), "non-finite quantile fan")

    # the FBM kernel's pipeline (dense q, increment-domain factor)
    fcfg = dataclasses.replace(cfg, kernel="fbm")
    fbm, fbm_aux = fit_forecast_batch(gen(0), train_x, ys, test_x, fcfg,
                                      mesh=mesh)
    fbm = whole(fbm, fcfg)
    _check(fbm.shape == (n_assets, nsample, h)
           and bool(torch.isfinite(fbm).all()), "non-finite FBM forecast")
    _check(bool(fbm_aux["ok"].all()), "FBM lane flagged not-ok")

    # the Kronecker multitask pipeline, tasks over the asset axis, cold
    # and warm
    num_tasks = 2 * asset_dim
    mt_cfg = MultitaskPipelineConfig(gpcv_iters=3, vol_iters=3, data_iters=3,
                                     k=10, nsample=nsample,
                                     output="quantiles")
    mt_fan, mt_aux = fit_forecast_multitask(gen(1), train_x, ys[:num_tasks],
                                            test_x, mt_cfg, mesh=mesh)
    mt_fan = whole(mt_fan, mt_cfg)
    _check(mt_fan.shape == (num_tasks, len(mt_cfg.quantile_levels), h)
           and bool(torch.isfinite(mt_fan).all()), "non-finite mt fan")
    _check(bool(mt_aux["ok"].all()), "mt lane flagged not-ok")
    _, mt_aux2 = fit_forecast_multitask(
        gen(2), train_x, ys[:num_tasks], test_x, mt_cfg, mesh=mesh,
        init_params=warm_start_multitask(mt_aux))
    _check(bool(mt_aux2["ok"].all()), "warm mt refit flagged not-ok")

    # the option-pricing grid, its means summed over the path axis
    strikes = torch.tensor([0.9, 1.0, 1.1], device=device) * torch.exp(
        torch.mean(torch.log(ys[:, -1])))
    out = price_options_batch(gen(2), train_x, ys, test_x, strikes, [1, h - 1],
                              cfg, mesh=mesh)
    values = mesh.gather(out["values"], ("asset",))
    _check(values.shape == (n_assets, 3, 2)
           and bool(torch.isfinite(values).all()), "non-finite option values")
    _check(bool((values >= 0).all()), "negative call value")
    return tuple(mesh.coords)


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0):
    """Run the batched pipelines once at tiny shapes over an ``(n/2, 2)``
    mesh (``(n, 1)`` for odd ``n``) of ``n_devices`` gloo ranks spawned on
    this host: the paths, the quantile fan, the FBM kernel, the multitask
    pipeline cold and warm, and the option grid; shapes and finite values
    checked on every rank.  ``device="cuda"`` spreads the ranks over the
    visible cards (several to a card when there are fewer cards than
    ranks; gloo stages the collectives through host memory), after the
    kernels are built here once; ``device="cpu"`` runs them on the CPU.
    Raises if a rank fails or the world does not finish within ``timeout``
    seconds."""
    from .parallel import spawn_world

    if torch.device(device).type == "cuda":
        from . import native

        native.library()  # built once here, not once in every rank
    coords = spawn_world(_dryrun_rank, n_devices, (n_devices, str(device)),
                         timeout=timeout)
    _check(len(set(coords)) == n_devices, f"mesh coordinates {coords}")


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", [tuple(t.shape) for t in fn(*args)])

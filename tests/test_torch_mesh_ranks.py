"""Rank functions of the sharded parity tests (``tests/test_torch_mesh.py``);
no test is collected here.

Each runs in a process spawned by ``volt_tpu_torch.parallel.spawn_world``,
which imports this module, so it imports torch and the port only, never
JAX, and returns the gathered global results.
"""

import torch

from volt_tpu_torch.parallel import (MultitaskPipelineConfig, PipelineConfig,
                                     fit_forecast_batch,
                                     fit_forecast_multitask, make_mesh,
                                     price_options_batch, shard_batch,
                                     warm_start)


def _lane(mesh, lane, d):
    """One lane on ``mesh`` with the inputs ``d``; returns global tensors."""
    x, f, tx, noise = d["x"], d["f"], d["tx"], d["noise"]
    if lane in ("samples", "quantiles"):
        cfg = PipelineConfig(output=lane, **d["cfg"])
        out, aux = fit_forecast_batch(None, x, f, tx, cfg, noise=noise,
                                      mesh=mesh)
        res = {"out": mesh.gather(out, shard_batch(mesh, lane)[1])}
        for k in ("vol", "gpcv_loss", "vol_loss", "data_loss", "ok"):
            res[k] = mesh.gather(aux[k].float(), ("asset",))
        return res
    if lane == "pricing":
        cfg = PipelineConfig(output="samples", **d["cfg"])
        out = price_options_batch(None, x, f, tx, d["strikes"], d["expiry"],
                                  cfg, realized=d["realized"], noise=noise,
                                  mesh=mesh)
        return {k: mesh.gather(out[k], ("asset",))
                for k in ("values", "forwards", "percentiles")}
    if lane == "warm":
        # a quantiles fit, then a refit of the window slid by one tick from
        # warm_start of the rank's own aux
        cfg = PipelineConfig(output="quantiles", **d["cfg"])
        f = d["f_long"]
        _, aux = fit_forecast_batch(None, x, f[:, :-1], tx, cfg, noise=noise,
                                    mesh=mesh)
        init = warm_start(aux, shift=1, n=x.shape[-1])
        out, _ = fit_forecast_batch(None, x, f[:, 1:], tx,
                                    PipelineConfig(output="quantiles",
                                                   **d["warm_cfg"]),
                                    init_params=init, noise=noise, mesh=mesh)
        return {"out": mesh.gather(out, ("asset",))}
    if lane == "multitask":
        cfg = MultitaskPipelineConfig(**d["mt_cfg"])
        out, aux = fit_forecast_multitask(None, x, d["mt_f"], tx, cfg,
                                          init_params=d["mt_init"],
                                          noise=d["mt_noise"], mesh=mesh)
        return {"out": mesh.gather(out, ("asset",)),
                "vols": mesh.gather(aux["vols"], ("asset",)),
                "gpcv_loss": aux["gpcv_loss"], "vol_loss": aux["vol_loss"],
                "ok": mesh.gather(aux["ok"].float(), ("asset",))}
    if lane == "generator":
        # no noise: the rank's streams come from the seed and its place
        cfg = PipelineConfig(output="samples", **d["cfg"])
        g = torch.Generator().manual_seed(5)
        out, aux = fit_forecast_batch(g, x, f, tx, cfg, mesh=mesh)
        return {"shard": out, "vol": aux["vol"], "coords": mesh.coords,
                "out": mesh.gather(out, ("asset", "path"))}
    raise ValueError(lane)


def run_lanes(rank, world, plan, inputs):
    """``plan``: ``[(axis_sizes, [lane, ...]), ...]``, each mesh made in
    turn on the CPU; returns ``{(axis_sizes, lane): result}``."""
    results = {}
    for axes, lanes in plan:
        mesh = make_mesh(axes, devices=["cpu"] * world)
        for lane in lanes:
            results[(axes, lane)] = _lane(mesh, lane, inputs)
    return results


def fail_on_rank_one(rank):
    if rank == 1:
        raise ValueError("boom")
    return rank

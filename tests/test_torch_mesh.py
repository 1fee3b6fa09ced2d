"""The scale-out layer: ``volt_tpu_torch.parallel.make_mesh``,
``multihost_initialize`` and the ``mesh=`` of ``fit_forecast_batch``,
``price_options_batch`` and ``fit_forecast_multitask``, in worlds of 2
and 4 gloo ranks spawned on this host, against the JAX package's sharded
pipelines on a ``(2, 2)`` mesh of the conftest's virtual devices.

The port is given the normals the JAX pipelines drew
(``torch_parity.jax_pipeline_noise`` / ``jax_multitask_noise``, global
shapes that each rank slices).  Tolerances are the pipeline tests': final
stage losses and the vol path rtol 1e-3, paths and fans rtol 2e-3 / atol
1e-3 (float32 Adam trajectories in two frameworks); option values on the
price scale rtol 2e-3 / atol 1e-3 of the largest strike; the sharded port
against the unsharded port (the same arithmetic on fewer rows) rtol 1e-5,
atol 1e-6 of the largest value."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_ranks as ranks
from test_torch_multitask import jax_multitask_init
from torch_parity import (close, jax_multitask_noise, jax_pipeline_noise,
                          jax_tree_np, t32)

from volt_tpu.data import sabr_paths
from volt_tpu.parallel import MultitaskPipelineConfig as JMTConfig
from volt_tpu.parallel import PipelineConfig as JConfig
from volt_tpu.parallel import fit_forecast_batch as j_fit
from volt_tpu.parallel import fit_forecast_multitask as j_fit_mt
from volt_tpu.parallel import make_mesh as j_make_mesh
from volt_tpu.parallel import price_options_batch as j_price

from volt_tpu_torch import graft_entry
from volt_tpu_torch.parallel import (Mesh, PipelineConfig, fit_forecast_batch,
                                     make_mesh, shard_batch, spawn_world,
                                     warm_start)
from volt_tpu_torch.parallel import mesh as mesh_mod

B, N, H, S, T, DT = 4, 48, 5, 16, 4, 1.0 / 252
CFG = dict(gpcv_iters=12, vol_iters=12, data_iters=12, k=10, nsample=S)
WARM_CFG = dict(CFG, gpcv_iters=4, vol_iters=4, data_iters=4)
MT_CFG = dict(gpcv_iters=12, vol_iters=12, data_iters=12, k=10, nsample=S,
              output="quantiles")
EXPIRY = [1, 4]
TIMEOUT = 240


def _grids():
    x = (np.arange(N, dtype=np.float32) * np.float32(DT)).astype(np.float32)
    tx = (np.arange(H, dtype=np.float32) * np.float32(DT) + x[-1]
          + np.float32(DT)).astype(np.float32)
    return x, tx


@pytest.fixture(scope="module")
def inputs():
    x, tx = _grids()
    f_long, _ = sabr_paths(steps=N + 2, seed=13, n_paths=B)
    f = f_long[:, :N + 1]
    strikes = np.float32([0.9, 1.0, 1.1]) * np.float32(np.median(f[:, -1]))
    realized = f_long[:, -1:].repeat(len(EXPIRY), axis=1)
    key = jax.random.key(0)
    mt_key = jax.random.key(3)
    mt_f = f[:T]
    return {
        "x": x, "tx": tx, "f": f, "f_long": f_long, "strikes": strikes,
        "realized": realized, "key": key, "mt_key": mt_key,
        "port": {
            "x": t32(x), "tx": t32(tx), "f": t32(f), "f_long": t32(f_long),
            "noise": jax_pipeline_noise(key, B, S, H), "cfg": CFG,
            "warm_cfg": WARM_CFG, "strikes": t32(strikes),
            "expiry": EXPIRY, "realized": t32(realized),
            "mt_f": t32(mt_f), "mt_cfg": MT_CFG,
            "mt_init": jax_multitask_init(mt_key, x, mt_f,
                                          JMTConfig(**MT_CFG)),
            "mt_noise": jax_multitask_noise(mt_key, T, N, S, H)},
    }


@pytest.fixture(scope="module")
def jax_runs(inputs, devices):
    """JAX's pipelines sharded over a (2, 2) mesh of virtual devices."""
    mesh = j_make_mesh((2, 2), devices=devices[:4])
    x, tx, f = (jnp.asarray(inputs[k]) for k in ("x", "tx", "f"))
    runs = {}
    for output in ("samples", "quantiles"):
        out, aux = j_fit(inputs["key"], x, f, tx,
                         JConfig(output=output, **CFG), mesh=mesh)
        runs[output] = (np.asarray(out), jax_tree_np(aux))
    price = j_price(inputs["key"], x, f, tx, jnp.asarray(inputs["strikes"]),
                    jnp.asarray(EXPIRY), JConfig(**CFG), mesh=mesh,
                    realized=jnp.asarray(inputs["realized"]))
    runs["pricing"] = {k: np.asarray(price[k])
                       for k in ("values", "forwards", "percentiles")}
    out, aux = j_fit_mt(inputs["mt_key"], x, jnp.asarray(inputs["f"][:T]), tx,
                        JMTConfig(**MT_CFG), mesh=mesh)
    runs["multitask"] = (np.asarray(out), jax_tree_np(aux))
    return runs


@pytest.fixture(scope="module")
def world4(inputs):
    """Every lane on a (2, 2) mesh of 4 gloo ranks."""
    plan = [((2, 2), ["samples", "quantiles", "pricing", "warm",
                      "multitask", "generator"])]
    return spawn_world(ranks.run_lanes, 4,
                       (4, plan, inputs["port"]), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def world2(inputs):
    """The fan on (2, 1) and (1, 2) meshes of 2 gloo ranks, and pricing's
    all-reduce over the path axis."""
    plan = [((2, 1), ["quantiles"]), ((1, 2), ["quantiles", "pricing"])]
    return spawn_world(ranks.run_lanes, 2,
                       (2, plan, inputs["port"]), timeout=TIMEOUT)


def _result(world, axes, lane, rank=0):
    return world[rank][(axes, lane)]


@pytest.mark.parametrize("output", ["samples", "quantiles"])
def test_sharded_pipeline_matches_jax(jax_runs, world4, output):
    jout, jaux = jax_runs[output]
    got = _result(world4, (2, 2), output)
    assert got["out"].shape == jout.shape
    close(got["out"], jout, 2e-3, 1e-3)
    for key in ("vol", "gpcv_loss", "vol_loss", "data_loss"):
        close(got[key], jaux[key], 1e-3)
    assert got["ok"].tolist() == [1.0] * B


@pytest.mark.parametrize("axes", [(2, 1), (1, 2)])
def test_fan_on_other_meshes(jax_runs, world2, axes):
    """The fan is the same function of the inputs on every mesh."""
    jout, _ = jax_runs["quantiles"]
    close(_result(world2, axes, "quantiles")["out"], jout, 2e-3, 1e-3)


@pytest.mark.parametrize("world,axes", [("world4", (2, 2)),
                                        ("world2", (1, 2))])
def test_pricing_sums_over_the_path_axis(request, inputs, jax_runs, world,
                                         axes):
    got = _result(request.getfixturevalue(world), axes, "pricing")
    want = jax_runs["pricing"]
    scale = float(inputs["strikes"].max())
    assert got["values"].shape == (B, 3, len(EXPIRY))
    close(got["values"], want["values"], 2e-3, 1e-3 * scale)
    close(got["forwards"], want["forwards"], 2e-3, 1e-3 * scale)
    # a fraction of the 16 paths: within one path of JAX's
    close(got["percentiles"], want["percentiles"], 0.0, 1.0 / S + 1e-6)


def test_ranks_agree(world4, world2):
    """Every rank ends with the same gathered tensors."""
    for world in (world4, world2):
        for key, res in world[0].items():
            for other in world[1:]:
                for name, value in res.items():
                    if name not in ("shard", "vol", "coords"):
                        close(other[key][name], value, 0.0)


def test_warm_start_on_a_shard(inputs, world4):
    """``warm_start`` of a rank's own ``aux`` seeds its sharded refit as the
    global ``aux`` seeds the unsharded one."""
    d = inputs["port"]
    f = d["f_long"]
    cfg = PipelineConfig(output="quantiles", **CFG)
    _, aux = fit_forecast_batch(None, d["x"], f[:, :-1], d["tx"], cfg,
                                noise=d["noise"])
    want, _ = fit_forecast_batch(
        None, d["x"], f[:, 1:], d["tx"],
        PipelineConfig(output="quantiles", **WARM_CFG),
        init_params=warm_start(aux, shift=1, n=N), noise=d["noise"])
    got = _result(world4, (2, 2), "warm")["out"]
    close(got, want, 1e-5, 1e-6 * float(want.abs().max()))


def test_multitask_sharded_matches_jax(jax_runs, world4):
    jout, jaux = jax_runs["multitask"]
    got = _result(world4, (2, 2), "multitask")
    assert got["out"].shape == jout.shape == (T, 7, H)
    close(got["out"], jout, 2e-3, 1e-3)
    for key in ("vols", "gpcv_loss", "vol_loss"):
        close(got[key], jaux[key], 1e-3)
    assert got["ok"].tolist() == [1.0] * T


def test_generator_streams(world4):
    """With a generator alone the ranks of one asset block fit alike (their
    initial values share a stream) and draw different paths (theirs do
    not); the gathered paths are finite."""
    by = {tuple(r[((2, 2), "generator")]["coords"]): r[((2, 2), "generator")]
          for r in world4}
    for a in (0, 1):
        close(by[(a, 1)]["vol"], by[(a, 0)]["vol"], 0.0)
        assert not torch.equal(by[(a, 1)]["shard"], by[(a, 0)]["shard"])
    out = by[(0, 0)]["out"]
    assert out.shape == (B, S, H) and bool(torch.isfinite(out).all())


def test_dryrun_multichip():
    graft_entry.dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_needs_the_card():
    """By default the dry run is on the card: without one it raises, and
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: test_torch_cuda.py runs it there")
    with pytest.raises(RuntimeError):
        graft_entry.dryrun_multichip(2, timeout=60.0)


# --- single process ----------------------------------------------------------


def test_world_of_one():
    """No process group: the 1x1 mesh on cuda:0 (no collective; nothing
    runs there), and on the CPU the identity for ``shard`` / ``gather``."""
    mesh = make_mesh()
    assert (mesh.shape, mesh.coords, mesh.backend) == ((1, 1), (0, 0), None)
    assert mesh.device == torch.device("cuda", 0)
    cpu = make_mesh(devices=["cpu"])
    t = torch.arange(6.0).reshape(2, 3)
    axes = ("asset", "path")
    close(cpu.shard(t, axes), t, 0.0)
    close(cpu.gather(t, axes), t, 0.0)
    close(cpu.all_reduce(t, "path"), t, 0.0)
    assert shard_batch(cpu, "samples") == (("asset",), ("asset", "path"))
    assert shard_batch(cpu, "quantiles") == (("asset",), ("asset",))


@pytest.mark.parametrize("kw", [{"axis_sizes": (2, 1)},
                                {"axis_sizes": (1, 1, 1)},
                                {"devices": ["cpu"], "backend": "nccl"},
                                {"devices": ["cpu"], "backend": "mpi"},
                                {"devices": ["cpu", "cpu"]}],
                         ids=["too-many-ranks", "three-axes", "nccl-on-cpu",
                              "unknown-backend", "two-devices"])
def test_make_mesh_refuses(kw):
    with pytest.raises(ValueError):
        make_mesh(**kw)


def test_batch_must_split():
    """A batch, a path count or a warm start that the mesh cannot split
    raises before any collective."""
    x, tx = (t32(a) for a in _grids())
    f, _ = sabr_paths(steps=N + 1, seed=13, n_paths=3)
    mesh = Mesh(axis_names=("asset", "path"), shape=(2, 2), coords=(0, 1),
                device=torch.device("cpu"), backend=None, groups={})
    cfg = PipelineConfig(**CFG)
    with pytest.raises(ValueError, match="asset"):
        fit_forecast_batch(None, x, t32(f), tx, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="path"):
        fit_forecast_batch(None, x, t32(f[:2]), tx,
                           dataclasses.replace(cfg, nsample=5), mesh=mesh)
    bad = {"gpcv": {"a": torch.zeros(3)}, "vol": {}, "volt": {}}
    with pytest.raises(ValueError, match="rows"):
        fit_forecast_batch(None, x, t32(f[:2]), tx, cfg, init_params=bad,
                           mesh=mesh)


# --- multihost_initialize's contract ----------------------------------------


@pytest.fixture()
def fake_dist(monkeypatch):
    """``init_process_group`` replaced by a recorder that marks the world
    initialised; the launcher variables cleared."""
    for group in mesh_mod._CLUSTER_ENV_VARS:
        for v in group:
            monkeypatch.delenv(v, raising=False)
    state = {"calls": [], "init": False}

    def init(**kw):
        state["calls"].append(kw)
        state["init"] = True

    monkeypatch.setattr(mesh_mod.dist, "init_process_group", init)
    monkeypatch.setattr(mesh_mod.dist, "is_initialized",
                        lambda: state["init"])
    return state


def test_single_process_is_noop(fake_dist):
    assert mesh_mod.multihost_initialize() is False
    assert fake_dist["calls"] == []


def test_explicit_coordinator_initializes(fake_dist):
    assert mesh_mod.multihost_initialize(
        coordinator_address="10.0.0.1:1234", num_processes=2,
        process_id=0) is True
    call = fake_dist["calls"][0]
    assert call["init_method"] == "tcp://10.0.0.1:1234"
    assert (call["world_size"], call["rank"]) == (2, 0)
    # idempotent: a second call is a no-op
    assert mesh_mod.multihost_initialize(
        coordinator_address="10.0.0.1:1234") is False
    assert len(fake_dist["calls"]) == 1


@pytest.mark.parametrize("env", [{"MASTER_ADDR": "10.0.0.1",
                                  "WORLD_SIZE": "2"},
                                 {"TORCHELASTIC_RUN_ID": "r"},
                                 {"SLURM_JOB_ID": "7"},
                                 {"OMPI_COMM_WORLD_SIZE": "2"}],
                         ids=["master", "torchelastic", "slurm", "ompi"])
def test_cluster_env_triggers_and_errors_propagate(fake_dist, monkeypatch,
                                                   env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def boom(**kw):
        raise RuntimeError("cluster misconfigured")

    monkeypatch.setattr(mesh_mod.dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="misconfigured"):
        mesh_mod.multihost_initialize()


def test_partial_explicit_args_count(fake_dist, monkeypatch):
    # MASTER_ADDR alone is no launcher; num_processes / process_id alone
    # reach init_process_group
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert mesh_mod.multihost_initialize() is False
    assert mesh_mod.multihost_initialize(num_processes=4,
                                         process_id=1) is True
    call = fake_dist["calls"][0]
    assert (call["world_size"], call["rank"]) == (4, 1)
    assert "init_method" not in call


def test_force_detect(fake_dist):
    assert mesh_mod.multihost_initialize(detect="force") is True
    assert len(fake_dist["calls"]) == 1
    with pytest.raises(ValueError, match="detect"):
        mesh_mod.multihost_initialize(detect="nope")


def test_spawn_world_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_world(ranks.fail_on_rank_one, 2, timeout=TIMEOUT)

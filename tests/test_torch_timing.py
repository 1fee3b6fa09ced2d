"""The port's timing tools (``volt_tpu_torch/tools/``: ``ablate_stages``,
``bench_refit``, ``bench_refit_multitask``, ``bench_multitask``,
``bench_scaling``, ``scaling_study``, ``bench_fbm``, ``bench_voltcov``,
``bench_compile``) against the JAX package's (``tools/*.py``) on the CPU:
each ``main`` at tiny flags with ``--device cpu`` prints the JAX tool's
keys; each tool builds the JAX tool's inputs bit for bit (the JAX tool's
own code run with its fits replaced by recorders); the untimed outputs
agree.  ``bench_compile``'s child runs on a copy of the package without
its build directory.

Tolerances: ``bench_multitask``'s last losses rtol 1e-4 (five float32
Adam steps of the same loss in two libraries); the refit tools'
``vol_rel_err_mean`` / ``vol_rel_err_max`` atol 3e-3: each is a relative
distance of two vol paths, each path within the pipeline's vol
tolerance (1e-3 relative, ``test_torch_eval.py``) of JAX's, and the JAX
tools round to 1e-4.  Sizes stay tiny (B <= 3, ntrain <= 96, <= 30
steps)."""

import dataclasses
import importlib
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu.data import sabr_paths as jax_sabr_paths
from volt_tpu.likelihoods import VolatilityGaussianLikelihood as JaxLik
from volt_tpu.models import multitask as jmt
from volt_tpu.train import _adam_scan

from volt_tpu_torch.data import sabr_paths
from volt_tpu_torch.tools import ablate_stages as tab
from volt_tpu_torch.tools import bench_multitask as tbm
from volt_tpu_torch.tools import bench_scaling as tbs

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import ablate_stages as jab  # noqa: E402  (the JAX tools)
import bench_multitask as jbm  # noqa: E402
import bench_refit as jbr  # noqa: E402
import bench_refit_multitask as jbrm  # noqa: E402
import bench_scaling as jbs  # noqa: E402

# each tool's tiny flags (the JAX tests' in tests/test_tools.py) and the
# environment it reads
TINY = {
    "ablate_stages": (["2", "64"], {"ABLATE_ITERS": "2",
                                    "ABLATE_NSAMPLE": "8"}),
    "bench_refit": (["--assets", "2", "--ntrain", "64", "--horizon", "8",
                     "--iters", "30", "--warm-iters", "3", "--nsample", "8",
                     "--reps", "1"], {}),
    "bench_refit_multitask": (["--tasks", "3", "--ntrain", "96", "--iters",
                               "5", "--warm-iters", "2", "--nsample", "8",
                               "--horizon", "6", "--reps", "1"], {}),
    "bench_multitask": (["--tasks", "3", "--n", "64", "--iters", "2",
                         "--nsample", "4", "--horizon", "8", "--repeats",
                         "1"], {}),
    "bench_scaling": (["--sizes", "64", "--iters", "2", "--nsample", "8",
                       "--reps", "1"], {}),
    "scaling_study": ([], {"SCALE_ASSETS": "2", "SCALE_NTRAIN": "64",
                           "SCALE_ITERS": "2", "SCALE_NSAMPLE": "8"}),
    "bench_fbm": (["--ntrain", "64", "--assets", "2", "--horizon", "8",
                   "--nsample", "8", "--iters", "2", "--repeats", "1"], {}),
    "bench_voltcov": (["--batch", "2", "--n", "64", "--reps", "2"], {}),
}

# the keys of the JAX tools' JSON lines (tools/*.py); each port line adds
# its first call's time
JAX_KEYS = {
    "bench_refit": {"stage", "assets", "ntrain", "backend", "cold_ms",
                    "warm_ms", "speedup", "iters", "warm_iters", "shift",
                    "vol_rel_err_mean", "vol_rel_err_max", "ok"},
    "bench_fbm": {"kernel", "ntrain", "assets", "iters_per_stage",
                  "batch_sec", "assets_per_sec", "warm_compile_sec",
                  "finite", "ok_frac"},
    "bench_voltcov": {"stage", "backend", "batch", "n", "pallas_ms",
                      "xla_ms", "bit_identical"},
    "mt_vol_fit": {"stage", "T", "n", "ms_per_iter", "fit_sec_400iter"},
    "mt_gpcv_fit": {"stage", "T", "n", "q", "ms_per_iter"},
    "mt_vol_forecast": {"stage", "T", "n", "S", "H", "ms_total"},
}
JAX_KEYS["bench_refit_multitask"] = (JAX_KEYS["bench_refit"] - {"assets"}
                                     | {"tasks"})


def _port(name, monkeypatch, *extra):
    argv, env = TINY[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mod = importlib.import_module(f"volt_tpu_torch.tools.{name}")
    return mod.main(["--device", "cpu", *argv, *extra])


def _jax_json(mod, name, monkeypatch, capsys):
    """The last JSON line of the JAX tool ``mod`` at ``TINY[name]``."""
    argv, env = TINY[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


# --- each main at tiny flags -------------------------------------------------


@pytest.mark.parametrize("name", sorted(TINY))
def test_main_runs_on_the_cpu(name, monkeypatch, capsys):
    out = _port(name, monkeypatch)
    lines = _lines(capsys)
    if name == "ablate_stages":
        for variant in tab.VARIANTS:
            assert any(ln.startswith(variant) and "first call" in ln
                       for ln in lines), variant
        assert set(out["best_s"]) == set(tab.VARIANTS)
        assert all(np.isfinite(v) for v in out["first_s"].values())
        assert lines[-1].startswith("throughput:")
    elif name == "bench_scaling":
        assert "n=    64" in lines[-1] and "full GPCV" in lines[-1]
        assert out["rows"][0]["first_call_s"] > 0
    elif name == "scaling_study":
        assert lines[-1].startswith("| 64 |") and lines[-1].count("|") == 5
        assert out["rows"][0]["ntrain"] == 64
    elif name == "bench_multitask":
        recs = [json.loads(ln) for ln in lines]
        assert [r["stage"] for r in recs] == ["mt_vol_fit", "mt_gpcv_fit",
                                              "mt_vol_forecast"]
        for rec in recs:
            assert set(rec) == JAX_KEYS[rec["stage"]] | {"first_call_ms"}
        assert recs == out
    else:
        rec = json.loads(lines[-1])
        first = {"bench_fbm": set(),
                 "bench_voltcov": {"route", "pallas_first_ms",
                                   "xla_first_ms"}}.get(
            name, {"cold_first_ms", "warm_first_ms"})
        assert set(rec) == JAX_KEYS[name] | first
        assert (rec == out) if isinstance(out, dict) else (rec == out[-1])
        assert rec.get("backend", "cpu") == "cpu"
        assert rec.get("ok", True) and rec.get("finite", True)


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_tools_run_on_the_card_by_default(name, monkeypatch):
    """Without ``--device`` a tool runs on the card: with no card it
    raises, and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the tools there")
    argv, env = TINY[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mod = importlib.import_module(f"volt_tpu_torch.tools.{name}")
    with pytest.raises((RuntimeError, AssertionError)):
        mod.main(argv)


# --- the JAX tools' inputs, bit for bit ----------------------------------------


class _Recorded(Exception):
    """Raised by a recorder in place of a JAX fit, carrying its input."""


def _recorder(*args, **kwargs):
    raise _Recorded(args, kwargs)


def test_ablate_stages_configs_and_series_are_jax_s(monkeypatch):
    """The JAX tool's variant configs and price windows, recorded at its
    ``fit_forecast_batch``: the port's configs hold the same fields and
    values, its windows the same float32 values."""
    import volt_tpu.parallel as jpar
    import volt_tpu.utils.profiling as jprof

    seen = []

    def record(key, train_x, train_ys, test_x, cfg):
        seen.append((np.asarray(train_ys), cfg))
        return jnp.zeros(1), {}

    monkeypatch.setattr(jpar, "fit_forecast_batch", record)
    monkeypatch.setattr(jprof, "timed_best",
                        lambda fn, repeats=3: (fn(), 1.0))
    monkeypatch.setenv("ABLATE_ITERS", "7")
    monkeypatch.setenv("ABLATE_NSAMPLE", "9")
    monkeypatch.setenv("BENCH_OUTPUT", "quantiles")
    monkeypatch.setattr(sys, "argv", ["ablate_stages.py", "3", "40"])
    jab.main()
    got = tab.configs(7, 9, "quantiles")
    assert len(seen) == len(got) == 5
    for (ys, jcfg), cfg in zip(seen, got.values()):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    f, _ = sabr_paths(steps=40, seed=0, n_paths=3)
    np.testing.assert_array_equal(np.asarray(f, np.float32), seen[0][0])


@pytest.mark.parametrize("ntrain,paths", [(64, 2), (97, 3)])
def test_sabr_windows_are_jax_s(ntrain, paths):
    """``sabr_paths(seed=0)``, which ``ablate_stages``, ``bench_refit``,
    ``bench_refit_multitask``, ``scaling_study`` and ``bench_fbm`` fit."""
    got, v = sabr_paths(steps=ntrain, seed=0, n_paths=paths)
    want, jv = jax_sabr_paths(steps=ntrain, seed=0, n_paths=paths)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(v, np.asarray(jv))


@pytest.mark.parametrize("n", [64, 1500])
def test_bench_scaling_series_is_jax_s(n, monkeypatch):
    """The JAX tool's ``default_rng(0)`` series, recorded where its
    ``run_one`` calls the GPCV fit (the sparse one above n = 1000)."""
    import volt_tpu.train as jtrain

    monkeypatch.setattr(jtrain, "learn_gpcv", _recorder)
    monkeypatch.setattr(jtrain, "learn_gpcv_sparse", _recorder)
    with pytest.raises(_Recorded) as rec:
        jbs.run_one(n)
    np.testing.assert_array_equal(tbs.series(n),
                                  np.asarray(rec.value.args[0][1]))


def test_bench_multitask_inputs_are_jax_s(monkeypatch):
    """The JAX tool's ``log_vols`` and ``yy`` per T, recorded where it
    fits the vol GP state and initialises the GPCV."""

    class VolGP:
        def __init__(self, **kwargs):
            pass

        def init(self):
            return {}

        def fit_state(self, params, train_x, log_vols_nt):
            raise _Recorded(np.asarray(log_vols_nt))

    class VarGP(VolGP):
        def init(self, train_x):
            return {}

        def initialize_variational_parameters(self, params, lik, lp, x, yy):
            raise _Recorded(np.asarray(yy))

    monkeypatch.setattr(jmt, "MultitaskBMGP", VolGP)
    monkeypatch.setattr(jmt, "MultitaskVariationalGP", VarGP)
    want = {}
    for stage in ("rollout", "gpcv"):
        monkeypatch.setattr(sys, "argv", [
            "bench_multitask.py", "--tasks", "3", "--n", "40", "--stages",
            stage])
        with pytest.raises(_Recorded) as rec:
            jbm.main()
        want[stage] = rec.value.args[0]
    log_vols, yy = tbm.inputs(np.random.default_rng(0), 39, 3)
    np.testing.assert_array_equal(log_vols, want["rollout"])
    np.testing.assert_array_equal(yy, want["gpcv"])


# --- the untimed outputs against the JAX tools' --------------------------------


def test_bench_multitask_vol_fit_against_adam_scan():
    """The last of five Adam steps of the Kronecker vol GP's spectral MLL
    at T=3, n=63, from JAX's initial values."""
    n, t, iters = 63, 3, 5
    log_vols, _ = tbm.inputs(np.random.default_rng(0), n, t)
    x = np.arange(n, dtype=np.float32) / 252
    mt = jmt.MultitaskBMGP(num_tasks=t, rank=1)
    p0 = mt.init()
    cache = mt.spectral_cache(j32(x), j32(log_vols))
    want = _adam_scan(lambda q: -mt.mll_spectral(q, cache, n, t), p0, iters,
                      0.01)[1][-1]
    module = tbm.vol_model(t, "cpu", init_params=jax_tree_np(p0))
    got = tbm.fit_vol(module, t32(x), t32(log_vols), iters)[-1]
    close(got, want, 1e-4)
    # the fit starts from a copy: the module keeps its initial values
    close(module.task_kernel.covar_factor,
          np.asarray(p0["task_kernel"]["covar_factor"]), 0.0)


@pytest.mark.parametrize("q", ["full", "tridiag"])
def test_bench_multitask_gpcv_fit_against_adam_scan(q):
    """The last of five Adam steps of the multitask GPCV's negative ELBO
    at T=3, n=63, from JAX's initialised variational parameters."""
    n, t, iters = 63, 3, 5
    _, yy = tbm.inputs(np.random.default_rng(0), n, t)
    x = j32(np.arange(n, dtype=np.float32) / 252)
    lik = JaxLik(param="exp")
    mvg = jmt.MultitaskVariationalGP(num_tasks=t, rank=1, q=q)
    params = mvg.initialize_variational_parameters(mvg.init(x), lik, {}, x,
                                                   j32(yy))
    want = _adam_scan(lambda p: -mvg.elbo(p, x, j32(yy), lik, {}), params,
                      iters, 0.01)[1][-1]
    model, tlik = tbm.gpcv_model(t32(np.asarray(x)), t32(yy), q,
                                 init_params=jax_tree_np(params))
    got = tbm.fit_gpcv(model, tlik, t32(np.asarray(x)), t32(yy), iters)[-1]
    close(got, want, 1e-4)


def test_refit_vol_errors_against_jax(monkeypatch, capsys):
    """The warm refit's vol paths against the cold fit's of the slid
    window: the port's distances are the JAX tool's."""
    want = _jax_json(jbr, "bench_refit", monkeypatch, capsys)
    got = _port("bench_refit", monkeypatch)
    assert got["ok"] and want["ok"]
    for key in ("vol_rel_err_mean", "vol_rel_err_max"):
        np.testing.assert_allclose(got[key], want[key], atol=3e-3,
                                   err_msg=key)


def test_refit_multitask_vol_errors_against_jax(monkeypatch, capsys):
    """As above for the multitask pipeline, whose cold fits draw their
    initial values (the task factors): both start from JAX's, of
    ``key(0)`` on the first window and ``key(1)`` on the slid one."""
    from volt_tpu.parallel import MultitaskPipelineConfig as JConfig

    from test_torch_multitask import jax_multitask_init
    from volt_tpu_torch.parallel import MultitaskPipelineConfig
    from volt_tpu_torch.tools import bench_refit_multitask as tbrm

    want = _jax_json(jbrm, "bench_refit_multitask", monkeypatch, capsys)
    ntrain, shift, tasks, h = 96, 1, 3, 6
    f, _ = sabr_paths(steps=ntrain + shift, seed=0, n_paths=tasks)
    # the JAX tool's grids, from 1/252
    x = np.asarray(jnp.arange(ntrain - 1, dtype=jnp.float32) * (1 / 252)
                   + 1 / 252)
    tx = np.asarray(jnp.arange(h, dtype=jnp.float32) * (1 / 252)
                    + x[-1] + 1 / 252)
    base = dict(nsample=8, output="quantiles", k=min(25, ntrain // 4))
    cold, warm = (dict(gpcv_iters=i, vol_iters=i, data_iters=i, **base)
                  for i in (5, 2))
    inits = (jax_multitask_init(jax.random.key(0), x, f[:, :ntrain],
                                JConfig(**cold)),
             jax_multitask_init(jax.random.key(1), x, f[:, shift:],
                                JConfig(**cold)))
    got = tbrm.refit(t32(f), t32(x), t32(tx), MultitaskPipelineConfig(**cold),
                     MultitaskPipelineConfig(**warm), shift, 1, inits)
    assert got["ok"] and want["ok"]
    for key in ("vol_rel_err_mean", "vol_rel_err_max"):
        np.testing.assert_allclose(got[key], want[key], atol=3e-3,
                                   err_msg=key)


# --- output files and the plain route -----------------------------------------


def test_bench_scaling_writes_its_table_only_when_asked(tmp_path,
                                                       monkeypatch):
    """No file unless ``--out`` names one; its header names the device."""
    monkeypatch.chdir(tmp_path)
    _port("bench_scaling", monkeypatch)
    assert list(tmp_path.iterdir()) == []
    _port("bench_scaling", monkeypatch, "--out", "scaling.md")
    text = (tmp_path / "scaling.md").read_text()
    assert text.startswith("# Sequence-length scaling (cpu)")
    assert "| 64 |" in text and "full GPCV" in text
    assert tbs.device_header("cpu") == "cpu"


def test_bench_voltcov_plain_route_is_bit_identical(monkeypatch):
    out = _port("bench_voltcov", monkeypatch)
    assert out["route"] == "plain" and out["bit_identical"]


# --- bench_compile: a fresh child on a copy of the package ---------------------

COMPILE_TINY = ["--assets", "2", "--ntrain", "60", "--iters", "2",
                "--nsample", "16", "--reps", "1"]
# the JAX tool's keys less ``unroll``, and the build's share
COMPILE_KEYS = {"assets", "ntrain", "backend", "first_s", "steady_ms",
                "build_s"}


def test_bench_compile_child_runs_on_a_copy_without_build(monkeypatch,
                                                           capsys):
    """The child starts in a directory that holds a copy of the package
    without ``_build/`` (so on the card it builds the kernels), imports
    that copy, and prints the JAX tool's keys less ``unroll``, finite;
    on the CPU nothing is built (``build_s`` 0)."""
    import subprocess

    from volt_tpu_torch.tools import bench_compile

    real_run, seen = subprocess.run, []

    def spy(cmd, **kwargs):
        pkg = Path(kwargs["cwd"]) / "volt_tpu_torch"
        seen.append(pkg)
        assert (pkg / "native.py").exists() and (pkg / "csrc").is_dir()
        assert not (pkg / "_build").exists()
        # the child writes the bytecode of what it imports beside it
        env = {k: v for k, v in os.environ.items()
               if k != "PYTHONDONTWRITEBYTECODE"}
        res = real_run(cmd, env=env, **kwargs)
        assert (pkg / "tools" / "__pycache__").is_dir(), res.stderr
        return res

    monkeypatch.setattr(subprocess, "run", spy)
    out = bench_compile.main(["--device", "cpu", *COMPILE_TINY])
    rec = json.loads(_lines(capsys)[-1])
    assert len(seen) == 1 and [rec] == out, out
    assert set(rec) == COMPILE_KEYS
    assert rec["assets"] == 2 and rec["backend"] == "cpu"
    assert rec["first_s"] > 0 and rec["steady_ms"] > 0
    assert rec["build_s"] == 0.0
    assert all(np.isfinite(v) for v in (rec["first_s"], rec["steady_ms"]))


def test_bench_compile_runs_on_the_card_by_default():
    """Without ``--device`` the tool runs on the card: with no card it
    raises before it starts a child."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the tool there")
    from volt_tpu_torch.tools import bench_compile

    with pytest.raises((RuntimeError, AssertionError)):
        bench_compile.main(COMPILE_TINY)


def test_the_tools_import_no_jax():
    """The port's timing tools import neither JAX nor the JAX package."""
    import subprocess

    mods = ", ".join(f"volt_tpu_torch.tools.{name}"
                     for name in [*TINY, "bench_compile"])
    code = (f"import sys, {mods}; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'volt_tpu.'))]; "
            "assert not bad, bad; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr

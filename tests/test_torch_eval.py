"""The port's evaluation tools (``volt_tpu_torch/tools/``) against the JAX
package's (``tools/*.py``), from the same numpy inputs on the CPU: the
metrics, the volt, basic and LSTM lanes on JAX's own draws and initial
values, the option oracle and scores, the gust-energy functionals, the
batched GPCV of ``eval_multitask``, and each tool's ``main`` at tiny flags
with ``--device cpu``.

Tolerances: ``metrics`` rtol 1e-5 (float32 CRPS sums in two libraries;
the rest is the same numpy); the volt lane's paths rtol 2e-3, atol 1e-3
(``test_torch_pipeline.py``'s, float32 Adam trajectories in two
libraries); the basic lanes' paths atol 1e-4 of max|log y| and the LSTM
lane's rtol 1e-4 (``test_torch_baselines.py``'s and
``test_torch_lstm.py``'s); the batched GPCV's vol rtol 1e-3
(the pipeline's vol path); the numpy oracle and functionals bit-equal;
the option grids and scores rtol 1e-6.  Sizes stay tiny (W <= 2,
ntrain <= 64, H <= 5, S <= 32, <= 5 steps)."""

import importlib
import json
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_pipeline_noise, jax_tree_np, t32

from volt_tpu.experiments import basic_wind as jbw
from volt_tpu.models import lstm as jl

from volt_tpu_torch.data import corrvol_windows, gbm_windows, sabr_windows
from volt_tpu_torch.tools import eval_compare as tec
from volt_tpu_torch.tools import eval_multitask as tem
from volt_tpu_torch.tools import eval_options as teo

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import eval_compare as jec  # noqa: E402  (the JAX tools)
import eval_multitask as jem  # noqa: E402
import eval_options as jeo  # noqa: E402

W, NTRAIN, H, S, ITERS, K = 2, 64, 5, 16, 5, 10


@pytest.fixture(scope="module")
def gbm():
    return gbm_windows(np.random.default_rng(7), W, NTRAIN, H)


# --- metrics -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_against_jax(seed):
    rng = np.random.default_rng(seed)
    samples = (4.6 + 0.02 * rng.standard_normal((W, 32, H))).astype(
        np.float32)
    truth = 4.6 + 0.02 * rng.standard_normal((W, H))
    got, want = tec.metrics(samples, truth), jec.metrics(samples, truth)
    assert set(got) == set(want) == {"calib_err", "crps", "nll"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5)
    # a tensor on any device is taken as its numpy copy
    assert tec.metrics(torch.from_numpy(samples), truth) == got


# --- the lanes on JAX's draws --------------------------------------------------


@pytest.mark.parametrize("theta", [None, 0.01])
def test_volt_lane_on_jax_draws(gbm, theta):
    want = jec.volt_lane(gbm, NTRAIN, H, ITERS, S, K, theta)
    noise = jax_pipeline_noise(jax.random.key(0), W, S, H)
    got = tec.volt_lane(gbm, NTRAIN, H, ITERS, S, K, theta, device="cpu",
                        noise=noise)
    assert got.shape == (W, S, H)
    close(got, want, 2e-3, 1e-3)


def _jax_basic_draws(prices, kernel_name, ntrain=NTRAIN, h=H, s=S, k=K):
    """JAX's ``basic_lane`` draws: per window ``(key, k_fit, k_s)`` from
    ``key(0)``; the initial tree of ``make_basic_model`` from ``k_fit`` and
    the rollout's ``normal(k_s, (h, s))``, as ``(s, h)``."""
    train_x = jnp.arange(ntrain - 1, dtype=jnp.float32) * jec.DT
    key, inits, zs = jax.random.key(0), [], []
    for widx in range(prices.shape[0]):
        log_y = jnp.log(j32(prices[widx, :ntrain])[1:])
        key, k_fit, k_s = jax.random.split(key, 3)
        if kernel_name == "sm":
            kernel = jbw.SpectralMixtureKernel(num_mixtures=10)
        else:
            kernel = jbw.ScaleKernel(jbw._KERNELS[kernel_name]())
        module = jbw.BasicGP(kernel, jbw._make_mean("ewma", k))
        params = module.init(key=k_fit)
        if kernel_name == "sm":
            params["kernel"] = kernel.initialize_from_data(
                params["kernel"], train_x, log_y, key=k_fit)
        inits.append(jax_tree_np(params))
        zs.append(t32(jax.random.normal(k_s, (h, s), jnp.float32)).T)
    return inits, zs


@pytest.mark.parametrize("kernel_name", ["matern", "sm"])
def test_basic_lane_on_jax_draws(gbm, kernel_name):
    want = jec.basic_lane(gbm, NTRAIN, H, ITERS, S, K, kernel_name)
    inits, zs = _jax_basic_draws(gbm, kernel_name)
    got = tec.basic_lane(gbm, NTRAIN, H, ITERS, S, K, kernel_name,
                         device="cpu", init_params=inits, zs=zs)
    assert got.shape == (W, S, H)
    close(got, want, 0.0, 1e-4 * float(np.abs(np.log(gbm)).max()))


def test_lstm_lane_on_jax_draws(gbm):
    """JAX's ``lstm_lane`` draws: per window ``(key, k_fit, k_s)``; in
    ``_train`` ``(k_init, key)`` and one permutation key per epoch; the
    forecast one normal key per step."""
    epochs, seq_len = 2, 20
    prices = gbm[:1]
    want = jec.lstm_lane(prices, NTRAIN, H, epochs, S)
    log_y = np.log(prices[0, :NTRAIN].astype(np.float32))
    _, k_fit, k_s = jax.random.split(jax.random.key(0), 3)
    k_init, k_perm = jax.random.split(k_fit)
    windows, _ = jl.make_windows(j32(log_y), seq_len)
    init = jl._Net(64, 1).init(k_init, windows[:2])["params"]
    n = log_y.shape[-1] - 1
    perms = torch.as_tensor(np.stack([
        np.asarray(jax.random.permutation(k, n))
        for k in jax.random.split(k_perm, epochs)]))
    zs = t32(np.stack([np.asarray(jax.random.normal(k, (S,)))
                       for k in jax.random.split(k_s, H)])).T
    got = tec.lstm_lane(prices, NTRAIN, H, epochs, S, device="cpu",
                        init_params=[jax_tree_np(init)], perms=[perms],
                        zs=[zs])
    assert got.shape == (1, S, H)
    close(got, want, 1e-4)


# --- eval_options ------------------------------------------------------------


def test_black76_and_sabr_continue_bit_equal():
    rng = np.random.default_rng(3)
    fwd = rng.uniform(40, 60, (3, 1, 2))
    k = np.array([0.95, 1.0, 1.05])[None, :, None] * 50.0
    v = np.array([0.002, 0.01])[None, None, :]
    np.testing.assert_array_equal(teo.black76(fwd, k, v),
                                  jeo.black76(fwd, k, v))
    f_last, v_last = rng.uniform(5, 20, 2), rng.uniform(0.1, 0.5, 2)
    np.testing.assert_array_equal(
        teo.sabr_continue(f_last, v_last, H, 8, 1 / 300, 5),
        jeo.sabr_continue(f_last, v_last, H, 8, 1 / 300, 5))


def test_grids_and_score_against_jax():
    rng = np.random.default_rng(4)
    px = 50 * np.exp(0.05 * rng.standard_normal((32, 3)))
    strikes = teo.MONEYNESS * 50.0
    for got, want in zip(teo.grids_from_paths(px, strikes),
                         jeo.grids_from_paths(px, strikes)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    log_samples = np.log(50) + 0.05 * rng.standard_normal((W, 32, H))
    s_last = np.array([50.0, 48.0])
    expiry_idx = np.array([1, 4])
    cf_call = rng.uniform(1, 3, (W, 3, 2))
    cf_put = rng.uniform(1, 3, (W, 3, 2))
    fwd = rng.uniform(47, 51, (W, 2))
    args = (log_samples, s_last, expiry_idx, cf_call, cf_put, fwd)
    got, want = teo.score(*args), jeo.score(*args)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)


@pytest.mark.parametrize("universe", ["GBM", "SABR"])
def test_oracle_lane_equals_jax(universe, capsys):
    """The oracle-mc lane (numpy paths, the port's price grids) scores as
    the JAX tool's does on the same universe."""
    flags = dict(universe=universe, windows=W, ntrain=NTRAIN, horizon=H,
                 nsample=32, oracle_paths=64, iters=ITERS, basic_iters=ITERS,
                 lstm_epochs=2, k=K, expiries="1,4", lanes="oracle-mc")
    jeo.main(Namespace(**flags))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = teo.main(["--device", "cpu", "--universe", universe, "--windows",
                    str(W), "--ntrain", str(NTRAIN), "--horizon", str(H),
                    "--nsample", "32", "--oracle-paths", "64",
                    "--expiries", "1,4", "--lanes", "oracle-mc"])
    for name in ("mae_bps", "bias_bps", "atm_rel", "fwd_bps",
                 "straddle_rel"):
        np.testing.assert_allclose(got["oracle-mc"][name], want[name],
                                   rtol=1e-6)


# --- eval_multitask ----------------------------------------------------------


def test_gust_energy_and_functional_metrics_bit_equal():
    rng = np.random.default_rng(5)
    samples = 4.6 + 0.02 * rng.standard_normal((3, S, H))
    truth = 4.6 + 0.02 * rng.standard_normal((3, H))
    last = 4.6 + 0.02 * rng.standard_normal(3)
    np.testing.assert_array_equal(tem.gust_energy(samples, last),
                                  jem.gust_energy(samples, last))
    assert tem.gust_energy(truth, last) == jem.gust_energy(truth, last)
    g_s = rng.uniform(0, 1e-3, (W, S))
    g_t = rng.uniform(0, 1e-3, W)
    assert tem.functional_metrics(g_s, g_t) == \
        jem.functional_metrics(g_s, g_t)


def test_batched_gpcv_against_jax():
    prices = corrvol_windows(np.random.default_rng(23), 1, 3, 40, H)[0,
                                                                      :, :40]
    x = np.arange(39, dtype=np.float32) / 252
    want = jem.batched_gpcv(j32(x), prices, ITERS)
    got = tem.batched_gpcv(t32(x), t32(prices), ITERS)
    assert got.shape == (3, 39)
    close(got, want, 1e-3)


# --- each tool's main at tiny flags ------------------------------------------

TINY = {
    "eval_compare": ["--windows", "2", "--ntrain", "64", "--horizon", "5",
                     "--nsample", "16", "--iters", "3", "--basic_iters", "3",
                     "--lstm_epochs", "2", "--k", "10"],
    "eval_options": ["--universe", "SABR", "--windows", "2", "--ntrain",
                     "64", "--horizon", "5", "--nsample", "32",
                     "--oracle-paths", "64", "--iters", "3", "--basic_iters",
                     "3", "--lstm_epochs", "2", "--k", "10", "--expiries",
                     "1,4"],
    "eval_multitask": ["--windows", "1", "--tasks", "2", "--ntrain", "40",
                       "--horizon", "5", "--nsample", "16", "--iters", "3",
                       "--vol-iters", "3", "--k", "10"],
    "wind_sweep": ["--windows", "2", "--ntrain", "64", "--horizon", "5",
                   "--nsample", "16", "--iters", "3", "--ks", "10,20",
                   "--thetas", "0.05,none"],
    "robustness_sweep": ["--seeds", "1", "2", "--assets", "2", "--ntrain",
                         "64", "--iters", "2", "--nsample", "8"],
    "eval_integral_rule": ["--assets", "3", "--ntrain", "60", "--horizon",
                           "5", "--iters", "5", "--nsample", "32"],
    "sparse_quality": ["--n", "64", "--ms", "16", "--iters", "3",
                       "--spot-n", "56"],
    "gpcv_convergence": ["--ns", "48", "--lrs", "0.01,0.03", "--chunks",
                         "3,2", "--opt", "adam"],
}


def _check(name, out):
    """The shape of each tool's result (what its JSON lines carry)."""
    if name == "eval_compare":
        assert set(out) == {"GBM", "SABR", "WIND", "WINDGUST"}
        assert all(set(rows) == {"volt-ewma", "matern-ewma", "sm-ewma",
                                 "lstm"} for rows in out.values())
        return [v for rows in out.values() for m in rows.values()
                for v in m.values()]
    if name == "eval_options":
        assert set(out) == {"oracle-mc", "volt-ewma", "matern-ewma",
                            "sm-ewma", "lstm"}
        return [v for m in out.values() for v in m.values()]
    if name == "eval_multitask":
        assert set(out) == {"independent", "multitask", "verdict"}
        return [v for lane in ("independent", "multitask")
                for part in ("marginal", "gust_energy")
                for v in out[lane][part].values()]
    if name == "wind_sweep":
        assert [(r["k"], r["theta"]) for r in out] == \
            [(10, 0.05), (10, None), (20, 0.05), (20, None)]
        return [r[m] for r in out for m in ("calib_err", "crps", "nll")]
    if name == "robustness_sweep":
        assert out["total"] == 4 and out["ok_rate"] == 1.0
        assert all(r["fan_finite"] for r in out["seeds"])
        return [out["ok_rate"]]
    if name == "eval_integral_rule":
        assert out["reference"]["ok_frac"] == 1.0
        return [out["verdict"][k] for k in out["verdict"]]
    if name == "sparse_quality":
        assert out["spot"]["n"] == 56
        return [out["dense"]["rel_err"], out["sparse"]["16"]["rel_err"],
                out["spot"]["rel_err"]]
    assert [r["lr"] for r in out["runs"]] == [0.01, 0.03]
    assert out["runs"][0]["trace"][-1]["iters"] == 5
    return [t[m] for r in out["runs"] for t in r["trace"]
            for m in ("rel_err", "elbo")]


@pytest.mark.parametrize("name", sorted(TINY))
def test_main_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module(f"volt_tpu_torch.tools.{name}")
    out = mod.main(["--device", "cpu", *TINY[name]])
    assert np.isfinite(np.asarray(_check(name, out), np.float64)).all()
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(next(ln for ln in lines if ln.startswith("{")))


def test_eval_compare_writes_its_table_only_when_asked(tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--windows", "1", "--ntrain", "40",
            "--horizon", "3", "--nsample", "8", "--iters", "2", "--lanes",
            "volt-ewma", "--universes", "GBM"]
    tec.main(argv)
    assert list(tmp_path.iterdir()) == []
    tec.main([*argv, "--out", "table.md"])
    text = (tmp_path / "table.md").read_text()
    assert "## GBM" in text and "| volt-ewma |" in text


def test_the_tools_run_on_the_card_by_default():
    """Without ``--device`` a tool runs on the card: with no card it
    raises, and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the tools there")
    with pytest.raises((RuntimeError, AssertionError)):
        tec.main(["--windows", "1", "--ntrain", "40", "--horizon", "3",
                  "--nsample", "8", "--iters", "2", "--lanes", "volt-ewma",
                  "--universes", "GBM"])
    with pytest.raises((RuntimeError, AssertionError)):
        importlib.import_module("volt_tpu_torch.tools.sparse_quality").main(
            ["--n", "48", "--ms", "16", "--iters", "2"])


def test_the_reference_covers_the_phase():
    """``jax_reference.json`` holds, for every item the ``evaluation``
    phase runs, each metric's key-0 value, its further keys' values and a
    band no narrower than its floor or three times its spread."""
    ref = json.loads((Path(tec.__file__).parent
                      / "jax_reference.json").read_text())
    assert len(ref["keys"]) >= 4 and ref["jax_version"]
    seen = {(it["tool"], it["universe"], it["lane"]) for it in ref["items"]}
    for want in [("eval_compare", u, "volt-ewma")
                 for u in ("GBM", "SABR", "WINDGUST")] + \
            [("eval_compare", "GBM", lane)
             for lane in ("matern-ewma", "sm-ewma", "lstm")] + \
            [("eval_options", "GBM", lane)
             for lane in ("volt-ewma", "oracle-mc")] + \
            [("eval_multitask", "CORRVOL", lane)
             for lane in ("independent", "multitask")]:
        assert want in seen, want
    for it in ref["items"]:
        for name, m in it["metrics"].items():
            assert len(m["further"]) == len(ref["keys"]) - 1
            assert m["spread"] == max(abs(v - m["key0"])
                                      for v in m["further"])
            if m["gated"]:
                assert m["band"] == max(3 * m["spread"], m["floor"])
            else:
                assert m["why"]


def test_sabr_windows_shared(gbm):
    """The universes the tools score are the JAX package's, bit for bit
    (both packages' tools draw them with the same numpy seeds)."""
    from volt_tpu.data import sabr_windows as jsabr

    np.testing.assert_array_equal(sabr_windows(W, NTRAIN, H),
                                  jsabr(W, NTRAIN, H))

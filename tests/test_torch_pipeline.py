"""The whole slice: ``volt_tpu_torch.parallel.fit_forecast_batch`` against
``volt_tpu.parallel.fit_forecast_batch`` at B=2 on the conftest std shape
(N=72, 60/60/40 iterations, ewma k=20, nsample 64, H=10), the port given
the exact normals the JAX pipeline drew.

Tolerances: final stage losses and the vol path rtol 1e-3, paths and fan
rtol 2e-3 / atol 1e-3 — these are float32 Adam trajectories in two
frameworks, whose roundings differ from the first step on."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, jax_pipeline_noise, jax_tree_np, t32

from volt_tpu.data import sabr_paths
from volt_tpu.parallel import PipelineConfig as JConfig
from volt_tpu.parallel import fit_forecast_batch as j_fit
from volt_tpu.parallel import warm_start as j_warm_start

from volt_tpu_torch.convert import load_jax_params
from volt_tpu_torch.models import GPCVModel
from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast,
                                     fit_forecast_batch, warm_start)
from volt_tpu_torch.parallel.pipeline import _resolve_config
from volt_tpu_torch.train import scaled_returns

B, N, H, S, DT = 2, 72, 10, 64, 1.0 / 252
STD = dict(gpcv_iters=60, vol_iters=60, data_iters=40, k=20, nsample=S)
KEY_SEED = 0


@pytest.fixture(scope="module")
def data():
    f, _ = sabr_paths(steps=N + 1, seed=77, n_paths=B)
    x = (np.arange(N, dtype=np.float32) * np.float32(DT)).astype(np.float32)
    test_x = (np.arange(H, dtype=np.float32) * np.float32(DT) + x[-1]
              + np.float32(DT)).astype(np.float32)
    return x, f, test_x


def _run_jax(data, output, prices=None):
    x, f, test_x = data
    out, aux = j_fit(jax.random.key(KEY_SEED), jnp.asarray(x),
                     jnp.asarray(f if prices is None else prices),
                     jnp.asarray(test_x), JConfig(output=output, **STD))
    return np.asarray(out), jax_tree_np(aux)


def _run_port(data, output, prices=None):
    x, f, test_x = data
    noise = jax_pipeline_noise(jax.random.key(KEY_SEED), B, S, H)
    prices = f if prices is None else prices
    return fit_forecast_batch(None, t32(x), t32(prices), t32(test_x),
                              PipelineConfig(output=output, **STD),
                              noise=noise)


@pytest.fixture(scope="module")
def runs(data):
    return {out: (_run_jax(data, out), _run_port(data, out))
            for out in ("samples", "quantiles")}


@pytest.mark.parametrize("output", ["samples", "quantiles"])
def test_stage_losses_and_vol(runs, output):
    (_, jaux), (_, taux) = runs[output]
    for key in ("gpcv_loss", "vol_loss", "data_loss", "vol"):
        close(taux[key], jaux[key], 1e-3)
    for key in ("gpcv_losses", "vol_losses", "data_losses"):
        iters = STD[key.replace("_losses", "_iters")]
        assert taux[key].shape == jaux[key].shape == (B, iters)


@pytest.mark.parametrize("output", ["samples", "quantiles"])
def test_forecast(runs, output):
    (jout, jaux), (tout, taux) = runs[output]
    assert tout.shape == jout.shape
    close(tout, jout, 2e-3, 1e-3)
    if output == "quantiles":
        assert tout.shape == (B, 7, H)
        for key in ("forecast_mean", "forecast_std"):
            close(taux[key], jaux[key], 2e-3, 1e-3)
    assert taux["ok"].tolist() == [True] * B == jaux["ok"].tolist()


def test_fitted_params(runs):
    (_, jaux), (_, taux) = runs["quantiles"]
    close(taux["vol_params"], jaux["vol_params"], 1e-3, 1e-4)
    close(taux["volt_params"], jaux["volt_params"], 1e-3, 1e-4)
    assert set(taux["gpcv_params"]) == set(jaux["gpcv_params"])
    assert set(taux["stage_seconds"]) == {"gpcv", "vol", "data", "rollout"}


def test_failed_asset_is_isolated(data, runs):
    """A NaN price poisons only its own asset: ``ok`` flags it, as in the
    JAX pipeline, and the other asset's fan is unchanged."""
    _, f, _ = data
    bad = f.copy()
    bad[1, 30] = np.nan
    _, jaux = _run_jax(data, "quantiles", bad)
    tout, taux = _run_port(data, "quantiles", bad)
    assert taux["ok"].tolist() == [True, False] == jaux["ok"].tolist()
    clean, _ = runs["quantiles"][1]
    close(tout[0], clean[0], 0.0)


def test_single_asset_entry(data, runs):
    x, f, test_x = data
    noise = jax_pipeline_noise(jax.random.key(KEY_SEED), B, S, H)
    out, aux = fit_forecast(None, t32(x), t32(f[0]), t32(test_x),
                            PipelineConfig(output="quantiles", **STD),
                            noise={k: v[0] for k, v in noise.items()})
    clean, clean_aux = runs["quantiles"][1]
    assert out.shape == (7, H) and aux["ok"].dim() == 0
    close(out, clean[0], 1e-6, 1e-6)
    close(aux["gpcv_losses"], clean_aux["gpcv_losses"][0], 1e-6, 1e-7)


@pytest.mark.parametrize("shift", [0, 3])
def test_warm_start(runs, shift):
    """Same bookkeeping as the JAX ``warm_start`` on the same trees."""
    (_, jaux), _ = runs["quantiles"]
    tree = {k: jaux[k] for k in ("gpcv_params", "vol_params", "volt_params")}
    want = jax_tree_np(j_warm_start(tree, shift=shift, n=N))
    got = warm_start({k: jax.tree.map(t32, v) for k, v in tree.items()},
                     shift=shift, n=N)
    close(got, want, 0.0)


def test_warm_refit(data, runs):
    x, f, test_x = data
    _, (_, taux) = runs["quantiles"]
    init = warm_start(taux)
    cfg = PipelineConfig(output="quantiles", **{**STD, "gpcv_iters": 5,
                                                "vol_iters": 5,
                                                "data_iters": 5})
    g = torch.Generator().manual_seed(1)
    out, aux = fit_forecast_batch(g, t32(x), t32(f), t32(test_x), cfg,
                                  init_params=init)
    assert aux["ok"].all()
    # the first warm step evaluates the warm-start parameters themselves
    gpcv = load_jax_params(GPCVModel(q="tridiag"), init["gpcv"])
    with torch.no_grad():
        want = -gpcv.elbo(t32(x), scaled_returns(t32(x), t32(f)))
    close(aux["gpcv_losses"][:, 0], want, 1e-6)
    with pytest.raises(ValueError):
        warm_start(taux, shift=1)


@pytest.mark.parametrize("repl", [
    {"gpcv_opt": "ngvi", "gpcv_iters": 8, "vol_mll": "kalman"},
    {"mean_func": "tewma"},
    {"mean_func": "meanrevert", "theta": 0.05},
], ids=["ngvi-kalman", "tewma", "meanrevert-theta"])
def test_ported_options_match(data, repl):
    """NGVI, the Kalman vol MLL and the other Magpie means against the JAX
    pipeline, at the tolerances of the default run above."""
    x, f, test_x = data
    cfg = {**STD, **repl}
    jout, jaux = j_fit(jax.random.key(KEY_SEED), jnp.asarray(x),
                       jnp.asarray(f), jnp.asarray(test_x),
                       JConfig(output="quantiles", **cfg))
    noise = jax_pipeline_noise(jax.random.key(KEY_SEED), B, S, H)
    tout, taux = fit_forecast_batch(None, t32(x), t32(f), t32(test_x),
                                    PipelineConfig(output="quantiles", **cfg),
                                    noise=noise)
    for key in ("gpcv_loss", "vol_loss", "data_loss", "vol"):
        close(taux[key], np.asarray(jaux[key]), 1e-3)
    close(tout, np.asarray(jout), 2e-3, 1e-3)
    assert taux["ok"].all()


@pytest.mark.parametrize("mean", ["linear", "loglinear", "dewma"])
def test_every_mean_runs(data, mean):
    """Every mean the JAX pipeline takes runs here too (the linear means'
    random initial weights come from the generator)."""
    x, f, test_x = data
    cfg = PipelineConfig(output="quantiles", mean_func=mean,
                         **{**STD, "gpcv_iters": 5, "vol_iters": 5})
    g = torch.Generator().manual_seed(0)
    out, aux = fit_forecast_batch(g, t32(x), t32(f), t32(test_x), cfg)
    assert out.shape == (B, 7, H) and aux["ok"].all()
    assert set(aux["volt_params"]["mean"]) == (
        {"weights", "bias"} if "linear" in mean else set())


@pytest.mark.parametrize("field,value,exc", [
    ("gpcv_opt", "sgd", ValueError),
    ("gpcv_q", "full", None),
    # the id this case carried while the value was not ported
    pytest.param("kernel", "fbm", None,
                 id="kernel-fbm-NotImplementedError"),
    ("vol_mll", "dense", ValueError),
    ("mean_func", "nope", ValueError),
    ("output", "paths", ValueError),
])
def test_config_outside_the_slice(data, field, value, exc):
    x, f, test_x = data
    cfg = dataclasses.replace(PipelineConfig(**STD), **{field: value})
    if exc is None:  # ported: the value is taken as it is
        assert getattr(_resolve_config(cfg), field) == value
        return
    with pytest.raises(exc):
        fit_forecast_batch(None, t32(x), t32(f), t32(test_x), cfg)


@pytest.mark.parametrize("case", ["short", "irregular"])
def test_grid_checks(data, case):
    x, f, test_x = data
    if case == "short":
        x, f = x[:10], f[:, :11]
    else:
        x = x.copy()
        x[5] += np.float32(0.3 * DT)
    with pytest.raises(ValueError):
        fit_forecast_batch(None, t32(x), t32(f), t32(test_x),
                           PipelineConfig(**STD))


def test_port_never_imports_jax():
    code = ("import sys, volt_tpu_torch, volt_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'volt_tpu.'))]; "
            "assert not bad, bad; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr

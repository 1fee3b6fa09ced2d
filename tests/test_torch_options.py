"""The option and calibration layer of the port against the JAX package's,
on the same numpy inputs: ``options`` (ECDF, the call and put grids, the
``pricer`` DataFrame), ``calibration`` (percentiles, bands, fan coverage,
interval coverage, CRPS) and ``parallel.price_options_batch``.

Tolerances (float32): the closed forms rtol 1e-5 / atol 1e-6 (of the
largest value where a mean of payoffs cancels); fractions of paths to
the rounding of their float32 mean (rtol 1e-6); ``price_options_batch``'s
grid on the JAX package's own paths rtol 1e-5, and end to end with the
JAX normals at the pipeline's fan tolerance (rtol 2e-3, atol 1e-3 of the
price scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_pipeline_noise, t32

from volt_tpu import calibration as jcal
from volt_tpu import options as jopt
from volt_tpu.data import sabr_paths
from volt_tpu.parallel import PipelineConfig as JConfig
from volt_tpu.parallel import price_options_batch as j_price

import volt_tpu_torch
from volt_tpu_torch import calibration as tcal
from volt_tpu_torch import options as topt
from volt_tpu_torch.parallel import PipelineConfig, price_options_batch
from volt_tpu_torch.parallel.pricing import option_grid

RTOL, ATOL = 1e-5, 1e-6


def _paths(seed, shape, sigma=0.2, mu=4.6):
    return np.random.default_rng(seed).lognormal(mu, sigma, shape).astype(
        np.float32)


# --- options --------------------------------------------------------------

@pytest.mark.parametrize("grid", ["call", "put"])
def test_price_grids(grid):
    paths = _paths(0, (3000, 4))
    strikes = np.linspace(80.0, 120.0, 9).astype(np.float32)
    jf, tf = {"call": (jopt.price_call_grid, topt.price_call_grid),
              "put": (jopt.price_put_grid, topt.price_put_grid)}[grid]
    want = np.asarray(jf(j32(paths), j32(strikes)))
    got = tf(t32(paths), t32(strikes))
    assert got.shape == (9, 4)
    close(got, want, RTOL, ATOL * float(np.abs(want).max()))
    # numpy inputs are taken as they are
    close(tf(paths, strikes), got, 0.0)


def test_put_call_parity():
    paths = _paths(1, (4000, 3), 0.3, 0.0)
    strikes = t32([0.7, 1.0, 1.4])
    calls = topt.price_call_grid(t32(paths), strikes)
    puts = topt.price_put_grid(t32(paths), strikes)
    close(calls - puts, t32(paths).mean(0)[None, :] - strikes[:, None],
          1e-5, 1e-5)


def test_ecdf():
    pxs = _paths(2, (3, 500))
    true = np.array([95.0, 100.0, 105.0], np.float32)
    want = jax.vmap(jopt.ecdf)(j32(pxs), j32(true))
    close(topt.ecdf(t32(pxs), t32(true)[:, None]), want, 1e-6)
    close(topt.ecdf(pxs[0], float(true[0])), want[0], 1e-6)
    assert topt.ECDF is topt.ecdf and topt.Pricer is topt.pricer
    assert volt_tpu_torch.ecdf is topt.ecdf


def _chain(pd, expiries):
    return pd.DataFrame({
        "expiration": expiries,
        "strike": [95.0, 105.0, 100.0][:len(expiries)],
        "bid": [6.0, 1.5, 4.0][:len(expiries)],
        "ask": [6.5, 1.8, 4.5][:len(expiries)]})


@pytest.mark.parametrize("chain", ["quotes", "empty"])
def test_pricer(chain):
    """The DataFrame of the JAX ``pricer``, column by column (numbers at
    rtol 1e-5); an empty chain keeps the schema."""
    pd = pytest.importorskip("pandas")
    paths = _paths(3, (2000, 2), 0.1)
    edays = [pd.Timestamp("2022-01-21"), pd.Timestamp("2022-02-18")]
    if chain == "quotes":
        opts = _chain(pd, [edays[0], edays[0], edays[1]])
    else:
        opts = _chain(pd, [pd.Timestamp("2023-06-16")])
    true = np.array([101.0, 99.0])
    want = jopt.pricer(paths, opts, edays, true, 100.0)
    got = topt.pricer(torch.tensor(paths), opts, edays, torch.tensor(true),
                      100.0)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == (3 if chain == "quotes" else 0)
    for col in want.columns:
        if pd.api.types.is_numeric_dtype(want[col]):
            close(got[col].to_numpy(np.float64),
                  want[col].to_numpy(np.float64), RTOL)
        else:
            assert list(got[col]) == list(want[col])


def test_date_helpers():
    pd = pytest.importorskip("pandas")
    dates = pd.date_range("2022-01-03", periods=30, freq="B")
    spy = pd.DataFrame({"Date": dates,
                        "Close": 100.0 + np.arange(30, dtype=np.float64)})
    d = dates[20]
    close(topt.get_training_data(spy, d, 5).to_numpy(),
          jopt.get_training_data(spy, d, 5).to_numpy(), 0.0)
    assert topt.get_true_value(spy, d, 110.0) == jopt.get_true_value(
        spy, d, 110.0)
    assert topt.get_trading_days(spy, dates[3], d) == 17
    close(topt.find_last_trading_days(spy, [dates[10]]).astype(np.int64),
          jopt.find_last_trading_days(spy, [dates[10]]).astype(np.int64), 0)


# --- calibration ------------------------------------------------------------

@pytest.mark.parametrize("fn", ["sample_percentiles", "calibration",
                                "calibration_levels", "coverage",
                                "curve", "interval_coverage", "crps"])
def test_calibration(fn):
    rs = np.random.default_rng(4)
    samples = rs.standard_normal((400, 12)).astype(np.float32)
    truth = rs.standard_normal(12).astype(np.float32)
    pct = rs.uniform(0.0, 1.0, 200).astype(np.float32)
    levels = np.array([0.1, 0.5, 0.9], np.float32)
    fan = np.sort(rs.standard_normal((3, 5, 12)), axis=1).astype(np.float32)
    fan_truth = rs.standard_normal((3, 12)).astype(np.float32)
    windows = rs.standard_normal((4, 300, 12)).astype(np.float32)
    wtruth = rs.standard_normal((4, 12)).astype(np.float32)
    fan_levels = np.linspace(0.1, 0.9, 5).astype(np.float32)
    want, got = {
        "sample_percentiles": lambda: (
            jcal.sample_percentiles(j32(samples), j32(truth)),
            tcal.sample_percentiles(t32(samples), t32(truth))),
        "calibration": lambda: (jcal.calibration(j32(pct)),
                                tcal.calibration(t32(pct))),
        "calibration_levels": lambda: (
            jcal.calibration(j32(pct), j32(levels)),
            tcal.calibration(t32(pct), levels)),
        "coverage": lambda: (
            jcal.coverage_from_quantiles(j32(fan_levels), j32(fan),
                                         j32(fan_truth)),
            tcal.coverage_from_quantiles(fan_levels, t32(fan),
                                         t32(fan_truth))),
        "curve": lambda: (
            jcal.calibration_curve(list(windows), list(wtruth)),
            tcal.calibration_curve([t32(w) for w in windows],
                                   [t32(t) for t in wtruth])),
        "interval_coverage": lambda: (
            jcal.interval_coverage(windows, wtruth, levels),
            tcal.interval_coverage(t32(windows), t32(wtruth), levels)),
        "crps": lambda: (jcal.crps(j32(samples), j32(truth)),
                         tcal.crps(t32(samples), t32(truth))),
    }[fn]()
    if fn == "interval_coverage":
        assert isinstance(got, np.ndarray)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            close(g, w, RTOL, ATOL)
    else:
        close(got, want, RTOL, ATOL)


# --- price_options_batch -----------------------------------------------------

B, N, H, S, DT = 2, 48, 8, 64, 1.0 / 252
CFG = dict(gpcv_iters=20, vol_iters=20, data_iters=20, k=20, nsample=S)
EXPIRY = [1, 4, 7]


@pytest.fixture(scope="module")
def market():
    f, _ = sabr_paths(steps=N + 1 + H, seed=31, n_paths=B)
    f = f.astype(np.float32)
    x = (np.arange(N, dtype=np.float32) * np.float32(DT)).astype(np.float32)
    test_x = (x[-1] + np.float32(DT) * np.arange(1, H + 1)).astype(np.float32)
    strikes = (np.median(f[:, N]) * np.linspace(0.9, 1.1, 5)).astype(
        np.float32)
    realized = f[:, N + 1 + np.asarray(EXPIRY)]
    return x, f[:, :N + 1], test_x, strikes, realized


@pytest.fixture(scope="module")
def jax_run(market):
    x, f, test_x, strikes, realized = market
    key = jax.random.key(32)
    out = j_price(key, jnp.asarray(x), f, jnp.asarray(test_x), strikes,
                  EXPIRY, JConfig(output="samples", **CFG),
                  realized=realized)
    return key, {k: np.asarray(v) for k, v in out.items() if k != "aux"}


def test_option_grid_on_the_jax_paths(market, jax_run):
    """The payoff reduction on the JAX package's own log paths: values and
    forwards rtol 1e-5, percentiles to their float32 mean's rounding."""
    _, _, _, strikes, realized = market
    _, want = jax_run
    got = option_grid(t32(want["samples"]), strikes, EXPIRY, realized)
    assert got["values"].shape == (B, 5, 3)
    close(got["values"], want["values"], RTOL,
          ATOL * float(want["values"].max()))
    close(got["forwards"], want["forwards"], RTOL)
    close(got["percentiles"], want["percentiles"], 1e-6)


def test_price_options_batch(market, jax_run):
    """End to end with the JAX normals: the paths and the grid at the
    pipeline's fan tolerance; strikes, expiries and realised prices given
    as lists and numpy arrays."""
    x, f, test_x, strikes, realized = market
    key, want = jax_run
    got = price_options_batch(
        None, t32(x), t32(f), t32(test_x), strikes.tolist(), EXPIRY,
        PipelineConfig(output="samples", **CFG), realized=realized,
        noise=jax_pipeline_noise(key, B, S, H))
    assert set(got) == {"values", "forwards", "percentiles", "samples",
                        "aux"}
    assert got["aux"]["ok"].all()
    close(got["samples"], want["samples"], 2e-3, 1e-3)
    scale = float(np.max(strikes))
    close(got["values"], want["values"], 2e-3, 1e-3 * scale)
    close(got["forwards"], want["forwards"], 2e-3)
    # a path within the fan tolerance of the realised price may change side
    assert np.abs(got["percentiles"].numpy() - want["percentiles"]).max() \
        <= 2.0 / S
    vals = got["values"]
    assert (vals >= 0).all() and (vals.diff(dim=1) <= 1e-5 * scale).all()


def test_price_options_batch_refuses_a_fan(market):
    x, f, test_x, strikes, _ = market
    with pytest.raises(ValueError, match="samples"):
        price_options_batch(None, t32(x), t32(f), t32(test_x), strikes,
                            EXPIRY, PipelineConfig(output="quantiles",
                                                   **CFG))

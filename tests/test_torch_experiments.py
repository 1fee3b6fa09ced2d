"""The port's data edges and experiment drivers against the JAX package's:
the universes bit-equal for the same ``np.random`` seed, the ticker lists
and fixtures, the USCRN parser and the CSV reader equal to JAX's on the
vendored fixtures, and every driver and CLI at a tiny size, as
``tests/test_models_experiments.py`` and ``tests/test_ingestion_offline.py``
run the JAX ones, with the same shapes and file names (the CLIs over the
fixtures side by side with JAX's).  The drivers run on the CPU here
because they are asked to (``device="cpu"``); their default is the card."""

import contextlib
import inspect
import io
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from volt_tpu import data as jdata
from volt_tpu.data import universes as juni
from volt_tpu.data import wind as jwind
from volt_tpu.experiments import forecast_generator as jfg
from volt_tpu.experiments import gp_generator as jgg

from volt_tpu_torch import data as tdata
from volt_tpu_torch import experiments as tex
from volt_tpu_torch.data import tickers as ttickers
from volt_tpu_torch.data import universes as tuni
from volt_tpu_torch.data import wind as twind
from volt_tpu_torch.experiments import (forecast_generator as tfg,
                                        generate_preds as tgp,
                                        gp_generator as tgg,
                                        lstm_generator as tlg)

FIX = tdata.fixtures_dir()
CPU = "cpu"


# --- data ---------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("gbm_windows", (3, 20, 5)), ("wind_windows", (3, 20, 5)),
    ("gusty_wind_windows", (3, 20, 5)), ("corrvol_windows", (2, 3, 20, 5))])
def test_universes_bit_equal(name, args):
    got = getattr(tuni, name)(np.random.default_rng(7), *args)
    want = getattr(juni, name)(np.random.default_rng(7), *args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_sabr_windows_bit_equal():
    got = tuni.sabr_windows(3, 20, 5, seed=4, return_vol=True)
    want = juni.sabr_windows(3, 20, 5, seed=4, return_vol=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ticker_lists_and_fixtures():
    jdir = os.path.dirname(jdata.__file__)
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".txt"))
    assert names and names == sorted(
        f for f in os.listdir(os.path.dirname(tdata.__file__))
        if f.endswith(".txt"))
    for name in names:
        assert tdata.make_ticker_list(name) == jdata.make_ticker_list(name)
        assert os.path.exists(tdata.ticker_file_path(name))
    jfix = jdata.fixtures_dir()
    assert sorted(os.listdir(FIX)) == sorted(os.listdir(jfix))
    for name in os.listdir(jfix):
        with open(os.path.join(FIX, name), "rb") as a, \
                open(os.path.join(jfix, name), "rb") as b:
            assert a.read() == b.read(), name
    assert tdata.make_ticker_list(os.path.join(FIX, "offline_tickers.txt")) \
        == ["AAA", "BBB"]


def test_uscrn_parser_against_jax(tmp_path):
    files = [os.path.join(FIX, f) for f in sorted(os.listdir(FIX))
             if f.startswith("CRNS")]
    got = twind.build_wind_dataset_from_files(
        files, out_path=str(tmp_path / "w.p"), expected_rows=288)
    want = jwind.build_wind_dataset_from_files(files, expected_rows=288)
    assert got[0] == want[0] == {0: "NE_Testville_1_SSW"}
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    with open(files[0]) as fh:  # the 100-row partial station is dropped
        assert twind.parse_uscrn_rows(fh.read().splitlines(), 288) is None
    names, lonlat, data = tgg.load_wind(str(tmp_path / "w.p"))
    assert names == got[0]
    np.testing.assert_array_equal(data[0], got[2][0])


def test_synthetic_wind_bit_equal():
    got = tgg.load_wind("", synthetic=True, n_stations=2, ntime=60)
    want = jgg.load_wind("", synthetic=True, n_stations=2, ntime=60)
    assert got[0] == want[0] and got[1] is want[1] is None
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ticker,history", [("AAA", 80), ("BBB", 520),
                                            ("AAA", 900)])
def test_load_prices_csv_against_jax(ticker, history):
    got, dates = tfg.load_prices(ticker, history, csv_dir=FIX)
    want, jdates = jfg.load_prices(ticker, history, csv_dir=FIX)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert dates == jdates and dates[0] < dates[-1]


def test_load_prices_synthetic_fallback(monkeypatch):
    """No CSV and no yfinance: the crc32-seeded synthetic series, equal to
    JAX's; the live ingestion raises a clear ``ImportError``."""
    monkeypatch.setitem(sys.modules, "yfinance", None)
    with pytest.raises(ImportError, match="yfinance"):
        ttickers.get_stock_history("AAA")
    for kw in ({"synthetic": True}, {"csv_dir": FIX}):
        got, dates = tfg.load_prices("ZZZ", 50, **kw)
        want, _ = jfg.load_prices("ZZZ", 50, **kw)
        assert dates is None
        np.testing.assert_array_equal(got, want)


# --- drivers ----------------------------------------------------------------


def _sabr(steps, seed, f0):
    f, _ = tdata.sabr_paths(steps=steps, seed=seed, F0=f0)
    return f


@pytest.mark.parametrize("batch_windows", [True, False])
def test_generate_stock_predictions(tmp_path, batch_windows):
    out = tex.generate_stock_predictions(
        "TEST", _sabr(160, 1, 100.0), forecast_horizon=5, train_iters=10,
        nsample=8, ntrain=80, mean="ewma", k=20, ntimes=3, save=True,
        outdir=str(tmp_path), batch_windows=batch_windows, device=CPU)
    assert list(out) == [str(e) for e in tgp.rolling_windows(
        np.zeros(160), 80, 3)]
    for s in out.values():
        assert s.shape == (8, 5) and np.isfinite(s).all()
    assert sorted(os.listdir(tmp_path / "TEST")) == sorted(
        f"volt_ewma20_{label}.npy" for label in out)


def test_generate_one_day_sweep(tmp_path):
    f = _sabr(81, 2, 50.0)
    out = tex.generate_one_day_predictions(
        "TEST", f, "2022-01-01", forecast_horizon=4, train_iters=10,
        nsample=4, ntrain=81, outdir=str(tmp_path), ks=(25, 50), save=True,
        device=CPU)
    assert sorted(out) == sorted(f"volt_{m}{k}" for m in
                                 ("ewma", "dewma", "tewma") for k in (25, 50))
    for s in out.values():
        assert s.shape == (4, 4) and np.isfinite(s).all()
    assert len(os.listdir(tmp_path / "TEST")) == 6
    sig = inspect.signature(tex.generate_one_day_predictions)
    assert sig.parameters["ks"].default == (25, 50, 100, 200, 300, 400)
    const = tex.generate_one_day_predictions(
        "TEST", f, "2022-01-01", forecast_horizon=4, train_iters=10,
        nsample=4, mean="constant", device=CPU)
    assert list(const) == ["volt_constant"]
    assert const["volt_constant"].shape == (4, 4)


@pytest.mark.parametrize("kernel,mean", [("matern", "ewma"),
                                         ("sm", "loglinear")])
def test_generate_basic_predictions(tmp_path, kernel, mean):
    out = tex.generate_basic_predictions(
        "TEST", _sabr(140, 3, 80.0), kernel, mean_name=mean, k=20,
        forecast_horizon=4, train_iters=10, nsample=6, ntrain=100, ntimes=2,
        save=True, outdir=str(tmp_path), device=CPU)
    assert len(out) == 2
    for s in out.values():
        assert s.shape == (6, 4) and np.isfinite(s).all()
    assert sorted(os.listdir(tmp_path / "TEST")) == sorted(
        f"{kernel}_{mean}20_{label}.npy" for label in out)


def test_generate_gpcv_predictions(tmp_path):
    out = tex.generate_gpcv_predictions(
        "TEST", _sabr(120, 4, 60.0), forecast_horizon=4, ntimes=2,
        train_iters=10, nsample=6, ntrain=100, save=True,
        outdir=str(tmp_path), device=CPU)
    for s in out.values():
        assert s.shape == (6, 4) and np.isfinite(s).all()
    assert sorted(os.listdir(tmp_path / "TEST")) == sorted(
        f"gpcv_{label}.npy" for label in out)


@pytest.mark.parametrize("mean", ["constant", "ewma"])
def test_wind_volt_window(mean):
    rng = np.random.default_rng(0)
    ntrain, h = 80, 4
    y = np.abs(rng.standard_normal(ntrain)).astype(np.float32) + 1.0
    x = np.arange(ntrain - 1, dtype=np.float32) / 365
    test_x = np.arange(ntrain, ntrain + h, dtype=np.float32) / 365
    s = tgg.wind_volt_window(x, y, test_x, mean, nsample=8, k=20,
                             device=CPU)
    assert s.shape == (8, h) and torch.isfinite(s).all()


@pytest.mark.parametrize("kernel,mean", [("rbf", "constant"),
                                         ("matern", "ewma")])
def test_basic_wind_rollouts(kernel, mean):
    rng = np.random.default_rng(1)
    ntrain, h = 60, 4
    y = np.abs(rng.standard_normal(ntrain)).astype(np.float32) + 1.0
    x = np.arange(ntrain, dtype=np.float32) / 365
    test_x = np.arange(ntrain, ntrain + h, dtype=np.float32) / 365
    s = tex.basic_wind_rollouts(x, y, test_x, kernel, mean_name=mean,
                                train_iters=10, nsample=8, device=CPU)
    assert s.shape == (8, h) and torch.isfinite(s).all()


def test_run_multitask_wind(tmp_path):
    """A dead station (all -99) is dropped before the joint fit."""
    _, _, data = tgg.load_wind("", synthetic=True, n_stations=3, ntime=60)
    data = [*data, np.full(60, -99.0, np.float32)]
    names = {i: f"s{i}" for i in range(4)}
    out = tex.run_multitask_wind(names, data, ntrain=40, forecast_horizon=4,
                                 nsample=8, gpcv_iters=5, vol_iters=5, k=10,
                                 out_path=str(tmp_path / "mt.p"), device=CPU)
    assert out["names_list"] == ["s0", "s1", "s2"]
    assert out["x_paths"].shape == (3, 8, 4)
    assert np.isfinite(out["x_paths"]).all()
    with open(tmp_path / "mt.p", "rb") as fh:
        assert pickle.load(fh)["names_list"] == out["names_list"]


def _run_cli(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(module.build_parser().parse_args(argv))
    return buf.getvalue()


def _saved(root):
    return {os.path.relpath(os.path.join(d, f), root): np.load(
        os.path.join(d, f)).shape for d, _, fs in os.walk(root) for f in fs}


def test_forecast_generator_cli_against_jax(tmp_path):
    """The CLI over the fixtures (CSV -> rolling windows -> batched fit and
    forecast -> saved files): the same files, of the same shapes, as the
    JAX CLI's, and no per-ticker skip."""
    argv = ["--ticker_fname", os.path.join(FIX, "offline_tickers"),
            "--csv_dir", FIX, "--ntrain", "64", "--lookback", "16",
            "--ntimes", "1", "--train_iters", "5", "--nsample", "8",
            "--forecast_horizon", "5", "--save"]
    out = _run_cli(tfg, argv + ["--outdir", str(tmp_path / "t"),
                                "--device", CPU])
    assert "done AAA" in out and "done BBB" in out and "FAILED" not in out
    _run_cli(jfg, argv + ["--outdir", str(tmp_path / "j")])
    saved = _saved(tmp_path / "t")
    assert saved and saved == _saved(tmp_path / "j")
    assert set(saved.values()) == {(8, 5)}


@pytest.mark.parametrize("kernel,mean", [("volt", "ewma"),
                                         ("volt", "constant"),
                                         ("rbf", "ewma")])
def test_gp_generator_cli(tmp_path, kernel, mean):
    """Fixture station -> pickle -> the wind CLI -> saved samples under the
    JAX CLI's names (``stn0/<tag>_<last_day>.npy``), positive levels."""
    twind.build_wind_dataset_from_files(
        [os.path.join(FIX, "CRNS0101-05-2021-NE_Testville_1_SSW.txt")],
        out_path=str(tmp_path / "wind_data.p"), expected_rows=288)
    _run_cli(tgg, ["--wind_data", str(tmp_path / "wind_data.p"),
                   "--kernel", kernel, "--mean", mean, "--ntrain", "48",
                   "--forecast_horizon", "4", "--n_test_times", "1",
                   "--nsample", "8", "--train_epochs", "5",
                   "--outdir", str(tmp_path), "--device", CPU])
    tag = {("volt", "ewma"): "volt_ema400_theta0.01",
           ("volt", "constant"): "volt_theta0.01",
           ("rbf", "ewma"): "rbf_ewma200"}[(kernel, mean)]
    last_days = range(48, 288 - 4, max(int((288 - 4 - 48) / 1), 1))
    saved = _saved(tmp_path / "stn0")
    assert saved == {f"{tag}_{d}.npy": (8 if kernel == "volt" else 200, 4)
                     for d in last_days}
    for name in saved:
        assert np.isfinite(np.load(tmp_path / "stn0" / name)).all()


def test_lstm_generator_cli(tmp_path):
    out = _run_cli(tlg, [
        "--ticker_fname", os.path.join(FIX, "offline_tickers"),
        "--csv_dir", FIX, "--ntrain", "64", "--lookback", "16",
        "--ntimes", "1", "--train_epochs", "1", "--nsample", "4",
        "--forecast_horizon", "3", "--seq_length", "5",
        "--outdir", str(tmp_path), "--device", CPU])
    assert "done AAA" in out and "done BBB" in out and "FAILED" not in out
    _, dates = tfg.load_prices("AAA", 80, FIX)
    ends = tgp.rolling_windows(np.zeros(80), 64, 1)
    assert _saved(tmp_path / "AAA") == {f"lstm_{dates[e]}.npy": (4, 3)
                                        for e in ends}


def test_drivers_run_on_the_card_by_default():
    """``device`` defaults to ``"cuda"`` in every driver and CLI; without a
    card the default raises rather than falling back to the CPU."""
    for fn in (tex.generate_stock_predictions, tex.generate_one_day_predictions,
               tex.generate_basic_predictions, tex.generate_gpcv_predictions,
               tex.basic_wind_rollouts, tex.run_multitask_wind,
               tgg.wind_volt_window):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for mod in (tfg, tgg, tlg):
        assert mod.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tex.generate_gpcv_predictions("T", _sabr(60, 1, 50.0),
                                          ntrain=50, ntimes=1)

"""Head-to-head forecast quality: Volt against the reference's own baselines.

The reference paper's headline evaluation compares Volt+Magpie against
standard exact GPs (Matérn and spectral-mixture kernels with
moving-average means, ``BasicGPModels.py``) and an LSTM
(``models/LSTM.py``) on forecast calibration and likelihood.  This tool
runs that comparison end to end on synthetic universes whose dynamics are
known (port of the JAX package's ``tools/eval_compare.py``, the source of
``EVALUATION.md``'s tables):

* GBM: constant vol 0.25, zero drift;
* SABR: stochastic-vol paths (the tutorial's generator);
* WIND: a squared-OU mean-reverting speed surrogate (+1-shifted like the
  reference's USCRN preprocessing); the Volt lane uses the reference's
  wind settings, EWMA(k=400) with theta=0.01 mean-reverting rollouts
  (``GPGenerator.py:68-107``);
* WINDGUST: the same speed process with stochastic log-vol gust episodes.

Per (universe, model), pooled over W forecast windows x H steps, in
log-price space: ``calib_err`` (mean |central-interval coverage - level|
over the levels 10%..90%), ``crps`` (the sample-ensemble CRPS against the
realised path) and ``nll`` (the Gaussian NLL of the realised value under
the ensemble's per-step mean and std).

Run::

    python -m volt_tpu_torch.tools.eval_compare [--windows 32]
        [--out TABLE.md] [--device cuda]

Prints one JSON line per (universe, model); ``--out`` writes the markdown
tables to the path it names.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from ..calibration import crps, interval_coverage
from ..data import gbm_windows, gusty_wind_windows, sabr_windows, wind_windows
from ..experiments.basic_wind import make_basic_model
from ..models.lstm import train_lstm
from ..parallel import PipelineConfig, fit_forecast_batch
from ..rollouts import nonvol_rollouts
from ._common import DT, f32, grids, numpy, parser, per_window, seeded

__all__ = ["DT", "LEVELS", "metrics", "volt_lane", "basic_lane", "lstm_lane",
           "main"]

LEVELS = np.linspace(0.1, 0.9, 9)


def metrics(samples, truth):
    """``samples (W, S, H)`` log-price forecasts, ``truth (W, H)`` the
    realised values: ``calib_err``, ``crps`` and ``nll``, rounded as the
    JAX tool prints them."""
    samples = numpy(samples)
    truth = np.asarray(truth)
    cov = interval_coverage(samples, truth, LEVELS)
    calib_err = float(np.abs(cov - LEVELS).mean())
    # CRPS per window and step: the windows side by side as steps of one
    # (S, W*H) ensemble, which is the same per-column sum
    w, s, h = samples.shape
    flat = torch.from_numpy(np.ascontiguousarray(
        samples.transpose(1, 0, 2).reshape(s, w * h), np.float32))
    crps_val = float(torch.mean(crps(flat, torch.from_numpy(
        truth.reshape(w * h).astype(np.float32)))))
    mu = samples.mean(axis=1)
    sd = samples.std(axis=1) + 1e-9
    nll = float(np.mean(0.5 * ((truth - mu) / sd) ** 2 + np.log(sd)
                        + 0.5 * math.log(2 * math.pi)))
    return {"calib_err": round(calib_err, 4), "crps": round(crps_val, 5),
            "nll": round(nll, 4)}


def volt_lane(prices, ntrain, h, iters, nsample, k, theta=None, *,
              device="cuda", generator=None, noise=None):
    """``fit_forecast_batch`` over the windows (EWMA mean of ``k``, the
    same ``iters`` Adam steps a stage): log samples ``(W, S, H)``.
    ``generator`` (default seeded 0 on ``device``) draws the Monte-Carlo
    normals unless ``noise`` gives them.  Fails if a window is not
    ``ok``."""
    train_x, test_x = grids(ntrain, h, device)
    cfg = PipelineConfig(gpcv_iters=iters, vol_iters=iters, data_iters=iters,
                         mean_func="ewma", k=k, nsample=nsample, theta=theta)
    generator = generator if generator is not None else seeded(device, 0)
    samples, aux = fit_forecast_batch(
        generator, train_x, f32(prices[:, :ntrain], device), test_x, cfg,
        noise=noise)
    ok = numpy(aux["ok"])
    if not ok.all():
        raise AssertionError(f"volt lane failed windows: {np.where(~ok)[0]}")
    return numpy(samples)


def basic_lane(prices, ntrain, h, iters, nsample, k, kernel_name, *,
               device="cuda", generator=None, init_params=None, zs=None):
    """An exact-GP baseline (``"matern"`` or ``"sm"`` with 10 mixtures, an
    EWMA mean of ``k``) fitted by ``iters`` Adam steps and rolled out by
    ``nonvol_rollouts``, one window at a time: log samples ``(W, S, H)``.
    ``init_params`` and ``zs`` (per window: the initial tree and the
    ``(S, H)`` normals) replace the generator's draws."""
    train_x, test_x = grids(ntrain, h, device)
    generator = generator if generator is not None else seeded(device, 0)
    out = []
    for widx in range(prices.shape[0]):
        train_y = f32(prices[widx, :ntrain], device)[1:]
        model = make_basic_model(train_x, torch.log(train_y), kernel_name,
                                 "ewma", k, iters, num_mixtures=10,
                                 generator=generator,
                                 init_params=per_window(init_params, widx))
        out.append(numpy(nonvol_rollouts(generator, model, train_x, train_y,
                                         test_x, nsample=nsample,
                                         zs=per_window(zs, widx))))
    return np.stack(out)


def lstm_lane(prices, ntrain, h, epochs, nsample, seq_len=20, *,
              device="cuda", generator=None, init_params=None, perms=None,
              zs=None):
    """The LSTM baseline (hidden 64, one layer, batch 128) trained for
    ``epochs`` on each window's log prices: log samples ``(W, S, H)``.
    ``init_params``, ``perms`` and ``zs`` (per window: the flax tree, the
    ``(epochs, N)`` permutations, the ``(S, H)`` normals) replace the
    generator's draws."""
    generator = generator if generator is not None else seeded(device, 0)
    out = []
    for widx in range(prices.shape[0]):
        log_y = np.log(prices[widx, :ntrain].astype(np.float32))
        state = train_lstm(log_y, seq_len=seq_len, hidden_size=64,
                           num_layers=1, epochs=epochs, batch_size=128,
                           generator=generator, device=device,
                           init_params=per_window(init_params, widx),
                           perms=per_window(perms, widx))
        out.append(numpy(state.forecast(generator, h, nsample,
                                        zs=per_window(zs, widx))))
    return np.stack(out)


def _markdown(a, tables):
    lines = [
        "# EVALUATION — forecast quality, Volt vs the reference's "
        "baselines",
        "",
        "The reference paper's headline comparison (calibration and "
        "likelihood of Volt+Magpie",
        "against exact GPs with moving-average means and an LSTM), run end "
        "to end in",
        "volt_tpu_torch on synthetic universes with known dynamics "
        "(`python -m volt_tpu_torch.tools.eval_compare`;",
        f"W={a.windows} windows, ntrain={a.ntrain}, H={a.horizon}, "
        f"S={a.nsample}, device {a.device}, log-price space, pooled over "
        "windows x steps).",
        "",
        "Metrics: `calib_err` = mean |central-interval coverage - "
        "nominal| over levels",
        "10%..90%; `crps`; Gaussian ensemble `nll`.  Lower is better for "
        "all three.",
        "",
    ]
    for uname, rows in tables.items():
        lines += [f"## {uname}", "", "| model | calib_err | crps | nll |",
                  "|---|---|---|---|"]
        for lname, m in rows.items():
            lines.append(f"| {lname} | {m['calib_err']:.3f} | "
                         f"{m['crps']:.4f} | {m['nll']:.3f} |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--windows", type=int, default=32)
    p.add_argument("--ntrain", type=int, default=252)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--nsample", type=int, default=256)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--basic_iters", type=int, default=400)
    p.add_argument("--lstm_epochs", type=int, default=40)
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--lanes", type=str, default="",
                   help="comma-separated subset of "
                        "volt-ewma,matern-ewma,sm-ewma,lstm")
    p.add_argument("--universes", type=str, default="",
                   help="comma-separated subset of GBM,SABR,WIND,WINDGUST")
    p.add_argument("--out", type=str, default="",
                   help="write the markdown tables to this path")
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    # per universe the Volt lane's k and theta: the stock-backtest default
    # for the price universes, the reference's wind settings (EWMA(k=400),
    # theta=0.01, GPGenerator.py:68-107) for the wind ones; the shared rng
    # draws GBM, then WIND, then WINDGUST (SABR has its own seed)
    rng = np.random.default_rng(7)
    wind = dict(k=min(400, a.ntrain - 1), theta=0.01)
    unis = {
        "GBM": (gbm_windows(rng, a.windows, a.ntrain, a.horizon),
                dict(k=a.k, theta=None)),
        "SABR": (sabr_windows(a.windows, a.ntrain, a.horizon),
                 dict(k=a.k, theta=None)),
        "WIND": (wind_windows(rng, a.windows, a.ntrain, a.horizon), wind),
        "WINDGUST": (gusty_wind_windows(rng, a.windows, a.ntrain,
                                        a.horizon), wind),
    }
    if a.universes:
        keep = set(a.universes.split(","))
        unis = {n: u for n, u in unis.items() if n in keep}

    def lanes_for(ucfg):
        return {
            "volt-ewma": lambda p: volt_lane(
                p, a.ntrain, a.horizon, a.iters, a.nsample, ucfg["k"],
                ucfg["theta"], device=dev),
            "matern-ewma": lambda p: basic_lane(
                p, a.ntrain, a.horizon, a.basic_iters, a.nsample,
                ucfg["k"], "matern", device=dev),
            "sm-ewma": lambda p: basic_lane(
                p, a.ntrain, a.horizon, a.basic_iters, a.nsample,
                ucfg["k"], "sm", device=dev),
            "lstm": lambda p: lstm_lane(
                p, a.ntrain, a.horizon, a.lstm_epochs, a.nsample,
                device=dev),
        }

    tables = {}
    for uname, (prices, ucfg) in unis.items():
        truth = np.log(prices[:, a.ntrain:])
        lanes = lanes_for(ucfg)
        if a.lanes:
            keep = set(a.lanes.split(","))
            lanes = {n: f for n, f in lanes.items() if n in keep}
        rows = {}
        for lname, fn in lanes.items():
            t0 = time.perf_counter()
            m = metrics(fn(prices), truth)
            m["sec"] = round(time.perf_counter() - t0, 1)
            rows[lname] = m
            print(json.dumps({"universe": uname, "model": lname, **m}),
                  flush=True)
        tables[uname] = rows

    if a.out:
        with open(a.out, "w") as fh:
            fh.write(_markdown(a, tables))
    return tables


if __name__ == "__main__":
    main()

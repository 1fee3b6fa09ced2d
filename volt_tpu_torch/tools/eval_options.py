"""Option-valuation accuracy: Monte-Carlo prices from fitted forecasts
against the true conditional expected payoff.

The reference's third use case is option valuation from forecast paths:
``option_utils.Pricer`` (``option_utils.py:26-45``) takes
``mean(max(S - K, 0))`` per strike and expiry.  This tool (port of the JAX
package's ``tools/eval_options.py``) scores that surface on universes
where the truth is computable:

* ``GBM`` (``data.universes.gbm_windows``, a driftless log random walk of
  known sigma): the closed form
  ``E[max(S_{t+h} - K, 0) | S_t] = Black76(F, K, V)`` with
  ``F = S_t exp(V/2)``, ``V = sigma^2 h dt`` (no discounting, as the
  reference's Pricer);
* ``SABR`` (``data.universes.sabr_windows(return_vol=True)``): no closed
  form; the oracle continues the true Euler SDE from each window's final
  ``(F, V)`` with ``--oracle-paths`` paths.  The latent ``V`` is hidden
  state the models must infer from prices.

Each lane (the ``eval_compare`` lanes, unchanged) fits every window,
rolls out price paths and prices calls and puts at moneyness {0.95, 1.0,
1.05} x the ``--expiries`` through ``options.price_call_grid`` /
``price_put_grid``; the scores against the oracle grid: ``mae_bps``
(mean |MC - oracle| in basis points of spot, over windows, strikes,
expiries, calls and puts), ``bias_bps`` (the same, signed), ``atm_rel``
(|MC - oracle| / oracle at the ATM strike, calls), ``fwd_bps`` (the
forward's error |mean(S) - F| by put-call parity: the drift leg) and
``straddle_rel`` (the ATM straddle's relative error: the width leg).  The
``oracle-mc`` lane draws ``--nsample`` paths from the true law: the
metric's floor at the lanes' sample count.

Run::

    python -m volt_tpu_torch.tools.eval_options [--universe GBM|SABR]
        [--windows 32] [--device cuda]

Prints one JSON line per lane.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from scipy.stats import norm

from ..data import gbm_windows, sabr_windows
from ..options import price_call_grid, price_put_grid
from ._common import DT, numpy, parser
from .eval_compare import basic_lane, lstm_lane, volt_lane

__all__ = ["MONEYNESS", "SABR", "black76", "grids_from_paths",
           "sabr_continue", "score", "main"]

MONEYNESS = np.array([0.95, 1.00, 1.05])
# the SABR generator's own dynamics (data/synthetic.py defaults)
SABR = dict(alpha=1.25, beta=0.9, rho=-0.2)


def black76(fwd, k, v):
    """The undiscounted expected call payoff under lognormal(F, V)."""
    sv = np.sqrt(v)
    d1 = (np.log(fwd / k) + 0.5 * v) / sv
    return fwd * norm.cdf(d1) - k * norm.cdf(d1 - sv)


def grids_from_paths(px, strikes):
    """``px (S, E)`` sampled prices, ``strikes (K,)``: the call and put
    grids ``(K, E)`` as numpy arrays."""
    return (numpy(price_call_grid(px, strikes)),
            numpy(price_put_grid(px, strikes)))


def sabr_continue(f_last, v_last, h, n_paths, dt, seed):
    """Continue the true SABR Euler scheme (``data/synthetic.py``, the same
    floors) from per-window ``(F, V)``: prices ``(W, n_paths, h)``."""
    rng = np.random.default_rng(seed)
    w = len(f_last)
    f = np.repeat(f_last[:, None], n_paths, axis=1).astype(np.float64)
    v = np.repeat(v_last[:, None], n_paths, axis=1).astype(np.float64)
    f_floor, v_floor = 1e-3 * 10.0, 1e-4
    out = np.empty((w, n_paths, h))
    for t in range(h):
        dw = rng.normal(0.0, np.sqrt(dt), (w, n_paths))
        dz = (SABR["rho"] * dw
              + np.sqrt(1 - SABR["rho"] ** 2)
              * rng.normal(0.0, np.sqrt(dt), (w, n_paths)))
        f = np.maximum(f + v * f ** SABR["beta"] * dw, f_floor)
        v = np.maximum(v + SABR["alpha"] * v * dz, v_floor)
        out[:, :, t] = f
    return out


def score(log_samples, s_last, expiry_idx, cf_call, cf_put, fwd_true):
    """``log_samples (W, S, H)`` forecast log prices, ``cf_* (W, K, E)`` the
    oracle grids, ``fwd_true (W, E)`` the true forward at each expiry."""
    w = log_samples.shape[0]
    abs_err, sgn_err, atm_rel, fwd_err, strad_rel = [], [], [], [], []
    for i in range(w):
        px = np.exp(np.asarray(log_samples[i]))[:, expiry_idx]  # (S, E)
        strikes = MONEYNESS * s_last[i]                          # (K,)
        mc_call, mc_put = grids_from_paths(px, strikes)
        err = np.concatenate([mc_call - cf_call[i], mc_put - cf_put[i]])
        abs_err.append(np.abs(err) / s_last[i])
        sgn_err.append(err / s_last[i])
        atm_rel.append(np.abs(mc_call[1] - cf_call[i][1]) / cf_call[i][1])
        fwd_err.append(np.abs(px.mean(axis=0) - fwd_true[i]) / s_last[i])
        strad = mc_call[1] + mc_put[1]                           # (E,)
        strad_true = cf_call[i][1] + cf_put[i][1]
        strad_rel.append(np.abs(strad - strad_true) / strad_true)
    return {
        "mae_bps": round(float(np.mean(abs_err)) * 1e4, 2),
        "bias_bps": round(float(np.mean(sgn_err)) * 1e4, 2),
        "atm_rel": round(float(np.mean(atm_rel)), 4),
        "fwd_bps": round(float(np.mean(fwd_err)) * 1e4, 2),
        "straddle_rel": round(float(np.mean(strad_rel)), 4),
    }


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--universe", choices=["GBM", "SABR"], default="GBM")
    p.add_argument("--windows", type=int, default=32)
    p.add_argument("--ntrain", type=int, default=252)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--nsample", type=int, default=1024)
    p.add_argument("--oracle-paths", type=int, default=16384)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--basic_iters", type=int, default=400)
    p.add_argument("--lstm_epochs", type=int, default=40)
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--expiries", type=str, default="4,9,19",
                   help="0-based horizon indices used as expiries")
    p.add_argument("--lanes", type=str, default="",
                   help="comma-separated subset of oracle-mc,volt-ewma,"
                        "matern-ewma,sm-ewma,lstm")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    rng = np.random.default_rng(7)
    expiry_idx = np.asarray([int(t) for t in a.expiries.split(",")],
                            dtype=int)
    if expiry_idx.max() >= a.horizon:
        p.error("an expiry lies past the horizon")

    if a.universe == "GBM":
        sigma = 0.25
        prices = gbm_windows(rng, a.windows, a.ntrain, a.horizon, vol=sigma)
        s_last = prices[:, a.ntrain - 1].astype(np.float64)
        v = sigma ** 2 * (expiry_idx + 1) * DT                   # (E,)
        fwd = s_last[:, None, None] * np.exp(0.5 * v)            # (W,1,E)
        strikes = MONEYNESS[None, :, None] * s_last[:, None, None]
        cf_call = black76(fwd, strikes, v[None, None, :])        # (W,K,E)
        cf_put = cf_call - (fwd - strikes)
        fwd_true = fwd[:, 0, :]                                  # (W,E)

        def true_paths(n_paths, seed):
            z = np.random.default_rng(seed).standard_normal(
                (a.windows, n_paths, a.horizon))
            return np.exp(np.log(s_last)[:, None, None]
                          + np.cumsum(sigma * np.sqrt(DT) * z, axis=-1))
    else:  # SABR
        prices, vols = sabr_windows(a.windows, a.ntrain, a.horizon,
                                    return_vol=True)
        s_last = prices[:, a.ntrain - 1].astype(np.float64)
        v_last = vols[:, a.ntrain - 1].astype(np.float64)
        dt = 1.0 / (a.ntrain + a.horizon)  # the generator's grid

        def true_paths(n_paths, seed):
            return sabr_continue(s_last, v_last, a.horizon, n_paths, dt,
                                 seed)

        big = true_paths(a.oracle_paths, seed=3)[:, :, expiry_idx]
        fwd_true = big.mean(axis=1)                              # (W,E)
        cf_call = np.empty((a.windows, len(MONEYNESS), len(expiry_idx)))
        cf_put = np.empty_like(cf_call)
        for i in range(a.windows):
            cf_call[i], cf_put[i] = grids_from_paths(
                big[i], MONEYNESS * s_last[i])

    lanes = {
        "oracle-mc": lambda p: np.log(true_paths(a.nsample, seed=5)),
        "volt-ewma": lambda p: volt_lane(
            p, a.ntrain, a.horizon, a.iters, a.nsample, a.k, device=dev),
        "matern-ewma": lambda p: basic_lane(
            p, a.ntrain, a.horizon, a.basic_iters, a.nsample, a.k, "matern",
            device=dev),
        "sm-ewma": lambda p: basic_lane(
            p, a.ntrain, a.horizon, a.basic_iters, a.nsample, a.k, "sm",
            device=dev),
        "lstm": lambda p: lstm_lane(
            p, a.ntrain, a.horizon, a.lstm_epochs, a.nsample, device=dev),
    }
    if a.lanes:
        keep = set(a.lanes.split(","))
        lanes = {n: f for n, f in lanes.items() if n in keep}

    rows = {}
    for lname, fn in lanes.items():
        t0 = time.perf_counter()
        m = score(fn(prices), s_last, expiry_idx, cf_call, cf_put, fwd_true)
        m["sec"] = round(time.perf_counter() - t0, 1)
        rows[lname] = m
        print(json.dumps({"universe": a.universe, "lane": lname, **m}),
              flush=True)
    return rows


if __name__ == "__main__":
    main()

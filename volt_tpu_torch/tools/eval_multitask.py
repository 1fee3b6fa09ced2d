"""What the Kronecker multitask vol coupling buys over independent fits.

The reference's multitask pieces (``MultitaskBMGP``, ``BMGP.py:30-56``;
the mtwind experiment) exist because volatility is correlated across
stations and tickers.  This tool (port of the JAX package's
``tools/eval_multitask.py``) measures that on a universe where the
coupling is known: ``data.universes.corrvol_windows``, T stations per
window whose log-vol shares one slow OU gust factor while the price
innovations stay independent.

Two lanes run the same machinery on identical per-station GPCV vol paths
(stage 1 is shared, so only the vol-GP coupling differs):

* ``independent``: ``train_volt_multitask`` + ``rollouts_multitask`` per
  station with T=1 (per-station fits, independent vol draws);
* ``multitask``: the same calls once, jointly over all T stations (rank-1
  task covariance; vol forecasts correlated across stations).

Scored on the per-station marginals (``eval_compare.metrics``, pooled over
W x T x H) and on the cross-station gust energy
``G = mean_{i,t} (dlog p_{i,t})^2`` over the horizon, a joint functional
whose ensemble spread an independent-draw lane underestimates: its PIT
calibration error, CRPS and ensemble std.

Run::

    python -m volt_tpu_torch.tools.eval_multitask [--windows 16]
        [--tasks 8] [--device cuda]

Prints one JSON line per lane and a verdict line.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..data import corrvol_windows
from ..models.gpcv import GPCVModel
from ..rollouts import rollouts_multitask
from ..train import adam_loop, scaled_returns, train_volt_multitask
from ._common import f32, grids, numpy, parser, seeded
from .eval_compare import LEVELS, metrics

__all__ = ["batched_gpcv", "gust_energy", "functional_metrics", "run_lane",
           "main"]


def batched_gpcv(train_x, prices, iters, lr=0.01):
    """Identical per-station GPCV fits (the tridiagonal family, Adam),
    batched over the stations: ``prices (T, ntrain)`` -> vol paths
    ``(T, ntrain - 1)``.  Both lanes get the same output, so a difference
    downstream is the vol-GP coupling alone."""
    yy = scaled_returns(train_x, prices)
    module = GPCVModel(kernel="bm", q="tridiag")
    module.init(train_x, yy, per_lane=True)
    adam_loop(module, lambda: -module.elbo(train_x, yy), iters, lr)
    with torch.no_grad():
        return module.predicted_scale(train_x)


def gust_energy(log_prices, last_logp):
    """``G`` = the mean squared log-increment across (station, step).

    ``log_prices`` ``(T, S, H)`` samples or ``(T, H)`` truth;
    ``last_logp`` ``(T,)`` the last observed log prices, from which the
    first increment is taken, so that every horizon step counts.  Returns
    ``(S,)`` for samples, a float for the truth."""
    if log_prices.ndim == 3:
        first = np.broadcast_to(last_logp[:, None, None],
                                (*log_prices.shape[:2], 1))
        d = np.diff(np.concatenate([first, log_prices], axis=-1), axis=-1)
        return (d ** 2).mean(axis=(0, 2))
    d = np.diff(np.concatenate([last_logp[:, None], log_prices], axis=-1),
                axis=-1)
    return float((d ** 2).mean())


def functional_metrics(g_samples, g_truth):
    """``g_samples (W, S)``, ``g_truth (W,)``: the PIT calibration error,
    CRPS and mean ensemble std of the scalar gust-energy ensemble, pooled
    over windows."""
    w, s = g_samples.shape
    pits = (g_samples <= g_truth[:, None]).mean(axis=1)
    cov = np.array([((pits >= 0.5 - p / 2) & (pits <= 0.5 + p / 2)).mean()
                    for p in LEVELS])
    calib_err = float(np.abs(cov - LEVELS).mean())
    # the sample-ensemble CRPS, its exact sorted form per window
    srt = np.sort(g_samples, axis=1)
    ranks = np.arange(1, s + 1)
    crps = float(np.mean(
        np.mean(np.abs(g_samples - g_truth[:, None]), axis=1)
        + np.mean(srt * (s + 1 - 2 * ranks) / s, axis=1)))
    disp = float(np.mean(g_samples.std(axis=1)))
    return {"calib_err": round(calib_err, 4),
            "crps_x1e4": round(crps * 1e4, 4),
            "ens_std_x1e4": round(disp * 1e4, 4)}


def run_lane(prices, ntrain, h, iters, vol_iters, nsample, k, joint, *,
             device="cuda", generator=None):
    """One lane over the windows of ``prices (W, T, ntrain + h)``: samples
    ``(W, T, S, H)`` of log prices.  ``generator`` (default seeded 3 on
    ``device``, the JAX tool's key) draws the task factors' init and the
    rollouts."""
    train_x, test_x = grids(ntrain, h, device)
    generator = generator if generator is not None else seeded(device, 3)
    fit = dict(train_iters=iters, vol_iters=vol_iters, k=k,
               mean_func="ewma", rank=1, generator=generator)
    out = []
    for b in range(prices.shape[0]):
        train_p = f32(prices[b, :, :ntrain], device)
        vols = batched_gpcv(train_x, train_p, iters)
        if joint:
            volt_state, mt_state = train_volt_multitask(
                train_x, train_p[:, 1:], vols, **fit)
            samples = rollouts_multitask(generator, volt_state, mt_state,
                                         train_p, test_x, nsample=nsample)
        else:
            per = []
            for i in range(train_p.shape[0]):
                volt_state, mt_state = train_volt_multitask(
                    train_x, train_p[i:i + 1, 1:], vols[i:i + 1], **fit)
                per.append(rollouts_multitask(
                    generator, volt_state, mt_state, train_p[i:i + 1],
                    test_x, nsample=nsample)[0])
            samples = torch.stack(per)
        out.append(numpy(samples))
    return np.stack(out)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--windows", type=int, default=16)
    p.add_argument("--tasks", type=int, default=8)
    p.add_argument("--ntrain", type=int, default=200)
    p.add_argument("--horizon", type=int, default=24)
    p.add_argument("--nsample", type=int, default=256)
    p.add_argument("--iters", type=int, default=200)
    # the /10-downscaled task-covariance init (reference parity,
    # BMGP.py:36-40) needs ~600 Adam steps to recover a task correlation
    # of ~0.8; both lanes get the same budget
    p.add_argument("--vol-iters", type=int, default=600)
    p.add_argument("--k", type=int, default=50)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    rng = np.random.default_rng(23)
    prices = corrvol_windows(rng, a.windows, a.tasks, a.ntrain, a.horizon)
    w, h = prices.shape[0], a.horizon
    truth = np.log(prices[:, :, a.ntrain:])        # (W, T, H)
    last_logp = np.log(prices[:, :, a.ntrain - 1])  # (W, T)

    results = {}
    for lname, joint in (("independent", False), ("multitask", True)):
        t0 = time.perf_counter()
        samples = run_lane(prices, a.ntrain, h, a.iters, a.vol_iters,
                           a.nsample, a.k, joint, device=dev)
        tt = samples.shape[1]
        marg = metrics(samples.reshape(w * tt, a.nsample, h),
                       truth.reshape(w * tt, h))
        g_s = np.stack([gust_energy(samples[b], last_logp[b])
                        for b in range(w)])  # (W, S)
        g_t = np.array([gust_energy(truth[b], last_logp[b])
                        for b in range(w)])  # (W,)
        rec = {"lane": lname, "marginal": marg,
               "gust_energy": functional_metrics(g_s, g_t),
               "sec": round(time.perf_counter() - t0, 1)}
        results[lname] = rec
        print(json.dumps(rec), flush=True)

    # the realised cross-window spread of G as the dispersion yardstick
    g_t_std = float(np.std([gust_energy(truth[b], last_logp[b])
                            for b in range(w)]))
    ratio = (results["multitask"]["gust_energy"]["ens_std_x1e4"]
             / max(results["independent"]["gust_energy"]["ens_std_x1e4"],
                   1e-12))
    verdict = {"realized_G_spread_x1e4": round(g_t_std * 1e4, 4),
               "mt_over_ind_dispersion": round(ratio, 3)}
    print(json.dumps({"verdict": verdict}), flush=True)
    results["verdict"] = verdict
    return results


if __name__ == "__main__":
    main()

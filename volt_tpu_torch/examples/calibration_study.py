"""Forecast-calibration study: the reference paper's own quality metric.

The reference evaluates Volt by forecast calibration: the fraction of
realised prices inside each central prediction interval should match the
interval's nominal level (the ``calib_plotter`` notebook).  This script
runs many independent forecast windows through the batched pipeline on two
synthetic data sets with known dynamics:

* GBM: constant vol 0.25, zero drift (well-specified for the model);
* SABR: stochastic-vol paths (the tutorial's harder generator);

then prints (and with ``--plot`` draws) the empirical central-interval
coverage against the nominal level.

Run:  python -m volt_tpu_torch.examples.calibration_study [--device cpu]
      [--plot calibration_output.png]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..calibration import interval_coverage
from ..data import gbm_windows, sabr_windows
from ..parallel import PipelineConfig, fit_forecast_batch
from ._common import parser, pyplot

DT = 1.0 / 252
LEVELS = np.linspace(0.1, 0.9, 9)


def run(prices, ntrain, h, iters, nsample, device):
    """Central-interval coverage at ``LEVELS`` of the pipeline's forecasts
    of each window's last ``h`` prices from its first ``ntrain``."""
    train_x = torch.arange(ntrain - 1, dtype=torch.float32, device=device) \
        * DT
    test_x = (torch.arange(h, dtype=torch.float32, device=device) * DT
              + train_x[-1] + DT)
    cfg = PipelineConfig(gpcv_iters=iters, vol_iters=iters, data_iters=iters,
                         mean_func="ewma", k=min(50, ntrain - 2),
                         nsample=nsample)
    g = torch.Generator(device=device).manual_seed(0)
    samples, aux = fit_forecast_batch(
        g, train_x, torch.tensor(prices[:, :ntrain], device=device), test_x,
        cfg)
    ok = aux["ok"].cpu().numpy()
    if not ok.all():
        raise RuntimeError(f"non-finite assets: {np.where(~ok)[0]}")
    truth = np.log(prices[:, ntrain:])
    return interval_coverage(samples.cpu().numpy(), truth, LEVELS)


def halving_prediction():
    """Coverage predicted by the reference's ``CumTrapz`` endpoint halving:
    on constant-vol data the one-step forecast std is ``sigma / sqrt(2)``,
    so a central interval of level ``p`` covers ``2 Phi(z_p / sqrt(2)) -
    1``."""
    normal = torch.distributions.Normal(0.0, 1.0)
    z = normal.icdf(torch.tensor(0.5 + LEVELS / 2, dtype=torch.float64))
    return (2 * normal.cdf(z / math.sqrt(2.0)) - 1).numpy()


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--windows", type=int, default=64)
    p.add_argument("--ntrain", type=int, default=252)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--nsample", type=int, default=600)
    p.add_argument("--plot", metavar="PATH",
                   help="save the coverage figure there")
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    rng = np.random.default_rng(7)
    common = (a.ntrain, a.horizon, a.iters, a.nsample, dev)
    cov_gbm = run(gbm_windows(rng, a.windows, a.ntrain, a.horizon), *common)
    cov_sabr = run(sabr_windows(a.windows, a.ntrain, a.horizon), *common)
    pred = halving_prediction()

    for name, cov in (("GBM", cov_gbm), ("SABR", cov_sabr),
                      ("pred½", pred)):
        gap = np.abs(cov - LEVELS).max()
        rows = " ".join(f"{lv:.0%}:{cv:.2f}" for lv, cv in zip(LEVELS, cov))
        print(f"{name:5s} max |coverage - nominal| = {gap:.3f}   {rows}")
    print(f"GBM vs halving prediction: max gap = "
          f"{np.abs(cov_gbm - pred).max():.3f} (the under-coverage IS the "
          f"reference's CumTrapz parity artifact)")
    if a.plot:
        plot(a.plot, cov_gbm, cov_sabr, pred, a.windows, a.horizon)
    return {"gbm": cov_gbm, "sabr": cov_sabr, "predicted": pred}


def plot(out, cov_gbm, cov_sabr, pred, windows, h):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5.2, 5.0))
    ax.plot([0, 1], [0, 1], color="#9ca3af", lw=1.2, ls="--", zorder=1)
    ax.text(0.86, 0.90, "ideal", color="#6b7280", fontsize=9, rotation=41)
    ax.plot(LEVELS, pred, color="#9ca3af", lw=1.2, ls=":", zorder=2)
    ax.annotate("predicted under CumTrapz ½\n(reference parity artifact)",
                (LEVELS[2], pred[2]), xytext=(10, -24),
                textcoords="offset points", color="#6b7280", fontsize=8)
    ax.plot(LEVELS, cov_gbm, color="#2563eb", lw=2, marker="o", ms=5,
            zorder=3)
    ax.plot(LEVELS, cov_sabr, color="#d97706", lw=2, marker="s", ms=5,
            zorder=3)
    ax.annotate("GBM (well-specified)", (LEVELS[-1], cov_gbm[-1]),
                xytext=(8, -4), textcoords="offset points", ha="left",
                color="#1e3a8a", fontsize=9)
    ax.annotate("SABR (stochastic vol)", (LEVELS[-1], cov_sabr[-1]),
                xytext=(8, 0), textcoords="offset points", ha="left",
                color="#92400e", fontsize=9)
    ax.set_xlabel("nominal central-interval level")
    ax.set_ylabel("empirical coverage of realized prices")
    ax.set_title(f"Forecast calibration ({windows} windows, "
                 f"{h}-step horizons)", fontsize=11)
    ax.set_xlim(0, 1.28)
    ax.set_xticks(np.linspace(0, 1, 6))
    ax.set_ylim(0, 1)
    ax.grid(True, color="#e5e7eb", lw=0.6)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

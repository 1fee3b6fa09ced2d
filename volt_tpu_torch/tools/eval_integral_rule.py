"""Calibration effect of the vol-integral quadrature: the reference's rule
against the exact trapezoid.

The reference's ``CumTrapz`` endpoint halving makes every rollout step's
conditional std ``vol * sqrt(dx / 2)`` instead of the exact trapezoid's
``sqrt(dx (v_t^2 + v_{t-1}^2) / 2)``: a one-step forecast 1/sqrt(2) too
narrow (PARITY.md).  This tool fits the full pipeline both ways
(``PipelineConfig(integral_rule=...)``) over a SABR universe of B assets,
rolls out H steps and scores the interval coverage and CRPS of the
forecasts against the realised continuations (port of the JAX package's
``tools/eval_integral_rule.py``).

Run::

    python -m volt_tpu_torch.tools.eval_integral_rule [--assets 24]
        [--ntrain 400] [--horizon 20] [--iters 150] [--nsample 500]
        [--seed 7] [--device cuda]

Prints one JSON object per rule and a verdict line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..calibration import crps, interval_coverage
from ..data import sabr_paths
from ..parallel import PipelineConfig, fit_forecast_batch
from ._common import f32, numpy, parser, seeded

__all__ = ["LEVELS", "main"]

LEVELS = (0.5, 0.8, 0.95)


def _coverage_gap(res):
    """The one-step coverage's mean distance from the nominal levels."""
    return float(np.mean([abs(res["coverage_step1"][str(lv)] - lv)
                          for lv in LEVELS]))


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--assets", type=int, default=24)
    p.add_argument("--ntrain", type=int, default=400)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--iters", type=int, default=150)
    p.add_argument("--nsample", type=int, default=500)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    f, _ = sabr_paths(steps=a.ntrain + a.horizon, seed=a.seed,
                      n_paths=a.assets)
    prices = f32(f[:, :a.ntrain], dev)
    truth_log = np.log(np.asarray(f[:, a.ntrain:]))  # (B, H) realised

    n = a.ntrain - 1
    dt = 1.0 / 252
    train_x = torch.arange(n, dtype=torch.float32, device=dev) * dt + dt
    test_x = train_x[-1] + dt * torch.arange(1, a.horizon + 1,
                                             dtype=torch.float32, device=dev)

    out = {}
    for rule in ("reference", "trapezoid"):
        cfg = PipelineConfig(gpcv_iters=a.iters, vol_iters=a.iters,
                             data_iters=a.iters, nsample=a.nsample,
                             k=min(100, max(2, n // 4)), integral_rule=rule)
        samples, aux = fit_forecast_batch(seeded(dev, 0), train_x, prices,
                                          test_x, cfg)
        samples, ok = numpy(samples), numpy(aux["ok"])  # (B, S, H) logs
        res = {"ok_frac": float(ok.mean())}
        # one-step and whole-horizon coverage, pooled over (asset, step)
        for tag, sl in (("step1", slice(0, 1)), ("all", slice(None))):
            s = samples[ok][..., sl]
            t = truth_log[ok][..., sl]
            cov = interval_coverage(s, t, np.asarray(LEVELS))
            res[f"coverage_{tag}"] = {str(lv): round(float(c), 4)
                                      for lv, c in zip(LEVELS, cov)}
            # crps per asset on (S, H) and (H,); the mean over both
            cr = [float(torch.mean(crps(torch.from_numpy(si),
                                        torch.from_numpy(
                                            ti.astype(np.float32)))))
                  for si, ti in zip(s, t)]
            res[f"crps_{tag}"] = round(float(np.mean(cr)), 6)
        out[rule] = res
        print(json.dumps({rule: res}), flush=True)

    verdict = {
        "step1_coverage_gap_reference": round(
            _coverage_gap(out["reference"]), 4),
        "step1_coverage_gap_trapezoid": round(
            _coverage_gap(out["trapezoid"]), 4),
        "crps_all_reference": out["reference"]["crps_all"],
        "crps_all_trapezoid": out["trapezoid"]["crps_all"],
    }
    print(json.dumps({"verdict": verdict}))
    out["verdict"] = verdict
    return out


if __name__ == "__main__":
    main()

"""Wind-settings sweep of the Volt lane: EWMA window ``k`` x mean-reversion
rate ``theta`` on the WIND universe.

WIND is the universe where Volt trails its baselines in ``EVALUATION.md``.
This sweeps the reference's own wind knobs (``GPGenerator.py``'s ``--k``,
default 400, and the mean-reversion rate ``theta``, ``:68-107``, default
0.01) over the same universe as ``eval_compare`` (the same random
protocol: the GBM universe is drawn first) to tell whether the gap is the
settings or the model (port of the JAX package's ``tools/wind_sweep.py``).

Run::

    python -m volt_tpu_torch.tools.wind_sweep [--windows 32] [--ntrain 400]
        [--device cuda]

Prints one JSON line per combination and a markdown table at the end.
"""

from __future__ import annotations

import itertools
import json
import time

import numpy as np
import torch

from ..data import gbm_windows, wind_windows
from ._common import parser
from .eval_compare import metrics, volt_lane

__all__ = ["main"]


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--windows", type=int, default=32)
    p.add_argument("--ntrain", type=int, default=400)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--nsample", type=int, default=256)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--ks", type=str, default="100,200,400")
    p.add_argument("--thetas", type=str, default="0.01,0.05,0.1,none")
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    # eval_compare's universe exactly: the shared rng draws GBM first
    rng = np.random.default_rng(7)
    gbm_windows(rng, a.windows, a.ntrain, a.horizon)
    prices = wind_windows(rng, a.windows, a.ntrain, a.horizon)
    truth = np.log(prices[:, a.ntrain:])

    ks = [int(s) for s in a.ks.split(",")]
    thetas = [None if s == "none" else float(s) for s in a.thetas.split(",")]
    rows = []
    for k, theta in itertools.product(ks, thetas):
        t0 = time.perf_counter()
        samples = volt_lane(prices, a.ntrain, a.horizon, a.iters, a.nsample,
                            k, theta, device=dev)
        m = metrics(samples, truth)
        m["sec"] = round(time.perf_counter() - t0, 1)
        row = {"k": k, "theta": theta, **m}
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| k | theta | calib_err | crps | nll |")
    print("|---|---|---|---|---|")
    for r in rows:
        th = "—" if r["theta"] is None else f"{r['theta']:g}"
        print(f"| {r['k']} | {th} | {r['calib_err']:.3f} | "
              f"{r['crps']:.4f} | {r['nll']:.3f} |")
    return rows


if __name__ == "__main__":
    main()

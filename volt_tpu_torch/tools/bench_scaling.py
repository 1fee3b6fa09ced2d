"""Sequence-length scaling of the fit and the rollout (port of the JAX
package's ``tools/bench_scaling.py``).

The reference's exact-GP machinery is O(n^3) per training iteration and
capped near n = 2000; here the vol and data stages are O(n) per iteration
and the sparse GPCV O(n m^2).  This tool times the whole chain on one
asset (GPCV, the sparse family above n = 1000; the vol GP; the Volt data
model; a rollout of ``--nsample`` paths of 100 steps) at each n: the least
of ``--reps`` calls after a first call, whose time is printed beside it.
It prints one row per n and, with ``--out``, writes the markdown table
there, under a header that names the device.

Run::

    python -m volt_tpu_torch.tools.bench_scaling
        [--sizes 400,2000,8000,25000] [--iters 300] [--nsample 1000]
        [--reps 3] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..rollouts import rollouts
from ..train import (learn_gpcv, learn_gpcv_sparse, train_vol_model,
                     train_volt_magpie)
from ..utils.profiling import timed_cold_best
from ._common import DT, backend, check_finite, f32, grids, parser, seeded

__all__ = ["series", "run_one", "device_header", "main"]


def series(n: int) -> np.ndarray:
    """One float32 price series of ``n + 1`` points: returns of a
    sinusoidal vol (0.2 x exp(0.3 sin)), normals from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    vol_true = 0.2 * np.exp(0.3 * np.sin(np.linspace(0, 20, n + 1)))
    rets = vol_true * rng.standard_normal(n + 1) * np.sqrt(DT)
    return (100 * np.exp(np.cumsum(rets))).astype(np.float32)


def run_one(n, device, horizon=100, nsample=1000, iters=300,
            m_inducing=256, reps=3):
    """``(best seconds, GPCV mode, first call's seconds)`` of the chain at
    ``n`` returns."""
    prices = f32(series(n), device)
    train_x, test_x = grids(n + 1, horizon, device)
    sparse = n > 1000

    def pipeline(seed):
        if sparse:
            vol = learn_gpcv_sparse(train_x, prices, num_inducing=m_inducing,
                                    train_iters=iters)
        else:
            vol = learn_gpcv(train_x, prices, train_iters=iters)
        vol_state = train_vol_model(train_x, vol, train_iters=iters)
        model = train_volt_magpie(train_x, prices[1:], vol_state, vol,
                                  train_iters=iters, k=100,
                                  mean_func="ewma")
        return rollouts(seeded(device, seed), model, train_x, prices,
                        test_x, nsample=nsample)

    # as the JAX tool: the first call draws with seed 0, the timed ones
    # with 1, 2, ...
    seeds = iter(range(reps + 1))
    out, best, first = timed_cold_best(lambda: pipeline(next(seeds)), reps)
    check_finite(out, f"n={n}")
    return best, (f"sparse-GPCV(m={m_inducing})" if sparse
                  else "full GPCV"), first


def device_header(device) -> str:
    """The device the table was measured on: the card's name and power
    limit as ``nvidia-smi`` gives them (its name alone where
    ``nvidia-smi`` cannot say), or ``cpu``."""
    name = backend(device)
    if torch.device(device).type != "cuda":
        return name
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return name
    lines = smi.stdout.strip().splitlines()
    index = torch.device(device).index or 0
    return lines[index] if smi.returncode == 0 and len(lines) > index \
        else name


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--sizes", type=str, default="400,2000,8000,25000")
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--nsample", type=int, default=1000)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", type=str, default="",
                   help="write the markdown table to this path (default: "
                        "print only)")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    header = device_header(dev)

    rows = []
    for n in (int(s) for s in a.sizes.split(",")):
        secs, mode, first = run_one(n, dev, nsample=a.nsample,
                                    iters=a.iters, reps=a.reps)
        rows.append({"n": n, "seconds": secs, "mode": mode,
                     "first_call_s": first})
        print(f"n={n:>6}  {secs:7.3f}s  ({mode}; first call {first:.3f}s; "
              f"{header})", flush=True)

    lines = [
        f"# Sequence-length scaling ({header})",
        "",
        f"Fit (3x{a.iters} Adam iters) + {a.nsample}-path x 100-step "
        f"rollout, single",
        f"asset, min of {a.reps} run(s) after a first call.  The reference "
        "is O(n^3)/iteration and",
        "guards n <= ~2000 (`max_cholesky_size`, GPGenerator.py:62).",
        "",
        "| n | seconds | GPCV mode | first call (s) |",
        "|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r['n']} | {r['seconds']:.3f} | {r['mode']} | "
                     f"{r['first_call_s']:.3f} |")
    if a.out:
        with open(a.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return {"device": header, "rows": rows}


if __name__ == "__main__":
    main()

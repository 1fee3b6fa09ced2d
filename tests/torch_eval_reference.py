"""Make ``volt_tpu_torch/tools/jax_reference.json``: the JAX package's
forecast-quality metrics at the settings of ``chip_smoke.py``'s
``evaluation`` phase, which holds the port's metrics on the card to them.

Run from the repository root, on the CPU::

    JAX_PLATFORMS=cpu python tests/torch_eval_reference.py

For each item it runs the JAX tool's own ``main`` (``tools/eval_compare.py``,
``tools/eval_options.py``, ``tools/eval_multitask.py``) in-process and reads
the JSON lines it prints, once with the tools' keys as they stand (key 0:
what ``python tools/<name>.py`` prints at those flags) and once for each of
the further keys 1, 2, ...: there every ``jax.random.key(s)`` the tools and
the package make becomes ``jax.random.key(s + 1000003 * key)``, so the
Monte-Carlo draws and every random initial value change together, as the
port's own generator changes them.  One process per key, in parallel.

Per metric the file holds the key-0 value, the further keys' values, their
``spread`` (the largest distance of a further key's value from key 0's),
the ``floor`` and the ``band`` ``max(3 * spread, floor)`` within which the
card's value must lie.  Not collected by pytest (it imports JAX, the tools
and writes a file); the port never imports it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "volt_tpu_torch" / "tools" / "jax_reference.json"
KEY_STRIDE = 1000003

# the phase's items: (tool, the port CLI's flags, the JAX tool's args)
COMPARE = dict(windows=32, ntrain=252, horizon=20, nsample=256, iters=300,
               basic_iters=400, lstm_epochs=40, k=50, lanes="",
               universes="", out="")
OPTIONS = dict(universe="GBM", windows=16, ntrain=252, horizon=20,
               nsample=1024, oracle_paths=16384, iters=300, basic_iters=400,
               lstm_epochs=40, k=50, expiries="4,9,19", lanes="")
# T=4 stations: at the tool's T=8 the item alone takes 53.5 s on the card
MULTITASK = dict(windows=1, tasks=4, ntrain=200, horizon=24, nsample=256,
                 iters=200, vol_iters=600, k=50)

ITEMS = [
    ("eval_compare", {**COMPARE, "universes": "GBM,SABR",
                      "lanes": "volt-ewma"}),
    ("eval_compare", {**COMPARE, "ntrain": 400, "universes": "WINDGUST",
                      "lanes": "volt-ewma"}),
    ("eval_compare", {**COMPARE, "windows": 4, "universes": "GBM",
                      "lanes": "matern-ewma,sm-ewma,lstm"}),
    ("eval_options", {**OPTIONS, "lanes": "oracle-mc,volt-ewma"}),
    ("eval_multitask", {**MULTITASK}),
]

# the floor of each metric: ("abs", x) or ("rel", fraction of |key 0|)
FLOORS = {"calib_err": ("abs", 0.01), "nll": ("abs", 0.05),
          "crps": ("rel", 0.02), "crps_x1e4": ("rel", 0.02),
          "ens_std_x1e4": ("rel", 0.02), "mae_bps": ("rel", 0.02),
          "fwd_bps": ("rel", 0.02), "atm_rel": ("rel", 0.02),
          "straddle_rel": ("rel", 0.02)}
BASELINE_LANES = ("matern-ewma", "sm-ewma", "lstm")


def argv_of(args: dict) -> list:
    """The port CLI's flags for the JAX tool's args (the same names)."""
    out = []
    for name, value in args.items():
        if value == "":
            continue
        flag = "--" + (name if name in ("basic_iters", "lstm_epochs")
                       else name.replace("_", "-"))
        out += [flag, str(value)]
    return out


def run_tool(tool: str, args: dict) -> list:
    """The JSON lines ``tools/<tool>.py``'s ``main`` prints for ``args``."""
    sys.path.insert(0, str(REPO / "tools"))
    mod = __import__(tool)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(Namespace(**args))
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def rows_of(tool: str, lines: list) -> dict:
    """``{(universe, lane): {metric: value}}`` from a tool's lines."""
    rows = {}
    for rec in lines:
        if tool == "eval_compare":
            rows[(rec["universe"], rec["model"])] = {
                k: rec[k] for k in ("calib_err", "crps", "nll")}
        elif tool == "eval_options":
            rows[(rec["universe"], rec["lane"])] = {
                k: v for k, v in rec.items()
                if k not in ("universe", "lane", "sec")}
        elif "lane" in rec:  # eval_multitask; its verdict line is skipped
            rows[("CORRVOL", rec["lane"])] = {
                **{f"marginal.{k}": v for k, v in rec["marginal"].items()},
                **{f"gust_energy.{k}": v
                   for k, v in rec["gust_energy"].items()}}
    return rows


def one_key(key: int) -> list:
    """Every item's rows with the tools' keys offset by ``key``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    orig = jax.random.key
    jax.random.key = lambda seed, *a, **kw: orig(seed + KEY_STRIDE * key,
                                                 *a, **kw)
    out = []
    for tool, args in ITEMS:
        rows = rows_of(tool, run_tool(tool, args))
        out.append([[list(k), v] for k, v in rows.items()])
        print(f"key {key}: {tool} {args.get('universes', '')} done",
              file=sys.stderr, flush=True)
    return out


def band_of(metric: str, lane: str, key0: float, further: list) -> dict:
    spread = max(abs(v - key0) for v in further)
    kind, x = FLOORS.get(metric.split(".")[-1], (None, None))
    rec = {"key0": key0, "further": further, "spread": spread}
    if kind is None:
        return {**rec, "gated": False,
                "why": "a signed mean, bounded by mae_bps, which is gated"}
    floor = x if kind == "abs" else x * abs(key0)
    rec.update(floor=floor, band=max(3 * spread, floor), gated=True)
    if metric == "nll" and lane in BASELINE_LANES and spread > 1:
        rec.update(gated=False, why="a baseline's nll whose JAX spread "
                   "over keys is above 1: printed, not gated")
    return rec


def merge(per_key: list, keys: list) -> dict:
    import jax

    items = []
    for i, (tool, args) in enumerate(ITEMS):
        rows0 = {tuple(k): v for k, v in per_key[0][i]}
        for (universe, lane), vals in rows0.items():
            further = [{tuple(k): v for k, v in per_key[j][i]}
                       [(universe, lane)] for j in range(1, len(keys))]
            items.append({
                "tool": tool, "universe": universe, "lane": lane,
                "argv": argv_of(args),
                "metrics": {m: band_of(m, lane, v, [f[m] for f in further])
                            for m, v in vals.items()}})
    return {
        "command": "JAX_PLATFORMS=cpu python tests/torch_eval_reference.py "
                   f"--keys {len(keys) - 1}",
        "jax_version": jax.__version__,
        "keys": keys,
        "key_rule": f"key k: every jax.random.key(s) made as "
                    f"jax.random.key(s + {KEY_STRIDE} * k); key 0 is what "
                    "the tools print",
        "spread": "max over the further keys of |value - key 0's value|",
        "band": "max(3 * spread, floor); floors: calib_err 0.01, nll 0.05, "
                "the others 2% of |key 0's value|; bias_bps and a "
                "baseline's nll with spread above 1 are printed, not gated",
        "items": items}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=8,
                    help="further keys (1..N) beside key 0")
    ap.add_argument("--one-key", type=int, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one_key is not None:
        print(json.dumps(one_key(a.one_key)))
        return
    keys = list(range(a.keys + 1))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, __file__, "--one-key",
                               str(k)], stdout=subprocess.PIPE, env=env,
                              cwd=REPO, text=True) for k in keys]
    per_key = []
    for k, p in zip(keys, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"key {k} failed ({p.returncode})")
        per_key.append(json.loads(out.strip().splitlines()[-1]))
    OUT.write_text(json.dumps(merge(per_key, keys), indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

"""Two evaluation results of the port against the JAX package's spread on
the CPU: ``eval_integral_rule``'s one-step coverage gaps (reference rule
and trapezoid) and ``eval_multitask``'s gust-energy ``calib_err``.

Each job runs one tool's ``main`` from one package in a process of its own
and prints its numbers: the JAX tool (``tools/<name>.py``) with every
``jax.random.key(s)`` made as ``jax.random.key(s + 1000003 * key)``, as
``tests/torch_eval_reference.py`` varies it, or the port's tool
(``volt_tpu_torch.tools.<name>``, ``--device cpu``) with its generator
seeded ``s + 1000003 * key``.  Key 0 is each tool as it stands.

* ``eval_integral_rule`` at its defaults (24 assets, ntrain 400, 150 Adam
  steps a stage, S=500) and data seeds 7 (the default), 8, 9 and 10,
  each at keys 0 to ``--keys - 1``;
* ``eval_multitask`` at its defaults (T=8, ntrain 200, 200 and 600 steps)
  but ``--mt-windows`` windows (16 at the defaults), keys 0 to
  ``--keys - 1``.

The summary gives, per number, both packages' values, JAX's spread over
its keys (the largest distance from key 0's value) and whether the port's
key-0 value lies within the evaluation phase's band of JAX's key 0,
``max(3 x spread, 0.01)``, and per tool and number the mean over seeds
and keys of each package.  Run from the repository root (about 40 min on
four processes)::

    JAX_PLATFORMS=cpu python tests/torch_eval_spread.py --out SPREAD.json

Not collected by pytest.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
KEY_STRIDE = 1000003


def _jax_main(tool, argv, key):
    import jax

    jax.config.update("jax_platforms", "cpu")
    orig = jax.random.key
    jax.random.key = lambda seed, *a, **kw: orig(seed + KEY_STRIDE * key,
                                                 *a, **kw)
    sys.path.insert(0, str(REPO / "tools"))
    mod = __import__(tool)
    buf = io.StringIO()
    sys.argv = [tool, *argv]
    with contextlib.redirect_stdout(buf):
        mod.main() if tool == "eval_integral_rule" else mod.main(
            _jax_multitask_args(argv))
    out = {}
    for line in buf.getvalue().splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if "lane" in rec:
                out[rec["lane"]] = rec
            else:
                (name, value), = rec.items()
                out[name] = value
    return out


def _jax_multitask_args(argv):
    ap = argparse.ArgumentParser()
    for name, default in (("windows", 16), ("tasks", 8), ("ntrain", 200),
                          ("horizon", 24), ("nsample", 256), ("iters", 200),
                          ("vol-iters", 600), ("k", 50)):
        ap.add_argument(f"--{name}", type=int, default=default)
    return ap.parse_args(argv)


def _port_main(tool, argv, key):
    import importlib

    sys.path.insert(0, str(REPO))
    mod = importlib.import_module(f"volt_tpu_torch.tools.{tool}")
    orig = mod.seeded
    mod.seeded = lambda device, seed: orig(device, seed + KEY_STRIDE * key)
    with contextlib.redirect_stdout(io.StringIO()):
        return mod.main(["--device", "cpu", *argv])


def _numbers(tool, out):
    if tool == "eval_integral_rule":
        v = out["verdict"]
        return {"step1_gap_reference": v["step1_coverage_gap_reference"],
                "step1_gap_trapezoid": v["step1_coverage_gap_trapezoid"]}
    return {f"{lane}.{part}.calib_err": out[lane][part]["calib_err"]
            for lane in ("independent", "multitask")
            for part in ("marginal", "gust_energy")}


def one(package, tool, argv, key):
    out = (_jax_main if package == "jax" else _port_main)(tool, argv, key)
    return _numbers(tool, out)


def jobs(keys, mt_windows):
    """``(setting, package, tool, argv, key)`` of every run."""
    out = []
    for package in ("jax", "port"):
        for seed in (7, 8, 9, 10):
            for key in range(keys):
                out.append((f"eval_integral_rule seed {seed}", package,
                            "eval_integral_rule", ["--seed", str(seed)],
                            key))
        for key in range(keys):
            out.append((f"eval_multitask W={mt_windows}", package,
                        "eval_multitask", ["--windows", str(mt_windows)],
                        key))
    return out


def summary(results):
    """Per setting and number: the values by package and key, JAX's
    spread, the port's key-0 distance from JAX's and the band."""
    table = {}
    for (setting, package, _, _, key), nums in results:
        for name, value in nums.items():
            row = table.setdefault(f"{setting}: {name}",
                                   {"jax": {}, "port": {}})
            row[package][key] = value
    pooled = {}
    for name, row in table.items():
        tool, number = name.split(" ", 1)[0], name.split(": ", 1)[1]
        for package in ("jax", "port"):
            pooled.setdefault(f"{tool} mean: {number}", {}).setdefault(
                package, []).extend(row[package].values())
    for row in table.values():
        j0 = row["jax"][0]
        row["jax_spread"] = max((abs(v - j0) for k, v in row["jax"].items()
                                 if k), default=0.0)
        row["port_minus_jax_key0"] = round(row["port"][0] - j0, 4)
        row["band"] = max(3 * row["jax_spread"], 0.01)
        row["within"] = abs(row["port_minus_jax_key0"]) <= row["band"]
    for name, row in pooled.items():
        table[name] = {p: round(sum(v) / len(v), 4) for p, v in row.items()}
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=4)
    ap.add_argument("--mt-windows", type=int, default=8)
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--out", default="")
    ap.add_argument("--one", nargs=4, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one:
        package, tool, argv_json, key = a.one
        print(json.dumps(one(package, tool, json.loads(argv_json),
                             int(key))))
        return None
    todo = jobs(a.keys, a.mt_windows)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}

    def run(job):
        setting, package, tool, targv, key = job
        proc = subprocess.run(
            [sys.executable, __file__, "--one", package, tool,
             json.dumps(targv), str(key)], cwd=REPO, env=env,
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{job} failed:\n{proc.stderr[-3000:]}")
        nums = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"setting": setting, "package": package,
                          "key": key, **nums}), flush=True)
        return job, nums

    with ThreadPoolExecutor(a.procs) as pool:
        results = list(pool.map(run, todo))
    table = summary(results)
    for name, row in table.items():
        print(json.dumps({name: row}))
    if a.out:
        Path(a.out).write_text(json.dumps(table, indent=1) + "\n")
    return table


if __name__ == "__main__":
    main()

"""What the first ``fit_forecast_batch`` call of a process spends beyond a
steady one.

In this fresh process it builds and loads the kernel library (the build
is ``bench_compile``'s ``build_s``, left out here), then runs the call
that ``volt_tpu_torch.tools.bench_compile`` times (``pipeline_call``)
as the process's first, once more unmeasured, and once more as the
steady call, and prints each measured call's wall time and stage seconds.

``--mode time`` runs the calls as they are, and samples the card's SM
clock, power draw and utilisation every 100 ms meanwhile (``nvidia-smi
-lms 100``), printing their median and range within each call.
``--mode profile`` runs the two measured calls under ``torch.profiler``
and prints the rows (operations, CUDA runtime calls, module loads) whose
own host time grew most from the steady call to the first; both calls
then carry the profiler's own cost, and its tables of a 300-step call
take minutes to make (``--iters 100`` keeps the run short).  Run from
the repository root, on the card::

    python tests/torch_first_call_profile.py --mode time
    python tests/torch_first_call_profile.py --mode profile --iters 100 \\
        --out chiprun_out/first_call.txt

``--out`` also writes the profiled calls' full tables.  Not collected by
pytest.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from volt_tpu_torch import native  # noqa: E402
from volt_tpu_torch.tools.bench_compile import pipeline_call  # noqa: E402

_SMI_FIELDS = "timestamp,clocks.sm,power.draw,utilization.gpu"


def _call(run, dev, profile):
    """``(seconds, stage seconds, key averages or None, (start, end))``."""
    ctx = contextlib.nullcontext()
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        ctx = torch.profiler.profile(activities=acts)
    with ctx as prof:
        start = datetime.now()
        t0 = time.perf_counter()
        _, aux = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        end = datetime.now()
    return (secs, aux["stage_seconds"],
            prof.key_averages() if profile else None, (start, end))


def _smi_samples(text):
    """``(time, SM MHz, W, utilisation %)`` from ``nvidia-smi``'s CSV."""
    out = []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            stamp = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
            out.append((stamp, float(parts[1].split()[0]),
                        float(parts[2].split()[0]),
                        float(parts[3].split()[0])))
        except (ValueError, IndexError):
            continue
    return out


def _window(samples, span):
    got = [s for s in samples if span[0] <= s[0] <= span[1]]
    if not got:
        return "no nvidia-smi samples"
    cols = list(zip(*got))[1:]
    return "; ".join(
        f"{name} median {statistics.median(c):.0f} ({min(c):.0f}-"
        f"{max(c):.0f})" for name, c in zip(("SM MHz", "W", "util %"),
                                            cols)) + f", {len(got)} samples"


def _growth(first, steady, rows):
    own = [{e.key: (e.self_cpu_time_total / 1e3, e.count) for e in avg}
           for avg in (first, steady)]
    lines = [f"own host ms, first call (calls) / steady call (calls), by "
             f"growth; all rows: first "
             f"{sum(v[0] for v in own[0].values()):.1f}, steady "
             f"{sum(v[0] for v in own[1].values()):.1f}"]
    grew = sorted(own[0], key=lambda k: own[1].get(k, (0.0, 0))[0]
                  - own[0][k][0])
    for key in grew[:rows]:
        f_ms, f_n = own[0][key]
        s_ms, s_n = own[1].get(key, (0.0, 0))
        lines.append(f"  {key[:60]:60s} {f_ms:10.1f} ({f_n}) / "
                     f"{s_ms:10.1f} ({s_n})")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("time", "profile"), default="time")
    ap.add_argument("--assets", type=int, default=64)
    ap.add_argument("--ntrain", type=int, default=1000)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--nsample", type=int, default=1000)
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--out", help="also write the profiled calls' tables")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    profile = a.mode == "profile"

    run = pipeline_call(a.assets, a.ntrain, a.horizon, a.iters, a.nsample,
                        dev)
    smi = None
    if dev.type == "cuda":
        native.library()
        if not profile:
            smi = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={_SMI_FIELDS}",
                 "--format=csv,noheader", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        first = _call(run, dev, profile)
        run()
        steady = _call(run, dev, profile)
    finally:
        samples = []
        if smi is not None:
            smi.terminate()
            samples = _smi_samples(smi.communicate(timeout=60)[0])
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    lines = [f"{a.assets} x {a.ntrain}, {a.iters} Adam steps a stage, "
             f"{a.nsample} paths, mode {a.mode} ({name})"]
    for what, (secs, stages, _, span) in (("first", first),
                                          ("steady", steady)):
        lines.append(f"{what} call: {secs:.3f} s; stage seconds "
                     + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        if smi is not None:
            lines.append(f"   card during it: {_window(samples, span)}")
    if profile:
        lines += _growth(first[2], steady[2], a.rows)
    print("\n".join(lines))
    if a.out and profile:
        tables = [f"\n{what} call\n" + avg.table(
            sort_by="self_cpu_time_total", row_limit=60)
            for what, avg in (("first", first[2]), ("steady", steady[2]))]
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(lines + tables) + "\n")


if __name__ == "__main__":
    main()

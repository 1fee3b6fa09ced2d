"""One run of a cell: set-up, the measured window, the traced call, the
check of the outputs against the reference, and the result line.  What a
call is (``entries/``), how the calls follow one another (``loops/``) and
how each metric is read (``metrics/``) are found by name."""

from __future__ import annotations

import gc
import json
import sys
import time
import traceback

import numpy as np
import torch

import cells
import devtrace
from traffic import Exhausted, Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "volt_tpu")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t0: float, log=print, control=None, numbers=None) -> dict:
    """The result of one run (the dict the last line prints); with
    ``control``, the control's numbers and verdict too, under
    ``"control"``; ``numbers``, a dict, takes every number of the check,
    those that no limit holds too."""
    device = torch.device(device)
    cfg, mix = spec["config"], spec["mix"]
    parts = {}

    def part(name, since):
        now = time.perf_counter()
        parts[name] = now - since
        return now

    t = part("import_s", t0)
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
        t = part("cuda_init_s", t)
        from volt_tpu_torch import native
        native.library()
        t = part("library_s", t)
    entry = cells.entry(cfg["entry"]).Entry(cfg, device, seed)
    traffic = Traffic(mix, cfg, seed, device)
    loop = cells.loop(mix["loop"]).Loop(entry, traffic, seed)
    _sync(device)
    t = part("inputs_s", t)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop.warm_up()
    t_start = part("warm_s", t)
    setup_s = t_start - t0
    for name, value in parts.items():
        log(f"setup {name} {value:.6f}")
    log(f"setup setup_s {setup_s:.6f}")

    ops = entry.ops(loop.iters)
    calls, attempted, failed = [], 0, 0
    deadline, last = t_start + seconds, t_start
    while time.perf_counter() < deadline:
        arrival = time.perf_counter()
        attempted += entry.assets
        try:
            got, aux = loop.call()
        except Exhausted:
            raise
        except Exception:  # a call that raises fails its assets
            traceback.print_exc()  # and its wait counts in the latencies
            failed += entry.assets
            calls.append({"seconds": time.perf_counter() - arrival,
                          "delivered": 0, "ops": 0, "stages": {}})
            continue
        last = time.perf_counter()
        ok = int(np.sum(got["ok"]))
        failed += entry.assets - ok
        calls.append({"seconds": last - arrival, "delivered": ok,
                      "ops": ops, "stages": entry.stages(aux)})
        loop.keep(got, aux)
        del got, aux
    window_s = last - t_start

    tr = None
    if trace:
        _, tr = devtrace.traced(loop.traced_call, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loop.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    check = Check(entry, control)
    loop.check(check)
    if numbers is not None:
        numbers.update(check.numbers)
    limits = spec["limits"]
    correct = any(c["delivered"] for c in calls) and check.passes(
        check.numbers, limits)

    record = {"calls": calls, "window_s": window_s, "setup_s": setup_s,
              "trace": tr, "assets": entry.assets, "n": entry.n}
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = cells.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    secs = [c["seconds"] for c in calls]
    if secs:  # how the host's speed moved over the window
        pcts = np.percentile(secs, [10, 25, 50, 75, 90]).round(4).tolist()
        tenths = [round(float(np.mean(s)), 4)
                  for s in np.array_split(secs, min(10, len(secs)))]
        log(f"window calls {len(secs)} seconds {window_s:.6f} call "
            f"percentiles 10-90 {pcts} mean by tenth {tenths}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = devtrace.breakdown(tr)
    if control is not None:
        result["control"] = {
            "correct": check.passes(check.controls, limits),
            "numbers": check.controls}
    result["check"] = {k: {"value": check.numbers.get(k), "limit": limits[k]}
                       for k in limits}
    return result


class Check:
    """The check's numbers: the reference run over the calls that a loop
    hands it, the program's outputs compared with it; with ``control``
    (a rounding of tensors), the same numbers of the reference run in
    float32 with its inputs, state and every Adam step rounded by it, in
    the program's place."""

    def __init__(self, entry, control=None):
        self.entry, self.control = entry, control
        self.numbers, self.controls = {}, {}

    def _low(self, items):
        return self.entry.reference(items, dtype=torch.float32,
                                    store=self.control)

    def _add(self, prefix, items, ref, low):
        e = self.entry
        self.numbers.update({prefix + k: v for k, v in
                             e.numbers(items, ref).items()})
        if low is not None:
            self.controls.update({prefix + k: v for k, v in e.numbers(
                e.as_kept(items, low), ref).items()})

    def compare(self, prefix: str, items: list):
        """The numbers of ``items`` (calls whose ``kept`` outputs are
        judged), named ``prefix`` + the entry's names; returns the items
        with the reference's and the control's results, for a chain."""
        t = time.perf_counter()
        ref = self.entry.reference(items)
        low = self._low(items) if self.control else None
        self._add(prefix, items, ref, low)
        print(f"check {prefix or 'window'} seconds "
              f"{time.perf_counter() - t:.3f}", file=sys.stderr)
        return items, ref, low

    def chain(self, prefix: str, first, steps: list):
        """The numbers of the last of ``steps`` (single calls, in order,
        each refit from the state that the one before left) reached from
        ``first`` (``compare``'s return for the call before them) by the
        reference's own states, and by the control's own."""
        t = time.perf_counter()
        before, ref, low = first
        for it in steps:
            ref_it = dict(it, prev=self.entry.state(before, ref))
            ref = self.entry.reference([ref_it])
            if self.control:
                low_it = dict(it, prev=self.entry.state(before, low))
                low = self._low([low_it])
            before = [ref_it]
        self._add(prefix, [steps[-1]], ref, low)
        print(f"check {prefix} seconds {time.perf_counter() - t:.3f}",
              file=sys.stderr)

    @staticmethod
    def passes(numbers: dict, limits: dict) -> bool:
        return all(k in numbers and np.isfinite(numbers[k])
                   and numbers[k] <= limits[k] for k in limits)


def forbidden() -> list:
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def report(result: dict, log=print):
    """The numbers compared beside their limits on standard error, then
    the result as the last line of standard output."""
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr)
    log(json.dumps(result))

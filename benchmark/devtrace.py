"""One call under ``torch.profiler`` (CUDA activity), reduced to what the
per-layer metrics read: device seconds and launches by kernel name, the
seconds in which a kernel or a copy ran, and the idle gaps between them,
each named by the kernel that ended it."""

from __future__ import annotations

import collections
import time

import torch


def _short(name: str) -> str:
    """A kernel's name without the namespaces that every ATen kernel
    carries, cut to 120 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::cuda::detail::", "std::"):
        name = name.replace(noise, "")
    return name if len(name) <= 120 else name[:117] + "..."


def traced(fn, device):
    """Run ``fn()`` under the profiler; returns ``(fn's result, trace)``.
    Without a card (the CPU tests) nothing runs on a device, and the
    trace holds no kernels."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        window = time.perf_counter() - t0
    return result, reduce(prof.profiler.kineto_results.events(), window)


def reduce(events, window_s: float) -> dict:
    """``{"kernels": {name: [launches, seconds]}, "launches", "busy_s",
    "window_s", "idle_by_next": {name: seconds}}`` from the profiler's
    events; copies and sets count as busy, not as launches."""
    spans, kernels = [], collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        name = e.name()
        spans.append((start, start + dur, name))
        if not name.startswith(("Memcpy", "Memset")):
            k = kernels[name]
            k[0] += 1
            k[1] += dur * 1e-9
    spans.sort()
    busy, idle = 0, collections.defaultdict(float)
    end = None
    for s, e, name in spans:
        if end is None or s >= end:
            if end is not None:
                idle[_short(name)] += (s - end) * 1e-9
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {"kernels": dict(kernels),
            "launches": sum(k[0] for k in kernels.values()),
            "busy_s": busy * 1e-9, "window_s": window_s,
            "idle_by_next": dict(idle)}


def kernel_sum(trace: dict, part: str):
    """``(launches, seconds)`` of the kernels whose name holds ``part``."""
    hits = [v for k, v in trace["kernels"].items() if part in k]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def breakdown(trace: dict) -> dict:
    """The ten kernels that took most device time and the ten largest
    sums of idle time, each by the kernel that ended the gap."""
    ops = sorted(((_short(k), v[1]) for k, v in trace["kernels"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(((f"before {k}", v) for k, v in
                   trace["idle_by_next"].items()), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(o) for o in ops],
            "idle_gaps": [list(g) for g in gaps]}

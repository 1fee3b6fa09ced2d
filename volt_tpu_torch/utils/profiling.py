"""Profiling and timing (port of :mod:`volt_tpu.utils.profiling`).

``annotate`` names a region on the profiler's timeline (and on the card
in NVTX), ``trace`` records the CPU and CUDA activity of a block into a
Chrome trace, and ``timed`` / ``timed_best`` / ``timed_cold_best`` take
wall times whose end waits for the card: PyTorch returns before the device finishes, so each
timed call ends in ``torch.cuda.synchronize`` of its result's devices.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["annotate", "trace", "timed", "timed_best", "timed_cold_best"]


@contextlib.contextmanager
def annotate(name: str):
    """A named region: ``torch.profiler.record_function``, and an NVTX
    range where there is a card."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA where there is a card)
    and write its Chrome trace to ``log_dir/trace.json`` (open it in
    Perfetto or ``chrome://tracing``).  Yields the profiler, whose
    ``key_averages()`` sum the time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(result):
    """Wait for every CUDA device that holds a tensor of ``result``."""
    devices, stack = set(), [result]
    while stack:
        item = stack.pop()
        if isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif torch.is_tensor(item) and item.is_cuda:
            devices.add(item.device)
    for device in devices:
        torch.cuda.synchronize(device)
    return result


def timed_cold_best(fn, repeats: int = 3):
    """``(result, best_seconds, cold_seconds)``: the first call, timed
    (``cold_seconds``: on a fresh process it pays the first use of each
    library, handle and allocation), then the least time of ``repeats``
    calls."""
    t0 = time.perf_counter()
    result = _synchronize(fn())
    cold = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        result = _synchronize(fn())
        best = min(best, time.perf_counter() - t0)
    return result, best, cold


def timed_best(fn, repeats: int = 3):
    """``(result, best_seconds)``: one warm call, then the least time of
    ``repeats`` calls (same return order as :func:`timed`)."""
    return timed_cold_best(fn, repeats)[:2]


def timed(fn, *args, warmup: int = 1, repeats: int = 1, **kwargs):
    """``(result, seconds)``: ``warmup`` untimed calls, then the mean time
    of ``repeats`` calls of ``fn(*args, **kwargs)``."""
    result = None
    for _ in range(max(warmup, 0)):
        result = _synchronize(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(max(repeats, 1)):
        result = _synchronize(fn(*args, **kwargs))
    elapsed = (time.perf_counter() - t0) / max(repeats, 1)
    return result, elapsed

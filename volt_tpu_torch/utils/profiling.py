"""Profiling and timing (port of :mod:`volt_tpu.utils.profiling`).

``annotate`` is the program's span.  Off, the default, it returns one
shared no-op context, and costs a read of a module flag.  Inside
``recording()`` it appends ``Span(name, start_ns, end_ns, parent,
call_id)`` to a buffer that ``spans()`` hands over: ``parent`` is the
enclosing span's index in that buffer (``None`` at the top), and
``call_id`` is shared by the spans of one pipeline call (a ``call``
span, or a span with no parent, opens a new one).  Its stamps are
``time.time_ns()``, the clock on which ``torch.profiler`` stamps its CPU
and device events, so spans and kernels lie on one time line.  While a
``torch.profiler`` runs, a recorded span is also a ``record_function``
region.  ``stage`` is a pipeline stage's span with its seconds, which
wait for the card whether spans are recorded or not, and ``annotated``
wraps a function in a span.

The span names the pipeline records, and the metrics that read them,
are listed in PERF.md.  A span named ``sync:<site>`` encloses a place
where the program waits for the card; those spans count the visits to
each such site (a visit may make more than one of PyTorch's syncs).
``device_constant`` is the one way a fixed constant reaches the card.

``trace`` records the CPU and CUDA activity of a block into a Chrome
trace, with the block's spans as its regions, and ``timed`` /
``timed_best`` / ``timed_cold_best`` take wall times whose end waits for
the card: PyTorch returns before the device finishes, so each timed call
ends in ``torch.cuda.synchronize`` of its result's devices.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import time

import torch

__all__ = ["Span", "annotate", "annotated", "recording", "spans", "stage",
           "trace", "timed", "timed_best", "timed_cold_best"]

Span = collections.namedtuple("Span", "name start_ns end_ns parent call_id")

_recording = False
_buffer = []  # [name, start_ns, end_ns, parent, call_id] rows, by start
_open = []  # (row index, call_id) of the open spans, innermost last
_call_ids = itertools.count()
_OFF = contextlib.nullcontext()
_CONSTANTS = 256
_constants = collections.OrderedDict()  # (site, key, dtype, device) -> tensor


class _Span:
    """One recorded span (``annotate`` while recording)."""

    __slots__ = ("name", "row", "region")

    def __init__(self, name: str):
        self.name, self.row, self.region = name, None, None

    def __enter__(self):
        parent = _open[-1][0] if _open else None
        call_id = (_open[-1][1] if _open and self.name != "call"
                   else next(_call_ids))
        if torch.autograd._profiler_enabled():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        _open.append((len(_buffer), call_id))
        self.row = [self.name, time.time_ns(), None, parent, call_id]
        _buffer.append(self.row)
        return self

    def __exit__(self, *exc):
        self.row[2] = time.time_ns()
        _open.pop()
        if self.region is not None:
            self.region.__exit__(*exc)
        return False


def annotate(name: str):
    """A named span: recorded inside :func:`recording`, else nothing."""
    return _Span(name) if _recording else _OFF


def annotated(name: str):
    """Decorate a function so that each call is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def device_constant(site: str, make, *key, dtype, device=None):
    """``make(*key)``, host data, as a ``dtype`` tensor on ``device``
    (``None``: the CPU), the same tensor for a ``(site, key, dtype, device)``
    among the last ``_CONSTANTS`` used.  Only a miss copies, in a span
    ``sync:<site>``.  Callers share the tensor: read it, never write it."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    entry = (site, key, dtype, device)
    if entry not in _constants:
        with annotate(f"sync:{site}"):
            _constants[entry] = torch.tensor(make(*key), dtype=dtype,
                                             device=device)
        if len(_constants) > _CONSTANTS:
            _constants.popitem(last=False)
    _constants.move_to_end(entry)
    return _constants[entry]


@contextlib.contextmanager
def recording():
    """Record the spans of the enclosed block (read them with
    :func:`spans`)."""
    global _recording
    before, _recording = _recording, True
    try:
        yield
    finally:
        _recording = before


def spans() -> list:
    """The recorded spans, in the order they opened, as :class:`Span`;
    empties the buffer.  Read it where no span is open (between calls):
    the ``parent`` of a span that opens later would point into the
    emptied buffer."""
    out = [Span(*row) for row in _buffer]
    _buffer.clear()
    return out


@contextlib.contextmanager
def stage(name: str, seconds: dict, device: torch.device):
    """A pipeline stage: the span ``name``, its wall seconds put in
    ``seconds[name]``.  On a CUDA ``device`` the stage waits for the
    device before it closes (a ``sync:stage_end`` span), and the first
    stage of a call (``seconds`` still empty) also before it opens
    (``sync:stage_start``, outside the stage's span), so a stage's
    seconds hold the work it queued, recorded or not."""
    cuda = device.type == "cuda"
    if cuda and not seconds:
        with annotate("sync:stage_start"):
            torch.cuda.synchronize(device)
    span, t0 = annotate(name), time.time_ns()
    with span:
        yield
        if cuda:
            with annotate("sync:stage_end"):
                torch.cuda.synchronize(device)
    start, end = (t0, time.time_ns()) if span is _OFF else span.row[1:3]
    seconds[name] = (end - start) * 1e-9


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA where there is a card),
    its spans recorded as the profiler's regions, and write its Chrome
    trace to ``log_dir/trace.json`` (open it in Perfetto or
    ``chrome://tracing``).  The block's spans live on in the trace alone:
    ``spans()`` does not see them.  Yields the profiler, whose
    ``key_averages()`` sum the time by operation, span and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    kept = len(_buffer)
    try:
        with recording(), torch.profiler.profile(
                activities=activities) as prof:
            yield prof
    finally:
        del _buffer[kept:]
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

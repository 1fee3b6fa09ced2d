"""The program's spans (``volt_tpu_torch.utils.profiling``): nothing is
recorded while recording is off, and the stages wait for the card alike
on and off; ``trace`` leaves no spans behind; recording changes no
output bit; the span tree of a pipeline call is the documented one
(PERF.md §3); spans share ``torch.profiler``'s clock; and the ``sync:``
spans count each host-device sync site once a call."""

import numpy as np
import pytest
import torch

from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                     PipelineConfig, fit_forecast_batch,
                                     fit_forecast_multitask, warm_start)
from volt_tpu_torch.utils import profiling
from volt_tpu_torch.utils.profiling import annotate, recording, spans

B, N, H, S, DT = 2, 64, 5, 16, 1.0 / 252
STAGES = ["gpcv", "vol", "data", "rollout"]
STEPS = 3


@pytest.fixture(autouse=True)
def empty_buffer():
    spans()
    yield
    spans()


def _prices(assets, seed=3):
    rng = np.random.default_rng(seed)
    logp = np.cumsum(0.01 * rng.standard_normal((assets, N + 1)), axis=-1)
    return torch.tensor(100.0 * np.exp(logp), dtype=torch.float32)


def _grids():
    x = torch.arange(N, dtype=torch.float32) * DT
    return x, torch.arange(H, dtype=torch.float32) * DT + x[-1] + DT


def _batch(init=None, steps=STEPS):
    x, test_x = _grids()
    cfg = PipelineConfig(gpcv_iters=steps, vol_iters=steps,
                         data_iters=steps, k=10, nsample=S,
                         output="quantiles")
    return fit_forecast_batch(torch.Generator().manual_seed(5), x,
                              _prices(B), test_x, cfg, init_params=init)


def _multitask():
    x, test_x = _grids()
    cfg = MultitaskPipelineConfig(gpcv_iters=STEPS, vol_iters=STEPS,
                                  data_iters=STEPS, nsample=S,
                                  output="quantiles")
    return fit_forecast_multitask(torch.Generator().manual_seed(5), x,
                                  _prices(3), test_x, cfg)


def _children(rows, index):
    return [i for i, s in enumerate(rows) if s.parent == index]


def _names(rows, indices):
    return [rows[i].name for i in indices]


def _check_nesting(rows):
    """Every span closed, inside its parent, after its earlier sibling."""
    for i, s in enumerate(rows):
        assert s.end_ns is not None and s.start_ns <= s.end_ns, s
        if s.parent is not None:
            p = rows[s.parent]
            assert s.parent < i
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
    for i in range(len(rows)):
        kids = _children(rows, i)
        for a, b in zip(kids, kids[1:]):
            assert rows[a].end_ns <= rows[b].start_ns


def test_off_records_nothing_and_stages_still_wait(monkeypatch):
    """(a) Off, ``annotate`` is the one shared no-op context and records
    nothing; a call's stages on a CUDA device wait for it all the same,
    before the first opens and as each closes, so ``stage_seconds`` mean
    one thing recorded or not.  On, those waits are ``sync:`` spans."""
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", waits.append)
    assert annotate("x") is annotate("y")
    with annotate("x"):
        pass
    seconds, card = {}, torch.device("cuda", 0)
    with profiling.stage("gpcv", seconds, card):
        pass
    with profiling.stage("vol", seconds, card):
        pass
    assert spans() == [] and waits == [card, card, card]
    assert set(seconds) == {"gpcv", "vol"} and seconds["gpcv"] >= 0.0
    waits.clear()
    seconds = {}
    with recording():
        with profiling.stage("gpcv", seconds, card):
            pass
        with profiling.stage("vol", seconds, card):
            pass
    assert waits == [card, card, card]
    assert [(s.name, s.parent) for s in spans()] == [
        ("sync:stage_start", None), ("gpcv", None), ("sync:stage_end", 1),
        ("vol", None), ("sync:stage_end", 3)]
    _batch()
    assert spans() == [] and waits == [card, card, card]


def test_trace_leaves_no_spans_behind(tmp_path):
    """``trace`` records its block's spans as the profiler's regions and
    drops them from the buffer as it ends; spans recorded around it stay."""
    with recording():
        with annotate("before"):
            pass
        with profiling.trace(str(tmp_path)):
            with annotate("traced"):
                torch.ones(8).sum()
    assert [s.name for s in spans()] == ["before"]
    assert "traced" in (tmp_path / "trace.json").read_text()


def _bits(tree):
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    return tree.numpy().tobytes() if torch.is_tensor(tree) else tree


def test_recording_changes_no_output_bit():
    """(b) The same call with spans recorded and without: every output
    and ``aux`` entry bit for bit, ``stage_seconds`` aside."""
    off_out, off_aux = _batch()
    with recording():
        on_out, on_aux = _batch()
    assert spans()
    assert set(on_aux["stage_seconds"]) == set(STAGES)
    for aux in (off_aux, on_aux):
        del aux["stage_seconds"]
    assert _bits(on_out) == _bits(off_out)
    assert _bits(on_aux) == _bits(off_aux)


def test_batch_span_tree():
    """(c) One ``call``; the four stages in order under it; three
    ``adam_step`` spans, each of ``forward``, ``backward`` and ``update``,
    in each fitting stage; the named inner spans; one ``call_id``."""
    with recording():
        _, aux = _batch()
    rows = spans()
    _check_nesting(rows)
    roots = _children(rows, None)
    assert _names(rows, roots) == ["call"]
    assert len({s.call_id for s in rows}) == 1
    under_call = _names(rows, _children(rows, roots[0]))
    assert [n for n in under_call if not n.startswith("sync:")] == STAGES
    stages = {rows[i].name: i for i in _children(rows, roots[0])}
    for name in STAGES:  # the stage's seconds are its span's
        s = rows[stages[name]]
        assert aux["stage_seconds"][name] == (s.end_ns - s.start_ns) * 1e-9
    inner = {"gpcv": ["init", "adam_step", "scale"],
             "vol": ["init", "spectral_cache", "adam_step", "fit_state"],
             "data": ["init", "integral", "train_mean", "adam_step",
                      "fit_state"],
             "rollout": ["sample_vol", "scan", "fan"]}
    for name, want in inner.items():
        kids = [i for i in _children(rows, stages[name])
                if not rows[i].name.startswith("sync:")]
        got = _names(rows, kids)
        assert [n for i, n in enumerate(got)
                if n != "adam_step" or i == got.index(n)] == want
        steps = [i for i in kids if rows[i].name == "adam_step"]
        assert len(steps) == (STEPS if name != "rollout" else 0)
        for i in steps:
            assert _names(rows, _children(rows, i)) == ["forward",
                                                        "backward",
                                                        "update"]


def test_warm_start_is_its_own_call():
    """A span outside any call (``warm_start``) opens its own ``call_id``;
    the refit's spans share the next one."""
    _, aux = _batch()
    with recording():
        init = warm_start(aux, shift=1, n=N)
        _batch(init)
    rows = spans()
    roots = _children(rows, None)
    assert _names(rows, roots) == ["warm_start", "call"]
    assert rows[roots[0]].call_id != rows[roots[1]].call_id
    assert {s.call_id for s in rows[roots[1]:]} == {rows[roots[1]].call_id}
    # the refit loads its state, so nothing climbs a Cholesky ladder
    assert "sync:jitter" not in _names(rows, range(len(rows)))


def _inner(rows, index):
    """The names of a span's children, its ``sync:`` spans left out."""
    return [n for n in _names(rows, _children(rows, index))
            if not n.startswith("sync:")]


def test_multitask_span_tree():
    """(d) ``fit_forecast_multitask``: one ``call``, the four stages in
    order, three ``adam_step`` spans in each fitting stage; each GPCV
    forward split into ``ell`` and ``kron_kl``, each vol forward a
    ``woodbury`` with its ``sync:solve``; the Matheron sampler its own
    stage ``sample_vol`` inside ``rollout``, of ``prior_draw``, ``eigh``
    (with ``sync:eigh``) and ``kron_solve``."""
    with recording():
        _, aux = _multitask()
    rows = spans()
    _check_nesting(rows)
    roots = _children(rows, None)
    assert _names(rows, roots) == ["call"]
    assert len({s.call_id for s in rows}) == 1
    kids = [i for i in _children(rows, roots[0])
            if not rows[i].name.startswith("sync:")]
    assert _names(rows, kids) == STAGES
    assert set(aux["stage_seconds"]) == set(STAGES) | {"sample_vol"}
    forwards = {"gpcv": ["ell", "kron_kl"], "vol": ["woodbury"],
                "data": []}
    for i in kids:
        steps = [j for j in _children(rows, i)
                 if rows[j].name == "adam_step"]
        assert len(steps) == (STEPS if rows[i].name != "rollout" else 0)
        for j in steps:
            (fwd,) = [k for k in _children(rows, j)
                      if rows[k].name == "forward"]
            assert _inner(rows, fwd) == forwards[rows[i].name]
    stages = dict(zip(STAGES, kids))
    assert _inner(rows, stages["rollout"]) == ["sample_vol", "scan", "fan"]
    (sample,) = [i for i in _children(rows, stages["rollout"])
                 if rows[i].name == "sample_vol"]
    assert _inner(rows, sample) == ["prior_draw", "eigh", "kron_solve"]
    s = rows[sample]
    assert aux["stage_seconds"]["sample_vol"] == (s.end_ns - s.start_ns) * 1e-9
    parents = {(r.name, rows[r.parent].name) for r in rows
               if r.name in ("sync:solve", "sync:eigh")}
    assert parents == {("sync:solve", "woodbury"), ("sync:eigh", "eigh")}
    assert sum(r.name == "sync:solve" for r in rows) == STEPS


def test_multitask_off_records_nothing():
    """A multitask call outside ``recording()`` records no span, and its
    stage clock still holds the four stages and ``sample_vol``."""
    _, aux = _multitask()
    assert spans() == []
    assert set(aux["stage_seconds"]) == set(STAGES) | {"sample_vol"}


def test_spans_share_the_profilers_clock():
    """(e) The ops run inside a span have ``torch.profiler`` CPU events
    within that span's ``[start_ns, end_ns]``, and the span is one of the
    profiler's regions."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        with annotate("matmul"):
            a = torch.ones(64, 64)
            a @ a
    (span,) = spans()
    events = prof.profiler.kineto_results.events()
    ops = [e for e in events if e.name().startswith("aten::")]
    assert ops
    for e in ops:
        assert span.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= span.end_ns
    assert any(e.name() == "matmul" for e in events)


def test_equispaced_sync_counted_once_a_call():
    """(f) The spectral grid's check copies ``train_x`` to the host once a
    call, inside a ``sync:equispaced`` span under ``call``."""
    with recording():
        _batch()
        _batch()
    rows = spans()
    syncs = [s for s in rows if s.name == "sync:equispaced"]
    assert len(syncs) == 2
    for s in syncs:
        assert rows[s.parent].name == "call"
    assert len({s.call_id for s in syncs}) == 2


def _sync_sites(init=None, steps=STEPS):
    """A batched call's result and its ``sync:`` spans, each as ``(name,
    its parent's name)``."""
    with recording():
        result = _batch(init, steps)
    rows = spans()
    return result, sorted((s.name, rows[s.parent].name) for s in rows
                          if s.name.startswith("sync:"))


def test_a_warm_tick_counts_its_sync_sites():
    """The ``sync:`` spans of a refit.  From an empty cache of constants a
    cold call visits the grid check and each constant site once: the three
    Adam loops' step tables (one table, the loops take as many steps), the
    quadrature nodes of the predicted scale, the train mean's taps, the
    integral's end weights and the fan's levels.  The first warm tick,
    at fewer steps, visits the grid check and the one constant it misses,
    the step tables; a second warm tick the grid check alone (the sites a
    census of the card's syncs over a tick finds, PERF.md §3)."""
    profiling._constants.clear()
    (_, aux), cold = _sync_sites()
    assert cold == sorted([("sync:equispaced", "call"),
                           ("sync:adam_tables", "gpcv"),
                           ("sync:gh_nodes", "scale"),
                           ("sync:ewma_taps", "train_mean"),
                           ("sync:cumtrapz", "integral"),
                           ("sync:levels", "fan")])
    (_, aux), first = _sync_sites(warm_start(aux, shift=1, n=N), STEPS - 1)
    assert first == sorted([("sync:equispaced", "call"),
                            ("sync:adam_tables", "gpcv")])
    _, second = _sync_sites(warm_start(aux, shift=1, n=N), STEPS - 1)
    assert second == [("sync:equispaced", "call")]


def test_device_constant_is_built_and_copied_once():
    """A hit returns the same tensor, and another dtype, key or site
    another one; ``None``, ``"cpu"`` and ``torch.device("cpu")`` share an
    entry; a miss records one ``sync:<site>`` span and makes the host
    value once, a hit neither."""
    made = []

    def make(n):
        made.append(n)
        return np.arange(n)

    with recording():
        a = profiling.device_constant("t_a", make, 3, dtype=torch.float32)
        same = [profiling.device_constant("t_a", make, 3,
                                          dtype=torch.float32, device=d)
                for d in (None, "cpu", torch.device("cpu"))]
    assert [s.name for s in spans()] == ["sync:t_a"]
    assert made == [3] and all(t is a for t in same)
    torch.testing.assert_close(a, torch.arange(3, dtype=torch.float32))
    with recording():
        others = [profiling.device_constant("t_a", make, 3,
                                            dtype=torch.float64),
                  profiling.device_constant("t_a", make, 4,
                                            dtype=torch.float32),
                  profiling.device_constant("t_b", make, 3,
                                            dtype=torch.float32)]
    assert [s.name for s in spans()] == ["sync:t_a", "sync:t_a", "sync:t_b"]
    assert len({id(t) for t in [a, *others]}) == 4
    assert made == [3, 3, 4, 3]

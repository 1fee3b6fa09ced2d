"""The FBM pipeline (``fit_forecast_batch(kernel="fbm")`` and
``warm_start``) against the benchmark's frozen plain copy of it,
``benchmark/reference/vfbm``, on the CPU in float64: a cold fit, then one
warm tick at shift 1.  Also the FBM path's spans (``fbm_factor``,
``dense_kl``, ``dense_mll``, ``dense_sample``), which nest under their
stages inside ``recording()`` and are absent outside it, and the per-lane
jitter ladder's counter ``ops.chol.ladder_counts``."""

import ast
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from volt_tpu_torch.ops import chol
from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                     warm_start)
from volt_tpu_torch.utils.profiling import recording, spans

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference.vfbm import pipeline as ref  # noqa: E402

B, N, H, S, DT = 3, 48, 8, 16, 1.0 / 252
STEPS = 10
SETTINGS = dict(gpcv_iters=STEPS, vol_iters=STEPS, data_iters=STEPS,
                kernel="fbm", gpcv_q="full", vol_mll="kalman", k=10,
                nsample=S, output="quantiles")
DENSE = ("fbm_factor", "dense_kl", "dense_mll", "dense_sample")

# The port and the copy run the same algebra in the same order in float64,
# so they agree to rounding; 1e-9 of each value's scale leaves room for a
# library's summation order, and is far below what a changed formula moves
# (a dropped KL term moves the GPCV loss by its whole size).
RTOL = 1e-9


def _inputs():
    rng = np.random.default_rng(4)
    logp = np.cumsum(0.012 * rng.standard_normal((B, N + 2)), axis=-1)
    prices = torch.tensor(10.0 * np.exp(logp), dtype=torch.float64)
    x = torch.arange(N, dtype=torch.float64) * DT
    test_x = torch.arange(H, dtype=torch.float64) * DT + x[-1] + DT
    g = torch.Generator().manual_seed(3)
    noise = {k: torch.randn(*shape, generator=g, dtype=torch.float64)
             for k, shape in (("vol_r0", (B, S)), ("vol_z", (B, S, H)),
                              ("zs", (B, S, H)))}
    return prices, x, test_x, noise


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return tree.float()


@pytest.fixture(scope="module")
def runs():
    """``{tick: (port's (out, aux), reference's (out, aux))}`` for the cold
    fit and the warm tick after it."""
    prices, x, test_x, noise = _inputs()
    gen = torch.Generator().manual_seed(0)
    port = fit_forecast_batch(gen, x, prices[:, :-1], test_x,
                              PipelineConfig(**SETTINGS), noise=noise)
    copy = ref.fit_forecast_batch(gen, x, prices[:, :-1], test_x,
                                  ref.PipelineConfig(**SETTINGS), noise=noise)
    port_warm = fit_forecast_batch(
        gen, x, prices[:, 1:], test_x, PipelineConfig(**SETTINGS),
        init_params=warm_start(port[1], shift=1, n=N), noise=noise)
    # the port loads a warm start in float32 (convert.load_jax_params), so
    # the copy is handed its own warm start in float32 too
    copy_warm = ref.fit_forecast_batch(
        gen, x, prices[:, 1:], test_x, ref.PipelineConfig(**SETTINGS),
        init_params=_float32(ref.warm_start(copy[1], shift=1, n=N)),
        noise=noise)
    return {"cold": (port, copy), "warm": (port_warm, copy_warm)}


def _close(got, want):
    got, want = got.double(), want.double()
    scale = max(1.0, want.abs().max().item())
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0.0, atol=RTOL * scale)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


@pytest.mark.parametrize("tick", ["cold", "warm"])
@pytest.mark.parametrize("what", ["losses", "vol", "params", "fan"])
def test_fbm_pipeline_matches_the_plain_reference(runs, tick, what):
    """Each stage's per-step losses, the GPCV vol path, every fitted
    parameter (the dense root, both Hurst parameters) and the fan with its
    mean and std, of the cold fit and of the warm tick at shift 1."""
    (out, aux), (ref_out, ref_aux) = runs[tick]
    assert bool(aux["ok"].all()) and bool(ref_aux["ok"].all())
    if what == "losses":
        for stage in ("gpcv", "vol", "data"):
            _close(aux[f"{stage}_losses"], ref_aux[f"{stage}_losses"])
    elif what == "vol":
        _close(aux["vol"], ref_aux["vol"])
    elif what == "params":
        for key in ("gpcv_params", "vol_params", "volt_params"):
            want = dict(_leaves(ref_aux[key]))
            got = dict(_leaves(aux[key]))
            assert set(got) == set(want)
            for leaf in want:
                _close(got[leaf], want[leaf])
    else:
        _close(out, ref_out)
        for key in ("forecast_mean", "forecast_std"):
            _close(aux[key], ref_aux[key])


def test_the_reference_imports_nothing_of_the_program():
    """Every module of the copy imports neither the port nor JAX."""
    for path in sorted((BENCH / "reference" / "vfbm").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert not name.startswith(("volt_tpu", "jax", "flax")), \
                    (path.name, name)


def _tick(kernel: str, record: bool):
    """A cold fit, then a warm tick at shift 1, the tick's spans recorded
    where ``record``; returns the tick's spans."""
    prices, x, test_x, _ = (t.float() if torch.is_tensor(t) else t
                            for t in _inputs())
    cfg = PipelineConfig(**dict(SETTINGS, kernel=kernel, gpcv_iters=2,
                                vol_iters=2, data_iters=2))
    gen = torch.Generator().manual_seed(0)
    _, aux = fit_forecast_batch(gen, x, prices[:, :-1], test_x, cfg)
    spans()
    with recording() if record else contextlib.nullcontext():
        fit_forecast_batch(gen, x, prices[:, 1:], test_x, cfg,
                           init_params=warm_start(aux, shift=1, n=N))
    return spans()


def _path(rows, i):
    """The names from the top span down to span ``i``."""
    names = []
    while i is not None:
        names.append(rows[i].name)
        i = rows[i].parent
    return names[::-1]


def test_fbm_spans_nest_under_their_stages():
    """Inside ``recording()``: ``dense_kl`` and an ``fbm_factor`` in each
    GPCV forward; ``dense_mll`` in each vol forward, an ``fbm_factor`` in
    it; ``dense_sample`` in the rollout's ``sample_vol``, an
    ``fbm_factor`` in it; no ``fbm_factor`` anywhere else."""
    rows = _tick("fbm", record=True)
    paths = {i: _path(rows, i) for i in range(len(rows))}
    where = {name: [paths[i][:-1] for i, s in enumerate(rows)
                    if s.name == name] for name in DENSE}
    fwd = ["call", "gpcv", "adam_step", "forward"]
    assert where["dense_kl"] == [fwd] * 2
    assert where["dense_mll"] == [["call", "vol", "adam_step",
                                   "forward"]] * 2
    assert where["dense_sample"] == [["call", "rollout", "sample_vol"]]
    assert sorted(map(tuple, where["fbm_factor"])) == sorted(
        [tuple(fwd)] * 2
        + [("call", "vol", "adam_step", "forward", "dense_mll")] * 2
        + [("call", "rollout", "sample_vol", "dense_sample")])


@pytest.mark.parametrize("kernel,record", [("fbm", False), ("bm", True)])
def test_no_dense_spans_outside_recording_or_off_the_fbm_path(kernel,
                                                               record):
    """Outside ``recording()`` the FBM tick records nothing; a recorded
    BM tick has none of the four spans."""
    rows = _tick(kernel, record)
    assert bool(rows) == record
    assert not [s for s in rows if s.name in DENSE]


def _spd(lanes: int, n: int = 6):
    g = torch.Generator().manual_seed(1)
    a = torch.randn(lanes, n, n, generator=g, dtype=torch.float64)
    return a @ a.mT + n * torch.eye(n, dtype=torch.float64)


@pytest.mark.parametrize("case", ["definite", "one_indefinite",
                                  "fixed_by_the_first_rung", "whole_batch"])
def test_ladder_counts_its_retried_lanes(case):
    """``ladders`` counts each call of the per-lane ladder and
    ``lanes_retried`` each lane it factors again, at each rung: a batch of
    definite matrices retries nothing; a lane made indefinite is retried
    at each of the three rungs; a lane that the first rung fixes, once.
    The whole-batch ladder counts nothing."""
    a = _spd(4)
    want_lanes = 0
    if case == "one_indefinite":
        a[2] -= 100.0 * torch.eye(6, dtype=torch.float64)
        want_lanes = 3
    elif case == "fixed_by_the_first_rung":
        evals, evecs = torch.linalg.eigh(a[1])
        # the smallest eigenvalue set to -1e-9: the bare factor fails,
        # the first rung's 1e-8 leaves it definite
        a[1] = evecs @ torch.diag(torch.cat([
            torch.tensor([-1e-9], dtype=torch.float64), evals[1:]])) \
            @ evecs.mT
        want_lanes = 1
    chol.ladder_counts.clear()
    got = chol.psd_safe_cholesky(a, per_lane=case != "whole_batch")
    if case == "whole_batch":
        assert chol.ladder_counts == {}
        return
    assert chol.ladder_counts["ladders"] == 1
    assert chol.ladder_counts["lanes_retried"] == want_lanes
    bad = torch.isnan(got).any(dim=(-2, -1))
    assert bad.tolist() == [case == "one_indefinite" and i == 2
                            for i in range(4)]

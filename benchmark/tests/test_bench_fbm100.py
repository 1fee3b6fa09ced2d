"""The FBM cell ``fbm100.live_refit`` as ``BENCHMARK.json`` declares it:
its per-layer metrics, which leave those of the other cells as they were;
a shrunk CPU run of its entry that reads ``correct``; the faults of the
FBM path that make ``correct`` false; the control failing a limit; the
dense work's lower bound; and the readers of the dense factors' kernels."""

import math

import pytest
import torch
from test_bench_mt505 import MT, TPUT

import cells
import counts
import counts_fbm
from conftest import ROOT

FBM = ["tick_p90_s.fbm", "gpcv_s.fbm", "vol_s.fbm", "data_s.fbm",
       "rollout_s.fbm", "launches_per_call.fbm", "s1_roofline.fbm",
       "k1_roofline.fbm", "idle_share.fbm", "mfu.fbm", "dense_la_s.fbm",
       "chol_launches.fbm"]


def test_the_cell_loads_from_the_benchmark():
    spec = cells.load(ROOT, "fbm100.live_refit")
    cfg = spec["config"]
    assert spec["cell"]["config"] == "volt_fbm_100" == cfg["name"]
    assert spec["cell"]["chips"] == 1 and spec["mix"]["loop"] == "tick"
    assert cfg["entry"] == "fbm" and cfg["assets"] == 100
    assert cfg["pipeline"]["kernel"] == "fbm"
    assert cfg["pipeline"]["gpcv_q"] == "full"
    assert {m["name"] for m in spec["end_to_end"]} == {"assets_per_s",
                                                       "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == FBM
    assert all(m["moves"] == "assets_per_s" for m in spec["per_layer"])


@pytest.mark.parametrize("workload,names", [("sp500.live_refit", TPUT),
                                            ("mt505.live_refit", MT)])
def test_the_other_cells_keep_their_metrics(workload, names):
    spec = cells.load(ROOT, workload)
    assert [m["name"] for m in spec["per_layer"]] == names


def test_shrunk_run_is_correct(tiny):
    """A traced CPU run of the shrunk cell: ``correct``, the stage seconds
    read, the device metrics absent (no card)."""
    res = tiny("fbm100.live_refit", trace=True)
    assert res["correct"] is True and res["failed"] == 0
    got = res["metrics"]
    for name in ("gpcv_s.fbm", "vol_s.fbm", "data_s.fbm", "rollout_s.fbm",
                 "tick_p90_s.fbm", "mfu.fbm"):
        assert got[name]["value"] > 0
    for name in ("dense_la_s.fbm", "chol_launches.fbm", "idle_share.fbm"):
        assert name not in got


def _hurst_moved(monkeypatch):
    """The vol GP's fitted Hurst parameter moved by 1e-2 before the
    forecast (and the warm start that follows)."""
    from volt_tpu_torch.models.bmgp import BMGP
    fit_state = BMGP.fit_state

    def moved(self, train_x, train_y):
        with torch.no_grad():
            h = self.kernel.vol() + 1e-2
            self.kernel.raw_vol.copy_(torch.log(h / (1.0 - h)))
        return fit_state(self, train_x, train_y)

    monkeypatch.setattr(BMGP, "fit_state", moved)


def _trace_dropped(monkeypatch):
    """The dense KL without its trace term, ``tr(Sp^{-1} Sq)``."""
    import volt_tpu_torch.gp.variational as variational
    from volt_tpu_torch.ops.chol import solve_lower_triangular

    kl = variational.mvn_kl

    def no_trace(mean_q, chol_q, mean_p, chol_p):
        a = solve_lower_triangular(chol_p, chol_q)
        return kl(mean_q, chol_q, mean_p, chol_p) \
            - 0.5 * torch.sum(a * a, dim=(-2, -1))

    monkeypatch.setattr(variational, "mvn_kl", no_trace)


@pytest.mark.parametrize("fault", [_hurst_moved, _trace_dropped],
                         ids=["hurst_moved", "kl_trace_dropped"])
def test_fault_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    assert tiny("fbm100.live_refit")["correct"] is False


def test_control_fails_a_limit(tiny):
    """The reference a precision below float32 in the program's place
    (float32 arithmetic, inputs, state and each Adam step rounded to
    bfloat16) fails a limit that the program's own run passes."""
    from conftest import load
    limits = load("fbm100.live_refit")["limits"]
    res = tiny("fbm100.live_refit",
               control=lambda t: t.to(torch.bfloat16).to(t.dtype))
    assert res["correct"] is True
    numbers = res["control"]["numbers"]
    assert set(limits) <= set(numbers)
    assert any(numbers[k] > limits[k] for k in limits)
    assert res["control"]["correct"] is False


def test_dense_counts_by_hand():
    # 2 assets, n 4: the root's 10 entries at 10 operations, the prior's
    # solve 3 passes of 4 * 4 * log2(4) = 32
    assert counts_fbm.dense_gpcv_step_ops(2, 4) == 2 * (10 * 10 + 3 * 32)
    base = counts.call_ops(2, 4, 5, 3, (7, 1, 1))
    assert counts_fbm.call_ops(2, 4, 5, 3, (7, 1, 1)) == \
        base + 7 * 2 * (100 + 96)
    # at the cell's shape the dense term is about B n^2 log2 n a step
    step = counts_fbm.dense_gpcv_step_ops(100, 999)
    assert 3.0 < step / (100 * 999 ** 2 * math.log2(999)) < 3.6


def test_dense_readers_read_their_kernels():
    """``dense_la_s`` sums the factor and solve kernels' seconds, each
    once; ``chol_launches`` counts the factor's launches; both ``None``
    where the trace holds none of them (a BM cell, a CPU run)."""
    la, launches = cells.reader("dense_la_s.fbm"), \
        cells.reader("chol_launches.fbm")
    kernels = {"void potrf_cta_lower_batch<float, float, 16>(int)": [40, 0.5],
               "void potrfBatch_trsm_lower<float, float, 16>(int)": [20, 0.25],
               "void batch_trsm_left_kernel<float, 64>(int)": [10, 1.0],
               "void at::native::elementwise_kernel<128>(int)": [99, 9.0]}
    run = {"trace": {"kernels": kernels}}
    assert la(run) == pytest.approx(1.75)
    assert launches(run) == 60.0
    empty = {"trace": {"kernels": {"void kalman_forward_kernel": [3, 0.1]}}}
    for read in (la, launches):
        assert read(empty) is None and read({"trace": None}) is None

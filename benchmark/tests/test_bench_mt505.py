"""The multitask cell ``mt505.live_refit`` as ``BENCHMARK.json`` itself
declares it: its per-layer metrics, which leave those of
``sp500.live_refit`` as they were, and the Matheron sampler's seconds,
read from the program's stage clock."""

import time

from conftest import ROOT, shrink

import cells
import harness

MT = ["tick_p90_s.mt", "gpcv_s.mt", "vol_s.mt", "data_s.mt",
      "rollout_s.mt", "sampler_s.mt", "launches_per_call.mt",
      "s1_roofline.mt", "k1_roofline.mt", "idle_share.mt", "mfu.mt"]
TPUT = ["tick_p90_s", "gpcv_s.tput", "vol_s.tput", "data_s.tput",
        "rollout_s.tput", "launches_per_call.tput", "s1_roofline.tput",
        "k1_roofline.tput", "idle_share.tput", "mfu.tput"]


def test_the_cell_loads_from_the_benchmark():
    spec = cells.load(ROOT, "mt505.live_refit")
    assert spec["cell"]["config"] == "volt_mt_sp500"
    assert spec["config"]["entry"] == "multitask"
    assert spec["config"]["assets"] == 505 and spec["mix"]["loop"] == "tick"
    assert {m["name"] for m in spec["end_to_end"]} == {"assets_per_s",
                                                       "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == MT
    assert all(m["moves"] == "assets_per_s" for m in spec["per_layer"])


def test_the_batched_cell_keeps_its_metrics():
    spec = cells.load(ROOT, "sp500.live_refit")
    assert [m["name"] for m in spec["per_layer"]] == TPUT


def test_sampler_seconds_from_a_shrunk_run():
    """A traced CPU run of the shrunk cell reads the sampler's seconds,
    a part of the rollout's; a run whose stages lack ``sample_vol`` (the
    program before the sampler had its own stage) reads nothing."""
    spec = shrink(cells.load(ROOT, "mt505.live_refit"), assets=3)
    res = harness.run(spec, 2**31 + 23, 1.0, True, "cpu",
                      time.perf_counter(), log=lambda *_: None)
    assert res["correct"] is True
    got = res["metrics"]
    assert got["sampler_s.mt"]["unit"] == "s"
    assert 0 < got["sampler_s.mt"]["value"] < got["rollout_s.mt"]["value"]
    read = cells.reader("sampler_s.mt")
    stages = {"gpcv": 0.05, "vol": 0.02, "data": 0.01, "rollout": 0.02}
    assert read({"calls": [{"stages": stages}]}) is None
    assert read({"calls": []}) is None

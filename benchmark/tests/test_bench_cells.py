"""The benchmark as data: every cell, configuration, mix, limit and metric
that ``BENCHMARK.json`` (or ``held.json``) names is found by name, and the
file keeps to the contract's keys and names."""

import json
import re

import pytest
from conftest import HERE, ROOT, bench_with_held, load

import cells

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ALL = bench_with_held()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_names():
    assert set(BENCH) == KEYS
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in metrics
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("workload", [w["name"] for w in ALL["workloads"]])
def test_cell_loads_by_name(workload):
    spec = load(workload)
    cfg = spec["config"]
    assert cfg["name"] == spec["cell"]["config"]
    assert (HERE / "entries" / f"{cfg['entry']}.py").exists()
    assert (HERE / "loops" / f"{spec['mix']['loop']}.py").exists()
    gaps = {"vol_gap", "loss_gap", "data_gap", "fan_gap", "std_gap"}
    assert {"vol_gap", "loss_gap"} <= set(spec["limits"]) <= \
        {p + g for p in ("", "start_", "roll_", "chain_") for g in gaps}
    assert all(0 < v < 1 for v in spec["limits"].values())
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    if workload in {w["name"] for w in BENCH["workloads"]}:
        assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))


@pytest.mark.parametrize("config", ALL["configs"],
                         ids=[c["name"] for c in ALL["configs"]])
def test_config_file_matches_its_entry(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    for key in cfg["reduced"]:  # a cut of scale, never of a width
        assert key in cfg and not key.endswith(("_dim", "_rank", "_size"))
    assert cfg["dtype"] == "float32"
    assert config["file"].startswith(BENCH["paths"][0] + "/")

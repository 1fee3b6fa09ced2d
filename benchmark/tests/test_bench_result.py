"""The result line's keys, the check beside its limits, and the run's
refusals: no card, and modules that no run may load."""

import json
import subprocess
import sys

import pytest
from conftest import HERE, ROOT

import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace", [
    ("sp500.backtest", False), ("sp500.backtest", True),
    ("sp500.live_refit", False), ("mt505.live_refit", True)])
def test_result_line(tiny, workload, trace, capsys):
    from conftest import load
    spec = load(workload)
    res = tiny(workload, trace=trace)
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in
            spec["per_layer" if trace else "end_to_end"]}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(res["check"]) == set(spec["limits"])
    harness.report(res)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(res))
    assert err.strip().splitlines()[-1] == "check correct True"


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    import types
    assert "volt_tpu_torch" in sys.modules
    assert harness.forbidden() == []
    monkeypatch.setitem(sys.modules, "volt_tpu.ops",
                        types.ModuleType("volt_tpu.ops"))
    assert harness.forbidden() == ["volt_tpu"]


def test_a_run_loads_no_jax_and_no_volt_tpu():
    code = (
        "import sys, time; sys.path[:0] = [{h!r}]; sys.path.append({r!r})\n"
        "sys.path.insert(0, {t!r})\n"
        "import conftest, cells, harness\n"
        "load = lambda w: conftest.shrink(conftest.load(w))\n"
        "spec = load('mt505.live_refit')\n"
        "harness.run(spec, 3, 0.5, True, 'cpu', time.perf_counter(),\n"
        "            log=lambda *_: None)\n"
        "spec = load('sp500.backtest')\n"
        "harness.run(spec, 3, 0.5, False, 'cpu', time.perf_counter(),\n"
        "            log=lambda *_: None)\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
    ).format(h=str(HERE), r=str(ROOT), t=str(HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "volt_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "volt_tpu"}


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "sp500.backtest", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    if p.returncode == 0:
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    import shutil
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sp500.backtest", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""

"""A later change adds a configuration, a mix and a per-layer metric as
new files and new entries of ``BENCHMARK.json``, and edits no file the
benchmark has: the harness finds and runs them."""

import hashlib
import json
import shutil
import sys
import time

import pytest
from conftest import HERE, ROOT, shrink


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def copy_root(tmp_path, monkeypatch):
    """A checkout holding ``BENCHMARK.json`` and ``benchmark/`` alone, whose
    modules are imported from it."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(sys, "path", [str(tmp_path / "benchmark"),
                                      *[p for p in sys.path
                                        if p != str(HERE)]])
    for name in list(sys.modules):
        if name.split(".")[0] in ("cells", "harness", "entries", "metrics",
                                  "traffic", "sabr", "counts", "devtrace",
                                  "reference"):
            monkeypatch.delitem(sys.modules, name)
    return tmp_path


def test_add_config_mix_and_metric_as_files(copy_root):
    before = _digest(copy_root / "benchmark")
    bench = json.loads((copy_root / "BENCHMARK.json").read_text())
    b = copy_root / "benchmark"
    cfg = json.loads((b / "configs" / "volt_bm_sp500.json").read_text())
    cfg.update(name="volt_bm_k25")
    cfg["pipeline"]["k"] = 25
    (b / "configs" / "volt_bm_k25.json").write_text(json.dumps(cfg))
    (b / "mixes" / "burst_refit.json").write_text(json.dumps(
        {"loop": "tick", "shift": 2, "warm_iters": 10, "ticks": 300,
         "check_ticks": 1}))
    (b / "limits" / "k25.burst_refit.json").write_text(json.dumps(
        {"vol_gap": 1.0, "loss_gap": 1.0, "fan_gap": 1.0, "std_gap": 1.0}))
    (b / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(len(run['calls'])) or None\n")
    bench["configs"].append({"name": "volt_bm_k25", "source": "x",
                             "file": "benchmark/configs/volt_bm_k25.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "k25.burst_refit",
                               "config": "volt_bm_k25",
                               "traffic": "burst_refit", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_done.tput", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "assets_per_s",
                               "workloads": ["k25.burst_refit"]})
    (copy_root / "BENCHMARK.json").write_text(json.dumps(bench))

    import cells
    import harness
    spec = shrink(cells.load(copy_root, "k25.burst_refit"))
    res = harness.run(spec, 5, 1.0, True, "cpu", time.perf_counter(),
                      log=lambda *_: None)
    assert res["correct"]
    assert res["metrics"]["calls_done.tput"]["value"] >= 1
    after = _digest(copy_root / "benchmark")
    assert all(after[k] == v for k, v in before.items())


TOY_ENTRY = '''
"""A toy entry: each asset's mean log return over its window."""
import numpy as np
import torch

import counts


class Entry:
    def __init__(self, cfg, device, seed):
        self.cfg, self.device = cfg, torch.device(device)
        self.assets, self.n = cfg["assets"], cfg["ntrain"] - 1
        self.watch = np.arange(self.assets)

    def settings(self, iters=None):
        return None

    def ops(self, iters=None):
        return float(self.assets * self.n)

    def noise(self, seed):
        return None

    def call(self, prices, settings, init, noise):
        out = torch.diff(torch.log(prices), dim=-1).mean(dim=-1)
        return out, {"ok": torch.isfinite(out)}

    def deliver(self, out, aux):
        return {"value": out.cpu().numpy(), "ok": aux["ok"].cpu().numpy()}

    def stages(self, aux):
        return {}

    def keep(self, got, aux):
        return {"value": got["value"]}

    def reference(self, items, dtype=torch.float64, store=None):
        return [torch.diff(torch.log(it["prices"].to(dtype)),
                           dim=-1).mean(dim=-1) for it in items]

    def as_kept(self, items, ref):
        return [dict(it, kept={"value": r.float().numpy()})
                for it, r in zip(items, ref)]

    def numbers(self, items, ref):
        return {"value_gap": max(float(np.max(np.abs(
            it["kept"]["value"] - r.numpy()))) for it, r in zip(items, ref))}
'''


def test_add_an_entry_as_a_file(copy_root):
    """A configuration that drives another entry of the program: the entry
    is a new file, and neither the harness nor the loops change."""
    before = _digest(copy_root / "benchmark")
    b = copy_root / "benchmark"
    (b / "entries" / "toy.py").write_text(TOY_ENTRY)
    cfg = json.loads((b / "configs" / "volt_bm_sp500.json").read_text())
    cfg.update(name="toy_returns", entry="toy")
    (b / "configs" / "toy_returns.json").write_text(json.dumps(cfg))
    (b / "limits" / "toy.backtest.json").write_text(json.dumps(
        {"value_gap": 1e-5, "roll_value_gap": 1e-5}))
    bench = json.loads((copy_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_returns", "source": "x",
                             "file": "benchmark/configs/toy_returns.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy.backtest", "config": "toy_returns",
                               "traffic": "backtest", "chips": 1, "why": "x"})
    for m in bench["per_layer"]:
        if m["name"] == "mfu.tput":
            m["workloads"].append("toy.backtest")
    (copy_root / "BENCHMARK.json").write_text(json.dumps(bench))

    import cells
    import harness
    spec = shrink(cells.load(copy_root, "toy.backtest"))
    spec["mix"]["windows"] = 20000  # a toy call takes microseconds
    res = harness.run(spec, 5, 0.05, False, "cpu", time.perf_counter(),
                      log=lambda *_: None)
    assert res["correct"] and res["metrics"]["assets_per_s"]["value"] > 0
    res = harness.run(spec, 5, 0.05, True, "cpu", time.perf_counter(),
                      log=lambda *_: None)
    assert res["correct"] and res["metrics"]["mfu.tput"]["value"] > 0
    after = _digest(copy_root / "benchmark")
    assert all(after[k] == v for k, v in before.items())

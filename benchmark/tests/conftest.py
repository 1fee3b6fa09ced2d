"""The benchmark's CPU tests: the harness's modules import from
``benchmark/`` and the program from the checkout's root, as ``run.py``
arranges them.  The cells of ``held.json`` are tested with those of
``BENCHMARK.json``."""

import atexit
import copy
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.append(p)


def bench_with_held() -> dict:
    """``BENCHMARK.json`` with the held-back configurations and cells."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    held = json.loads((HERE / "held.json").read_text())
    bench["configs"] += held["configs"]
    bench["workloads"] += held["workloads"]
    return bench


_ROOT = []


def load(workload: str) -> dict:
    """``cells.load`` of a cell of ``BENCHMARK.json`` or ``held.json``, from
    a checkout whose ``BENCHMARK.json`` names both."""
    import cells
    if not _ROOT:
        root = Path(tempfile.mkdtemp(prefix="bench-held-"))
        atexit.register(shutil.rmtree, root, True)
        (root / "benchmark").symlink_to(HERE)
        (root / "BENCHMARK.json").write_text(json.dumps(bench_with_held()))
        _ROOT.append(root)
    return cells.load(_ROOT[0], workload)


def shrink(spec: dict, assets: int = 3) -> dict:
    """A cell at a size the CPU runs in seconds: every number of the check
    and of the loop kept, the widths cut."""
    spec = copy.deepcopy(spec)
    c = spec["config"]
    c.update(assets=assets, ntrain=60, horizon=5,
             check_assets=min(c["check_assets"], assets))
    c["pipeline"].update(gpcv_iters=20, vol_iters=20, data_iters=20,
                         nsample=16, k=10)
    spec["mix"].update(windows=40, ticks=400, warm_iters=3)
    return spec


@pytest.fixture
def tiny():
    """``tiny(workload, **kw)``: the harness's result of a one-second run
    of the shrunk cell on the CPU."""
    import cells
    import harness

    def run(workload, seed=2**31 + 11, trace=False, control=None,
            spec=None, assets=3, seconds=1.0):
        spec = spec or shrink(load(workload), assets)
        return harness.run(spec, seed, seconds, trace, "cpu",
                           time.perf_counter(), log=lambda *_: None,
                           control=control)
    return run

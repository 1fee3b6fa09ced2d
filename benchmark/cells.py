"""A cell as data: its entry in ``BENCHMARK.json``, its configuration's
file, its traffic mix (``mixes/<traffic>.json``), its limits
(``limits/<cell>.json``) and the metrics it reports, found by name, with
the modules they name (``entries/``, ``loops/``, ``metrics/``), so that a
cell, a configuration, a mix or a metric is added as files and entries
alone."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(root: Path, workload: str) -> dict:
    """Everything a run of ``workload`` reads, from the checkout ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"cell": cell, "config": config, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": layer}


def reports(metric: dict, workload: str) -> bool:
    """Whether ``workload`` reports the end-to-end ``metric``."""
    return "workloads" not in metric or workload in metric["workloads"]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """``entries/<name>.py``: the adapter to one of the program's entries
    and its plain reference."""
    return _module(HERE / "entries" / f"{name}.py", f"entries.{name}")


def loop(name: str):
    """``loops/<name>.py``: how the calls of a mix's window follow one
    another."""
    return _module(HERE / "loops" / f"{name}.py", f"loops.{name}")


def reader(metric: str):
    """``metrics/<family>.py`` for the metric ``family`` or
    ``family.split``: its ``read(run)`` gives the value, or ``None`` where
    the run holds nothing to read.  ``run``: ``{"calls": [{"seconds",
    "delivered", "ops", "stages"}], "window_s", "setup_s", "trace",
    "assets", "n"}``."""
    family = metric.split(".")[0]
    return _module(HERE / "metrics" / f"{family}.py",
                   f"metrics.{family}").read

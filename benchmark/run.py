"""Run one cell of the benchmark of ``volt_tpu_torch`` on this machine's
card and print its result as the last line of standard output.

    python3 benchmark/run.py --workload sp500.backtest --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a traced call after the
window.  Exits 2 without a result where there is no card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    # one host thread: the program is bound by its dispatch on the host,
    # and idle worker threads that spin after a CPU op take its core
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)

    import cells
    import harness

    spec = cells.load(ROOT, a.workload)
    chips = spec["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    sys.path.append(str(ROOT))
    result = harness.run(spec, a.seed, a.seconds, bool(a.trace), "cuda", T0)
    bad = harness.forbidden()
    if bad:
        print(f"modules that no run may load were loaded: {bad}",
              file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

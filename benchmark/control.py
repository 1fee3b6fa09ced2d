"""The control of a cell's check, run on the card: for each seed, a run
of the cell with a short window, then the check's numbers of the program
(the lower readings) and, for the first ``--control`` seeds, of the
control: the reference in the program's place, computed a precision
below the configuration's float32 (float32 arithmetic with the inputs,
the warm state and the parameters after every Adam step rounded to
bfloat16), judged by the cell's limits as the program is.  One JSON line
a seed; exits 1 where the control passes the check on any seed.

    python3 benchmark/control.py --workload sp500.backtest \\
        --seeds 11,12,13 --seconds 5

The benchmark's own runs do not run it; the limits in ``limits/`` were
set from its readings and the runs' (``PERF.md``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def bfloat16(t):
    """``t`` rounded to bfloat16, in its own dtype."""
    import torch
    return t.to(torch.bfloat16).to(t.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=3,
                    help="run the control on the first this many seeds")
    a = ap.parse_args(argv)

    import torch

    import cells
    import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    sys.path.append(str(ROOT))
    passed = []
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        spec = cells.load(ROOT, a.workload)
        t, numbers = time.perf_counter(), {}
        res = harness.run(spec, seed, a.seconds, False, "cuda", t,
                          log=lambda *_: None, numbers=numbers,
                          control=bfloat16 if i < a.control else None)
        ctl = res.get("control")
        if ctl and ctl["correct"]:
            passed.append(seed)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "seconds": time.perf_counter() - t,
                          "program": numbers,
                          "control": ctl}), flush=True)
    if passed:
        print(f"the control passed the check on seeds {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The window's share of the card's float32 peak: the operations of the
calls it completed, by the frozen formulas of ``counts.py`` as the entry
counts them (``Entry.ops``), over the window's seconds times 67
TFLOP/s."""

import counts


def read(run):
    if not run["calls"] or not run["window_s"]:
        return None
    ops = sum(c["ops"] for c in run["calls"])
    return 100.0 * ops / (run["window_s"] * counts.FP32_OPS_PER_S)

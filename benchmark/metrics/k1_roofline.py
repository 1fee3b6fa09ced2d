"""Kernel K1 (``csrc/ewma_filter.cu``) against its roofline in the traced
call: the least time of its launches at the cell's (assets, n), by the
frozen counts, over their device time."""

import counts
import devtrace


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    launches, seconds = devtrace.kernel_sum(trace, "ewma_filter_kernel")
    if not seconds:
        return None
    return 100.0 * launches * counts.k1_bound_s(run["assets"],
                                                run["n"]) / seconds

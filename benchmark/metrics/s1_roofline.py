"""Kernel S1 (``csrc/kalman.cu``, forward and adjoint) against its
roofline in the traced call: the least time of its launches, by the
frozen byte and operation counts at the cell's (assets, n), over their
device time."""

import counts
import devtrace


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    b, n = run["assets"], run["n"]
    nf, tf = devtrace.kernel_sum(trace, "kalman_forward_kernel")
    nb, tb = devtrace.kernel_sum(trace, "kalman_backward_kernel")
    if not tf + tb:
        return None
    bound = (nf * counts.s1_forward_bound_s(b, n)
             + nb * counts.s1_backward_bound_s(b, n))
    return 100.0 * bound / (tf + tb)

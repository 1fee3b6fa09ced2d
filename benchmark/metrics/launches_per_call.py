"""Kernels launched in one traced call, counted by the profiler."""


def read(run):
    trace = run.get("trace")
    return float(trace["launches"]) if trace and trace["launches"] else None

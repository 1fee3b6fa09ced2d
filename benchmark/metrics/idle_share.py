"""Percent of the traced call in which no kernel or copy ran on the card."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])

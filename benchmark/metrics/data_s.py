"""Seconds of the data stage a call, the mean over the window's calls,
from the program's stage clock (``Entry.stages``, which reads
``aux["stage_seconds"]["data"]``); the clock waits for the card at each
mark."""


def read(run):
    secs = [c["stages"]["data"] for c in run["calls"]
            if "data" in c["stages"]]
    return sum(secs) / len(secs) if secs else None

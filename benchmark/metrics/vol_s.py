"""Seconds of the vol stage a call, the mean over the window's calls,
from the program's stage clock (``Entry.stages``, which reads
``aux["stage_seconds"]["vol"]``); the clock waits for the card at each
mark."""


def read(run):
    secs = [c["stages"]["vol"] for c in run["calls"]
            if "vol" in c["stages"]]
    return sum(secs) / len(secs) if secs else None

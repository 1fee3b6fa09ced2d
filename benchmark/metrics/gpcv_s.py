"""Seconds of the gpcv stage a call, the mean over the window's calls,
from the program's stage clock (``Entry.stages``, which reads
``aux["stage_seconds"]["gpcv"]``); the clock waits for the card at each
mark."""


def read(run):
    secs = [c["stages"]["gpcv"] for c in run["calls"]
            if "gpcv" in c["stages"]]
    return sum(secs) / len(secs) if secs else None

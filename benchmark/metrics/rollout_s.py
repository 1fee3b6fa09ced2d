"""Seconds of the rollout stage a call, the mean over the window's calls,
from the program's stage clock (``Entry.stages``, which reads
``aux["stage_seconds"]["rollout"]``); the clock waits for the card at each
mark."""


def read(run):
    secs = [c["stages"]["rollout"] for c in run["calls"]
            if "rollout" in c["stages"]]
    return sum(secs) / len(secs) if secs else None

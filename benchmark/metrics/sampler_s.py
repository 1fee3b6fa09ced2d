"""Seconds of the Matheron sampler a call, the mean over the window's
calls, from the program's stage clock (``Entry.stages``, which reads
``aux["stage_seconds"]["sample_vol"]``, a part of the rollout stage);
the clock waits for the card at each mark.  ``None`` where no call holds
it (an entry whose sampler is not its own stage)."""


def read(run):
    secs = [c["stages"]["sample_vol"] for c in run["calls"]
            if "sample_vol" in c["stages"]]
    return sum(secs) / len(secs) if secs else None

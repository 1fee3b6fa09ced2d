"""Assets whose forecast came back ``ok``, over every call of the window,
by the seconds from the window's start to the last completion."""


def read(run):
    if not run["window_s"]:
        return None
    return sum(c["delivered"] for c in run["calls"]) / run["window_s"]

"""Seconds from the process's start to the window's: imports, the card,
the kernel library, the inputs and the warm-up calls."""


def read(run):
    return run["setup_s"]

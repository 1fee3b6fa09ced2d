"""How the calls of a window follow one another, one module a mix's
``loop``: its set-up calls, each timed call, the traced call, and the
check's sample of the calls (``Loop.check``)."""

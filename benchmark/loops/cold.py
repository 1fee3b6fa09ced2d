"""A closed loop of cold fits: each call fits a fresh window of every
asset from the configuration's initial values; the next starts when the
last is delivered.  The set-up's call is the warm-up (window ``-1``),
the traced call window ``-2``.

The check refits, with the reference, ``len(entry.watch)`` (call, asset)
pairs drawn from the seed (``""``), and forecasts the same pairs from the
program's own fitted state (``roll_``)."""

from __future__ import annotations

import numpy as np

from entries.common import call_seed


class Loop:
    def __init__(self, entry, traffic, seed: int):
        self.entry, self.traffic, self.seed = entry, traffic, seed
        self.iters = None  # the configuration's own Adam steps
        self.settings = entry.settings(self.iters)
        self.kept, self.j = {}, 0

    def _call(self, j: int):
        e = self.entry
        out, aux = e.call(self.traffic.window(j), self.settings, None,
                          e.noise(call_seed(self.seed, j)))
        return e.deliver(out, aux), aux

    def warm_up(self):
        self._call(-1)

    def call(self):
        """One timed call: its delivery and ``aux``."""
        self.j += 1
        return self._call(self.j - 1)

    def keep(self, got, aux):
        self.kept[self.j - 1] = self.entry.keep(got, aux)

    def traced_call(self):
        self._call(-2)

    def release(self):
        pass

    def check(self, check):
        done = sorted(self.kept)
        if not done:
            return
        rng = np.random.default_rng(self.seed + 1)
        rows = {}
        for p in range(len(self.entry.watch)):
            rows.setdefault(int(rng.choice(done)), []).append(p)
        items = [{"kept": self.kept[c], "prev": None, "shift": 0,
                  "prices": self.traffic.window(c), "iters": self.iters,
                  "seed": call_seed(self.seed, c), "rows": r}
                 for c, r in sorted(rows.items())]
        check.compare("", items)
        check.compare("roll_", [dict(it, prev=it["kept"], iters=0)
                                for it in items])

"""A closed loop of ticks: each slides every window by the mix's
``shift`` new prices and refits from the last tick's state with
``warm_iters`` Adam steps a stage; the next starts when the last is
delivered.  Tick 0 is the cold fit and tick 1 an untimed refit, both in
set-up; the traced call is the tick after the window.

The check, on every watched asset: the cold fit from the seed
(``start_``); ``check_ticks`` ticks drawn from the seed, each refit from
the program's own previous state (``""``) and forecast from its own
fitted state (``roll_``); and the first tick of the window reached by the
reference's own chain from its cold fit (``chain_``)."""

from __future__ import annotations

import numpy as np

from entries.common import call_seed


class Loop:
    def __init__(self, entry, traffic, seed: int):
        self.entry, self.traffic, self.seed = entry, traffic, seed
        self.shift = traffic.mix["shift"]
        self.iters = traffic.mix["warm_iters"]
        self.cold = entry.settings(None)
        self.settings = entry.settings(self.iters)
        self.kept = {}

    def _tick(self, j: int):
        e, (i, aux, _) = self.entry, self.prev
        init = e.warm_start(aux, self.shift * (j - i))
        out, aux = e.call(self.traffic.window(j), self.settings, init,
                          e.noise(call_seed(self.seed, j)))
        return e.deliver(out, aux), aux

    def warm_up(self):
        e = self.entry
        out, aux = e.call(self.traffic.window(0), self.cold, None,
                          e.noise(call_seed(self.seed, 0)))
        self.start = e.keep(e.deliver(out, aux), aux)
        self.prev = (0, aux, self.start)
        got, aux = self._tick(1)
        self.prev = (1, aux, e.keep(got, aux))
        self.j = 2

    def call(self):
        """One timed tick: its delivery and ``aux``."""
        self.j += 1
        return self._tick(self.j - 1)

    def keep(self, got, aux):
        j, (i, _, before) = self.j - 1, self.prev
        kept = self.entry.keep(got, aux)
        self.kept[j] = (kept, before, self.shift * (j - i))
        self.prev = (j, aux, kept)

    def traced_call(self):
        self._tick(self.j)

    def release(self):
        self.prev = None

    def _item(self, j, kept, prev, shift, iters):
        return {"kept": kept, "prev": prev, "shift": shift,
                "prices": self.traffic.window(j), "iters": iters,
                "seed": call_seed(self.seed, j),
                "rows": list(range(len(self.entry.watch)))}

    def check(self, check):
        start = self._item(0, self.start, None, 0, None)
        first = check.compare("start_", [start])
        done = sorted(self.kept)
        if not done:
            return
        rng = np.random.default_rng(self.seed + 1)
        picked = sorted(int(c) for c in rng.choice(
            done, min(self.traffic.mix["check_ticks"], len(done)),
            replace=False))
        items = [self._item(j, *self.kept[j], self.iters) for j in picked]
        check.compare("", items)
        check.compare("roll_", [dict(it, prev=it["kept"], shift=0, iters=0)
                                for it in items])
        # ticks 1 to the window's first, each from the reference's state
        chain = [self._item(j, None, None, self.shift, self.iters)
                 for j in range(1, done[0] + 1)]
        chain[-1]["kept"] = self.kept[done[0]][0]
        check.chain("chain_", first, chain)

"""The one generator of traffic: it reads a mix's parameters and makes the
price windows of a run from its seed, in set-up, on the card.

* ``"loop": "cold"`` — a closed loop of cold fits: ``windows`` distinct
  windows of every asset, each an independent path of ``ntrain`` prices,
  two more for the warm-up and the traced call; the run fails if the
  window asks for more.
* ``"loop": "tick"`` — a closed loop of ticks: one path of ``ntrain +
  ticks * shift`` prices an asset; tick ``j`` fits prices ``j * shift``
  to ``j * shift + ntrain``, warm from tick ``j - 1``'s state, with
  ``warm_iters`` Adam steps a stage.  Tick 0 is the cold fit and tick 1
  an untimed refit, both in set-up.
"""

from __future__ import annotations

import torch

from sabr import sabr_prices


class Exhausted(RuntimeError):
    """The mix has no window left for a call: the run fails."""


class Traffic:
    def __init__(self, mix: dict, cfg: dict, seed: int, device):
        self.mix, self.loop = mix, mix["loop"]
        self.ntrain, self.assets = cfg["ntrain"], cfg["assets"]
        self.shift = mix.get("shift", 0)
        g = torch.Generator(device).manual_seed(seed)
        if self.loop == "cold":
            self.count = mix["windows"] + 2
            paths = sabr_prices(g, self.count * self.assets, self.ntrain,
                                **cfg["sabr"])
            self.prices = paths.reshape(self.count, self.assets, self.ntrain)
        else:
            self.count = mix["ticks"]
            self.prices = sabr_prices(
                g, self.assets, self.ntrain + self.count * self.shift,
                **cfg["sabr"])

    def window(self, j: int) -> torch.Tensor:
        """Call ``j``'s prices ``(assets, ntrain)``: for a cold loop the
        warm-up is ``-1`` and the traced call ``-2``."""
        if self.loop == "cold":
            if not -2 <= j < self.count - 2:
                raise Exhausted(f"the mix's {self.count - 2} windows ran "
                                   f"out at call {j}")
            return self.prices[j % self.count]
        if not 0 <= j < self.count:
            raise Exhausted(f"the mix's {self.count} ticks ran out")
        s = j * self.shift
        return self.prices[:, s:s + self.ntrain].contiguous()

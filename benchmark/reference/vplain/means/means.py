"""Mean functions (the port's ``means/means.py``, trimmed to what the
cells run).

``ConstantMean`` (the GPCV's prior mean) maps the time grid to a
learnable constant.  ``EWMAMean`` filters the series itself through the
truncated EWMA (kernel K1 in the program, here its plain ``conv1d``): its
train values come from the full filter, and the rollout advances it
through the scan protocol (``scan_*`` with ``(..., k)`` windows, or
``scan_fast_*`` with a few scalar sums per path when the horizon is at
most ``k``; the fast protocol's per-step inputs ``xs`` keep the horizon
on the last axis).
"""

from __future__ import annotations

import torch
from torch import nn
from ..ops.ewma import (ewma, ewma_weights, rolling_append, rolling_coeffs, window_append, window_init, window_value)


class ConstantMean(nn.Module):
    """Learnable constant (init 0); parameter ``constant`` ``(*batch, 1)``."""

    is_history_dependent = False

    def forward(self, x):
        c = self.constant
        return c.expand(torch.broadcast_shapes(c.shape[:-1] + x.shape[-1:],
                                               x.shape))


class EWMAMean(nn.Module):
    """Truncated EWMA mean (no parameters)."""

    is_history_dependent = True

    def __init__(self, k: int = 20):
        super().__init__()
        self.k = k

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        return self

    def _w(self, like):
        return ewma_weights(self.k, like.dtype, like.device)

    # --- full-filter forms (fitting) ---
    def full_values(self, y):
        return ewma(y, self.k)

    def train_values(self, y):
        return self.full_values(y)[..., :-1]

    # --- window scan protocol (rollouts) ---
    def scan_init(self, y):
        return {"buf": window_init(y, self.k)}

    def scan_value(self, state):
        return window_value(state["buf"], self._w(state["buf"]))

    def scan_append(self, state, y_new):
        return {"buf": window_append(state["buf"], y_new)}

    # --- O(1) scan protocol (rollouts with horizon <= k) ---
    def scan_fast_supported(self, horizon: int) -> bool:
        return horizon <= self.k

    def scan_fast_init(self, y, horizon: int):
        """``(carry, xs)``: the window sum ``s1`` ``(...)`` and the train
        values that expire at each step, ``exp1`` ``(..., horizon)``."""
        buf = window_init(y, self.k)
        return ({"s1": window_value(buf, self._w(buf))},
                {"exp1": buf[..., :horizon]})

    def scan_fast_value(self, carry):
        return carry["s1"]

    def scan_fast_append(self, carry, x_t, y_new):
        return {"s1": rolling_append(carry["s1"], y_new, x_t["exp1"],
                                     rolling_coeffs(self.k))}


"""Mean functions of the slice (port of :mod:`volt_tpu.means.means`).

``ConstantMean`` is deterministic; ``EWMAMean`` is history dependent: its
train values come from the full filter, and the rollout advances it
through the scan protocol (``scan_*`` with an ``(..., k)`` window, or
``scan_fast_*`` with one scalar sum per path when the horizon is at most
``k``).  Parameters carry the JAX leaf names with a leading batch shape.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.ewma import (ewma, ewma_weights, rolling_append, rolling_coeffs,
                        window_append, window_init, window_value)

__all__ = ["ConstantMean", "EWMAMean"]


class ConstantMean(nn.Module):
    """Learnable constant (init 0); parameter ``constant`` ``(*batch, 1)``."""

    is_history_dependent = False

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        self.constant = nn.Parameter(torch.zeros((*batch_shape, 1),
                                                 dtype=dtype, device=device))
        return self

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

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        return self

    # --- full-filter forms (fitting) ---
    def full_values(self, y):
        return ewma(y, self.k)

    def train_values(self, y):
        return self.full_values(y)[..., :-1]

    # --- window scan protocol (rollouts) ---
    def scan_init(self, y):
        return {"buf": window_init(y, self.k)}

    def scan_value(self, state):
        buf = state["buf"]
        return window_value(buf, ewma_weights(self.k, buf.dtype, buf.device))

    def scan_append(self, state, y_new):
        return {"buf": window_append(state["buf"], y_new)}

    # --- O(1) scan protocol (rollouts with horizon <= k) ---
    def scan_fast_supported(self, horizon: int) -> bool:
        return horizon <= self.k

    def scan_fast_init(self, y, horizon: int):
        """``(carry, xs)``: the window sum ``s1`` ``(...)`` and the train
        values that expire at each step, ``exp1`` ``(..., horizon)``."""
        buf = window_init(y, self.k)
        w = ewma_weights(self.k, buf.dtype, buf.device)
        return {"s1": window_value(buf, w)}, {"exp1": buf[..., :horizon]}

    def scan_fast_value(self, carry):
        return carry["s1"]

    def scan_fast_append(self, carry, x_t, y_new):
        return {"s1": rolling_append(carry["s1"], y_new, x_t["exp1"],
                                     rolling_coeffs(self.k))}

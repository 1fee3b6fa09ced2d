"""Mean functions (port of :mod:`volt_tpu.means.means`).

Deterministic means (``ConstantMean``, ``LinearMean``, ``LogLinearMean``,
``MulIdentityMean``) map the time grid to values.  History ("Magpie")
means filter the series itself through the truncated EWMA (kernel K1 on
CUDA tensors): their train values come from the full filter, and the
rollout advances them through the scan protocol (``scan_*`` with
``(..., k)`` windows, or ``scan_fast_*`` with a few scalar sums per path
when the horizon is at most ``k``; the fast protocol's per-step inputs
``xs`` keep the horizon on the last axis).  Parameters carry the JAX leaf
names with a leading batch shape.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.ewma import (ewma, ewma_weights, rolling_append, rolling_coeffs,
                        window_append, window_init, window_value)

__all__ = [
    "ConstantMean",
    "LinearMean",
    "LogLinearMean",
    "MulIdentityMean",
    "EWMAMean",
    "HEWMAMean",
    "DEWMAMean",
    "TEWMAMean",
    "MeanRevertingEMAMean",
]


# ---------------------------------------------------------------------------
# Deterministic means
# ---------------------------------------------------------------------------


class ConstantMean(nn.Module):
    """Learnable constant (init 0); parameter ``constant`` ``(*batch, 1)``."""

    is_history_dependent = False

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        self.constant = nn.Parameter(torch.zeros((*batch_shape, 1),
                                                 dtype=dtype, device=device))
        return self

    def forward(self, x):
        c = self.constant
        return c.expand(torch.broadcast_shapes(c.shape[:-1] + x.shape[-1:],
                                               x.shape))


class LinearMean(nn.Module):
    """``m(x) = x @ weights + bias``; parameters ``weights``
    ``(*batch, input_size, 1)`` and ``bias`` ``(*batch, 1)``, initialised
    with standard normals from ``generator`` (gpytorch's ``LinearMean``)."""

    is_history_dependent = False

    def __init__(self, input_size: int = 1, bias: bool = True):
        super().__init__()
        self.input_size = input_size
        self.bias_on = bias

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weights = nn.Parameter(torch.randn(
            (*batch_shape, self.input_size, 1), **kw))
        if self.bias_on:
            self.bias = nn.Parameter(torch.randn((*batch_shape, 1), **kw))
        return self

    def _linear(self, x):
        if x.dim() == 0 or (self.input_size == 1
                            and (x.dim() == 1 or x.shape[-1] != 1)):
            x = x[..., None]  # (..., n) -> (..., n, 1)
        res = torch.matmul(x, self.weights)[..., 0]
        return res + self.bias if self.bias_on else res

    def forward(self, x):
        return self._linear(x)


class LogLinearMean(LinearMean):
    """``log(max(x @ weights + bias, 1e-6))``; the data are log prices."""

    @torch.no_grad()
    def initialize_from_data(self, x, y):
        """Set the bias to ``mean(exp(y))`` over the last axis."""
        self.bias = nn.Parameter(torch.mean(torch.exp(y), dim=-1,
                                            keepdim=True))
        return self

    def forward(self, x):
        return torch.log(torch.clamp(self._linear(x), min=1e-6))


class MulIdentityMean(nn.Module):
    """``m(x) = constant * x``; parameter ``constant`` ``(*batch, 1)``,
    init 0."""

    is_history_dependent = False

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             generator=None):
        self.constant = nn.Parameter(torch.zeros((*batch_shape, 1),
                                                 dtype=dtype, device=device))
        return self

    def forward(self, x):
        return self.constant * x


# ---------------------------------------------------------------------------
# History (Magpie) means
# ---------------------------------------------------------------------------


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

    def last_value(self, y):
        return self.full_values(y)[..., -1]

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


class DEWMAMean(EWMAMean):
    """Double EWMA: ``2 ema - ema(ema)``."""

    def full_values(self, y):
        e = ewma(y, self.k)
        return 2.0 * e - ewma(e, self.k)[..., :-1]

    def scan_init(self, y):
        e = ewma(y, self.k)
        # the second level's causal window ends one entry before e's last
        return {"buf": window_init(y, self.k),
                "buf_e": window_init(e[..., :-1], self.k)}

    def scan_value(self, state):
        w = self._w(state["buf"])
        return (2.0 * window_value(state["buf"], w)
                - window_value(state["buf_e"], w))

    def scan_append(self, state, y_new):
        e_cur = window_value(state["buf"], self._w(state["buf"]))
        return {"buf": window_append(state["buf"], y_new),
                "buf_e": window_append(state["buf_e"], e_cur)}

    def scan_fast_init(self, y, horizon: int):
        e = ewma(y, self.k)
        buf = window_init(y, self.k)
        buf_e = window_init(e[..., :-1], self.k)
        w = self._w(buf)
        return ({"s1": window_value(buf, w), "s2": window_value(buf_e, w)},
                {"exp1": buf[..., :horizon], "exp2": buf_e[..., :horizon]})

    def scan_fast_value(self, carry):
        return 2.0 * carry["s1"] - carry["s2"]

    def scan_fast_append(self, carry, x_t, y_new):
        c = rolling_coeffs(self.k)
        # the second level appends the pre-append first-level value
        return {"s1": rolling_append(carry["s1"], y_new, x_t["exp1"], c),
                "s2": rolling_append(carry["s2"], carry["s1"], x_t["exp2"],
                                     c)}


class TEWMAMean(EWMAMean):
    """Triple EWMA: ``3 ema - 3 ema^2 + ema^3``."""

    def _levels(self, y):
        e = ewma(y, self.k)
        ee = ewma(e, self.k)[..., :-1]
        return e, ee

    def full_values(self, y):
        e, ee = self._levels(y)
        eee = ewma(ee, self.k)[..., :-1]
        return 3.0 * e - 3.0 * ee + eee

    def scan_init(self, y):
        e, ee = self._levels(y)
        return {"buf": window_init(y, self.k),
                "buf_e": window_init(e[..., :-1], self.k),
                "buf_ee": window_init(ee[..., :-1], self.k)}

    def scan_value(self, state):
        w = self._w(state["buf"])
        return (3.0 * window_value(state["buf"], w)
                - 3.0 * window_value(state["buf_e"], w)
                + window_value(state["buf_ee"], w))

    def scan_append(self, state, y_new):
        w = self._w(state["buf"])
        e_cur = window_value(state["buf"], w)
        ee_cur = window_value(state["buf_e"], w)
        return {"buf": window_append(state["buf"], y_new),
                "buf_e": window_append(state["buf_e"], e_cur),
                "buf_ee": window_append(state["buf_ee"], ee_cur)}

    def scan_fast_init(self, y, horizon: int):
        e, ee = self._levels(y)
        bufs = (window_init(y, self.k), window_init(e[..., :-1], self.k),
                window_init(ee[..., :-1], self.k))
        w = self._w(bufs[0])
        return ({f"s{i + 1}": window_value(b, w) for i, b in enumerate(bufs)},
                {f"exp{i + 1}": b[..., :horizon] for i, b in enumerate(bufs)})

    def scan_fast_value(self, carry):
        return 3.0 * carry["s1"] - 3.0 * carry["s2"] + carry["s3"]

    def scan_fast_append(self, carry, x_t, y_new):
        c = rolling_coeffs(self.k)
        # each level appends the pre-append value of the level below
        return {"s1": rolling_append(carry["s1"], y_new, x_t["exp1"], c),
                "s2": rolling_append(carry["s2"], carry["s1"], x_t["exp2"],
                                     c),
                "s3": rolling_append(carry["s3"], carry["s2"], x_t["exp3"],
                                     c)}


class HEWMAMean(EWMAMean):
    """Hull-style EWMA:
    ``ewma(2 ewma(y, k/2)[:-1] - ewma(y, k)[:-1], sqrt(k))``.  The
    reference has no single-query form of it, so it cannot drive rollouts:
    the scan protocol raises."""

    def full_values(self, y):
        wk = ewma(y, self.k)
        wk2 = ewma(y, int(self.k / 2))
        inner = 2.0 * wk2[..., :-1] - wk[..., :-1]
        return ewma(inner, int(math.isqrt(self.k)))

    def scan_init(self, y):
        raise NotImplementedError(
            "HEWMAMean has no single-query semantics in the reference "
            "(means/EWMA.py:57-71) and cannot drive rollouts.")

    def scan_fast_supported(self, horizon: int) -> bool:
        return False


class MeanRevertingEMAMean(EWMAMean):
    """EWMA with mean reversion ``ema[t] -= theta (ema[t-1] - latent)``; the
    latent mean is the series mean at construction, frozen through the
    rollout."""

    def __init__(self, k: int = 20, theta: float = 0.5):
        super().__init__(k)
        self.theta = theta

    def full_values(self, y, latent_mean=None):
        e = ewma(y, self.k)
        if latent_mean is None:
            latent_mean = torch.mean(y, dim=-1, keepdim=True)
        return torch.cat([e[..., :1], e[..., 1:] - self.theta
                          * (e[..., :-1] - latent_mean)], dim=-1)

    def train_values(self, y, latent_mean=None):
        return self.full_values(y, latent_mean)[..., :-1]

    def last_value(self, y, latent_mean=None):
        return self.full_values(y, latent_mean)[..., -1]

    def scan_init(self, y):
        return {"buf": window_init(y, self.k),
                "prev_e": ewma(y, self.k)[..., -2],
                "latent_mean": torch.mean(y, dim=-1)}

    def scan_value(self, state):
        e = window_value(state["buf"], self._w(state["buf"]))
        return e - self.theta * (state["prev_e"] - state["latent_mean"])

    def scan_append(self, state, y_new):
        return {"buf": window_append(state["buf"], y_new),
                "prev_e": window_value(state["buf"], self._w(state["buf"])),
                "latent_mean": state["latent_mean"]}

    def scan_fast_init(self, y, horizon: int):
        buf = window_init(y, self.k)
        carry = {"s1": window_value(buf, self._w(buf)),
                 "prev_e": ewma(y, self.k)[..., -2],
                 "latent_mean": torch.mean(y, dim=-1)}
        return carry, {"exp1": buf[..., :horizon]}

    def scan_fast_value(self, carry):
        return carry["s1"] - self.theta * (carry["prev_e"]
                                           - carry["latent_mean"])

    def scan_fast_append(self, carry, x_t, y_new):
        return {"s1": rolling_append(carry["s1"], y_new, x_t["exp1"],
                                     rolling_coeffs(self.k)),
                "prev_e": carry["s1"],  # the pre-append value
                "latent_mean": carry["latent_mean"]}

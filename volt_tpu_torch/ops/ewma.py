"""Truncated EWMA ("Magpie" mean) primitives (port of :mod:`volt_tpu.ops.ewma`).

The reference's k-tap filter: taps ``alpha (1 - alpha)**i``
(``alpha = 2/(k+1)``) normalised to sum to one, oldest first, applied to the
series left-padded with ``k`` copies of ``y[0]``; output ``j`` of ``T + 1``
is the weighted mean of ``padded[j:j+k]``.

:func:`ewma` runs kernel K1 (``csrc/ewma_filter.cu``) on CUDA tensors, for
every ``k``, and its plain version (a ``conv1d`` over the padded series)
on CPU tensors.  The taps are geometric, so K1 computes the filter as the
equivalent first-order recurrence on the output (``_recurrence``).  The
rolling forms serve the rollout.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..utils.profiling import device_constant

__all__ = [
    "ewma_weights",
    "ewma",
    "ewma_filter_cuda",
    "window_init",
    "window_append",
    "window_value",
    "rolling_coeffs",
    "rolling_append",
]


@lru_cache(maxsize=64)
def _ewma_weights_np(k: int):
    alpha = 2.0 / (k + 1)
    w = alpha * (1.0 - alpha) ** np.arange(k - 1, -1, -1, dtype=np.float64)
    return w / w.sum()


def ewma_weights(k: int, dtype=torch.float32, device=None):
    """Normalised taps, oldest first, from float64: a read-only constant."""
    return device_constant("ewma_taps", _ewma_weights_np, k, dtype=dtype,
                           device=device)


@lru_cache(maxsize=64)
def _recurrence(k: int):
    """``(beta, c, beta**k)`` in float64: the k-tap filter is
    ``out[0] = y[0]``, ``out[i+1] = beta out[i] + c (y[i] - beta**k
    y[max(i - k, 0)])``, since its taps are ``c beta**(k-1-i)``."""
    beta = 1.0 - 2.0 / (k + 1)
    beta_k = beta ** k
    return beta, (1.0 - beta) / (1.0 - beta_k), beta_k


def _pad_left(y, k: int):
    """Left-pad the series with ``k`` copies of its first value."""
    return torch.cat([y[..., :1].expand(*y.shape[:-1], k), y], dim=-1)


def _ewma_conv(y, k: int):
    """The plain version: ``conv1d`` over the padded series."""
    w = ewma_weights(k, y.dtype, y.device)
    padded = _pad_left(y, k)
    out = F.conv1d(padded.reshape(-1, 1, padded.shape[-1]), w.reshape(1, 1, k))
    return out.reshape(*y.shape[:-1], y.shape[-1] + 1)


def ewma_filter_cuda(y2, k: int):
    """Kernel K1 on ``(rows, T)`` float32: ``(rows, T + 1)``."""
    native.check_tensors("ewma_filter", y2)
    if y2.dim() != 2 or y2.shape[0] < 1 or y2.shape[1] < 1 or k < 1:
        raise ValueError(f"ewma_filter: expected (rows, T) with rows, T >= 1 "
                         f"and k >= 1, got {tuple(y2.shape)}, k={k}")
    rows, t = y2.shape
    out = y2.new_empty((rows, t + 1))
    native.launch("volt_ewma_filter", y2, out, rows, t, k, *_recurrence(k),
                  device=y2.device)
    return out


class _EWMAFilter(torch.autograd.Function):
    """K1 forward; the backward is the plain filter's transpose (the
    filter is linear in ``y``), as the JAX package's ``_ewma_mxu_bwd``."""

    @staticmethod
    def forward(ctx, y2, k):
        ctx.k = k
        ctx.save_for_backward(y2)
        return ewma_filter_cuda(y2, k)

    @staticmethod
    def backward(ctx, g):
        (y2,) = ctx.saved_tensors
        with torch.enable_grad():
            yy = y2.detach().requires_grad_()
            (gy,) = torch.autograd.grad(_ewma_conv(yy, ctx.k), yy, g)
        return gy, None


def ewma(y, k: int):
    """Truncated EWMA filter, ``(..., T) -> (..., T + 1)``."""
    if k < 1:
        raise ValueError(f"ewma needs k >= 1, got {k}")
    if not native.on_card(y):
        return _ewma_conv(y, k)
    t = y.shape[-1]
    flat = y.dim() == 2  # the main path's (B, T): no reshape either way
    y2 = (y if flat else y.reshape(-1, t)).contiguous()
    if y.requires_grad and torch.is_grad_enabled():
        out = _EWMAFilter.apply(y2, k)
    else:
        out = ewma_filter_cuda(y2, k)
    return out if flat else out.reshape(*y.shape[:-1], t + 1)


# ---------------------------------------------------------------------------
# Rolling forms for the rollout
# ---------------------------------------------------------------------------


def window_init(y, k: int):
    """Last ``k`` values of the padded series — the state whose weighted sum
    is ``ewma(y, k)[..., -1]``."""
    return _pad_left(y, k)[..., -k:]


def window_append(buf, value):
    """Shift the window left by one and append ``value`` (shape ``(...,)``)."""
    return torch.cat([buf[..., 1:], value[..., None]], dim=-1)


def window_value(buf, w):
    """Weighted window sum — equals the last output of the full filter."""
    return torch.matmul(buf, w)


def rolling_coeffs(k: int):
    """``(decay, w_new, w_exp)`` for :func:`rolling_append`: appending
    ``y_new`` to the window whose oldest element ``y_exp`` expires updates
    the weighted sum as ``decay * sum + w_new * y_new - w_exp * y_exp``."""
    w = _ewma_weights_np(k)
    alpha = 2.0 / (k + 1)
    return (float(np.float32(1.0 - alpha)), float(np.float32(w[-1])),
            float(np.float32((1.0 - alpha) * w[0])))


def rolling_append(sum_cur, y_new, y_exp, coeffs):
    """O(1) update of the truncated-EWMA weighted sum."""
    decay, w_new, w_exp = coeffs
    return decay * sum_cur + w_new * y_new - w_exp * y_exp

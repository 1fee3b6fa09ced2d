"""Truncated EWMA ("Magpie" mean) primitives (port of :mod:`volt_tpu.ops.ewma`).

The reference's k-tap filter: taps ``alpha (1 - alpha)**i``
(``alpha = 2/(k+1)``) normalised to sum to one, oldest first, applied to the
series left-padded with ``k`` copies of ``y[0]``; output ``j`` of ``T + 1``
is the weighted mean of ``padded[j:j+k]``.

:func:`ewma` is the plain version of kernel K1, a ``conv1d`` over the
padded series, on every device.  The rolling forms serve the rollout.
"""

from __future__ import annotations

from functools import lru_cache
import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _ewma_weights_np(k: int):
    alpha = 2.0 / (k + 1)
    w = alpha * (1.0 - alpha) ** np.arange(k - 1, -1, -1, dtype=np.float64)
    return w / w.sum()


@lru_cache(maxsize=64)
def ewma_weights(k: int, dtype=torch.float32, device=None):
    """Normalised taps, oldest first, computed on the host in float64.

    Cached per ``(k, dtype, device)``, so a filter call on the card does
    not wait on a host-to-device copy of its taps; callers must not
    modify the returned tensor.
    """
    return torch.tensor(_ewma_weights_np(k), dtype=dtype, device=device)


def _pad_left(y, k: int):
    """Left-pad the series with ``k`` copies of its first value."""
    return torch.cat([y[..., :1].expand(*y.shape[:-1], k), y], dim=-1)


def _ewma_conv(y, k: int):
    """The plain version: ``conv1d`` over the padded series."""
    w = ewma_weights(k, y.dtype, y.device)
    padded = _pad_left(y, k)
    out = F.conv1d(padded.reshape(-1, 1, padded.shape[-1]), w.reshape(1, 1, k))
    return out.reshape(*y.shape[:-1], y.shape[-1] + 1)


def ewma(y, k: int):
    """Truncated EWMA filter, ``(..., T) -> (..., T + 1)``."""
    if k < 1:
        raise ValueError(f"ewma needs k >= 1, got {k}")
    return _ewma_conv(y, k)


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

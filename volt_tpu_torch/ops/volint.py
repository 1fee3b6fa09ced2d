"""The volatility time-integral under the Volt covariance (port of
:mod:`volt_tpu.ops.volint`).

``I = CumTrapz(vol**2, x)`` with the reference's uniform step and both
endpoint weights halved (``"reference"``), or the exact cumulative
trapezoid rule (``"trapezoid"``).  Both assume a uniform grid.  The Volt
covariance is ``K[i, j] = I[min(i, j)]`` (:func:`min_index_covariance`,
kernel K2 on the card: :mod:`.volt_cov`), and for nondecreasing ``I`` it
has the closed-form Cholesky factor :func:`brownian_cholesky`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import device_constant

__all__ = ["cumtrapz_weights", "vol_integral", "min_index_covariance",
           "brownian_cholesky"]


def _halved_ends(n: int):
    """``[0.5, 1, ..., 1, 0.5]`` of length ``n >= 2``."""
    return np.r_[0.5, np.ones(n - 2), 0.5]


def cumtrapz_weights(x):
    """Reference ``CumTrapz`` weights: uniform ``dx``, both endpoints halved."""
    dx = (x[..., 1] - x[..., 0])[..., None]
    scale = device_constant("cumtrapz", _halved_ends, x.shape[-1],
                            dtype=x.dtype, device=x.device)
    return dx.expand(x.shape) * scale


def vol_integral(x, vol, rule: str = "reference"):
    """``I_j = integral of vol**2 up to x[j]`` along the last axis; ``x``
    and ``vol`` broadcast against each other's leading dims."""
    if rule == "reference":
        return torch.cumsum(cumtrapz_weights(x) * vol * vol, dim=-1)
    if rule == "trapezoid":
        dx = (x[..., 1] - x[..., 0])[..., None]
        v2 = vol * vol
        x0 = x[..., :1].expand(v2[..., :1].shape)
        inc0 = x0 * v2[..., :1]
        incs = 0.5 * dx * (v2[..., 1:] + v2[..., :-1])
        return torch.cumsum(torch.cat([inc0, incs], dim=-1), dim=-1)
    raise ValueError(f"unknown integral rule {rule!r} "
                     "(expected 'reference' or 'trapezoid')")


def min_index_covariance(integral):
    """``K[..., i, j] = integral[..., min(i, j)]`` by index comparison (the
    plain version of kernel K2)."""
    n = integral.shape[-1]
    idx = torch.arange(n, device=integral.device)
    return torch.where(idx[:, None] <= idx[None, :], integral[..., :, None],
                       integral[..., None, :])


def brownian_cholesky(integral, jitter: float = 0.0):
    """Closed-form lower Cholesky of :func:`min_index_covariance` for a
    nondecreasing integral: ``L[i, j] = sqrt(I[j] - I[j-1])`` for ``j <= i``
    (``I[-1] = 0``), each squared increment raised by ``jitter``."""
    inc = torch.diff(integral, dim=-1,
                     prepend=torch.zeros_like(integral[..., :1]))
    col = torch.sqrt(torch.clamp(inc + jitter, min=0.0))
    n = integral.shape[-1]
    tril = torch.tril(torch.ones(n, n, dtype=integral.dtype,
                                 device=integral.device))
    return tril * col[..., None, :]

"""The volatility time-integral under the Volt covariance (the port's
``ops/volint.py``).

``I = CumTrapz(vol**2, x)`` with the reference's uniform step and both
endpoint weights halved (``"reference"``), or the exact cumulative
trapezoid rule (``"trapezoid"``).  Both assume a uniform grid.  The Volt
covariance is ``K[i, j] = I[min(i, j)]``.
"""

from __future__ import annotations

import torch


def cumtrapz_weights(x):
    """Reference ``CumTrapz`` weights: uniform ``dx``, both endpoints halved."""
    dx = (x[..., 1] - x[..., 0])[..., None]
    n = x.shape[-1]
    scale = torch.ones(n, dtype=x.dtype, device=x.device)
    scale[0] = 0.5
    scale[-1] = 0.5
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


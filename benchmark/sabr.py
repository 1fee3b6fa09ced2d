"""Synthetic SABR prices made on the device from a seed.

The recipe of ``volt_tpu_torch/data/synthetic.py`` ``sabr_paths``, frozen
here: ``F_t = max(F_{t-1} + V_{t-1} F_{t-1}^beta dW_t, F0 / 1000)``,
``V_t = max(V_{t-1} + alpha V_{t-1} dZ_t, 1e-4)``, ``corr(dW, dZ) =
rho``, computed in float64 and returned in float32.  The draws come from
a ``torch.Generator`` on the card, one pair of calls a step for every
path at once, so a different stream from numpy's but the same process.
"""

from __future__ import annotations

import math

import torch


def sabr_prices(generator: torch.Generator, paths: int, steps: int,
                F0: float, V0: float, alpha: float, beta: float, rho: float,
                step: float) -> torch.Tensor:
    """``(paths, steps)`` float32 prices on the generator's device, the
    first column ``F0``; ``step`` is the SDE's time step."""
    dev = generator.device
    kw = dict(dtype=torch.float64, device=dev, generator=generator)
    out = torch.empty(steps, paths, dtype=torch.float32, device=dev)
    f = torch.full((paths,), F0, dtype=torch.float64, device=dev)
    v = torch.full((paths,), V0, dtype=torch.float64, device=dev)
    out[0] = f
    sd, cross = math.sqrt(step), math.sqrt(1.0 - rho * rho)
    for t in range(1, steps):
        dw = torch.randn(paths, **kw) * sd
        dz = rho * dw + cross * sd * torch.randn(paths, **kw)
        f = torch.clamp(f + v * f ** beta * dw, min=1e-3 * F0)
        v = torch.clamp(v + alpha * v * dz, min=1e-4)
        out[t] = f
    return out.T.contiguous()

"""Synthetic SDE data with known ground-truth volatility.

A numpy copy of :mod:`volt_tpu.data.synthetic` (same generator, same
values for a seed): the port keeps its own copy because ``volt_tpu``'s
package import pulls in JAX, which the port never imports.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sabr_paths"]


def sabr_paths(steps: int = 400, T: int = 1, F0: float = 10.0, V0: float = 0.2,
               alpha: float = 1.25, beta: float = 0.9, rho: float = -0.2,
               seed: int = 2019, n_paths: int = 1):
    """Simulate ``F_t = F_{t-1} + V_{t-1} F_{t-1}^beta dW_t``,
    ``V_t = V_{t-1} + alpha V_{t-1} dZ_t`` with ``corr(dW, dZ) = rho``.

    Returns ``(F, V)`` shaped ``(steps,)`` (or ``(n_paths, steps)``) in
    float32 — prices and the true volatility path.

    The Euler scheme is floored at small positive values (``F0 * 1e-3``
    for prices): a large negative increment otherwise drives ``F``
    negative and ``F**beta`` NaN for non-integer ``beta`` (likely
    somewhere in any batch of ~50+ paths).  Paths that stay positive —
    including the reference tutorial's seed-2019 path — are unchanged
    bit-for-bit.
    """
    rng = np.random.default_rng(seed)
    # `steps` points discretize the total horizon [0, T]: dt = T/steps,
    # n = steps (the previous n = steps*T simulated a T^2 horizon at a
    # doubled per-step noise scale for any T != 1; all shipped callers
    # use T=1, for which this is bit-identical)
    dt = T / steps
    n = steps
    dw = rng.normal(0.0, np.sqrt(dt), (n_paths, n))
    dz = rho * dw + np.sqrt(1 - rho**2) * rng.normal(0.0, np.sqrt(dt),
                                                     (n_paths, n))
    f = np.zeros((n_paths, n))
    v = np.zeros((n_paths, n))
    f[:, 0] = F0
    v[:, 0] = V0
    f_floor = 1e-3 * F0
    v_floor = 1e-4
    for t in range(1, n):
        f[:, t] = np.maximum(
            f[:, t - 1] + v[:, t - 1] * f[:, t - 1] ** beta * dw[:, t],
            f_floor,
        )
        v[:, t] = np.maximum(v[:, t - 1] + alpha * v[:, t - 1] * dz[:, t],
                             v_floor)
    f = f.astype(np.float32)
    v = v.astype(np.float32)
    if n_paths == 1:
        return f[0], v[0]
    return f, v

"""Gauss–Hermite quadrature (port of :mod:`volt_tpu.ops.quadrature`).

Physicists' Hermite nodes ``x_i`` / weights ``w_i``, computed once in
float64 on the host; ``f`` is evaluated at ``sqrt(2) * sigma * x_i + mu``
with weights ``w_i / sqrt(pi)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import device_constant

__all__ = ["gauss_hermite_nodes", "expected_value", "DEFAULT_NUM_LOCS"]

DEFAULT_NUM_LOCS = 75


def _hermgauss(n: int):
    """``[x, w / sqrt(pi)]``, shape ``(2, n)``, in float64."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return np.stack([x, w / np.sqrt(np.pi)])


def gauss_hermite_nodes(num_locs: int = DEFAULT_NUM_LOCS,
                        dtype=torch.float32, device=None):
    """``(locations, normalized_weights)``: rows of one read-only tensor."""
    return tuple(device_constant("gh_nodes", _hermgauss, num_locs,
                                 dtype=dtype, device=device))


def expected_value(fn, mean, var, num_locs: int = DEFAULT_NUM_LOCS):
    """``E_{f ~ N(mean, var)}[fn(f)]`` by Gauss–Hermite quadrature.

    ``fn`` must broadcast over a new leading node axis; the result is
    shaped like ``mean``.
    """
    locs, weights = gauss_hermite_nodes(num_locs, mean.dtype, mean.device)
    shape = (num_locs,) + (1,) * mean.dim()
    shifted = torch.sqrt(2.0 * var) * locs.reshape(shape) + mean
    return torch.tensordot(weights, fn(shifted), dims=([0], [0]))

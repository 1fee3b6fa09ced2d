"""The dense Volt covariance (port of :mod:`volt_tpu.ops.pallas.volt_cov`).

``K[b, i, j] = I[b, min(i, j)]`` with ``I = cumsum(w * vol**2)`` and the
reference's endpoint-halved weights (:func:`.volint.vol_integral`).  The
O(N) integral is computed here in torch; on CUDA tensors kernel K2
(``csrc/volt_cov.cu``) writes the O(N^2) matrix, on CPU tensors the plain
:func:`.volint.min_index_covariance` does.  The gradient is the plain
transpose of the expansion, as in the JAX package (which has no backward
kernel either): ``dI[m] = sum_{min(i, j) = m} g[i, j]``, then autograd
carries it through the cumsum and ``w * vol**2``.
"""

from __future__ import annotations

import torch

from .. import native
from .volint import min_index_covariance, vol_integral

__all__ = ["volt_covariance", "volt_covariance_cuda"]


def volt_covariance_cuda(integral2):
    """Kernel K2 on ``(R, N)`` float32: ``(R, N, N)``."""
    native.check_tensors("volt_covariance", integral2)
    if integral2.dim() != 2 or integral2.shape[0] < 1 or \
            integral2.shape[1] < 1:
        raise ValueError(f"volt_covariance: expected (R, N) with R, N >= 1, "
                         f"got {tuple(integral2.shape)}")
    rows, n = integral2.shape
    # K2 indexes the output with 64-bit offsets: R N^2 may pass 2^31
    out = torch.empty(rows, n, n, dtype=torch.float32,
                      device=integral2.device)
    native.launch("volt_covariance", integral2, out, rows, n,
                  device=integral2.device)
    return out


def _min_index_transpose(g):
    """The transpose of :func:`min_index_covariance`:
    ``dI[m] = g[m, m] + sum_{j > m} g[m, j] + sum_{i > m} g[i, m]``."""
    return (torch.diagonal(g, dim1=-2, dim2=-1)
            + torch.triu(g, 1).sum(-1) + torch.tril(g, -1).sum(-2))


class _VoltCovariance(torch.autograd.Function):
    """K2 forward; the backward is the plain transpose."""

    @staticmethod
    def forward(ctx, integral2):
        return volt_covariance_cuda(integral2)

    @staticmethod
    def backward(ctx, g):
        return _min_index_transpose(g)


def volt_covariance(x, vol):
    """``(..., N, N)`` Volt covariance on the uniform grid ``x`` ``(N,)``
    under the reference rule; ``vol`` is ``(N,)`` or ``(..., N)``."""
    integral = vol_integral(x, vol, "reference")
    if not native.on_card(integral):
        return min_index_covariance(integral)
    n = integral.shape[-1]
    out = _VoltCovariance.apply(integral.reshape(-1, n).contiguous())
    return out.reshape(*integral.shape, n)

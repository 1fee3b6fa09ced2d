"""Closed-form algebra for Brownian (min) kernels (port of
:mod:`volt_tpu.ops.brownian`).

The vol-GP stage's spectral MLL needs the closed-form eigensystem of the
integer min-matrix ``M[i, j] = min(i, j)`` (``i, j = 1..n``):

    ``mu_k = 1 / (4 sin^2((2k+1) pi / (2(2n+1))))``
    ``u_k[j] = 2/sqrt(2n+1) * sin((2k+1) j pi / (2n+1))``

and the projection ``U^T y``: one matrix product against the materialised
basis up to n = 4096, a real FFT above (any n).  The dense GPCV family's
KL uses the Cholesky factor
of ``min(x)``, ``L = T diag(sqrt(dx))`` with ``T`` the lower-ones matrix:
its solves are differences, its log-determinant ``sum log dx``.
"""

from __future__ import annotations

import math
import torch

_PROJECT_FFT_MIN_N = 4096


def future_grid_ok(test_x, train_x):
    """``test_x`` strictly increasing and strictly after the last train
    point — the contract of the filtered-state forecast closed forms."""
    if test_x.shape[-1] > 1:
        inc_ok = torch.all(torch.diff(test_x, dim=-1) > 0, dim=-1)
    else:
        inc_ok = torch.ones(test_x.shape[:-1], dtype=torch.bool,
                            device=test_x.device)
    return inc_ok & (test_x[..., 0] > train_x[..., -1])


def nan_poison(x, ok):
    """``x`` where ``ok`` else NaN, as arithmetic: ``x * (ok / ok)``.
    ``ok`` broadcasts against ``x`` from the left (pre-expand it)."""
    okf = ok.to(x.dtype)
    return x * (okf / okf)


def min_kernel_eigenvalues(n: int, dtype=torch.float32, device=None):
    """Eigenvalues ``mu_k`` of the integer min-matrix — O(n), any n."""
    k = torch.arange(n, dtype=dtype, device=device)
    return 1.0 / (4.0 * torch.sin((2 * k + 1)
                                  * (math.pi / (2 * (2 * n + 1)))) ** 2)


def spectral_n_ok(n: int) -> bool:
    """Whether :func:`min_kernel_spectrum` is exact at this ``n``: its
    angle reduction forms ``(2k+1) j`` with ``k <= n-1``, ``j <= n`` in
    int64, at most ``(2n-1) n``, which must stay below ``2^63`` (``n <=
    2^31``).

    The JAX package forms the same products in int32, so its predicate is
    ``False`` above ``n = 32768``; here the answer is ``True`` up to
    ``2^31``, which covers every ``n`` whose ``n x n`` basis fits in
    memory.  As in the JAX package, the bound concerns the materialised
    basis alone: :func:`min_kernel_project` takes the FFT above n = 4096.
    """
    return (2 * n - 1) * n < 2**63


def min_kernel_spectrum(n: int, dtype=torch.float32, device=None):
    """``(mu (n,), u (n, n) orthonormal columns, w (n,) = U^T 1)``.

    The sine arguments are reduced with exact integer arithmetic (int64)
    so float32 ``sin`` stays accurate where the raw angles reach
    ``~2 n pi``.  Raises ``ValueError`` where that reduction would
    overflow (:func:`spectral_n_ok`).
    """
    if not spectral_n_ok(n):
        raise ValueError(f"min_kernel_spectrum: n={n} overflows the int64 "
                         f"angle reduction (needs (2n-1)n < 2^63, i.e. "
                         f"n <= 2^31)")
    mu = min_kernel_eigenvalues(n, dtype, device)
    k = torch.arange(n, device=device)
    j = torch.arange(1, n + 1, device=device)
    prod = ((2 * k[None, :] + 1) * j[:, None]) % (2 * (2 * n + 1))
    u = torch.sin(prod.to(dtype) * (math.pi / (2 * n + 1))) * (
        2.0 / math.sqrt(2 * n + 1))
    return mu, u, torch.sum(u, dim=0)


def min_kernel_project(y, axis: int = -1, method: str = "auto"):
    """``U^T y`` along ``axis`` for the closed-form eigenbasis,
    ``(U^T y)[k] = 2/sqrt(m) sum_{j=1..n} y_j sin((2k+1) j pi / m)`` with
    ``m = 2n + 1``.

    ``"matmul"``: one matrix product against the materialised basis
    (``torch.matmul`` outside any kernel, as the JAX package leaves this
    product to XLA), O(n^2) memory.  ``"fft"``: the sum is ``-Im`` of bin
    ``2k+1`` of the length-``2m`` real FFT of ``y`` placed at indices
    ``1..n`` of zeros; O(n log n), no n x n object, any n (cuFFT and
    pocketfft take any length, so the JAX package's power-of-two
    Bluestein evaluation is not needed).  ``"auto"``: matmul up to
    n = 4096, the FFT above."""
    if method not in ("auto", "matmul", "fft"):
        raise ValueError("method must be 'auto', 'matmul' or 'fft'")
    y = torch.movedim(y, axis, -1)
    n = y.shape[-1]
    if method == "matmul" or (method == "auto" and n <= _PROJECT_FFT_MIN_N):
        _, u, _ = min_kernel_spectrum(n, y.dtype, y.device)
        return torch.movedim(torch.matmul(y, u), -1, axis)
    m = 2 * n + 1
    spec = torch.fft.rfft(torch.nn.functional.pad(y, (1, 2 * m - n - 1)),
                          dim=-1)
    out = -spec[..., 1:2 * n:2].imag * (2.0 / math.sqrt(m))
    return torch.movedim(out, -1, axis)


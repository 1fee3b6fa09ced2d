"""The BM vol GP's spectral MLL by kernel G2 (``csrc/bm_vol_mll.cu``).

:meth:`volt_tpu_torch.models.BMGP.mll_spectral` composes it from plain
ops: ``K + s I = diag(d) + a w w^T`` in the eigenbasis of the min-matrix,
by Sherman–Morrison and the determinant lemma, about twenty elementwise
operations and four row sums over ``(assets, n)``, some 90 kernel launches
a step with autograd's reverse, for two parameters an asset.  G2 computes
the same per-asset MLL in one launch and, when a gradient is wanted, in the
same pass its gradient with respect to ``vol`` and the noise ``s``: with

* ``d_k = vol dx mu_k + s``, ``a = vol (x0 - dx)``, ``r_k = p_y,k + vol^2
  p_t,k / 2``;
* ``A = sum w^2 / d``, ``B = sum w r / d``, ``C = sum r^2 / d``, ``S = 1 +
  a A``, ``q = C - a B^2 / S``;
* ``mll = -(q + sum log d + log S + n log(2 pi)) / (2 n)``,

each derivative of ``q + log det`` follows from the derivatives of ``d``,
``a`` and ``r`` in closed form (the noise: ``d' = 1``; vol: ``d' = dx mu``,
``a' = x0 - dx``, ``r' = vol p_t``) through ten more row sums.  The
autograd function's backward only scales the two gradients by the per-asset
cotangent; the constraints (sigmoid, softplus) stay in autograd.

:func:`bm_vol_mll_reference` is that computation in plain PyTorch, phase by
phase as the kernel runs it; the CPU tests hold it to autograd of the
composition, and the composition stays the CPU's path (``native.on_card``:
on the card G2 runs or its wrapper raises).
"""

from __future__ import annotations

import math

import torch

from .. import native

__all__ = ["bm_vol_mll", "bm_vol_mll_cuda", "bm_vol_mll_reference"]

_LOG_2PI = math.log(2.0 * math.pi)


def bm_vol_mll_reference(p_y, p_t, mu, w, dx, x0, vol, noise):
    """G2's MLL ``(...)`` and its gradients with respect to ``(vol,
    noise)``, in plain PyTorch in the inputs' dtype (the tests' is
    float64), as ``csrc/bm_vol_mll.cu`` computes them: the spectral cache
    ``p_y (..., n)``, ``mu``, ``w`` ``(n,)``, the grid's ``p_t``, ``dx``
    and ``x0`` shared (``(n,)``, ``()``, ``()``) or per asset, and ``vol``,
    ``noise`` ``(..., 1)``; the shapes broadcast.  Returns ``(mll, (g_vol,
    g_noise))``, the gradients ``(..., 1)``."""
    n = p_y.shape[-1]
    v, s = vol[..., 0], noise[..., 0]
    # (1) one pass over the row: the fourteen sums
    d = (v * dx)[..., None] * mu + s[..., None]
    r = p_y + (0.5 * v * v)[..., None] * p_t
    wd, rd = w / d, r / d
    terms = (w * wd, w * rd, r * rd, torch.log(d), wd * wd, wd * rd,
             rd * rd, 1.0 / d, wd * wd * mu, wd * rd * mu, rd * rd * mu,
             mu / d, wd * p_t, rd * p_t)
    (s_a, s_b, s_c, log_d, a2, b2, c2, d1, a2m, b2m, c2m, d1m, bp,
     cp) = (torch.sum(t, dim=-1) for t in terms)
    # (2) the scalars
    gap = x0 - dx
    a = v * gap
    big_s = 1.0 + a * s_a
    bb = s_b * s_b
    mll = -0.5 * (s_c - a * bb / big_s + log_d + torch.log(big_s)
                  + n * _LOG_2PI) / n

    def phi(da, db, dc, ds, dd):
        """The derivative of ``q + log det`` from ``(a', B', C', S', sum
        d' / d)``."""
        return (dc - da * bb / big_s - 2.0 * a * s_b * db / big_s
                + a * bb * ds / (big_s * big_s) + dd + ds / big_s)

    g_noise = -0.5 / n * phi(0.0, -b2, -c2, -a * a2, d1)
    g_vol = -0.5 / n * phi(gap, v * bp - dx * b2m, 2.0 * v * cp - dx * c2m,
                           gap * s_a - a * dx * a2m, dx * d1m)
    return mll, (g_vol[..., None], g_noise[..., None])


def bm_vol_mll_cuda(p_y, p_t, mu, w, dx, x0, vol, noise, grad: bool = False):
    """Kernel G2 over contiguous float32 CUDA tensors: ``p_y (..., n)``,
    ``mu``, ``w`` ``(n,)``, the grid's ``p_t``, ``dx``, ``x0`` shared
    (``(n,)``, ``()``, ``()``) or per asset (``(..., n)``, ``(...)``,
    ``(...)``), ``vol`` and ``noise`` ``(..., 1)``.  Returns ``(mll,
    grads)``: the MLL ``(...)`` and, with ``grad``, its gradients with
    respect to ``(vol, noise)`` in their shapes (else ``None``)."""
    ins = (p_y, p_t, mu, w, dx, x0, vol, noise)
    native.check_tensors("bm_vol_spectral_mll", *ins)
    n = p_y.shape[-1] if p_y.dim() else 0
    batch = tuple(p_y.shape[:-1])
    per_row = p_t.dim() > 1
    grid = ((*batch, n), batch) if per_row else ((n,), ())
    want = {"p_y": (*batch, n), "p_t": grid[0], "mu": (n,), "w": (n,),
            "dx": grid[1], "x0": grid[1], "vol": (*batch, 1),
            "noise": (*batch, 1)}
    got = {k: tuple(t.shape) for k, t in zip(want, ins)}
    if n < 1 or got != want:
        raise ValueError(f"bm_vol_spectral_mll: expected {want} with n >= 1, "
                         f"got {got}")
    out = p_y.new_empty(batch)
    grads = (torch.empty_like(vol), torch.empty_like(noise)) if grad \
        else (None, None)
    rows = p_y.numel() // n
    if rows:
        native.launch("volt_bm_vol_spectral_mll", p_y, p_t, mu, w, dx, x0,
                      int(per_row), vol, noise, out, *grads, rows, n,
                      device=p_y.device)
    return out, (grads if grad else None)


class _SpectralMLL(torch.autograd.Function):
    """G2's forward, keeping its gradients; the backward scales them."""

    @staticmethod
    def forward(ctx, p_y, p_t, mu, w, dx, x0, vol, noise):
        out, grads = bm_vol_mll_cuda(p_y, p_t, mu, w, dx, x0, vol, noise,
                                     grad=True)
        ctx.save_for_backward(*grads)
        return out

    @staticmethod
    def backward(ctx, g):
        # one multi-tensor launch for the two
        g = g[..., None]
        grads = torch._foreach_mul(list(ctx.saved_tensors), [g, g])
        return (None,) * 6 + tuple(t if need else None for t, need in
                                   zip(grads, ctx.needs_input_grad[6:]))


def bm_vol_mll(p_y, p_t, mu, w, dx, x0, vol, noise):
    """The per-asset MLL ``(...)`` of ``BMGP.mll_spectral`` by G2, for the
    card's tensors: the spectral cache's ``p_y``, ``p_t``, ``mu``, ``w``,
    ``dx`` and ``x0`` (the grid shared or per asset), ``vol`` and ``noise``
    ``(..., 1)``; the batch shapes broadcast together, and gradients reach
    ``vol`` and ``noise``.  Raises on what G2 does not take: a tensor not
    float32, and a gradient wanted for the spectral cache."""
    cache = (p_y, p_t, mu, w, dx, x0)
    grad = torch.is_grad_enabled()
    if grad and any(t.requires_grad for t in cache):
        raise ValueError("bm_vol_spectral_mll: G2 gives no gradient for the "
                         "spectral cache")
    per_row = p_t.dim() > 1 or dx.dim() > 0 or x0.dim() > 0
    grid_batch = (p_t.shape[:-1], dx.shape, x0.shape) if per_row else ()
    batch = torch.broadcast_shapes(p_y.shape[:-1], vol.shape[:-1],
                                   noise.shape[:-1], *grid_batch)

    def rows(t):
        return t.expand(*batch, t.shape[-1]).contiguous()

    if per_row:
        grid = (rows(p_t), dx.expand(batch).contiguous(),
                x0.expand(batch).contiguous())
    else:
        grid = (p_t.contiguous(), dx.contiguous(), x0.contiguous())
    ins = (rows(p_y), grid[0], mu.contiguous(), w.contiguous(), *grid[1:],
           rows(vol), rows(noise))
    if grad and (vol.requires_grad or noise.requires_grad):
        return _SpectralMLL.apply(*ins)
    return bm_vol_mll_cuda(*ins)[0]

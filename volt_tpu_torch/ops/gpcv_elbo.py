"""The tridiagonal GPCV ELBO by kernel G1 (``csrc/gpcv_elbo.cu``).

:meth:`volt_tpu_torch.models.GPCVModel.elbo` with ``q="tridiag"``, the BM
kernel and the closed-form exp term composes it from plain ops: the
Takahashi band and the tridiagonal KL of :mod:`.bidiag` and the
likelihood's lognormal moments, about 740 kernel launches a step with
autograd's reverse.  G1 computes the same per-asset ELBO in one launch and,
when a gradient is wanted, in the same pass its gradient with respect to
the variational mean, ``q_log_d``, ``q_e``, the constant prior mean and
the kernel's ``vol``; the autograd function's backward only scales those
by the per-asset cotangent.  That plain composition is the CPU's path and
the kernel's reference (``native.on_card``: on the card G1 runs or its
wrapper raises).
"""

from __future__ import annotations

import torch

from .. import native

__all__ = ["tridiag_elbo", "tridiag_elbo_cuda"]


def tridiag_elbo_cuda(x, y, m, q_log_d, q_e, c, vol, grad: bool = False):
    """Kernel G1 over contiguous float32 CUDA tensors: ``y``, ``m`` and
    ``q_log_d`` ``(..., n)``, ``q_e`` ``(..., n-1)``, ``c`` and ``vol``
    ``(..., 1)``, the grid ``x`` ``(n,)`` shared or ``(..., n)`` per asset.
    Returns ``(elbo, grads)``: the ELBO ``(...)`` and, with ``grad``, the
    gradients with respect to ``(m, q_log_d, q_e, c, vol)`` in their
    shapes (else ``None``)."""
    native.check_tensors("gpcv_tridiag_elbo", x, y, m, q_log_d, q_e, c, vol)
    n = y.shape[-1]
    batch = y.shape[:-1]
    want = {"y": (*batch, n), "m": (*batch, n), "q_log_d": (*batch, n),
            "q_e": (*batch, n - 1), "c": (*batch, 1), "vol": (*batch, 1)}
    got = {k: tuple(t.shape) for k, t in zip(want, (y, m, q_log_d, q_e, c,
                                                     vol))}
    if n < 1 or got != want or x.shape not in ((n,), y.shape):
        raise ValueError(f"gpcv_tridiag_elbo: expected x (n,) or (..., n) "
                         f"and {want}, got x {tuple(x.shape)} and {got}")
    out = y.new_empty(batch)
    grads = tuple(torch.empty_like(t) for t in (m, q_log_d, q_e, c, vol)) \
        if grad else (None,) * 5
    var_ws = torch.empty(y.shape, dtype=torch.float64, device=y.device) \
        if grad else None
    rows = y.numel() // n
    if rows:
        native.launch("volt_gpcv_tridiag_elbo", x, int(x.dim() > 1), y, m,
                      q_log_d, q_e, c, vol, out, *grads, var_ws, rows, n,
                      device=y.device)
    return out, (grads if grad else None)


class _TridiagELBO(torch.autograd.Function):
    """G1's forward, keeping its gradients; the backward scales them."""

    @staticmethod
    def forward(ctx, x, y, m, q_log_d, q_e, c, vol):
        out, grads = tridiag_elbo_cuda(x, y, m, q_log_d, q_e, c, vol,
                                       grad=True)
        ctx.save_for_backward(*grads)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g[..., None]
        return (None, None, *(g * t if need else None for t, need in
                              zip(ctx.saved_tensors,
                                  ctx.needs_input_grad[2:])))


def tridiag_elbo(train_x, y, m, q_log_d, q_e, c, vol):
    """The per-asset ELBO ``(...)`` of ``GPCVModel.elbo`` (``q="tridiag"``,
    BM, the closed-form exp term) by G1, for the card's tensors: the batch
    shapes broadcast together, ``train_x`` is ``(n,)`` or batched, and
    gradients reach ``m``, ``q_log_d``, ``q_e``, the prior mean's constant
    ``c`` ``(..., 1)`` and ``vol`` ``(..., 1)``.  Raises on what G1 does
    not take: a tensor not float32, and a gradient wanted for the grid or
    the returns."""
    if torch.is_grad_enabled() and (train_x.requires_grad
                                    or y.requires_grad):
        raise ValueError("gpcv_tridiag_elbo: G1 gives no gradient for the "
                         "grid or the returns")
    batch = torch.broadcast_shapes(*(t.shape[:-1] for t in (
        train_x, y, m, q_log_d, q_e, c, vol)))

    def rows(t):
        return t.expand(*batch, t.shape[-1]).contiguous()

    x = train_x.contiguous() if train_x.dim() == 1 else rows(train_x)
    ins = (x, *map(rows, (y, m, q_log_d, q_e, c, vol)))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins[2:]):
        return _TridiagELBO.apply(*ins)
    return tridiag_elbo_cuda(*ins)[0]

"""The joint tridiagonal GPCV ELBO of the multitask model by kernel G3
(``csrc/mt_gpcv_elbo.cu``).

:meth:`volt_tpu_torch.models.MultitaskVariationalGP.elbo` with
``q="tridiag"`` (the BM kernel) and the closed-form exp term composes it
from plain ops: two Takahashi scans of :mod:`.bidiag`, the Kronecker KL of
:mod:`..gp.kronecker` with a Cholesky of the ``T x T`` task covariance
(whose jitter ladder waits for the card) and two triangular solves, and
the likelihood's lognormal moments, about 1000 kernel launches a step with
autograd's reverse.  G3 computes the same ELBO in one call of three
launches and, when a gradient is wanted, in the same pass its gradient
with respect to the variational mean, ``q_log_d``, ``q_e``, the task root,
the prior's constants, the task factor ``F``, its diagonal ``v`` and the
kernel's ``vol``; the autograd function's backward only scales those by
the cotangent.  The task side goes through ``K_t = F F^T + diag(v)`` by
Woodbury in float64, so it needs no ``T x T`` factor and no jitter.  That
plain composition is the CPU's path and the kernel's reference.
"""

from __future__ import annotations

import torch

from .. import native

__all__ = ["G3_MAX_RANK", "mt_tridiag_elbo", "mt_tridiag_elbo_cuda"]

# The largest rank of the task factor that G3 takes (``RMAX`` in the
# kernel's source).
G3_MAX_RANK = 4


def mt_tridiag_elbo_cuda(x, y, m, q_log_d, q_e, root, c, factor, v, vol,
                         grad: bool = False):
    """Kernel G3 over contiguous float32 CUDA tensors: the grid ``x (n,)``,
    the returns ``y`` and the variational mean ``m`` ``(n, T)``,
    ``q_log_d (n,)``, ``q_e (n-1,)``, the task root ``root (T, T)`` (its
    lower triangle), the prior's constants ``c (T,)``, the task factor
    ``factor (T, r)`` and diagonal ``v (T,)``, ``vol (1,)``.  Returns
    ``(elbo, grads)``: the ELBO (a scalar) and, with ``grad``, the
    gradients with respect to ``(m, q_log_d, q_e, root, c, factor, v,
    vol)`` in their shapes (``root``'s zero above the diagonal), else
    ``None``."""
    ins = (x, y, m, q_log_d, q_e, root, c, factor, v, vol)
    native.check_tensors("mt_gpcv_tridiag_elbo", *ins)
    n, t = y.shape[-2:] if y.dim() == 2 else (0, 0)
    r = factor.shape[-1] if factor.dim() == 2 else 0
    want = {"x": (n,), "y": (n, t), "m": (n, t), "q_log_d": (n,),
            "q_e": (n - 1,), "root": (t, t), "c": (t,), "factor": (t, r),
            "v": (t,), "vol": (1,)}
    got = {k: tuple(a.shape) for k, a in zip(want, ins)}
    if n < 1 or t < 1 or not 1 <= r <= G3_MAX_RANK or got != want:
        raise ValueError(f"mt_gpcv_tridiag_elbo: expected {want} with n, T "
                         f">= 1 and 1 <= r <= {G3_MAX_RANK}, got {got}")
    out = y.new_empty(())
    grads = tuple(torch.empty_like(a) for a in ins[2:]) if grad \
        else (None,) * 8
    ws = torch.empty(native.size("volt_mt_gpcv_workspace_len", n, t, r),
                     dtype=torch.float64, device=y.device)
    native.launch("volt_mt_gpcv_tridiag_elbo", *ins, out, *grads, ws,
                  ws.numel(), n, t, r, device=y.device)
    return out, (grads if grad else None)


class _MtTridiagELBO(torch.autograd.Function):
    """G3's forward, keeping its gradients; the backward scales them."""

    @staticmethod
    def forward(ctx, x, y, m, q_log_d, q_e, root, c, factor, v, vol):
        out, grads = mt_tridiag_elbo_cuda(x, y, m, q_log_d, q_e, root, c,
                                          factor, v, vol, grad=True)
        ctx.save_for_backward(*grads)
        return out

    @staticmethod
    def backward(ctx, g):
        # one multi-tensor launch for the eight
        grads = torch._foreach_mul(list(ctx.saved_tensors), g)
        return (None, None, *(t if need else None for t, need in
                              zip(grads, ctx.needs_input_grad[2:])))


def mt_tridiag_elbo(train_x, y, m, q_log_d, q_e, root, c, factor, v, vol):
    """The ELBO of ``MultitaskVariationalGP.elbo`` (``q="tridiag"``, the
    closed-form exp term) by G3, for the card's tensors: gradients reach
    ``m``, ``q_log_d``, ``q_e``, the task root ``root``, the prior's
    constants ``c (T,)``, the task factor, its diagonal ``v`` and ``vol
    (1,)``.  Raises on what G3 does not take: a batch, a task factor of
    rank above :data:`G3_MAX_RANK`, a tensor not float32, and a gradient
    wanted for the grid or the returns."""
    ins = tuple(a.contiguous() for a in (train_x, y, m, q_log_d, q_e, root,
                                         c, factor, v, vol))
    grad = torch.is_grad_enabled()
    if grad and (train_x.requires_grad or y.requires_grad):
        raise ValueError("mt_gpcv_tridiag_elbo: G3 gives no gradient for "
                         "the grid or the returns")
    if grad and any(a.requires_grad for a in ins[2:]):
        return _MtTridiagELBO.apply(*ins)
    return mt_tridiag_elbo_cuda(*ins)[0]

"""Adam with optax's arithmetic (``optax.adam``, the JAX package's
optimiser), op for op.

``torch.optim.Adam`` takes the same steps in exact arithmetic, but rounds
differently: it corrects the moments' bias in float64 on the host, so its
first step is ``lr`` to float32 resolution.  optax computes ``1 - b**t``
in the parameters' precision (for float32, ``0.9`` and ``0.999``
rounded), so its first float32 step is about ``6.7e-6`` relative short
of ``lr``.  That matters where a parameter starts at ``lr``: the dense
GPCV family's Laplace root on a grid from ``x = 0`` has ``10 * sqrt(1e-6)
= 0.01`` in its first diagonal entry, torch's first step of ``lr = 0.01``
lands it on 0 and the KL's ``log|diag|`` on ``-inf``, while optax's
leaves about ``7e-8``.

The update is taken in the form XLA compiles optax's to, ``mu / (c1 *
(sqrt(nu / c2) + eps))``; it matches optax to float32 rounding (XLA's
``pow`` and its compiled update differ from these by an ulp at times).  Every
operation is one IEEE-rounded multiply, add, divide or square root, each
its own kernel (no fused multiply-add), and the bias corrections are
device tensors (a CPU scalar makes CUDA's division a multiply by the
reciprocal), so the card and the CPU take the same steps.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.profiling import device_constant

__all__ = ["Adam"]


def _sqrt(a):
    """The correctly rounded square root: the CPU's vectorised float32
    ``sqrt`` is not (about 0.7% of its results are an ulp off), so there
    it is taken in float64 and rounded, which for a square root gives the
    correctly rounded float32; CUDA's ``sqrtf`` is IEEE."""
    if a.device.type == "cpu" and a.dtype == torch.float32:
        return torch.sqrt(a.double()).float()
    return torch.sqrt(a)


def _bias_tables(steps: int, b1: float, b2: float, dt):
    """optax's ``1 - b**t``, ``t = 1..steps``, in the numpy dtype ``dt``."""
    t = np.arange(1, steps + 1).astype(dt)
    return np.stack([dt.type(1) - dt.type(b) ** t for b in (b1, b2)])


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` over ``params`` for at most ``steps``
    calls of :meth:`step`, each after the gradients are in ``.grad``."""

    def __init__(self, params, lr: float, steps: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        like = self.params[0] if self.params else torch.zeros(())
        dt = torch.empty((), dtype=like.dtype).numpy().dtype
        self.c1, self.c2 = device_constant(
            "adam_tables", _bias_tables, max(steps, 1), b1, b2, dt,
            dtype=like.dtype, device=like.device)
        self.t = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        if not self.params:
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, g2)
        c1, c2 = self.c1[self.t], self.c2[self.t]
        self.t += 1
        # p += -lr * (mu / c1) / (sqrt(nu / c2) + eps), in the form XLA
        # compiles optax's update to: mu / (c1 * (sqrt(nu / c2) + eps))
        den = [_sqrt(torch.div(v, c2)) for v in self.nu]
        torch._foreach_add_(den, self.eps)
        den = [torch.mul(d, c1) for d in den]
        upd = torch._foreach_div(self.mu, den)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)

"""Gauss–Hermite expected log-likelihood of the exp volatility model (port
of :mod:`volt_tpu.ops.pallas.gh_ell`).

``E_{f ~ N(mean, var)}[log N(y; 0, scale(f)^2)]`` with
``scale(f) = max(exp(min(f, 80)), 1e-3)``, by ``num_locs``-node
Gauss–Hermite quadrature — the GPCV ELBO's reference term
(``method="quadrature"``).  On CUDA tensors kernel K3 (``csrc/gh_ell.cu``)
computes it; when a gradient is wanted, the same node pass also keeps the
node sums of its analytic gradient, and the backward is an elementwise
kernel over them.  On CPU tensors the plain version (the node sum of
:func:`.quadrature.expected_value`) does.
"""

from __future__ import annotations

import math

import torch

from .. import native
from ..utils.profiling import device_constant
from .quadrature import DEFAULT_NUM_LOCS, _hermgauss, expected_value

__all__ = ["exp_scale", "exp_log_prob", "gh_expected_log_prob",
           "gh_ell_forward_cuda", "gh_ell_backward_cuda",
           "var_grad_resolution"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# dynamic shared memory holds 3 * num_locs floats, within the 48 KB a
# launch gets without an opt-in
_MAX_LOCS = 4096
# threads the forward aims for: about one full load of 132 SMs at 2048
# threads each (its split of a datum's nodes over up to 8 lanes fills the
# card at small shapes)
_THREADS = 2**18


def exp_scale(f):
    """Observation std ``max(exp(min(f, 80)), 1e-3)``; the cap keeps GH tail
    nodes of a wide ``q`` from overflowing ``exp``.  At either kink the
    derivative is the clamped side's (0), as in kernel K3 and the JAX
    package's Pallas backward; NaN passes through."""
    ef = torch.exp(torch.where(f >= 80.0, 80.0, f))
    return torch.where(ef <= 1e-3, 1e-3, ef)


def exp_log_prob(y, f):
    """``log N(y; 0, exp_scale(f)^2)`` elementwise."""
    s = exp_scale(f)
    return -0.5 * (y / s) ** 2 - torch.log(s) - _HALF_LOG_2PI


def _gh_ell_plain(y, mean, var, num_locs: int):
    """The plain version: the weighted node sum over a ``(nodes, ...)``
    intermediate."""
    return expected_value(lambda f: exp_log_prob(y, f), mean, var, num_locs)


def var_grad_resolution(y, mean, var, g, num_locs: int = DEFAULT_NUM_LOCS):
    """Float32 resolution of the d/dvar node sum, ``num_locs`` ulps of
    ``|g| sum_k w_k |x_k| |dlp_k| / sd``: the error bound of a recursive
    float32 sum of ``num_locs`` terms (``(num_locs - 1) u`` of the sum of
    their magnitudes) for each of two implementations.  The sum itself
    cancels to a value proportional to ``sd`` (``sum_k w_k x_k = 0``), so at
    small variance that rounding, in any summation order, is a large share
    of the result."""
    with torch.no_grad():
        locs, w = (t.reshape(-1, *(1,) * mean.dim()) for t in
                   _nodes(num_locs, mean.device).to(mean.dtype).chunk(2))
        sd = torch.sqrt(2.0 * var)
        f = sd * locs + mean
        ef = torch.exp(torch.clamp(f, max=80.0))
        live = (ef > 1e-3) & (f < 80.0)
        dlp = ((y / torch.clamp(ef, min=1e-3)) ** 2 - 1.0) * live
        terms = (w * locs.abs() * dlp.abs()).sum(0)
        eps = torch.finfo(torch.float32).eps
        return num_locs * eps * g.abs() * terms / torch.clamp(sd, min=1e-20)


def _nodes(num_locs: int, device):
    """The quadrature's read-only nodes, ``[x, w]`` flattened, in float32."""
    return device_constant("gh_nodes", _hermgauss, num_locs,
                           dtype=torch.float32, device=device).reshape(-1)


def _check(name, num_locs, *tensors):
    native.check_tensors(name, *tensors)
    if any(t.shape != tensors[0].shape for t in tensors):
        raise ValueError(f"{name}: expected tensors of one shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not 1 <= num_locs <= _MAX_LOCS:
        raise ValueError(f"{name}: num_locs must be in [1, {_MAX_LOCS}], "
                         f"got {num_locs}")


def _split_log2(count: int) -> int:
    """log2 of the lanes that share a datum's node loop: the least of 1,
    2, 4 and 8 that gives ``_THREADS`` threads."""
    s = 0
    while s < 3 and count << s < _THREADS:
        s += 1
    return s


def gh_ell_forward_cuda(y, mu, s2, num_locs: int = DEFAULT_NUM_LOCS,
                        save: bool = False):
    """Kernel K3 forward, elementwise over contiguous float32 tensors of
    one shape.  With ``save`` it returns ``(out, saved)``: ``saved``
    ``(3, *shape)`` holds the node sums of the gradient, from the same
    pass, for :func:`gh_ell_backward_cuda`."""
    _check("gh_ell_forward", num_locs, y, mu, s2)
    out = torch.empty_like(y)
    saved = y.new_empty((3, *y.shape)) if save else None
    if y.numel():
        native.launch("volt_gh_ell_forward", y, mu, s2,
                      _nodes(num_locs, y.device), out, saved, y.numel(),
                      num_locs, _split_log2(y.numel()), device=y.device)
    return (out, saved) if save else out


def gh_ell_backward_cuda(y, mu, s2, g, num_locs: int = DEFAULT_NUM_LOCS,
                         saved=None):
    """Kernel K3 backward: ``(dy, dmu, ds2)`` for the cotangent ``g``, from
    the node sums ``saved`` by the forward with ``save`` (run here when
    ``saved`` is not given)."""
    _check("gh_ell_backward", num_locs, y, mu, s2, g)
    if saved is None:
        saved = gh_ell_forward_cuda(y, mu, s2, num_locs, save=True)[1]
    native.check_tensors("gh_ell_backward", saved, y)
    if saved.shape != (3, *y.shape):
        raise ValueError(f"gh_ell_backward: saved sums of shape "
                         f"{tuple(saved.shape)} for data {tuple(y.shape)}")
    dy, dmu, ds2 = (torch.empty_like(y) for _ in range(3))
    if y.numel():
        native.launch("volt_gh_ell_backward", s2, g, saved, dy, dmu, ds2,
                      y.numel(), device=y.device)
    return dy, dmu, ds2


class _GHELL(torch.autograd.Function):
    """K3 forward, keeping the gradient's node sums, with the elementwise
    backward kernel."""

    @staticmethod
    def forward(ctx, y, mu, s2, num_locs):
        out, saved = gh_ell_forward_cuda(y, mu, s2, num_locs, save=True)
        ctx.num_locs = num_locs
        ctx.save_for_backward(y, mu, s2, saved)
        return out

    @staticmethod
    def backward(ctx, g):
        y, mu, s2, saved = ctx.saved_tensors
        return (*gh_ell_backward_cuda(y, mu, s2, g.contiguous(),
                                      ctx.num_locs, saved), None)


def gh_expected_log_prob(y, mean, var, num_locs: int = DEFAULT_NUM_LOCS):
    """GH expected log-likelihood; ``y``, ``mean`` and ``var`` broadcast
    together, and gradients reach all three."""
    y, mean, var = torch.broadcast_tensors(y, mean, var)
    if y.is_cpu:
        return _gh_ell_plain(y, mean, var, num_locs)
    ins = (y.contiguous(), mean.contiguous(), var.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _GHELL.apply(*ins, num_locs)
    return gh_ell_forward_cuda(*ins, num_locs)

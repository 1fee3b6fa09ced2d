"""Tridiagonal algebra and the Kalman-filter MLL (port of
:mod:`volt_tpu.ops.tridiag`).

* :func:`tridiag_ldl_pivots` — LDL pivots and logdet of an SPD
  tridiagonal from the leading-minor recurrence, a scan over normalised
  2x2 matrix products (doubling scan, as in :mod:`.bidiag`).
* :func:`tridiag_solve` / :func:`brownian_noise_mll` — the solve from
  those pivots and the min-kernel MLL through it: two affine doubling
  scans (:func:`.bidiag.affine_scan`), no sequential loop.  Plain torch on
  every device; the fit runs the Kalman form below.
* :func:`brownian_noise_mll_kalman` / :func:`brownian_noise_filter` — the
  scalar random-walk Kalman filter.  On CUDA tensors both run kernel S1
  (``csrc/kalman.cu``, forward and adjoint); on CPU tensors they run the
  plain version, a Python loop over time vectorised over the batch.
"""

from __future__ import annotations

import math

import torch

from .. import native

__all__ = [
    "tridiag_ldl_pivots",
    "tridiag_solve",
    "brownian_noise_mll",
    "brownian_noise_mll_kalman",
    "brownian_noise_filter",
    "kalman_forward_cuda",
    "kalman_backward_cuda",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _max_abs(*xs):
    out = xs[0].abs()
    for x in xs[1:]:
        out = torch.maximum(out, x.abs())
    return torch.clamp(out, min=1e-30)


def tridiag_ldl_pivots(diag, off):
    """LDL pivots ``d`` and ``logdet`` of an SPD tridiagonal matrix.

    ``diag``: ``(..., n)``; ``off``: ``(..., n-1)``.  The minors follow
    ``p_i = a_i p_{i-1} - e_{i-1}^2 p_{i-2}``, a product of the 2x2
    matrices ``[[a_i, -e_{i-1}^2], [1, 0]]``.  Each matrix, and each
    partial product, is divided by its largest entry and the log-scales
    are summed apart: without that the minors overflow float32.
    """
    esq = torch.cat([torch.zeros_like(diag[..., :1]), off * off], dim=-1)
    one = torch.ones_like(diag)
    zero = torch.zeros_like(diag)
    scale = _max_abs(diag, esq, one)
    # the matrix entries (m00, m01, m10, m11), normalised
    m = (diag / scale, -esq / scale, one / scale, zero)
    logs = torch.log(scale)

    n = diag.shape[-1]
    off_ = 1
    while off_ < n:
        # later (y) times earlier (x): prod = M_y @ M_x
        x = [a[..., :-off_] for a in m]
        y = [a[..., off_:] for a in m]
        p = (y[0] * x[0] + y[1] * x[2], y[0] * x[1] + y[1] * x[3],
             y[2] * x[0] + y[3] * x[2], y[2] * x[1] + y[3] * x[3])
        ps = _max_abs(*p)
        m = tuple(torch.cat([a[..., :off_], b / ps], dim=-1)
                  for a, b in zip(m, p))
        logs = torch.cat([logs[..., :off_], logs[..., :-off_]
                          + logs[..., off_:] + torch.log(ps)], dim=-1)
        off_ *= 2
    # [p_i, p_{i-1}]^T = P_i @ [1, 0]^T: column 0 of the prefix product
    p_top, p_bot = m[0], m[2]
    d = p_top / p_bot
    logdet = logs[..., -1] + torch.log(torch.abs(p_top[..., -1]))
    return d, logdet


def tridiag_solve(d, off, b):
    """Solve ``T x = b`` given the LDL pivots ``d`` of the SPD tridiagonal
    ``T`` with off-diagonal ``off``: ``T = L diag(d) L^T`` with the unit
    lower-bidiagonal ``L[i+1, i] = off_i / d_i``, so a forward and a
    backward first-order recurrence, each an affine doubling scan."""
    from .bidiag import affine_scan

    l = off / d[..., :-1]
    zero = torch.zeros_like(b[..., :1])
    # forward: z_0 = b_0, z_i = b_i - l_{i-1} z_{i-1}
    z = affine_scan(torch.cat([zero, -l], dim=-1), b)
    # backward: x_{n-1} = y_{n-1}, x_i = y_i - l_i x_{i+1}
    return affine_scan(torch.cat([-l, zero], dim=-1), z / d, reverse=True)


def brownian_noise_mll(v, sigma2, resid):
    """``log N(resid; 0, K + sigma2 I) / n`` for the min-kernel ``K`` with
    integral values ``v (..., n)`` (strictly increasing, positive) through
    its tridiagonal precision ``W``: ``logdet(K + s I) = sum log D_i +
    logdet(I + s W)`` and ``(K + s I)^{-1} r = (I + s W)^{-1} W r``, with
    the increments ``D``; O(n) work in log-depth scans, no factorisation.
    The same function as :func:`brownian_noise_mll_kalman`."""
    n = v.shape[-1]
    delta = torch.diff(v, dim=-1, prepend=torch.zeros_like(v[..., :1]))
    inv_d = 1.0 / delta
    s2 = torch.as_tensor(sigma2, dtype=v.dtype, device=v.device)[..., None]
    w_diag = inv_d + torch.cat([inv_d[..., 1:],
                                torch.zeros_like(inv_d[..., :1])], dim=-1)
    w_off = -inv_d[..., 1:]
    a_off = s2 * w_off
    d, logdet_a = tridiag_ldl_pivots(1.0 + s2 * w_diag, a_off)
    logdet = torch.sum(torch.log(delta), dim=-1) + logdet_a
    r = resid
    zero = torch.zeros_like(r[..., :1])
    g = (w_diag * r + torch.cat([w_off * r[..., 1:], zero], dim=-1)
         + torch.cat([zero, w_off * r[..., :-1]], dim=-1))
    quad = torch.sum(r * tridiag_solve(d, a_off, g),
                     dim=-1)
    return -0.5 * (quad + logdet + n * _LOG_2PI) / n


# ---------------------------------------------------------------------------
# Kalman filter: plain version and kernel S1
# ---------------------------------------------------------------------------


def _kalman_plain(delta, s2, resid):
    """The plain version: ``(ll / n, mean, var)`` by a Python loop over
    time, vectorised over the lanes (``delta``/``resid`` ``(..., n)``,
    ``s2`` ``(...)``, all of one batch shape)."""
    n = resid.shape[-1]
    mean = torch.zeros_like(s2)
    var = torch.zeros_like(s2)
    ll = torch.zeros_like(s2)
    for d_t, y_t in zip(delta.unbind(-1), resid.unbind(-1)):
        var_pred = var + d_t
        innov_var = var_pred + s2
        e = y_t - mean
        ll = ll - 0.5 * (torch.log(innov_var) + e * e / innov_var + _LOG_2PI)
        gain = var_pred / innov_var
        mean = mean + gain * e
        var = var_pred * (1.0 - gain)
    return ll / n, mean, var


def _check_lanes(name, delta, s2, resid):
    native.check_tensors(name, delta, s2, resid)
    if delta.dim() != 2 or delta.shape != resid.shape or \
            s2.shape != delta.shape[:1] or delta.shape[0] < 1 or \
            delta.shape[1] < 1:
        raise ValueError(f"{name}: expected delta, resid (B, n) and s2 (B,) "
                         f"with B, n >= 1, got {tuple(delta.shape)}, "
                         f"{tuple(resid.shape)}, {tuple(s2.shape)}")


def kalman_forward_cuda(delta, s2, resid, save: bool):
    """Kernel S1 forward on ``(B, n)`` lanes: ``(ll / n, mean, var)``
    ``(B,)`` each, plus the per-step entering state ``(m_prev, p_prev)``
    ``(B, n)`` when ``save`` (else ``None``)."""
    _check_lanes("kalman_forward", delta, s2, resid)
    b, n = delta.shape
    ll, mean, var = (torch.empty_like(s2) for _ in range(3))
    m_prev = torch.empty_like(delta) if save else None
    p_prev = torch.empty_like(delta) if save else None
    native.launch("volt_kalman_forward", delta, s2, resid, ll, mean, var,
                  m_prev, p_prev, b, n, device=delta.device)
    return ll, mean, var, m_prev, p_prev


def kalman_backward_cuda(delta, s2, resid, m_prev, p_prev, g_ll, g_mean,
                         g_var):
    """Kernel S1 backward: the reverse-time adjoint.  Returns
    ``(g_delta (B, n), g_s2 (B,), g_resid (B, n))``."""
    _check_lanes("kalman_backward", delta, s2, resid)
    native.check_tensors("kalman_backward", m_prev, p_prev, g_ll, g_mean,
                         g_var, delta)
    if m_prev.shape != delta.shape or p_prev.shape != delta.shape or \
            not g_ll.shape == g_mean.shape == g_var.shape == s2.shape:
        raise ValueError("kalman_backward: saved state or cotangents do "
                         "not match the lanes")
    b, n = delta.shape
    g_delta = torch.empty_like(delta)
    g_resid = torch.empty_like(resid)
    g_s2 = torch.empty_like(s2)
    native.launch("volt_kalman_backward", delta, s2, resid, m_prev, p_prev,
                  g_ll, g_mean, g_var, g_delta, g_s2, g_resid, b, n,
                  device=delta.device)
    return g_delta, g_s2, g_resid


class _KalmanS1(torch.autograd.Function):
    """Kernel S1 with its adjoint kernel as the backward."""

    @staticmethod
    def forward(ctx, delta, s2, resid):
        save = any(ctx.needs_input_grad)
        ll, mean, var, m_prev, p_prev = kalman_forward_cuda(delta, s2, resid,
                                                            save)
        if save:
            ctx.save_for_backward(delta, s2, resid, m_prev, p_prev)
        return ll, mean, var

    @staticmethod
    def backward(ctx, g_ll, g_mean, g_var):
        delta, s2, resid, m_prev, p_prev = ctx.saved_tensors
        g_ll, g_mean, g_var = (torch.zeros_like(s2) if g is None
                               else g.contiguous()
                               for g in (g_ll, g_mean, g_var))
        return kalman_backward_cuda(delta, s2, resid, m_prev, p_prev, g_ll,
                                    g_mean, g_var)


def _kalman(v, sigma2, resid):
    """``(ll / n, mean, var)`` with the batch shape of the broadcast inputs;
    ``v`` are the integral values (increments ``diff(v, prepend=0)``)."""
    sigma2 = torch.as_tensor(sigma2, dtype=resid.dtype, device=resid.device)
    n = resid.shape[-1]
    delta = torch.diff(v, dim=-1, prepend=torch.zeros_like(v[..., :1]))
    batch = torch.broadcast_shapes(resid.shape[:-1], sigma2.shape,
                                   delta.shape[:-1])
    delta_b = delta.expand(*batch, n)
    resid_b = resid.expand(*batch, n)
    s2_b = sigma2.expand(batch)
    if not native.on_card(resid):
        return _kalman_plain(delta_b, s2_b, resid_b)
    outs = _KalmanS1.apply(delta_b.reshape(-1, n).contiguous(),
                           s2_b.reshape(-1).contiguous(),
                           resid_b.reshape(-1, n).contiguous())
    return tuple(o.reshape(batch) for o in outs)


def brownian_noise_mll_kalman(v, sigma2, resid):
    """``log N(resid; 0, K + sigma2 I) / n`` for the min-kernel ``K`` with
    integral values ``v``: the innovation decomposition of the random walk
    ``f_t = f_{t-1} + w_t``, ``w_t ~ N(0, v_t - v_{t-1})``, observed
    through ``y_t = f_t + eps``, ``eps ~ N(0, sigma2)``.

    Batched over the broadcast leading dims of ``v``, ``sigma2`` and
    ``resid``; gradients reach all three.
    """
    return _kalman(v, sigma2, resid)[0]


def brownian_noise_filter(v, sigma2, resid):
    """Filtered ``(mean, var)`` of the latent at the last point given all
    observations (same model as :func:`brownian_noise_mll_kalman`)."""
    _, mean, var = _kalman(v, sigma2, resid)
    return mean, var


def tolerance_used(got, want, rtol, atol):
    """``max |got - want| / (rtol |want| + atol)`` in float64, 0 where the
    two are equal: the share of the tolerance used (1.0 is its edge)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return torch.where(err == 0, 0.0, err / (rtol * want.abs() + atol)) \
        .max().item()


KALMAN_CHECKED = ("ll/n", "mean", "var", "d/dv", "d/dsigma2", "d/dresid")


def kalman_agreement(got, plain, f64):
    """Kernel S1 held to its plain version, the rule of the card checks.

    Each argument is the six tensors ``(ll / n, mean, var, d/dv,
    d/dsigma2, d/dresid)`` of one run: S1's, the float32 plain loop's and
    a float64 run of the plain loop.  S1 computes in float64 inside, so
    every tensor is held to the float64 loop: the three outputs at rtol
    1e-5, the gradients at rtol 1e-4 and atol 1e-6 of their largest
    magnitude (at least 1e-6), since d/dv differences neighbouring
    d/d(delta).  The float32 loop is no reference: its own rounding lies
    up to about that tolerance from float64 on long rows (d/dv at (505,
    999)), and on either side of S1's (d/dv at (32, 251)).  Returns one
    row per tensor, ``(name, used, plain_f64, max_abs_err)``: S1's share
    of its tolerance from the float64 loop (it passes at most 1.0), the
    float32 loop's in the same units, and S1's max abs error against the
    float32 loop."""
    rows = []
    for i, (name, a, p, w) in enumerate(zip(KALMAN_CHECKED, got, plain,
                                            f64)):
        rtol, atol = (1e-5, 0.0) if i < 3 else \
            (1e-4, 1e-6 * max(1.0, w.abs().max().item()))
        rows.append((name, tolerance_used(a, w, rtol, atol),
                     tolerance_used(p, w, rtol, atol),
                     (a - p).abs().max().item()))
    return rows

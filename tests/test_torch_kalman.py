"""The plain version of kernel S1 (the Kalman MLL and filter, which CPU
tensors take) against ``volt_tpu.ops.tridiag`` with ``jax.grad``:
value, final state and gradients w.r.t. ``(v, sigma2, resid)`` at
``(4, 64)``, float32, rtol 1e-5 (gradients with an atol of 1e-6 of their
largest entry).

The algebra of kernel S1's chunked scans (``csrc/kalman.cu``) is checked
here too, by an emulation in PyTorch with the kernel's chunk, tile, scan
and carry logic (chunk, tile and warp sizes as parameters): against the
JAX functions and ``jax.grad`` in float32 at the same tolerances, and
against a float64 run of the plain loop at rtol 1e-10."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, t32

from volt_tpu.ops.tridiag import (brownian_noise_filter as j_filter,
                                  brownian_noise_mll as j_scan_mll,
                                  brownian_noise_mll_kalman as j_mll,
                                  tridiag_solve as j_tridiag_solve)

from volt_tpu_torch.ops import tridiag as ttd

RTOL = 1e-5


def _inputs(shared_v: bool, b: int = 4, n: int = 64):
    """A realistic vol integral (vol ~0.2 on a daily grid), noise and
    residuals; ``shared_v`` gives one ``v (n,)`` broadcast over lanes."""
    rs = np.random.default_rng(3)
    dt = 1.0 / 252
    vol = 0.2 + 0.05 * rs.random((1 if shared_v else b, n))
    v = np.cumsum(dt * vol * vol, axis=-1)
    v = (v[0] if shared_v else v).astype(np.float32)
    sigma2 = (10.0 ** rs.uniform(-4, -0.2, b)).astype(np.float32)
    resid = (0.05 * rs.standard_normal((b, n))).astype(np.float32)
    return v, sigma2, resid


@pytest.mark.parametrize("shared_v", [False, True])
def test_mll_value_and_gradients(shared_v):
    v, s2, r = _inputs(shared_v)
    tv, ts, tr = (t32(a).requires_grad_() for a in (v, s2, r))
    got = ttd.brownian_noise_mll_kalman(tv, ts, tr)
    want = j_mll(j32(v), j32(s2), j32(r))
    close(got, want, RTOL)
    # a non-uniform cotangent, so every lane's gradient is checked apart
    weights = np.arange(1, 5, dtype=np.float32)
    (got * t32(weights)).sum().backward()
    grads = jax.grad(
        lambda a, b, c: jnp.sum(j_mll(a, b, c) * weights),
        argnums=(0, 1, 2))(j32(v), j32(s2), j32(r))
    for t, g in zip((tv, ts, tr), grads):
        assert t.grad.shape == t.shape
        # d/dv is a difference of neighbouring d/d(delta) (the transpose of
        # the increments), so its float32 error is relative to max|grad|
        close(t.grad, g, RTOL, 1e-6 * float(np.max(np.abs(g))))


@pytest.mark.parametrize("shared_v", [False, True])
def test_scan_mll_value_and_gradients(shared_v):
    """The associative-scan MLL (two affine doubling scans) against JAX's,
    value and gradients, and against the Kalman form of the same
    function."""
    v, s2, r = _inputs(shared_v)
    tv, ts, tr = (t32(a).requires_grad_() for a in (v, s2, r))
    got = ttd.brownian_noise_mll(tv, ts, tr)
    # the value sums terms of the size of |log increment| ~ 9 that cancel
    # to O(0.1): float32 resolves them to about 1e-6
    close(got, jax.jit(j_scan_mll)(j32(v), j32(s2), j32(r)), RTOL, 1e-5)
    close(got, ttd.brownian_noise_mll_kalman(t32(v), t32(s2), t32(r)), RTOL,
          1e-5)
    weights = np.arange(1, 5, dtype=np.float32)
    (got * t32(weights)).sum().backward()
    grads = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(j_scan_mll(a, b, c) * weights),
        argnums=(0, 1, 2)))(j32(v), j32(s2), j32(r))
    wide = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in (v, s2, r)]
    (ttd.brownian_noise_mll(*wide)
     * torch.tensor(weights, dtype=torch.float64)).sum().backward()
    # the scan form's gradients pass through 1/increments: in float32 both
    # packages' d/dv lie up to 3e-5 of its largest magnitude from a float64
    # run (measured on these inputs), so 1e-4 of it is the tolerance
    for t, g, w in zip((tv, ts, tr), grads, wide):
        assert t.grad.shape == t.shape
        scale = float(np.max(np.abs(g)))
        close(t.grad, g, 1e-4, 1e-4 * scale)
        close(t.grad.double(), w.grad, 1e-4, 1e-4 * scale)


def test_tridiag_solve():
    """``T x = b`` from the LDL pivots, against JAX's and a dense solve."""
    rs = np.random.default_rng(4)
    n = 37
    off = (0.3 * rs.standard_normal((3, n - 1))).astype(np.float32)
    diag = (1.5 + rs.random((3, n))).astype(np.float32)
    b = rs.standard_normal((3, n)).astype(np.float32)
    d, _ = ttd.tridiag_ldl_pivots(t32(diag), t32(off))
    got = ttd.tridiag_solve(d, t32(off), t32(b))
    close(got, jax.jit(j_tridiag_solve)(j32(d.numpy()), j32(off), j32(b)),
          RTOL, 1e-6)
    dense = (np.apply_along_axis(np.diag, -1, diag)
             + np.apply_along_axis(np.diag, -1, off, 1)
             + np.apply_along_axis(np.diag, -1, off, -1))
    close(got, np.linalg.solve(dense.astype(np.float64), b[..., None])[..., 0],
          1e-4, 1e-5)


@pytest.mark.parametrize("shared_v", [False, True])
def test_filter_final_state(shared_v):
    v, s2, r = _inputs(shared_v)
    for got, want in zip(ttd.brownian_noise_filter(t32(v), t32(s2), t32(r)),
                         j_filter(j32(v), j32(s2), j32(r))):
        close(got, want, RTOL, 1e-7)


def test_mll_and_filter_share_one_recursion():
    """The MLL's final state is the filter's: one pass serves both."""
    v, s2, r = _inputs(False)
    ll, mean, var = ttd._kalman(t32(v), t32(s2), t32(r))
    close(ll, ttd.brownian_noise_mll_kalman(t32(v), t32(s2), t32(r)), 0.0)
    fm, fv = ttd.brownian_noise_filter(t32(v), t32(s2), t32(r))
    close(mean, fm, 0.0)
    close(var, fv, 0.0)


def test_final_state_gradients():
    """Gradients through the filter's outputs (the backward kernel takes
    cotangents for ll, mean and var)."""
    v, s2, r = _inputs(False)
    tv, ts, tr = (t32(a).requires_grad_() for a in (v, s2, r))
    mean, var = ttd.brownian_noise_filter(tv, ts, tr)
    (mean.sum() + 2.0 * var.sum()).backward()

    def loss(a, b, c):
        m, p = j_filter(a, b, c)
        return jnp.sum(m) + 2.0 * jnp.sum(p)

    grads = jax.grad(loss, argnums=(0, 1, 2))(j32(v), j32(s2), j32(r))
    for t, g in zip((tv, ts, tr), grads):
        close(t.grad, g, 1e-4, 1e-6)


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ttd.kalman_forward_cuda(z, torch.ones(2), z, save=False)
    with pytest.raises(ValueError, match="CUDA"):
        ttd.kalman_backward_cuda(z, torch.ones(2), z, z, z, torch.ones(2),
                                 torch.ones(2), torch.ones(2))


def _plain_runs():
    """The six tensors ``kalman_agreement`` takes (outputs, then gradients
    of ``sum(ll / n)``) from the plain loop in float32 and in float64."""
    runs = []
    for dtype in (torch.float32, torch.float64):
        ins = [torch.from_numpy(a).to(dtype).requires_grad_()
               for a in _inputs(False)]
        out = ttd._kalman(*ins)
        out[0].sum().backward()
        runs.append([o.detach() for o in out] + [t.grad for t in ins])
    return runs


# (tensor moved, relative move, passes): outputs are held at rtol 1e-5 to
# the float64 loop, gradients at rtol 1e-4 to the float32 loop
AGREEMENT_CASES = {"float32 loop": (None, 0.0, True),
                   "float64 loop": ("f64", 0.0, True),
                   "ll/n in": (0, 5e-6, True), "ll/n out": (0, 3e-5, False),
                   "var out": (2, 3e-5, False),
                   "d/dsigma2 in": (4, 5e-5, True),
                   "d/dsigma2 out": (4, 3e-4, False),
                   "d/dresid out": (5, 3e-4, False),
                   # the float32 loop's own gradient moved outside its
                   # tolerance from float64: the float64 loop is the
                   # reference, which the float64 run passes and the
                   # moved float32 loop fails
                   "d/dsigma2 reference out, float64 in": (
                       ("plain", 4), 3e-4, True),
                   "d/dsigma2 reference out, reference in": (
                       ("both", 4), 3e-4, False)}


@pytest.mark.parametrize("case", list(AGREEMENT_CASES))
def test_kalman_agreement_rule(case):
    """The card checks' rule passes the plain loop itself and its float64
    run, and fails an output or a gradient moved past its tolerance; where
    the float32 loop's gradient is itself out of its tolerance from
    float64, the gradient is held to the float64 loop."""
    which, rel, passes = AGREEMENT_CASES[case]
    plain, f64 = _plain_runs()
    got = [t.float() for t in f64] if which in ("f64", ("plain", 4)) else \
        [t.clone() for t in plain]
    if isinstance(which, int):
        got[which] = got[which] * (1.0 + rel)
    elif isinstance(which, tuple):
        plain = [t.clone() for t in plain]
        plain[which[1]] = plain[which[1]] * (1.0 + rel)
        if which[0] == "both":
            got[which[1]] = plain[which[1]].clone()
    rows = ttd.kalman_agreement(got, plain, f64)
    assert [r[0] for r in rows] == list(ttd.KALMAN_CHECKED)
    assert all(r[1] <= 1.0 for r in rows) == passes, rows


# ---------------------------------------------------------------------------
# Emulation of kernel S1's chunked scans
# ---------------------------------------------------------------------------
#
# Maps are tuples of (lanes, threads) tensors.  ``after(x, y)`` is the map x
# applied after y.  Each loop over a chunk's steps masks the threads whose
# chunk is shorter (``live``), as the kernel's ``k < steps`` does.

KERNEL_SIZES = (8, 128, 32)  # chunk, threads, warp: csrc/kalman.cu
WIDE = torch.float64  # the kernel's double-precision parts


def _pow2_scale(mx):
    """The power of two that brings ``mx > 0`` into [1, 2), from its
    exponent bits (exact, as ``Moebius::scaled``)."""
    if mx.dtype == torch.float32:
        e = mx.view(torch.int32) & 0x7f800000
        return (0x7f000000 - e).view(torch.float32)
    e = mx.view(torch.int64) & 0x7ff0000000000000
    return (0x7fe0000000000000 - e).view(torch.float64)


def _moebius_after(x, y):
    a, b, c, d = x
    p, q, r, s = y
    prod = (a * p + b * r, a * q + b * s, c * p + d * r, c * q + d * s)
    k = _pow2_scale(torch.maximum(torch.maximum(prod[0], prod[1]),
                                  torch.maximum(prod[2], prod[3])))
    return tuple(t * k for t in prod)


def _affine_after(x, y):
    return x[0] * y[0], x[0] * y[1] + x[1]


def _adjoint_after(x, y):
    q, l, r, c0, c1 = x
    return (q * y[0], l * y[0] + r * y[1], r * y[2], q * y[3] + c0,
            l * y[3] + r * y[4] + c1)


def _identity(like, n_entries):
    """(1, 0, 0, 1), (1, 0) or (1, 0, 1, 0, 0): the identity map."""
    one, zero = torch.ones_like(like), torch.zeros_like(like)
    return {4: (one, zero, zero, one), 2: (one, zero),
            5: (one, zero, one, zero, zero)}[n_entries]


def _where(mask, x, y):
    return tuple(torch.where(mask, a, b) for a, b in zip(x, y))


def _exclusive_scan(x, after, warp, reverse):
    """The kernel's block scan: Hillis-Steele in each warp, then the warp
    totals composed in order; from the last thread when ``reverse``."""
    if reverse:
        x = tuple(t.flip(-1) for t in x)
    lanes, threads = x[0].shape
    warps = threads // warp
    x = tuple(t.reshape(lanes, warps, warp) for t in x)
    pos = torch.arange(warp)
    off = 1
    while off < warp:
        y = tuple(torch.roll(t, off, dims=-1) for t in x)
        x = _where(pos >= off, after(x, y), x)
        off *= 2
    ex = _where(pos == 0, _identity(x[0], len(x)),
                tuple(torch.roll(t, 1, dims=-1) for t in x))
    before = [_identity(x[0][:, 0, 0], len(x))]
    for w in range(1, warps):
        before.append(after(tuple(t[:, w - 1, -1] for t in x), before[-1]))
    before = tuple(torch.stack(parts, dim=1)[..., None]
                   for parts in zip(*before))
    out = after(ex, tuple(t.expand_as(x[0]) for t in before))
    out = tuple(t.reshape(lanes, threads) for t in out)
    return tuple(t.flip(-1) for t in out) if reverse else out


def _block_sum(v, warp):
    """Butterfly sum in each warp, then the warp sums in order."""
    lanes, threads = v.shape
    v = v.reshape(lanes, threads // warp, warp)
    off = warp // 2
    while off:
        v = v + v[..., torch.arange(warp) ^ off]
        off //= 2
    total = torch.zeros_like(v[:, 0, 0])
    for w in range(v.shape[1]):
        total = total + v[:, w, 0]
    return total


def _tiles(n, chunk, threads):
    """(base, len, live) per tile: ``live[k]`` marks the threads whose
    chunk has a step k."""
    tile = chunk * threads
    for base in range(0, n, tile):
        length = min(tile, n - base)
        steps = (length - torch.arange(threads) * chunk).clamp(0, chunk)
        yield base, length, [steps > k for k in range(chunk)]


def _chunks(x, base, length, chunk, threads):
    """Tile [base, base + length) of ``x (lanes, n)`` as
    ``(lanes, threads, chunk)``, zero past the end."""
    out = x.new_zeros(x.shape[0], chunk * threads)
    out[:, :length] = x[:, base:base + length]
    return out.reshape(x.shape[0], threads, chunk)


def chunked_forward(delta, s2, resid, chunk, threads, warp):
    """``(ll / n, mean, var, m_prev, p_prev)`` as the forward kernel
    computes them: in float64 from the inputs, with the log of the
    innovation variance rounded to the inputs' precision first."""
    lanes, n = delta.shape
    s = s2.to(WIDE)[:, None]
    log_2pi = math.log(2.0 * math.pi)
    mean = var = torch.zeros_like(s2, dtype=WIDE)
    ll = delta.new_zeros(lanes, threads, dtype=WIDE)
    m_prev, p_prev = torch.empty_like(delta), torch.empty_like(delta)
    for base, length, live in _tiles(n, chunk, threads):
        d, y = (_chunks(t, base, length, chunk, threads).to(WIDE)
                for t in (delta, resid))
        # (1) the variance maps, scanned: the entering P
        pm = _identity(ll, 4)
        for k in range(chunk):
            dk = d[..., k]
            step = (s.expand_as(dk), s * dk, torch.ones_like(dk), dk + s)
            pm = _where(live[k], _moebius_after(step, pm), pm)
        a, b, c, e = _exclusive_scan(pm, _moebius_after, warp, False)
        p = (a * var[:, None] + b) / (c * var[:, None] + e)
        # (2) P over the chunk, and the mean maps, scanned: the entering m
        p_in, gain = [], []
        mm = _identity(ll, 2)
        for k in range(chunk):
            p_in.append(p)
            var_pred = p + d[..., k]
            g = var_pred / (var_pred + s)
            gain.append(g)
            mm = _where(live[k], (mm[0] * (1.0 - g),
                                  mm[1] + g * (y[..., k] - mm[1])), mm)
            p = torch.where(live[k], var_pred * (1.0 - g), p)
        ma, mb = _exclusive_scan(mm, _affine_after, warp, False)
        m = ma * mean[:, None] + mb
        # (3) the ll terms and the saved state
        saved_m = torch.zeros_like(d)
        for k in range(chunk):
            innov = p_in[k] + d[..., k] + s
            e = y[..., k] - m
            log_innov = torch.log(innov.to(delta.dtype)).to(WIDE)
            ll = torch.where(live[k], ll - 0.5 * (log_innov + e * e / innov
                                                  + log_2pi), ll)
            saved_m[..., k] = m
            m = torch.where(live[k], m + gain[k] * e, m)
        saved_p = torch.stack(p_in, dim=-1)
        m_prev[:, base:base + length] = saved_m.reshape(lanes, -1)[:, :length]
        p_prev[:, base:base + length] = saved_p.reshape(lanes, -1)[:, :length]
        last = (length - 1) // chunk
        mean, var = m[:, last], p[:, last]
    return tuple(t.to(delta.dtype) for t in (_block_sum(ll, warp) / n, mean,
                                             var)) + (m_prev, p_prev)


def chunked_backward(delta, s2, resid, m_prev, p_prev, g_ll, g_mean, g_var,
                     chunk, threads, warp):
    """``(g_delta, g_s2, g_resid)`` as the adjoint kernel computes them,
    in float64 from the inputs."""
    lanes, n = delta.shape
    s = s2.to(WIDE)[:, None]
    a_ll = (g_ll.to(WIDE) / n)[:, None]
    a_m, a_p = g_mean.to(WIDE), g_var.to(WIDE)
    a_s = delta.new_zeros(lanes, threads, dtype=WIDE)
    g_delta, g_resid = torch.empty_like(delta), torch.empty_like(delta)
    for base, length, live in reversed(list(_tiles(n, chunk, threads))):
        d, y, m, p = (_chunks(t, base, length, chunk, threads).to(WIDE)
                      for t in (delta, resid, m_prev, p_prev))
        vp = p + d
        inv = 1.0 / (vp + s[..., None])
        e = y - m
        gain = vp * inv
        q = 1.0 - gain
        # the step maps (a_m, a_p) -> (q a_m + c0, l a_m + q^2 a_p + c1)
        steps = (q, s[..., None] * e * inv * inv, q * q, a_ll[..., None] * e * inv,
                 -0.5 * a_ll[..., None] * (inv - e * e * inv * inv))
        am = _identity(a_s, 5)
        for k in reversed(range(chunk)):
            am = _where(live[k], _adjoint_after(tuple(t[..., k] for t in steps),
                                                am), am)
        q_, l_, r_, c0_, c1_ = _exclusive_scan(am, _adjoint_after, warp, True)
        am_k = q_ * a_m[:, None] + c0_
        ap_k = l_ * a_m[:, None] + r_ * a_p[:, None] + c1_
        gd, gr = torch.zeros_like(d), torch.zeros_like(d)
        for k in reversed(range(chunk)):
            sq, sl, sr, s0, s1 = (t[..., k] for t in steps)
            vk, ik, ek = vp[..., k], inv[..., k], e[..., k]
            a_gain = am_k * ek - ap_k * vk
            a_innov = (-0.5 * a_ll * (ik - ek * ek * ik * ik)
                       - a_gain * vk * ik * ik)
            gr[..., k] = am_k * gain[..., k] - s0
            a_s = torch.where(live[k], a_s + a_innov, a_s)
            am_k, ap_k = (torch.where(live[k], sq * am_k + s0, am_k),
                          torch.where(live[k], sl * am_k + sr * ap_k + s1, ap_k))
            gd[..., k] = ap_k
        g_delta[:, base:base + length] = gd.reshape(lanes, -1)[:, :length]
        g_resid[:, base:base + length] = gr.reshape(lanes, -1)[:, :length]
        a_m, a_p = am_k[:, 0], ap_k[:, 0]
    return (g_delta, _block_sum(a_s, warp).to(delta.dtype), g_resid)


def _sigma2_sweep():
    v, _, r = _inputs(False, b=9)
    return v, np.logspace(-8, 0, 9).astype(np.float32), r


# name: (inputs (v, sigma2, resid), (chunk, threads, warp))
SCAN_CASES = {
    "lanes": (lambda: _inputs(False), KERNEL_SIZES),
    "shared_v": (lambda: _inputs(True), KERNEL_SIZES),
    "n1": (lambda: _inputs(False, b=3, n=1), KERNEL_SIZES),
    "n33_ragged_chunk": (lambda: _inputs(False, b=3, n=33), KERNEL_SIZES),
    "three_tiles": (lambda: _inputs(False, b=3, n=37), (2, 8, 4)),
    "sigma2_1e-8_to_1": (_sigma2_sweep, KERNEL_SIZES),
    "three_kernel_tiles": (lambda: _inputs(False, b=2, n=2100), KERNEL_SIZES),
}


def _scan_case(name, dtype):
    make, sizes = SCAN_CASES[name]
    v, s2, r = make()
    n = r.shape[-1]
    tv, ts, tr = (torch.tensor(np.asarray(a, np.float64), dtype=dtype)
                  for a in (v, s2, r))
    delta = torch.diff(tv, dim=-1, prepend=torch.zeros_like(tv[..., :1]))
    delta = delta.expand(r.shape[0], n).contiguous()
    # cotangents of (ll / n, mean, var), different in every lane
    rs = np.random.default_rng(11)
    cots = [torch.tensor(rs.uniform(0.5, 2.0, r.shape[0]), dtype=dtype)
            for _ in range(3)]
    return (v, s2, r), (tv, ts, tr, delta), cots, sizes


def _grad_v(g_delta, v):
    """d/dv from d/d(delta): the transpose of ``diff(v, prepend=0)``,
    summed over the lanes where ``v`` is shared."""
    g = g_delta - torch.cat([g_delta[:, 1:], torch.zeros_like(g_delta[:, :1])],
                            dim=-1)
    return g.sum(0) if v.ndim == 1 else g


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_chunked_scan_forward_matches_jax(case):
    (v, s2, r), (_, ts, tr, delta), _, sizes = _scan_case(case, torch.float32)
    ll, mean, var, _, _ = chunked_forward(delta, ts, tr, *sizes)
    close(ll, j_mll(j32(v), j32(s2), j32(r)), RTOL)
    for got, want in zip((mean, var), j_filter(j32(v), j32(s2), j32(r))):
        close(got, want, RTOL, 1e-7)


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_chunked_scan_adjoint_matches_jax_grad(case):
    (v, s2, r), (_, ts, tr, delta), cots, sizes = _scan_case(case,
                                                              torch.float32)
    _, _, _, m_prev, p_prev = chunked_forward(delta, ts, tr, *sizes)
    g_delta, g_s2, g_resid = chunked_backward(delta, ts, tr, m_prev, p_prev,
                                              *cots, *sizes)
    w = [c.numpy().astype(np.float32) for c in cots]

    def loss(a, b, c):
        mean, var = j_filter(a, b, c)
        return jnp.sum(w[0] * j_mll(a, b, c)) + jnp.sum(w[1] * mean) + \
            jnp.sum(w[2] * var)

    want = jax.grad(loss, argnums=(0, 1, 2))(j32(v), j32(s2), j32(r))
    for got, g in zip((_grad_v(g_delta, v), g_s2, g_resid), want):
        close(got, g, 1e-4, 1e-6 * float(np.max(np.abs(g))))


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_chunked_scan_float64_matches_plain_loop(case):
    (v, _, _), (tv, ts, tr, delta), cots, sizes = _scan_case(case,
                                                              torch.float64)
    ll, mean, var, m_prev, p_prev = chunked_forward(delta, ts, tr, *sizes)
    g_delta, g_s2, g_resid = chunked_backward(delta, ts, tr, m_prev, p_prev,
                                              *cots, *sizes)
    ins = [t.clone().requires_grad_() for t in (tv, ts, tr)]
    d = torch.diff(ins[0], dim=-1, prepend=torch.zeros_like(ins[0][..., :1]))
    want = ttd._kalman_plain(d.expand_as(delta), ins[1], ins[2])
    sum(c * o for c, o in zip(cots, want)).sum().backward()
    for got, w in zip((ll, mean, var), want):
        close(got, w.detach(), 1e-10, 1e-14)
    for got, w in zip((_grad_v(g_delta, v), g_s2, g_resid), ins):
        close(got, w.grad, 1e-10, 1e-10 * float(w.grad.abs().max()))

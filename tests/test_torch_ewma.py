"""The port's EWMA filter (the plain version of kernel K1, which CPU
tensors take) against the JAX package's Pallas kernel ``ewma_pallas`` in
interpret mode and its XLA filter ``volt_tpu.ops.ewma.ewma``; and the
rolling forms.  float32, rtol/atol 1e-6.

The algebra of kernel K1 (``csrc/ewma_filter.cu``: the filter as a
first-order recurrence on the output, run as a chunked scan in float64) is
checked here too, by an emulation in PyTorch with the kernel's chunk,
segment, scan, tile and carry logic (chunk, warp and block sizes as
parameters; a tile is a row's segment of at most a block's threads times
the chunk): against ``ewma_pallas``
in interpret mode and the XLA filter at the same tolerance, and against a
float64 run of the plain ``conv1d`` at rtol 1e-12."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, t32

from volt_tpu.ops.pallas import ewma_pallas

# the modules (``ops.ewma`` is also the name of the function re-exported
# by each package's ``ops``)
jew = importlib.import_module("volt_tpu.ops.ewma")
tew = importlib.import_module("volt_tpu_torch.ops.ewma")

TOL = 1e-6


@pytest.fixture()
def rs():
    return np.random.default_rng(11)


@pytest.mark.parametrize("shape,k", [((3, 50), 1), ((3, 50), 5),
                                     ((3, 50), 20), ((3, 50), 64),
                                     ((3, 50), 200), ((2, 3, 37), 7)])
def test_ewma_matches_pallas_and_xla(rs, shape, k):
    y = (4.0 + 0.3 * rs.standard_normal(shape)).astype(np.float32)
    got = tew.ewma(t32(y), k)
    assert got.shape == (*shape[:-1], shape[-1] + 1)
    close(got, ewma_pallas(j32(y), k, interpret=True), TOL, TOL)
    close(got, jew.ewma(j32(y), k), TOL, TOL)


def test_ewma_weights(rs):
    for k in (1, 3, 300):
        close(tew.ewma_weights(k), jew.ewma_weights(k), TOL)


def test_ewma_gradient(rs):
    y = rs.standard_normal((2, 40)).astype(np.float32)
    yt = t32(y).requires_grad_()
    torch.sin(tew.ewma(yt, 9)).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(jnp.sin(jew.ewma(v, 9))))(j32(y))
    close(yt.grad, gj, TOL, TOL)


@pytest.mark.parametrize("k", [4, 25])
def test_window_form(rs, k):
    y = (4.0 + 0.3 * rs.standard_normal((3, 30))).astype(np.float32)
    buf = tew.window_init(t32(y), k)
    close(buf, jew.window_init(j32(y), k), 0.0)
    w = tew.ewma_weights(k)
    close(tew.window_value(buf, w), tew.ewma(t32(y), k)[..., -1], TOL, TOL)
    new = t32(rs.standard_normal(3))
    close(tew.window_append(buf, new),
          jew.window_append(jew.window_init(j32(y), k), j32(new.numpy())), 0.0)


@pytest.mark.parametrize("k", [4, 25])
def test_rolling_form(rs, k):
    """The O(1) register: appending to the window sum, with the oldest
    element expiring, equals re-filtering the extended series."""
    y = (4.0 + 0.3 * rs.standard_normal(30)).astype(np.float32)
    new = np.float32(4.2)
    buf = tew.window_init(t32(y), k)
    s = tew.window_value(buf, tew.ewma_weights(k))
    got = tew.rolling_append(s, torch.tensor(new), buf[0],
                             tew.rolling_coeffs(k))
    want = jew.rolling_append(jnp.asarray(s.numpy()), jnp.float32(new),
                              jnp.asarray(buf[0].numpy()),
                              jew.rolling_coeffs(k))
    close(got, want, TOL, TOL)
    close(got, tew.ewma(t32(np.append(y, new)), k)[..., -1], 1e-5, 1e-5)


def test_ewma_rejects_bad_k():
    with pytest.raises(ValueError):
        tew.ewma(torch.zeros(5), 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """K1's wrapper takes CUDA tensors only (the CPU path is the plain
    version, chosen by ``ewma`` itself)."""
    with pytest.raises(ValueError, match="CUDA"):
        tew.ewma_filter_cuda(torch.zeros(2, 5), 3)


# ---------------------------------------------------------------------------
# Kernel K1's chunked scan, emulated
# ---------------------------------------------------------------------------
#
# A row gets a segment of L threads (the least power of two with L * chunk
# >= T, at most a block), each thread a chunk of steps; rows longer than a
# block's chunks walk in tiles with a carry.  The scan runs within each
# warp's part of a segment, then composes the totals of the segment's
# earlier warps.  Rows are independent (the kernel's shuffles have the
# segment's width), so the emulation runs all rows at once as (rows, L,
# chunk) tensors; ``steps[l, j]`` marks the threads whose chunk has a step
# j, as the kernel's ``kk < steps``.

KERNEL_SIZES = (8, 32, 128)  # chunk, warp, threads: csrc/ewma_filter.cu
WIDE = torch.float64


def _warp_scan(a, b, width):
    """Inclusive Hillis-Steele scan of the maps ``out -> a out + b`` within
    groups of ``width`` threads, shifted by one: the map of the chunks
    before each thread in its group."""
    rows, lanes = a.shape
    pos = torch.arange(lanes) % width
    a, b = a.reshape(rows, -1, width), b.reshape(rows, -1, width)
    pos = pos.reshape(-1, width)
    off = 1
    while off < width:
        a_up, b_up = torch.roll(a, off, -1), torch.roll(b, off, -1)
        b = torch.where(pos >= off, a * b_up + b, b)
        a = torch.where(pos >= off, a * a_up, a)
        off *= 2
    a_in = torch.where(pos == 0, 1.0, torch.roll(a, 1, -1))
    b_in = torch.where(pos == 0, 0.0, torch.roll(b, 1, -1))
    return (a_in.reshape(rows, lanes), b_in.reshape(rows, lanes),
            a[..., -1], b[..., -1])


def chunked_ewma(y, k, chunk, warp, threads):
    """``(rows, T) -> (rows, T + 1)`` as kernel K1 computes it: float64
    inside, the output rounded to the inputs' type."""
    rows, t = y.shape
    beta, c, beta_k = tew._recurrence(k)
    lanes = 1
    while lanes < threads and lanes * chunk < t:
        lanes *= 2
    width = min(lanes, warp)
    seg = lanes * chunk
    yw = y.to(WIDE)
    out = torch.empty(rows, t + 1, dtype=y.dtype)
    out[:, 0] = y[:, 0]
    carry = yw[:, 0]
    for base in range(0, t, seg):
        length = min(seg, t - base)
        i = torch.arange(base, base + seg)
        steps = (i < t).reshape(lanes, chunk)
        lag = torch.clamp(i - k, min=0).clamp(max=t - 1)
        v = c * (yw[:, i.clamp(max=t - 1)] - beta_k * yw[:, lag])
        v = v.reshape(rows, lanes, chunk)
        # (1) each chunk's map out -> a out + b
        a = torch.ones(rows, lanes, dtype=WIDE)
        b = torch.zeros(rows, lanes, dtype=WIDE)
        for j in range(chunk):
            a = torch.where(steps[:, j], a * beta, a)
            b = torch.where(steps[:, j], beta * b + v[..., j], b)
        # (2) the scan within each warp, then the earlier warps' totals
        a_in, b_in, tot_a, tot_b = _warp_scan(a, b, width)
        pa, pb = [torch.ones_like(carry)], [torch.zeros_like(carry)]
        for w in range(1, lanes // width):
            pb.append(tot_a[:, w - 1] * pb[-1] + tot_b[:, w - 1])
            pa.append(tot_a[:, w - 1] * pa[-1])
        pa = torch.stack(pa, -1).repeat_interleave(width, -1)
        pb = torch.stack(pb, -1).repeat_interleave(width, -1)
        # (3) each chunk rerun from its entering value
        o = a_in * (pa * carry[:, None] + pb) + b_in
        tile = []
        for j in range(chunk):
            o = torch.where(steps[:, j], beta * o + v[..., j], o)
            tile.append(o)
        tile = torch.stack(tile, -1).reshape(rows, seg)[:, :length]
        out[:, 1 + base:1 + base + length] = tile.to(y.dtype)
        carry = tile[:, -1]
    return out


def _series(shape, seed=5):
    rs = np.random.default_rng(seed)
    return 4.6 + 0.01 * np.cumsum(rs.standard_normal(shape), axis=-1)


# name: ((rows, T), k, (chunk, warp, threads))
SCAN_CASES = {
    "k1": ((3, 999), 1, KERNEL_SIZES),
    "k2": ((3, 999), 2, KERNEL_SIZES),
    "k25": ((3, 999), 25, KERNEL_SIZES),
    "k100": ((3, 999), 100, KERNEL_SIZES),
    "k300": ((3, 999), 300, KERNEL_SIZES),
    "k_above_T": ((3, 50), 200, KERNEL_SIZES),
    "T1": ((4, 1), 5, KERNEL_SIZES),
    "ragged_chunk": ((2, 45), 7, KERNEL_SIZES),
    "rows_share_a_block": ((70, 3), 2, KERNEL_SIZES),
    "two_warps_a_row": ((3, 400), 25, KERNEL_SIZES),
    "five_tiles": ((2, 37), 7, (2, 2, 4)),
    "three_kernel_tiles": ((2, 2100), 300, KERNEL_SIZES),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_chunked_ewma_matches_pallas_and_xla(case):
    shape, k, sizes = SCAN_CASES[case]
    y = _series(shape).astype(np.float32)
    got = chunked_ewma(t32(y), k, *sizes)
    close(got, ewma_pallas(j32(y), k, interpret=True), TOL, TOL)
    close(got, jew.ewma(j32(y), k), TOL, TOL)


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_chunked_ewma_float64_matches_plain(case):
    shape, k, sizes = SCAN_CASES[case]
    y = torch.tensor(_series(shape))
    close(chunked_ewma(y, k, *sizes), tew._ewma_conv(y, k), 1e-12)


def test_recurrence_coefficients_are_the_taps():
    for k in (1, 2, 25, 300, 2000):
        beta, c, beta_k = tew._recurrence(k)
        taps = c * beta ** np.arange(k - 1, -1, -1, dtype=np.float64)
        np.testing.assert_allclose(taps, tew._ewma_weights_np(k), rtol=1e-12)
        assert beta_k == beta ** k


@pytest.mark.parametrize("sizes", [KERNEL_SIZES, (2, 2, 4)])
def test_chunked_ewma_nan_stays_in_its_row(sizes):
    """The recurrence carries a NaN from its step to the end of its row
    (the FIR confined it to k outputs, the TPU kernel to its tile); the
    other rows are untouched."""
    y = torch.tensor(_series((3, 40)))
    y[1, 10] = float("nan")
    got, want = chunked_ewma(y, 5, *sizes), tew._ewma_conv(y, 5)
    close(got[[0, 2]], want[[0, 2]], 1e-12)
    close(got[1, :11], want[1, :11], 1e-12)
    assert torch.isnan(got[1, 11:]).all()

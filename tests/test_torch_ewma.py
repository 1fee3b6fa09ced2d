"""The port's EWMA filter (the plain version of kernel K1, which CPU
tensors take) against the JAX package's Pallas kernel ``ewma_pallas`` in
interpret mode and its XLA filter ``volt_tpu.ops.ewma.ewma``; and the
rolling forms.  float32, rtol/atol 1e-6."""

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

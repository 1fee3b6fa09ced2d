"""The plain version of kernel S1 (the Kalman MLL and filter, which CPU
tensors take) against ``volt_tpu.ops.tridiag`` with ``jax.grad``:
value, final state and gradients w.r.t. ``(v, sigma2, resid)`` at
``(4, 64)``, float32, rtol 1e-5 (gradients with an atol of 1e-6 of their
largest entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, t32

from volt_tpu.ops.tridiag import (brownian_noise_filter as j_filter,
                                  brownian_noise_mll_kalman as j_mll)

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

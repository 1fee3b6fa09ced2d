"""volt_tpu_torch.ops against volt_tpu.ops: the same numpy inputs through
both, float32, rtol 1e-5 (gradients rtol 1e-5 with a small atol)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, t32

from volt_tpu.gp import variational as jvar
from volt_tpu.ops import bidiag as jbd
from volt_tpu.ops import brownian as jbr
from volt_tpu.ops import constraints as jc
from volt_tpu.ops import quadrature as jq
from volt_tpu.ops import tridiag as jtd
from volt_tpu.ops import volint as jvi
from volt_tpu.train import scaled_returns as j_scaled_returns

from volt_tpu_torch.gp import variational as tvar
from volt_tpu_torch.ops import bidiag as tbd
from volt_tpu_torch.ops import brownian as tbr
from volt_tpu_torch.ops import constraints as tc
from volt_tpu_torch.ops import quadrature as tq
from volt_tpu_torch.ops import tridiag as ttd
from volt_tpu_torch.ops import volint as tvi
from volt_tpu_torch.train import scaled_returns as t_scaled_returns

RTOL = 1e-5


@pytest.fixture()
def rs():
    return np.random.default_rng(7)


def _grid(n, dt=1.0 / 252):
    return (np.arange(n, dtype=np.float32) * np.float32(dt)).astype(np.float32)


def _bidiag(rs, shape):
    """A well-conditioned bidiagonal precision factor ``(d, e)``."""
    d = np.exp(0.3 * rs.standard_normal(shape)).astype(np.float32) + 0.5
    e = (0.4 * rs.standard_normal((*shape[:-1], shape[-1] - 1))).astype(
        np.float32)
    return d, e


# --- constraints -----------------------------------------------------------

@pytest.mark.parametrize("name", ["softplus", "inv_softplus"])
def test_softplus_pair(rs, name):
    x = rs.standard_normal(64).astype(np.float32)
    if name == "inv_softplus":
        x = np.abs(x) + 0.05
    close(getattr(tc, name)(t32(x)), getattr(jc, name)(j32(x)), RTOL, 1e-7)


@pytest.mark.parametrize("cls,args", [("Interval", (0.0, 1.0)),
                                      ("Interval", (-3.0, 3.0)),
                                      ("Positive", ()),
                                      ("GreaterThan", (1e-4,))])
def test_constraint_roundtrip(rs, cls, args):
    raw = rs.standard_normal(64).astype(np.float32)
    tcon, jcon = getattr(tc, cls)(*args), getattr(jc, cls)(*args)
    val = tcon.forward(t32(raw))
    close(val, jcon.forward(j32(raw)), RTOL, 1e-7)
    close(tcon.inverse(val), jcon.inverse(j32(val.numpy())), 1e-4, 1e-5)


# --- vol integral ----------------------------------------------------------

@pytest.mark.parametrize("rule", ["reference", "trapezoid"])
def test_vol_integral(rs, rule):
    x = _grid(50) + np.float32(1.0 / 252)
    vol = (0.2 + 0.05 * rs.random((3, 50))).astype(np.float32)
    close(tvi.vol_integral(t32(x), t32(vol), rule),
          jvi.vol_integral(j32(x), j32(vol), rule), RTOL)


def test_cumtrapz_weights():
    x = _grid(20)
    close(tvi.cumtrapz_weights(t32(x)), jvi.cumtrapz_weights(j32(x)), RTOL)


def test_vol_integral_rejects_unknown_rule():
    with pytest.raises(ValueError):
        tvi.vol_integral(t32(_grid(5)), t32(np.ones(5)), "simpson")


# --- affine scan and the bidiagonal family ---------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 37, 64])
def test_affine_scan(rs, n, reverse):
    alpha = rs.uniform(-0.95, 0.95, (3, n)).astype(np.float32)
    beta = rs.standard_normal((3, n)).astype(np.float32)
    close(tbd.affine_scan(t32(alpha), t32(beta), reverse),
          jax.jit(jbd.affine_scan, static_argnums=2)(
              j32(alpha), j32(beta), reverse), RTOL, 1e-6)


def test_affine_scan_gradient(rs):
    alpha = rs.uniform(-0.9, 0.9, (2, 33)).astype(np.float32)
    beta = rs.standard_normal((2, 33)).astype(np.float32)
    a, b = t32(alpha).requires_grad_(), t32(beta).requires_grad_()
    torch.sin(tbd.affine_scan(a, b, True)).sum().backward()
    ja, jb = jax.jit(jax.grad(
        lambda u, v: jnp.sum(jnp.sin(jbd.affine_scan(u, v, True))),
        argnums=(0, 1)))(j32(alpha), j32(beta))
    close(a.grad, ja, RTOL, 1e-6)
    close(b.grad, jb, RTOL, 1e-6)


def test_takahashi_band(rs):
    d, e = _bidiag(rs, (3, 40))
    for got, want in zip(tbd.takahashi_band(t32(d), t32(e)),
                         jax.jit(jbd.takahashi_band)(j32(d), j32(e))):
        close(got, want, RTOL, 1e-7)


@pytest.mark.parametrize("which", ["lower", "upper"])
def test_bidiag_solves(rs, which):
    d, e = _bidiag(rs, (3, 30))
    b = rs.standard_normal((3, 30)).astype(np.float32)
    tfn = getattr(tbd, f"bidiag_solve_{which}")
    jfn = getattr(jbd, f"bidiag_solve_{which}")
    close(tfn(t32(d), t32(e), t32(b)), jax.jit(jfn)(j32(d), j32(e), j32(b)),
          RTOL, 1e-6)


def test_bidiag_chol_from_tridiag(rs):
    n = 45
    diag = (2.5 + rs.random((2, n))).astype(np.float32)
    off = (-0.9 * rs.random((2, n - 1))).astype(np.float32)
    for got, want in zip(tbd.bidiag_chol_from_tridiag(t32(diag), t32(off)),
                         jax.jit(jbd.bidiag_chol_from_tridiag)(
                             j32(diag), j32(off))):
        close(got, want, RTOL)


def test_min_precision(rs):
    x = _grid(30)
    jitter = np.float32(1e-6 / 0.2)
    for got, want in zip(tbd.min_precision(t32(x), float(jitter)),
                         jbd.min_precision(j32(x), jitter)):
        close(got, want, RTOL)


def test_tridiag_q_kl_bm_prior(rs):
    n = 40
    x = _grid(n)
    d, e = _bidiag(rs, (n,))
    d = d * 30.0
    mq = rs.standard_normal(n).astype(np.float32)
    mp = np.full(n, -1.5, np.float32)
    vol = np.array([0.2], np.float32)
    got = tbd.tridiag_q_kl_bm_prior(t32(x), t32(vol), t32(mq), t32(d), t32(e),
                                    t32(mp))
    want = jax.jit(jbd.tridiag_q_kl_bm_prior)(j32(x), j32(vol), j32(mq),
                                              j32(d), j32(e), j32(mp))
    close(got, want, RTOL)


# --- tridiagonal pivots (the float32 overflow guard) -----------------------

@pytest.mark.parametrize("span", ["unit", "wide"])
def test_tridiag_ldl_pivots(rs, span):
    n = 300
    if span == "unit":
        diag = 2.5 + rs.random((2, n))
        off = -0.9 * rs.random((2, n - 1))
    else:
        # entries from 1e3 to 1e6: the minors' product overflows float32
        # (1e3**300) unless each partial product is normalised
        diag = 10.0 ** rs.uniform(3, 6, (2, n))
        off = -0.3 * np.sqrt(diag[:, 1:] * diag[:, :-1])
    diag, off = diag.astype(np.float32), off.astype(np.float32)
    d_t, logdet_t = ttd.tridiag_ldl_pivots(t32(diag), t32(off))
    d_j, logdet_j = jax.jit(jtd.tridiag_ldl_pivots)(j32(diag),
                                                     j32(off))
    close(d_t, d_j, RTOL)
    close(logdet_t, logdet_j, RTOL)
    # and the float64 truth
    for b in range(2):
        dense = (np.diag(diag[b].astype(np.float64))
                 + np.diag(off[b].astype(np.float64), 1)
                 + np.diag(off[b].astype(np.float64), -1))
        np.testing.assert_allclose(float(logdet_t[b]),
                                   np.linalg.slogdet(dense)[1], rtol=1e-5)


# --- Brownian spectral algebra ---------------------------------------------

@pytest.mark.parametrize("n", [11, 200])
def test_min_kernel_spectrum(n):
    for got, want in zip(tbr.min_kernel_spectrum(n),
                         jbr.min_kernel_spectrum(n)):
        close(got, want, RTOL, 1e-6)
    close(tbr.min_kernel_eigenvalues(n), jbr.min_kernel_eigenvalues(n), RTOL)


@pytest.mark.parametrize("n", [50, 999])
def test_min_kernel_project(rs, n):
    y = rs.standard_normal((2, n)).astype(np.float32)
    close(tbr.min_kernel_project(t32(y)),
          jbr.min_kernel_project(j32(y), method="matmul"), RTOL, 2e-5)


def test_min_kernel_project_long_series_not_ported():
    """Above n = 4096 the projection is the FFT (ported), equal to the
    basis product in float64."""
    y = torch.tensor(np.random.default_rng(2).standard_normal((2, 4097)))
    close(tbr.min_kernel_project(y),
          tbr.min_kernel_project(y, method="matmul"), 0.0,
          1e-10 * y.abs().sum().item())


@pytest.mark.parametrize("grid", ["future", "overlap", "decreasing", "single"])
def test_future_grid_ok_and_poison(grid):
    train_x = _grid(20)
    last = train_x[-1]
    test_x = {
        "future": last + _grid(5) + np.float32(0.01),
        "overlap": last + _grid(5),
        "decreasing": (last + np.float32(0.01) + _grid(5))[::-1].copy(),
        "single": np.array([last + 0.01], np.float32),
    }[grid]
    ok_t = tbr.future_grid_ok(t32(test_x), t32(train_x))
    ok_j = jbr.future_grid_ok(j32(test_x), j32(train_x))
    assert bool(ok_t) == bool(ok_j)
    x = np.arange(4, dtype=np.float32)
    close(tbr.nan_poison(t32(x), ok_t[..., None]),
          jbr.nan_poison(j32(x), ok_j[..., None]), 0.0)


# --- GPCV init helpers, quadrature, returns --------------------------------

def test_running_std_latent_init(rs):
    y = (0.2 * rs.standard_normal((3, 60))).astype(np.float32)
    for got, want in zip(tvar.running_std_latent_init(t32(y)),
                         jvar.running_std_latent_init(j32(y))):
        close(got, want, RTOL, 1e-6)
    with pytest.raises(ValueError):
        tvar.running_std_latent_init(torch.zeros(10))


def test_exp_laplace_inv_hessian(rs):
    y = (0.2 * rs.standard_normal(80)).astype(np.float32)
    f = (rs.standard_normal(80) - 1.5).astype(np.float32)
    close(tvar.exp_laplace_inv_hessian(t32(y), t32(f)),
          jvar.exp_laplace_inv_hessian(j32(y), j32(f)), RTOL)


def test_gauss_hermite_expected_value(rs):
    mean = rs.standard_normal((2, 30)).astype(np.float32)
    var = (0.1 + rs.random((2, 30))).astype(np.float32)
    close(tq.expected_value(torch.exp, t32(mean), t32(var)),
          jq.expected_value(jnp.exp, j32(mean), j32(var)), RTOL)


def test_scaled_returns(rs):
    x = _grid(30)
    prices = (10.0 + np.cumsum(rs.standard_normal((2, 31)), -1) * 0.1).astype(
        np.float32)
    close(t_scaled_returns(t32(x), t32(prices)),
          j_scaled_returns(j32(x), j32(prices)), RTOL)
    with pytest.raises(ValueError):
        t_scaled_returns(t32(x), t32(prices[..., :-1]))

"""The dense Volt algebra of the port against the JAX package's: the
covariance build (K2's plain version, against the Pallas kernel in
interpret mode and the XLA build), its gradient, the psd-safe Cholesky and
solves, MVN log-density, conditionals and sampling, the exact GP, and the
dense MLLs of the Volt and vol GPs against their Kalman forms.
float32; rtol 1e-5 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, t32

from volt_tpu.gp.exact import exact_mll as j_exact_mll
from volt_tpu.gp.exact import posterior as j_posterior
from volt_tpu.kernels import BMKernel as JBMKernel
from volt_tpu.kernels import VolatilityKernel as JVolKernel
from volt_tpu.models.bmgp import BMGP as JBMGP
from volt_tpu.models.volt import VoltGP as JVolt, make_mean as j_make_mean
from volt_tpu.ops import chol as jchol
from volt_tpu.ops import mvn as jmvn
from volt_tpu.ops.pallas import volt_covariance as j_volt_cov_pallas
from volt_tpu.ops.pallas import volt_covariance_grad as j_volt_cov_grad
from volt_tpu.ops.volint import brownian_cholesky as j_brownian_cholesky
from volt_tpu.ops.volint import min_index_covariance as j_min_index
from volt_tpu.ops.volint import vol_integral as j_vol_integral

from volt_tpu_torch.convert import load_jax_params
from volt_tpu_torch.gp.exact import exact_mll, posterior
from volt_tpu_torch.kernels import BMKernel, VolatilityKernel
from volt_tpu_torch.models import BMGP, VoltGP, make_mean
from volt_tpu_torch.ops import chol, mvn
from volt_tpu_torch.ops.volint import brownian_cholesky, min_index_covariance
from volt_tpu_torch.ops.volint import vol_integral
from volt_tpu_torch.ops.volt_cov import _min_index_transpose, volt_covariance

RTOL = 1e-5
DT = 1.0 / 252


def _grid(n):
    return (np.arange(1, n + 1, dtype=np.float32) * np.float32(DT)).astype(
        np.float32)


def _vol(rs, shape):
    return (0.1 + 0.2 * rs.random(shape)).astype(np.float32)


def _spd(rs, b, n, ridge=0.5):
    a = rs.standard_normal((b, n, n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) / n + ridge * np.eye(n)).astype(
        np.float32)


# --- K2: the covariance build ------------------------------------------------

@pytest.mark.parametrize("shape", [(100,), (3, 37), (2, 257)])
def test_volt_covariance_plain_matches_pallas_and_xla(shape):
    rs = np.random.default_rng(0)
    x, vol = _grid(shape[-1]), _vol(rs, shape)
    got = volt_covariance(t32(x), t32(vol))
    assert got.shape == (*shape, shape[-1])
    pallas = j_volt_cov_pallas(j32(x), j32(vol), interpret=True)
    xla = j_min_index(j_vol_integral(j32(x), j32(vol)))
    close(got, pallas, RTOL, 1e-7)
    close(got, xla, RTOL, 1e-7)


def test_volt_covariance_gradient_matches_jax_transpose():
    """The backward K2 uses on the card (the plain transpose) against the
    JAX package's custom VJP and against autograd of the plain build."""
    rs = np.random.default_rng(1)
    x, vol = _grid(130), _vol(rs, (2, 130))
    want = jax.grad(lambda v: jnp.sum(jnp.cos(
        j_volt_cov_grad(j32(x), v))))(j32(vol))
    v = t32(vol).requires_grad_()
    torch.cos(volt_covariance(t32(x), v)).sum().backward()
    close(v.grad, want, RTOL, 1e-6)

    integral = vol_integral(t32(x), t32(vol)).requires_grad_()
    g = torch.cos(min_index_covariance(integral.detach()))
    (auto,) = torch.autograd.grad(min_index_covariance(integral), integral, g)
    close(_min_index_transpose(g), auto, RTOL, 1e-6)


def test_brownian_cholesky_and_min_index():
    rs = np.random.default_rng(2)
    integral = np.cumsum(_vol(rs, (2, 40)) ** 2 * np.float32(DT), axis=-1)
    integral = integral.astype(np.float32)
    close(min_index_covariance(t32(integral)), j_min_index(j32(integral)), 0.0)
    got = brownian_cholesky(t32(integral), jitter=1e-6)
    close(got, j_brownian_cholesky(j32(integral), jitter=1e-6), RTOL, 1e-7)
    exact = brownian_cholesky(t32(integral))
    close(exact @ exact.mT, min_index_covariance(t32(integral)), 1e-4, 1e-7)


@pytest.mark.parametrize("rule", ["reference", "trapezoid"])
def test_volatility_kernel_dense_and_diag(rule):
    rs = np.random.default_rng(3)
    x, vol = _grid(50), _vol(rs, (3, 50))
    jk, tk = JVolKernel(integral_rule=rule), VolatilityKernel(rule)
    close(tk(t32(x), t32(vol)), jk({}, j32(x), j32(vol)), RTOL, 1e-7)
    close(tk(t32(x), t32(vol), diag=True),
          jk({}, j32(x), j32(vol), diag=True), RTOL, 1e-7)


def test_bm_kernel_dense():
    x1, x2 = _grid(20), _grid(7) + np.float32(0.3)
    raw = np.asarray([[-1.0], [0.5]], np.float32)
    tk = load_jax_params(BMKernel(), {"raw_vol": raw})
    jk = JBMKernel(batch_shape=(2,))
    close(tk(t32(x1)), jk({"raw_vol": j32(raw)}, j32(x1)), RTOL)
    close(tk(t32(x1), t32(x2)), jk({"raw_vol": j32(raw)}, j32(x1), j32(x2)),
          RTOL)
    close(tk(t32(x1), diag=True), jk({"raw_vol": j32(raw)}, j32(x1),
                                     diag=True), RTOL)


# --- psd-safe Cholesky and solves --------------------------------------------

def test_psd_safe_cholesky_values_and_gradient():
    rs = np.random.default_rng(4)
    a = _spd(rs, 3, 12)
    g = rs.standard_normal((3, 12, 12)).astype(np.float32)
    want = jchol.psd_safe_cholesky(j32(a))
    want_grad = jax.grad(lambda m: jnp.sum(jchol.psd_safe_cholesky(m)
                                           * j32(g)))(j32(a))
    at = t32(a).requires_grad_()
    got = chol.psd_safe_cholesky(at)
    close(got, want, 1e-5, 1e-6)
    (got * t32(g)).sum().backward()
    close(at.grad, want_grad, 1e-4, 1e-5)


def test_psd_safe_cholesky_jitter_ladder():
    """A singular matrix fails bare and takes the first rung (1e-6); one
    that no rung rescues comes back NaN, as in the JAX package."""
    v = np.arange(1.0, 6.0, dtype=np.float32)
    singular = np.outer(v, v).astype(np.float32)
    got = chol.psd_safe_cholesky(t32(singular))
    want = jchol.psd_safe_cholesky(j32(singular))
    assert torch.isfinite(got).all()
    close(got, want, 1e-4, 1e-6)
    bad = -np.eye(4, dtype=np.float32)
    close(chol.psd_safe_cholesky(t32(bad)), jchol.psd_safe_cholesky(j32(bad)),
          0.0)  # NaN below the diagonal, 0 above, in both


def test_triangular_solves():
    rs = np.random.default_rng(5)
    a = _spd(rs, 2, 10)
    b = rs.standard_normal((2, 10, 3)).astype(np.float32)
    lt = chol.psd_safe_cholesky(t32(a))
    lj = jchol.psd_safe_cholesky(j32(a))
    for name in ("solve_lower_triangular", "solve_upper_triangular",
                 "cholesky_solve", "tril_inverse_quad"):
        close(getattr(chol, name)(lt, t32(b)), getattr(jchol, name)(lj, j32(b)),
              1e-4, 1e-5)
    close(chol.tril_inverse_quad(lt, t32(b[..., 0])),
          jchol.tril_inverse_quad(lj, j32(b[..., 0])), 1e-4)


# --- MVN and the exact GP ----------------------------------------------------

def test_mvn_log_prob_conditional_and_sample():
    rs = np.random.default_rng(6)
    cov = _spd(rs, 2, 14)
    y = rs.standard_normal((2, 14)).astype(np.float32)
    mean = rs.standard_normal((2, 14)).astype(np.float32)
    close(mvn.mvn_log_prob(t32(y), t32(mean), t32(cov)),
          jmvn.mvn_log_prob(j32(y), j32(mean), j32(cov)), 1e-5)

    n = 10
    args = (cov[:, :n, :n], cov[:, :n, n:], cov[:, n:, n:], y[:, :n])
    got = mvn.conditional(*map(t32, args), jitter=1e-4)
    want = jmvn.conditional(*map(j32, args), jitter=1e-4)
    for a, b in zip(got, want):
        close(a, b, 1e-4, 1e-5)

    key = jax.random.key(3)
    want = jmvn.sample_mvn(key, j32(mean), j32(cov), (5,))
    z = jax.random.normal(key, (5, 2, 14), jnp.float32)
    got = mvn.sample_mvn(t32(mean), t32(cov), (5,), noise=t32(z))
    assert got.shape == (5, 2, 14)
    close(got, want, 1e-4, 1e-5)


def test_exact_mll_and_posterior():
    rs = np.random.default_rng(7)
    cov = _spd(rs, 2, 16, ridge=0.1)
    y = rs.standard_normal((2, 16)).astype(np.float32)
    mean = 0.1 * rs.standard_normal((2, 16)).astype(np.float32)
    noise = np.asarray([[0.05], [0.2]], np.float32)
    close(exact_mll(t32(y), t32(mean), t32(cov), t32(noise)),
          j_exact_mll(j32(y), j32(mean), j32(cov), j32(noise)), 1e-5)
    n = 11
    args = (cov[:, :n, :n], cov[:, :n, n:], cov[:, n:, n:], y[:, :n], noise)
    for a, b in zip(posterior(*map(t32, args)), j_posterior(*map(j32, args))):
        close(a, b, 1e-4, 1e-5)


# --- the dense MLLs of the Volt and vol GPs ------------------------------------

@pytest.fixture(scope="module")
def volt_data():
    from volt_tpu.data import sabr_paths

    f, vol = sabr_paths(steps=91, seed=8)
    x = (np.arange(90, dtype=np.float32) * np.float32(DT)).astype(np.float32)
    return x, np.log(f[1:]).astype(np.float32), vol[1:].astype(np.float32)


@pytest.mark.parametrize("mean,rule", [("ewma", "reference"),
                                       ("constant", "reference"),
                                       ("dewma", "trapezoid")])
def test_volt_dense_mll_matches_jax_and_kalman(volt_data, mean, rule):
    x, log_y, vol = volt_data
    jv = JVolt(mean=j_make_mean(mean, k=20), integral_rule=rule)
    params = jv.init()
    params["likelihood"]["raw_noise"] = jnp.asarray([-6.0], jnp.float32)
    if mean == "constant":
        params["mean"]["constant"] = jnp.asarray([4.6], jnp.float32)
    jstate = jv.fit_state(params, j32(x), j32(log_y), j32(vol))
    tv = load_jax_params(VoltGP(mean=make_mean(mean, k=20),
                                integral_rule=rule),
                         jax.tree.map(np.asarray, params))
    tstate = tv.fit_state(t32(x), t32(log_y), t32(vol))
    dense = tstate.mll()
    close(dense, jstate.mll(), 1e-5)
    close(dense, tstate.mll_kalman().detach(), 1e-4)
    dense.backward()
    want = jax.grad(lambda p: jv.mll(p, j32(x), j32(log_y), j32(vol)))(params)
    close(tv.likelihood.raw_noise.grad, want["likelihood"]["raw_noise"],
          1e-3, 1e-6)
    new = tstate.update_vol_path(t32(vol) * 1.1)
    close(new.mll(), jstate.update_vol_path(j32(vol) * 1.1).mll(), 1e-5)


def test_bmgp_dense_mll_kalman_posterior_and_sample(volt_data):
    x, _, vol = volt_data
    log_vol = np.log(vol).astype(np.float32)
    params = {"kernel": {"raw_vol": np.asarray([-1.2], np.float32)},
              "likelihood": {"raw_noise": np.asarray([-3.0], np.float32)}}
    jm = JBMGP()
    tm = load_jax_params(BMGP(), params)
    jx, jy = j32(x), j32(log_vol)
    dense = tm.mll(t32(x), t32(log_vol))
    kalman = tm.mll_kalman(t32(x), t32(log_vol)).detach()
    close(dense, jm.mll(params, jx, jy), 1e-5)
    close(kalman, jm.mll_kalman(params, jx, jy), 1e-5)
    close(dense, kalman, 1e-4)

    test_x = np.concatenate([x[40:45], x[-1] + np.arange(1, 4) * DT]).astype(
        np.float32)
    jstate = jm.fit_state(params, jx, jy)
    tstate = tm.fit_state(t32(x), t32(log_vol))
    for a, b in zip(tstate.posterior(t32(test_x)),
                    jstate.posterior(j32(test_x))):
        close(a.detach(), b, 1e-4, 1e-6)
    key = jax.random.key(4)
    want = jstate.sample(key, j32(test_x), (6,))
    z = jax.random.normal(key, (6, test_x.shape[0]), jnp.float32)
    got = tstate.sample(t32(test_x), (6,), noise=t32(z))
    close(got, want, 1e-4, 1e-5)

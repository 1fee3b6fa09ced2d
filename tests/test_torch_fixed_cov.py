"""The fixed-covariance exact MLL, the Gaussian likelihood's density and
the spectral basis's bound of the port against the JAX package's, on the
same numpy inputs (float32, CPU):

* ``make_fixed_cov_cache`` / ``exact_mll_fixed_cov`` against JAX's (rel
  1e-5: the two ``eigh`` differ in rounding only) and against the port's
  own Cholesky ``exact_mll`` (rel 1e-4, as
  ``tests/test_likelihoods_gp.py`` holds JAX's); their gradients against
  ``jax.grad`` at rtol 1e-3, atol 1e-5;
* ``VoltGP.make_cov_cache`` / ``mll_fixed_cov`` on a small fitted-like
  state (B=2, n=120, JAX's parameters through ``load_jax_params``)
  against JAX's (rel 1e-5, gradients rtol 1e-3 / atol 1e-5 of the
  largest) and against the port's Kalman MLL (rel 1e-3, the tolerance of
  ``tests/test_pipeline.py``'s fixed-covariance check);
* ``GaussianLikelihood.log_prob`` / ``marginal_covariance`` (rtol 1e-6),
  for the multitask likelihood too;
* ``spectral_n_ok``: JAX's answer wherever JAX's is ``True``, the port's
  own int64 bound above n = 32768.

Each test's numpy seed is in its docstring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu import gp as jgp
from volt_tpu.data import sabr_paths
from volt_tpu.likelihoods import GaussianLikelihood as JLik
from volt_tpu.likelihoods import MultitaskGaussianLikelihood as JMTLik
from volt_tpu.models.volt import VoltGP as JVolt, make_mean as j_make_mean
from volt_tpu.ops.brownian import spectral_n_ok as j_spectral_n_ok

from volt_tpu_torch import gp
from volt_tpu_torch.convert import load_jax_params
from volt_tpu_torch.likelihoods import (GaussianLikelihood,
                                        MultitaskGaussianLikelihood)
from volt_tpu_torch.models import VoltGP, make_mean
from volt_tpu_torch.ops.brownian import min_kernel_spectrum, spectral_n_ok

DT = 1.0 / 252


def _spd(rs, n):
    a = rs.standard_normal((n, n))
    return (a @ a.T / n + np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("noise", [1e-3, 0.1, 1.0])
def test_fixed_cov_mll_matches_jax_and_the_cholesky_mll(noise):
    """``default_rng(3)``, n=25, ``cov = a a^T / n + I``: the port's
    eigendecomposition MLL against JAX's at rel 1e-5 and against its own
    ``exact_mll`` at rel 1e-4."""
    rs = np.random.default_rng(3)
    n = 25
    cov = _spd(rs, n)
    y = rs.standard_normal(n).astype(np.float32)
    mean = rs.standard_normal(n).astype(np.float32)
    cache = gp.make_fixed_cov_cache(t32(cov))
    assert isinstance(cache, gp.FixedCovCache)
    assert cache.evals.shape == (n,) and cache.evecs.shape == (n, n)
    got = gp.exact_mll_fixed_cov(t32(y), t32(mean), cache, noise)
    want = jgp.exact_mll_fixed_cov(j32(y), j32(mean),
                                   jgp.make_fixed_cov_cache(j32(cov)), noise)
    close(got, want, 1e-5)
    close(got, gp.exact_mll(t32(y), t32(mean), t32(cov), noise), 1e-4)


def test_fixed_cov_cache_clamps_negative_eigenvalues():
    """``default_rng(4)``, n=6: a covariance of rank 2 has eigenvalues
    that round below zero; the cache holds them at 0, as JAX's."""
    rs = np.random.default_rng(4)
    a = rs.standard_normal((6, 2)).astype(np.float32)
    cov = a @ a.T
    cache = gp.make_fixed_cov_cache(t32(cov))
    assert bool((cache.evals >= 0).all())
    want = jgp.make_fixed_cov_cache(j32(cov))
    close(cache.evals, want.evals, 1e-5, 1e-5)


@pytest.mark.parametrize("raw", [-2.0, 0.5])
def test_fixed_cov_gradients_match_jax(raw):
    """``default_rng(5)``, n=20, noise ``exp(raw)``: the gradients in
    ``y``, ``mean`` and ``raw`` against ``jax.grad`` at rtol 1e-3, atol
    1e-5, and against the Cholesky MLL's."""
    rs = np.random.default_rng(5)
    n = 20
    cov = _spd(rs, n)
    y = rs.standard_normal(n).astype(np.float32)
    mean = (0.3 + 0.1 * rs.standard_normal(n)).astype(np.float32)
    jcache = jgp.make_fixed_cov_cache(j32(cov))
    want = jax.grad(lambda a, m, r: -jgp.exact_mll_fixed_cov(
        a, m, jcache, jnp.exp(r)), argnums=(0, 1, 2))(
            j32(y), j32(mean), jnp.float32(raw))

    def grads(mll):
        args = [t32(y).requires_grad_(), t32(mean).requires_grad_(),
                torch.tensor(raw, requires_grad=True)]
        return torch.autograd.grad(-mll(args[0], args[1],
                                        torch.exp(args[2])), args)

    cache = gp.make_fixed_cov_cache(t32(cov))
    got = grads(lambda a, m, s: gp.exact_mll_fixed_cov(a, m, cache, s))
    direct = grads(lambda a, m, s: gp.exact_mll(a, m, t32(cov), s))
    for g, w, d in zip(got, want, direct):
        close(g, w, 1e-3, 1e-5)
        close(g, d, 1e-3, 1e-5)


@pytest.fixture(scope="module")
def volt_state():
    """``sabr_paths(steps=121, seed=8, n_paths=2)``: log prices and vol on
    the return grid of n=120."""
    f, vol = sabr_paths(steps=121, seed=8, n_paths=2)
    x = (np.arange(120, dtype=np.float32) * np.float32(DT)).astype(
        np.float32)
    return x, np.log(f[:, 1:]).astype(np.float32), vol[:, 1:].astype(
        np.float32)


@pytest.mark.parametrize("mean", ["ewma", "constant"])
def test_volt_fixed_cov_mll_matches_jax_and_kalman(volt_state, mean):
    """The data model's fixed-covariance MLL per lane (raw noise -6 and
    -3) against JAX's (rel 1e-5; gradients in the raw noise and the mean
    constant rtol 1e-3, atol 1e-5 of the largest) and against the port's
    Kalman MLL of the same state (rel 1e-3)."""
    x, log_y, vol = volt_state
    jv = JVolt(mean=j_make_mean(mean, k=20))
    params = jax.vmap(lambda _: jv.init())(jnp.arange(2))
    params["likelihood"]["raw_noise"] = jnp.asarray([[-6.0], [-3.0]],
                                                    jnp.float32)
    if mean == "constant":
        params["mean"]["constant"] = jnp.asarray([[4.6], [4.5]], jnp.float32)

    def jmll(p):
        return jax.vmap(lambda q, y, v: jv.mll_fixed_cov(
            q, jv.make_cov_cache(j32(x), v), j32(x), y))(
                p, j32(log_y), j32(vol))

    want = jmll(params)
    jgrad = jax.grad(lambda p: jnp.sum(jmll(p)))(params)

    tv = load_jax_params(VoltGP(mean=make_mean(mean, k=20)),
                         jax_tree_np(params))
    cache = tv.make_cov_cache(t32(x), t32(vol))
    assert cache.evecs.shape == (2, 120, 120)
    got = tv.mll_fixed_cov(cache, t32(x), t32(log_y))
    close(got, want, 1e-5)
    close(got, tv.mll_kalman(t32(x), t32(log_y), t32(vol)).detach(), 1e-3)
    got.sum().backward()
    for path, p in tv.named_parameters():
        w = jgrad
        for part in path.split("."):
            w = w[part]
        close(p.grad, w, 1e-3, 1e-5 * float(np.max(np.abs(w))))


@pytest.mark.parametrize("cls,jcls", [(GaussianLikelihood, JLik),
                                      (MultitaskGaussianLikelihood, JMTLik)])
def test_gaussian_likelihood_log_prob_and_marginal_covariance(cls, jcls):
    """``default_rng(6)``, a batch of 2 with raw noise (-1.5, 0.7): the
    elementwise log density and ``K + noise I`` against JAX's at rtol
    1e-6 (the multitask likelihood inherits both, as in JAX)."""
    rs = np.random.default_rng(6)
    raw = np.asarray([[-1.5], [0.7]], np.float32)
    y = rs.standard_normal((2, 9)).astype(np.float32)
    f = rs.standard_normal((2, 9)).astype(np.float32)
    cov = np.stack([_spd(rs, 9), _spd(rs, 9)])
    lik = cls() if cls is GaussianLikelihood else cls(3)
    jlik = jcls(batch_shape=(2,)) if jcls is JLik else jcls(3, (2,))
    load_jax_params(lik, {"raw_noise": raw})
    params = {"raw_noise": j32(raw)}
    close(lik.log_prob(t32(y), t32(f)), jlik.log_prob(params, j32(y), j32(f)),
          1e-6, 1e-6)
    close(lik.marginal_covariance(t32(cov)),
          jlik.marginal_covariance(params, j32(cov)), 1e-6)


@pytest.mark.parametrize("n", [1, 1000, 16000, 32768])
def test_spectral_n_ok_equals_jax_inside_its_bound(n):
    assert spectral_n_ok(n) is j_spectral_n_ok(n) is True


def test_spectral_n_ok_above_jax_bound():
    """Above n = 32768 JAX's int32 reduction overflows and the port's
    int64 one does not, up to n = 2^31; beyond it the port also refuses,
    and ``min_kernel_spectrum`` raises before it allocates."""
    for n in (32769, 100_000, 2**31):
        assert not j_spectral_n_ok(n)
        assert spectral_n_ok(n)
    assert not spectral_n_ok(2**31 + 1)
    with pytest.raises(ValueError, match="int64"):
        min_kernel_spectrum(2**31 + 1)

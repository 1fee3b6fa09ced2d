"""The Kronecker multitask chain of the port against the JAX package's on
the same numpy inputs and parameters (JAX's random initial values carried
by ``volt_tpu_torch.convert``, JAX's normals rebuilt from its key recipe
by ``torch_parity.jax_multitask_noise``): ``IndexKernel`` and
``MultitaskGaussianLikelihood``; every function of ``gp/kronecker.py``,
``kron_mvn_log_prob``'s closed-form backward at the degenerate init among
them, and a dense ``(NT, NT)`` MVN in float64; ``MultitaskBMGP`` (MLL
against the spectral MLL, gradients, the posterior, Matheron and dense
sampling given JAX's normals); ``MultitaskVariationalGP`` in both families
(init, ELBO, gradients, prediction); ``learn_gpcv_multitask``,
``train_volt_multitask``, ``rollouts_multitask``, ``Volt`` with ``(T, n)``
data; and ``fit_forecast_multitask`` cold and after
``warm_start_multitask`` at shift 0 and 1.

The ``eigh`` bases of LAPACK (JAX), torch's CPU path and cuSOLVER differ
in signs and in the order within degenerate eigenspaces, so nothing
compared here depends on them: log-probabilities, gradients, posterior
moments and samples given the same normals (Matheron's formula is
basis-invariant for fixed normals).

Tolerances (float32): closed forms rtol 1e-5 with atol 1e-6 of the
largest value; ``eigh``-based values (``kron_mvn_log_prob``,
``kron_posterior``, the dense MLL and samples) and gradients rtol 1e-4 /
atol 1e-5 of the largest (two libraries' ``eigh`` round differently);
float64 against the dense MVN 1e-10; the Laplace inits 1e-4 (a Cholesky
and a triangular inverse); fits of a few Adam steps rtol 1e-3 (each
library's rounding enters Adam's normalised step; the dense family's
pipeline loss 1e-2, with its measured reason at the test), paths and fans
2e-3 / 1e-3 as the single-task pipeline tests.  The largest share of a
tolerance used on these inputs: 0.48 (the dense family's pipeline loss),
then 0.35 (the likelihood's noise, the warm refit), 0.20 (the dense
Laplace init) and 0.13 (the backward at the degenerate init)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (close, j32, jax_multitask_noise, jax_tree_np,
                          t32)

from volt_tpu import train as jtrain
from volt_tpu.data import sabr_paths
from volt_tpu.gp import kronecker as jkr
from volt_tpu.kernels import IndexKernel as JIndex
from volt_tpu.likelihoods import MultitaskGaussianLikelihood as JMTLik
from volt_tpu.likelihoods import VolatilityGaussianLikelihood as JLik
from volt_tpu.models.multitask import MultitaskBMGP as JMTBMGP
from volt_tpu.models.multitask import MultitaskVariationalGP as JMTVGP
from volt_tpu.models.volt import VoltGP as JVolt
from volt_tpu.models.volt import make_mean as j_make_mean
from volt_tpu.parallel import MultitaskPipelineConfig as JConfig
from volt_tpu.parallel import fit_forecast_multitask as j_fit
from volt_tpu.parallel import warm_start_multitask as j_warm
from volt_tpu.rollouts import rollouts_multitask as j_rollouts

from volt_tpu_torch import train as ttrain
from volt_tpu_torch.convert import load_jax_params, params_tree
from volt_tpu_torch.gp import kronecker as tkr
from volt_tpu_torch.kernels import IndexKernel
from volt_tpu_torch.likelihoods import (MultitaskGaussianLikelihood,
                                        VolatilityGaussianLikelihood)
from volt_tpu_torch.models import (MultitaskBMGP, MultitaskVariationalGP,
                                   Volt)
from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                     fit_forecast_multitask,
                                     warm_start_multitask)
from volt_tpu_torch.rollouts import rollouts_multitask

T, N, H, S, DT = 3, 40, 6, 16, 1.0 / 252


def _grid(n, start=1):
    return (np.arange(start, n + start, dtype=np.float32)
            * np.float32(DT)).astype(np.float32)


def _close_max(got, want, rtol, share=1e-6):
    want = np.asarray(want)
    close(got, want, rtol, share * float(np.max(np.abs(want))))


def _tree_close(got, want, rtol, share=1e-6):
    if isinstance(want, dict):
        assert set(got) == set(want), (set(got), set(want))
        for k in want:
            _tree_close(got[k], want[k], rtol, share)
    else:
        _close_max(got, want, rtol, share)


def _grads(module):
    return {name: p.grad for name, p in module.named_parameters()}


def _jget(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _grads_close(module, jgrads, rtol, share=1e-5):
    for name, g in _grads(module).items():
        _close_max(g, _jget(jgrads, name), rtol, share)


@pytest.fixture(scope="module")
def rs():
    return np.random.default_rng(12)


@pytest.fixture(scope="module")
def data():
    f, _ = sabr_paths(steps=N + 1, seed=41, n_paths=T)
    x = _grid(N)
    yy = np.asarray(jtrain.scaled_returns(j32(x), j32(f))).T  # (N, T)
    return {"x": x, "prices": f.astype(np.float32), "yy": yy,
            "log_vols": np.log(np.abs(yy) + 0.2).astype(np.float32)}


# --- IndexKernel, MultitaskGaussianLikelihood -------------------------------------


def test_index_kernel(rs):
    params = {"covar_factor": rs.standard_normal((T, 2)).astype(np.float32),
              "raw_var": rs.standard_normal(T).astype(np.float32)}
    jk, jp = JIndex(T, rank=2), jax.tree.map(j32, params)
    tk = load_jax_params(IndexKernel(T, rank=2), params)
    with torch.no_grad():
        _close_max(tk.covar_matrix(), jk.covar_matrix(jp), 1e-5)
        f, v = tk.factor_and_diag()
        jf, jv = jk.factor_and_diag(jp)
        close(f, jf, 0.0)
        close(v, jv, 1e-6)
        i1, i2 = np.asarray([2, 0]), np.asarray([1, 1, 2])
        _close_max(tk(torch.tensor(i1), torch.tensor(i2)),
                   jk(jp, jnp.asarray(i1), jnp.asarray(i2)), 1e-5)
        _close_max(tk(torch.tensor(i1), diag=True),
                   jk(jp, jnp.asarray(i1), diag=True), 1e-5)
        close(tk(), tk.covar_matrix(), 0.0)
    init = IndexKernel(T, 2).init(generator=torch.Generator().manual_seed(1))
    assert init.covar_factor.shape == (T, 2)
    assert torch.equal(init.raw_var, torch.zeros(T))


def test_multitask_likelihood():
    lik = MultitaskGaussianLikelihood(T).init_with_noise(1e-3)
    want = JMTLik(T).noise(JMTLik(T).init_with_noise(1e-3))
    assert lik.num_tasks == T
    close(lik.noise(), want, 1e-6)


# --- gp/kronecker.py -------------------------------------------------------------


def _spd(rs, n, scale=1.0):
    a = rs.standard_normal((n, n)).astype(np.float32)
    return (scale * (a @ a.T / n + 0.5 * np.eye(n))).astype(np.float32)


@pytest.fixture(scope="module")
def kron_inputs(rs, data):
    x = data["x"]
    return {"y": data["log_vols"],
            "mean": (0.1 * rs.standard_normal((N, T))).astype(np.float32),
            "k_data": (0.3 * np.minimum(x[:, None], x[None, :])).astype(
                np.float32),
            "k_task": _spd(rs, T), "noise": np.float32(0.05)}


def _degenerate_task(rs):
    """``F F^T + I`` with ``F`` rank 1: ``T - 1`` equal eigenvalues, as
    ``IndexKernel``'s init (``raw_var = 0`` gives ``softplus(0) I``)."""
    f = (0.1 * rs.standard_normal((T, 1))).astype(np.float32)
    return (f @ f.T + np.log(2.0) * np.eye(T)).astype(np.float32)


@pytest.mark.parametrize("task", ["random", "degenerate"])
def test_kron_mvn_log_prob_and_backward(rs, kron_inputs, task):
    ins = dict(kron_inputs)
    if task == "degenerate":
        ins["k_task"] = _degenerate_task(rs)
    names = ("y", "mean", "k_data", "k_task", "noise")
    jvals = [j32(ins[k]) for k in names]
    want = jkr.kron_mvn_log_prob(*jvals)
    jgrads = jax.grad(lambda *a: jkr.kron_mvn_log_prob(*a),
                      argnums=tuple(range(5)))(*jvals)
    tvals = [torch.tensor(np.asarray(ins[k], np.float32), requires_grad=True)
             for k in names]
    got = tkr.kron_mvn_log_prob(*tvals)
    got.backward()
    close(got, want, 1e-4)
    for t, g in zip(tvals, jgrads):
        assert torch.isfinite(t.grad).all()
        _close_max(t.grad, g, 1e-4, 1e-5)


def test_kron_mvn_log_prob_against_dense_float64(kron_inputs):
    """In float64 against ``log N(vec(y); vec(mean), K_d (x) K_t + s I)``
    built densely, value and gradients (autograd through the dense
    Cholesky)."""
    ins = {k: torch.tensor(np.asarray(v), dtype=torch.float64,
                           requires_grad=True)
           for k, v in kron_inputs.items()}
    got = tkr.kron_mvn_log_prob(ins["y"], ins["mean"], ins["k_data"],
                                ins["k_task"], ins["noise"])
    got.backward()
    g_kron = {k: v.grad.clone() for k, v in ins.items()}
    for v in ins.values():
        v.grad = None
    cov = torch.kron(ins["k_data"], ins["k_task"]) + ins["noise"] * torch.eye(
        N * T, dtype=torch.float64)
    want = torch.distributions.MultivariateNormal(
        ins["mean"].reshape(-1), cov).log_prob(ins["y"].reshape(-1))
    want.backward()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-10)
    for k, v in ins.items():
        np.testing.assert_allclose(g_kron[k].numpy(), v.grad.numpy(),
                                   rtol=1e-8, atol=1e-10)


def _blockdiag_inputs(rs, data):
    """A BM data kernel's closed-form spectrum: ``U^T r``, ``ld``, ``c``,
    ``w`` from the port's projection (held to JAX's in the spectral
    tests)."""
    from volt_tpu_torch.ops.brownian import (min_kernel_eigenvalues,
                                             min_kernel_project)

    x = t32(data["x"])
    r = t32(data["log_vols"])
    vol, dx = 0.3, float(data["x"][1] - data["x"][0])
    return {"r_tilde": min_kernel_project(r, axis=-2).numpy(),
            "ld": (vol * dx * min_kernel_eigenvalues(N)).numpy(),
            "c": np.float32(vol * (float(x[0]) - dx)),
            "w": min_kernel_project(torch.ones(N)).numpy()}


def test_kron_blockdiag_forms(rs, data):
    bd = _blockdiag_inputs(rs, data)
    factor = (0.3 * rs.standard_normal((T, 1))).astype(np.float32)
    diag = np.asarray([0.7, 0.4, 0.9], np.float32)
    k_task = (factor @ factor.T + np.diag(diag)).astype(np.float32)
    noise = np.float32(0.02)
    want = jkr.kron_mvn_log_prob_blockdiag(
        j32(bd["r_tilde"]), j32(bd["ld"]), bd["c"], j32(k_task), noise,
        j32(bd["w"]))
    got = tkr.kron_mvn_log_prob_blockdiag(
        t32(bd["r_tilde"]), t32(bd["ld"]), torch.tensor(bd["c"]),
        t32(k_task), torch.tensor(noise), t32(bd["w"]))
    close(got, want, 1e-5)
    lf = torch.tensor(factor, requires_grad=True)
    ldg = torch.tensor(diag, requires_grad=True)
    low = tkr.kron_mvn_log_prob_blockdiag_lowrank(
        t32(bd["r_tilde"]), t32(bd["ld"]), torch.tensor(bd["c"]), lf, ldg,
        torch.tensor(noise), t32(bd["w"]))
    low.backward()
    jlow, jg = jax.value_and_grad(
        lambda f, d: jkr.kron_mvn_log_prob_blockdiag_lowrank(
            j32(bd["r_tilde"]), j32(bd["ld"]), bd["c"], f, d, noise,
            j32(bd["w"])), argnums=(0, 1))(j32(factor), j32(diag))
    close(low, jlow, 1e-5)
    close(low, got, 1e-5)
    _close_max(lf.grad, jg[0], 1e-4, 1e-5)
    _close_max(ldg.grad, jg[1], 1e-4, 1e-5)


def _kl_inputs(rs, data):
    x = data["x"]
    return {"mean_q": (0.1 * rs.standard_normal((N, T))).astype(np.float32),
            "root_x": np.tril(0.05 * rs.standard_normal((N, N))
                              + 0.3 * np.eye(N)).astype(np.float32),
            "root_t": np.tril(0.1 * rs.standard_normal((T, T))
                              + np.eye(T)).astype(np.float32),
            "mean_p": (0.05 * rs.standard_normal((N, T))).astype(np.float32),
            "k_data": (0.3 * np.minimum(x[:, None], x[None, :])).astype(
                np.float32),
            "k_task": _spd(rs, T)}


def test_kron_kl_forms(rs, data):
    ins = _kl_inputs(rs, data)
    x, vol = data["x"], np.asarray([0.3], np.float32)
    args = ("mean_q", "root_x", "root_t", "mean_p")
    want = jkr.kron_kl(*(j32(ins[k]) for k in args), j32(ins["k_data"]),
                       j32(ins["k_task"]))
    got = tkr.kron_kl(*(t32(ins[k]) for k in args), t32(ins["k_data"]),
                      t32(ins["k_task"]))
    close(got, want, 1e-4)
    jbm = jkr.kron_kl_bm_prior(*(j32(ins[k]) for k in args), j32(x),
                               j32(vol), j32(ins["k_task"]))
    tbm = tkr.kron_kl_bm_prior(*(t32(ins[k]) for k in args), t32(x),
                               t32(vol), t32(ins["k_task"]))
    close(tbm, jbm, 1e-5)
    close(tbm, got, 1e-4)  # the same KL through the closed-form factor
    q_d = (1.0 + 0.2 * rs.random(N)).astype(np.float32)
    q_e = (0.1 * rs.standard_normal(N - 1)).astype(np.float32)
    jtri = jkr.kron_kl_bm_prior_tridiag(
        j32(ins["mean_q"]), j32(q_d), j32(q_e), j32(ins["root_t"]),
        j32(ins["mean_p"]), j32(x), j32(vol), j32(ins["k_task"]))
    ttri = tkr.kron_kl_bm_prior_tridiag(
        t32(ins["mean_q"]), t32(q_d), t32(q_e), t32(ins["root_t"]),
        t32(ins["mean_p"]), t32(x), t32(vol), t32(ins["k_task"]))
    close(ttri, jtri, 1e-5)


def test_kron_posterior(rs, kron_inputs, data):
    x, tx = data["x"], _grid(H, N + 1)
    k = lambda a, b: (0.3 * np.minimum(a[:, None], b[None, :])).astype(
        np.float32)
    resid = kron_inputs["y"] - kron_inputs["mean"]
    for k_task in (kron_inputs["k_task"], _degenerate_task(rs)):
        args = (k(x, x), k(x, tx), k(tx, tx), k_task, resid)
        jm, jc = jkr.kron_posterior(*(j32(a) for a in args), 0.05)
        tm, tc = tkr.kron_posterior(*(t32(a) for a in args),
                                    torch.tensor(0.05))
        assert tc.shape == (H * T, H * T)
        _close_max(tm, jm, 1e-4, 1e-5)
        _close_max(tc, jc, 1e-4, 1e-5)


# --- MultitaskBMGP ------------------------------------------------------------------


@pytest.fixture(scope="module")
def mt_params():
    p = jax_tree_np(JMTBMGP(T).init(key=jax.random.key(3)))
    p["data_kernel"]["raw_vol"] = np.asarray([-0.8], np.float32)
    p["likelihood"]["raw_noise"] = np.asarray([-2.0], np.float32)
    return p


def test_multitask_bmgp_mll(data, mt_params):
    """The dense MLL (one ``eigh`` a factor) against the spectral MLL (the
    closed-form spectrum, the low-rank blocks) and JAX's, gradients
    against ``jax.grad`` at the init's degenerate task covariance."""
    x, y = data["x"], data["log_vols"]
    jm, jp = JMTBMGP(T), jax.tree.map(jnp.asarray, mt_params)
    want, jg = jax.value_and_grad(lambda p: jm.mll(p, j32(x), j32(y)))(jp)
    tm = load_jax_params(MultitaskBMGP(T), mt_params)
    got = tm.mll(t32(x), t32(y))
    got.backward()
    close(got, want, 1e-4)
    _grads_close(tm, jg, 1e-4)
    dense_grads = _grads(tm)
    tm.zero_grad()
    spec = tm.mll_spectral(tm.spectral_cache(t32(x), t32(y)), N, T)
    spec.backward()
    close(spec, got.detach(), 1e-5)
    for name, g in _grads(tm).items():
        _close_max(g, dense_grads[name], 1e-3, 1e-5)
    jspec = jm.mll_spectral(jp, jm.spectral_cache(j32(x), j32(y)), N, T)
    close(spec, jspec, 1e-5)


def test_multitask_bmgp_samples(data, mt_params):
    """Matheron samples and dense posterior samples given JAX's normals."""
    x, y, tx = data["x"], data["log_vols"], _grid(H, N + 1)
    jm, jp = JMTBMGP(T), jax.tree.map(jnp.asarray, mt_params)
    jstate = jm.fit_state(jp, j32(x), j32(y))
    key = jax.random.key(7)
    want = jstate.sample_forecast(key, j32(tx), (S,))
    k0, k1 = jax.random.split(key)
    z = jax.random.normal(k0, (S, N + H, T), jnp.float32)
    eps = jax.random.normal(k1, (S, N, T), jnp.float32)
    tstate = load_jax_params(MultitaskBMGP(T), mt_params).fit_state(
        t32(x), t32(y))
    with torch.no_grad():
        got = tstate.sample_forecast(t32(tx), S, noise=(t32(z), t32(eps)))
    assert got.shape == (S, H, T)
    _close_max(got, want, 1e-4, 1e-5)
    # off the future grid the Matheron form is NaN, as JAX's
    with torch.no_grad():
        bad = tstate.sample_forecast(t32(x[:H]), 2)
    assert torch.isnan(bad).all()
    jdense = jstate.sample(key, j32(tx), (S,))
    zd = jax.random.normal(key, (S, H * T), jnp.float32)
    with torch.no_grad():
        dense = tstate.sample(t32(tx), (S,), noise=t32(zd))
        jmean, _ = jstate.posterior(j32(tx))
        mean, _ = tstate.posterior(t32(tx))
    _close_max(mean, jmean, 1e-4, 1e-5)
    _close_max(dense, jdense, 1e-3, 1e-4)


# --- MultitaskVariationalGP ---------------------------------------------------------


@pytest.fixture(scope="module", params=["tridiag", "full"])
def mtv(request, data):
    """JAX's random init and its Laplace init of one family."""
    q = request.param
    jm = JMTVGP(T, q=q)
    lik = JLik(param="exp")
    p0 = jm.init(j32(data["x"]), key=jax.random.key(5))
    p1 = jm.initialize_variational_parameters(p0, lik, {}, j32(data["x"]),
                                              j32(data["yy"]))
    return q, jm, jax_tree_np(p0), jax_tree_np(p1)


def test_variational_init(data, mtv):
    q, _, p0, p1 = mtv
    tm = load_jax_params(MultitaskVariationalGP(T, q=q), p0)
    tm.initialize_variational_parameters(
        VolatilityGaussianLikelihood(param="exp"), t32(data["x"]),
        t32(data["yy"]))
    _tree_close(params_tree(tm), p1, 1e-4)


def test_variational_elbo_gradient_and_predict(data, mtv):
    q, jm, _, p1 = mtv
    x, yy, tx = data["x"], data["yy"], _grid(H, N + 1)
    lik = JLik(param="exp")
    jp = jax.tree.map(jnp.asarray, p1)
    want, jg = jax.value_and_grad(
        lambda p: jm.elbo(p, j32(x), j32(yy), lik, {}))(jp)
    tm = load_jax_params(MultitaskVariationalGP(T, q=q), p1)
    got = tm.elbo(t32(x), t32(yy), VolatilityGaussianLikelihood(param="exp"))
    got.backward()
    close(got, want, 1e-4)
    _grads_close(tm, jg, 1e-3)
    jmean, jcov = jm.predict(jp, j32(x), j32(tx))
    with torch.no_grad():
        mean, cov = tm.predict(t32(x), t32(tx))
    _close_max(mean, jmean, 1e-4)
    _close_max(cov, jcov, 1e-4, 1e-5)


def test_tridiag_family_equals_full_in_float64():
    """The port's counterpart of ``tools/tridiag_family_equiv.py`` (run by
    ``tests/test_multitask.py``'s ``test_equivalence_float64``): its
    inputs (``default_rng(11)``, n=14, T=3) in float64, one distribution
    in both families, the tridiagonal precision's bidiagonal factor
    ``(d, e)`` and the full root ``chol((L L^T)^{-1})``.  Held at the JAX
    payload's tolerances; measured here: KL 2.7e-16 (tol 1e-10), marginal
    variances 4.4e-16 (1e-10), predictive mean 0 (1e-9) and covariance
    4.4e-16 (1e-8), ELBO under the cv likelihood 1.6e-16 (1e-9)."""
    f64 = torch.float64
    rng = np.random.default_rng(11)
    n, t = 14, 3
    x = torch.tensor(np.sort(rng.uniform(0.01, 1.0, n)))
    d = rng.uniform(0.5, 2.0, n)
    e = rng.uniform(-0.3, 0.3, n - 1)
    low = np.diag(d) + np.diag(e, -1)
    rx = np.linalg.cholesky(np.linalg.inv(low @ low.T))
    rt = np.tril(rng.uniform(0.2, 1.0, (t, t))) + np.eye(t)
    shared = {"variational_mean": rng.normal(0, 1, (n, t)),
              "variational_task_covar_root": rt,
              "mean_constants": rng.normal(0, 0.5, t)}
    mod_f = MultitaskVariationalGP(t).init(x, dtype=f64)
    mod_q = MultitaskVariationalGP(t, q="tridiag").init(x, dtype=f64)
    for mod, own in ((mod_f, {"variational_covar_root": rx}),
                     (mod_q, {"q_log_d": np.log(d), "q_e": e})):
        for k, v in {**shared, **own}.items():
            setattr(mod, k, torch.nn.Parameter(torch.tensor(v, dtype=f64)))
    mod_q.data_kernel.load_state_dict(mod_f.data_kernel.state_dict())
    mod_q.index_kernel.load_state_dict(mod_f.index_kernel.state_dict())

    def rel(a, b):
        return float(torch.max(torch.abs(a - b) / torch.abs(b)))

    with torch.no_grad():
        assert rel(mod_q.kl_divergence(x), mod_f.kl_divergence(x)) < 1e-10
        assert rel(mod_q.marginal_variances(),
                   mod_f.marginal_variances()) < 1e-10
        test_x = x[-1] + torch.tensor([0.05, 0.11, 0.2], dtype=f64)
        (m_f, c_f), (m_q, c_q) = (mod_f.predict(x, test_x),
                                  mod_q.predict(x, test_x))
        assert float(torch.max(torch.abs(m_q - m_f))) < 1e-9
        assert float(torch.max(torch.abs(c_q - c_f))) < 1e-8
        lik = VolatilityGaussianLikelihood().init(dtype=f64)
        y = torch.tensor(rng.normal(0, 0.3, (n, t)))
        assert rel(mod_q.elbo(x, y, lik), mod_f.elbo(x, y, lik)) < 1e-9


# --- the training entries, the rollout, Volt -------------------------------------


def _jax_gpcv_init(x, yy, key, q="full"):
    jm, lik = JMTVGP(T, q=q), JLik(param="exp")
    p = jm.initialize_variational_parameters(jm.init(j32(x), key=key), lik,
                                             {}, j32(x), j32(yy))
    return {"model": jax_tree_np(p), "lik": {}}


def test_learn_gpcv_multitask(data):
    x, f, yy = data["x"], data["prices"], data["yy"]
    key = jax.random.key(9)
    want = jtrain.learn_gpcv_multitask(j32(x), j32(f), 10, key=key)
    got, (model, lik) = ttrain.learn_gpcv_multitask(
        t32(x), t32(f), 10, return_model=True,
        init_params=_jax_gpcv_init(x, yy, key))
    assert got.shape == (T, N) and isinstance(model, MultitaskVariationalGP)
    close(got, want, 1e-3)


def test_learn_gpcv_multitask_cv(data):
    """The cv likelihood: the mixture triplets trained with the variational
    GP, the init's latent from inverting the mixture and its curvature
    from the autodiff Hessian; JAX's initial values loaded."""
    x, f, yy = data["x"], data["prices"], data["yy"]
    key = jax.random.key(10)
    want = jtrain.learn_gpcv_multitask(j32(x), j32(f), 5, key=key,
                                       param="cv", q="tridiag")
    jm, lik = JMTVGP(T, q="tridiag"), JLik(param="cv")
    lp = lik.init(key=key)
    p0 = jm.init(j32(x), key=key)
    p = jm.initialize_variational_parameters(p0, lik, lp, j32(x), j32(yy))
    # the port's own cv Laplace init from JAX's random values
    tm = load_jax_params(MultitaskVariationalGP(T, q="tridiag"),
                         jax_tree_np(p0))
    tlik = load_jax_params(VolatilityGaussianLikelihood(param="cv"),
                           jax_tree_np(lp))
    tm.initialize_variational_parameters(tlik, t32(x), t32(yy))
    _tree_close(params_tree(tm), jax_tree_np(p), 1e-4)
    got = ttrain.learn_gpcv_multitask(
        t32(x), t32(f), 5, param="cv", q="tridiag",
        init_params=jax_tree_np({"model": p, "lik": lp}))
    close(got, want, 1e-3)


@pytest.fixture(scope="module")
def volt_mt(data):
    """``train_volt_multitask`` both ways, on JAX's initial values."""
    x, f = data["x"], data["prices"]
    vols = np.exp(data["log_vols"].T).astype(np.float32)  # (T, N)
    key = jax.random.key(4)
    jvolt, jmt = jtrain.train_volt_multitask(j32(x), j32(f[:, 1:]),
                                             j32(vols), 20, 20, key=key)
    init = {"vol": jax_tree_np(JMTBMGP(T).init(key=key))}
    tvolt, tmt = ttrain.train_volt_multitask(t32(x), t32(f[:, 1:]),
                                             t32(vols), 20, 20,
                                             init_params=init)
    return (jvolt, jmt), (tvolt, tmt)


def test_train_volt_multitask(volt_mt):
    (jvolt, jmt), (tvolt, tmt) = volt_mt
    close(params_tree(tmt.module), jax_tree_np(jmt.params), 1e-3, 1e-5)
    close(tvolt.module.likelihood.raw_noise,
          jvolt.params["likelihood"]["raw_noise"], 1e-3)
    close(tvolt.log_vol_path, jvolt.log_vol_path, 1e-6)


@pytest.mark.parametrize("grid", ["future", "overlap"])
def test_rollouts_multitask(data, volt_mt, grid):
    """The Matheron path on a future grid, the dense one otherwise, each
    given JAX's normals, with and without mean reversion."""
    (jvolt, jmt), (tvolt, tmt) = volt_mt
    f = data["prices"]
    tx = _grid(H, N + 1) if grid == "future" else _grid(H, N - 2)
    key = jax.random.key(8)
    theta = 0.5 if grid == "future" else None
    want = j_rollouts(key, jvolt, jmt, j32(f), j32(tx), S, theta=theta)
    k_vol, k_z = jax.random.split(key)
    if grid == "future":
        k0, k1 = jax.random.split(k_vol)
        noise = {"vol_z": jax.random.normal(k0, (S, N + H, T)),
                 "vol_eps": jax.random.normal(k1, (S, N, T))}
    else:
        noise = {"vol": jax.random.normal(k_vol, (S, H * T))}
    noise["zs"] = jax.random.normal(k_z, (T, S, H))
    got = rollouts_multitask(None, tvolt, tmt, t32(f), t32(tx), S,
                             theta=theta,
                             noise={k: t32(v) for k, v in noise.items()})
    assert got.shape == (T, S, H)
    close(got, want, 2e-3, 1e-3)


def test_volt_with_task_data(data):
    """``Volt`` on ``(T, n)`` log prices runs the multitask chain: its
    ``Train`` and ``Forecast`` equal the entries called in turn with the
    same generator."""
    x_full = _grid(N + 1, 0)
    log_data = np.log(data["prices"])
    v = Volt(t32(x_full), t32(log_data), mean="ewma", k=10)
    v.Train(gpcv_iters=5, vol_mod_iters=5, data_mod_iters=5,
            generator=torch.Generator().manual_seed(1))
    paths = v.Forecast(t32(_grid(H, N + 1)), nsample=S,
                       generator=torch.Generator().manual_seed(2))
    assert paths.shape == (T, S, H) and torch.isfinite(paths).all()
    g = torch.Generator().manual_seed(1)
    prices = t32(log_data).exp()
    vol = ttrain.learn_gpcv_multitask(t32(x_full[1:]), prices, 5,
                                      generator=g)
    volt, mt = ttrain.train_volt_multitask(t32(x_full[1:]), prices[:, 1:],
                                           vol, 5, 5, k=10, generator=g)
    again = rollouts_multitask(torch.Generator().manual_seed(2), volt, mt,
                               prices, t32(_grid(H, N + 1)), S)
    close(paths, again, 0.0)
    close(v.model.log_vol_path, volt.log_vol_path, 0.0)


# --- the pipeline -------------------------------------------------------------------


STD = dict(gpcv_iters=12, vol_iters=12, data_iters=12, nsample=S,
           output="quantiles")


def jax_multitask_init(key, x, prices, config):
    """JAX's cold initial values of ``volt_tpu.parallel.fit_forecast_multitask``
    for ``prices (T, n+1)``, as its pipeline draws them from ``key`` inside
    its compiled program: ``(k_lik, k_roll)``; the likelihood, the
    variational GP's init and the vol GP's from ``k_lik``; the Volt models'
    broadcast over tasks."""
    tasks = prices.shape[0]
    lik = JLik(param=config.gpcv_param)
    jm = JMTVGP(tasks, rank=config.rank, q=config.gpcv_q)
    volt = JVolt(mean=j_make_mean(config.mean_func, k=config.k,
                                  theta=config.theta))

    @jax.jit
    def init(key, x, prices):
        k_lik, _ = jax.random.split(key)
        yy = jtrain.scaled_returns(x, prices).T
        lp = lik.init(key=k_lik)
        p = jm.initialize_variational_parameters(jm.init(x, key=k_lik), lik,
                                                 lp, x, yy)
        return {
            "gpcv": {"model": p, "lik": lp},
            "vol": JMTBMGP(tasks, rank=config.rank).init(key=k_lik),
            "volt": jax.tree.map(
                lambda a: jnp.broadcast_to(a, (tasks, *a.shape)),
                volt.init())}

    return jax_tree_np(init(key, j32(x), j32(prices)))


@pytest.fixture(scope="module")
def pipeline_runs(data):
    x, f, tx = data["x"], data["prices"], _grid(H, N + 1)
    key = jax.random.key(0)
    runs = {}
    for q in ("tridiag", "full"):
        cfg = JConfig(gpcv_q=q, **STD)
        jout, jaux = j_fit(key, j32(x), j32(f), j32(tx), cfg)
        out, aux = fit_forecast_multitask(
            None, t32(x), t32(f), t32(tx),
            MultitaskPipelineConfig(gpcv_q=q, **STD),
            init_params=jax_multitask_init(key, x, f, cfg),
            noise=jax_multitask_noise(key, T, N, S, H))
        runs[q] = (np.asarray(jout), jax_tree_np(jaux)), (out, aux)
    return runs


@pytest.mark.parametrize("q", ["tridiag", "full"])
def test_pipeline_cold(pipeline_runs, q):
    (jout, jaux), (out, aux) = pipeline_runs[q]
    # the dense family's ELBO after 12 Adam steps is chaotic in its
    # initial values: a 1e-7 relative perturbation of them moves it by up
    # to 5e-3 (and the vols by 1.8e-4; measured on the CPU), so its loss
    # is held at 1e-2
    close(aux["gpcv_loss"], jaux["gpcv_loss"], 1e-3 if q == "tridiag"
          else 1e-2)
    for key in ("vol_loss", "data_losses", "vols"):
        close(aux[key], jaux[key], 1e-3)
    assert out.shape == jout.shape == (T, 7, H)
    close(out, jout, 2e-3, 1e-3)
    for key in ("forecast_mean", "forecast_std"):
        close(aux[key], jaux[key], 2e-3, 1e-3)
    assert aux["ok"].tolist() == jaux["ok"].tolist() == [True] * T
    assert aux["data_loss_trajs"].shape == (T, STD["data_iters"])
    close(aux["vol_params"], jaux["vol_params"], 1e-3, 1e-4)
    # the four stages, and the Matheron sampler's part of the rollout
    assert set(aux["stage_seconds"]) == {"gpcv", "vol", "data", "rollout",
                                         "sample_vol"}


@pytest.mark.parametrize("shift", [0, 1])
def test_warm_start(data, pipeline_runs, shift):
    """A warm refit (6 steps a stage) from the tridiagonal cold fit, on the
    window slid by ``shift``, against JAX's from its own cold fit."""
    (_, jaux), (_, aux) = pipeline_runs["tridiag"]
    f = sabr_paths(steps=N + 1 + shift, seed=41, n_paths=T)[0][:, shift:]
    x, tx = data["x"], _grid(H, N + 1)
    key = jax.random.key(1)
    jw = j_warm(jax.tree.map(jnp.asarray, jaux), shift=shift, n=N)
    tw = warm_start_multitask(aux, shift=shift, n=N)
    close(tw["gpcv"], jax_tree_np(jw["gpcv"]), 1e-3, 1e-5)
    cfg = dict(STD, gpcv_iters=6, vol_iters=6, data_iters=6)
    jout, jaux2 = j_fit(key, j32(x), j32(f), j32(tx), JConfig(**cfg),
                        init_params=jw)
    out, aux2 = fit_forecast_multitask(
        None, t32(x), t32(f), t32(tx), MultitaskPipelineConfig(**cfg),
        init_params=tw, noise=jax_multitask_noise(key, T, N, S, H))
    for k in ("gpcv_loss", "vol_loss", "vols"):
        close(aux2[k], np.asarray(jaux2[k]), 1e-3)
    close(out, np.asarray(jout), 2e-3, 1e-3)
    with pytest.raises(ValueError, match="needs n"):
        warm_start_multitask(aux, shift=1)


def test_config_checks(data):
    x, f, tx = t32(data["x"]), t32(data["prices"]), t32(_grid(H, N + 1))
    for bad in ({"gpcv_q": "banded"}, {"output": "paths"}):
        with pytest.raises(ValueError):
            fit_forecast_multitask(None, x, f, tx,
                                   MultitaskPipelineConfig(**bad))
    irregular = x.clone()
    irregular[5] += 0.3 * DT
    with pytest.raises(ValueError, match="equispaced"):
        fit_forecast_multitask(None, irregular, f, tx,
                               MultitaskPipelineConfig())

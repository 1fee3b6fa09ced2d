"""The GPCV families of the port against the JAX package's, on the same
numpy inputs and parameters (JAX's random cv triplets and its dense roots
carried by ``volt_tpu_torch.convert``): the BM closed forms and
``mvn_kl``; the cv likelihood; the dense variational engine and its
Laplace inits; ``GPCVModel`` with ``q="full"``, the cv likelihood, the
sparse form and prediction onto test grids; the per-lane Cholesky ladder
against ``jax.vmap``; NGVI with the cv hyperparameters; ``learn_gpcv``
and ``learn_gpcv_sparse``; the pipeline with ``gpcv_q="full"`` and its
warm start.

Tolerances (float32): closed forms rtol 1e-5 / atol 1e-6 (of the largest
value where a sum cancels); ELBO values and gradients at init rtol 1e-4;
Laplace inits compared on ``S = R R^T`` at rtol 1e-3 (three Cholesky
factorisations in two libraries); short fits, with Adam's or NGVI's steps
on top, rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_pipeline_noise, jax_tree_np, t32

from volt_tpu import train as jtrain
from volt_tpu.data import sabr_paths
from volt_tpu.gp import variational as jvar
from volt_tpu.gp.natural import ngvi_tridiag_fit as j_ngvi
from volt_tpu.likelihoods import VolatilityGaussianLikelihood as JLik
from volt_tpu.models.gpcv import GPCVModel as JGPCV
from volt_tpu.ops import brownian as jbm
from volt_tpu.ops import chol as jchol
from volt_tpu.ops.mvn import mvn_kl as j_mvn_kl
from volt_tpu.parallel import PipelineConfig as JConfig
from volt_tpu.parallel import fit_forecast_batch as j_fit
from volt_tpu.parallel import warm_start as j_warm_start

from volt_tpu_torch import train as ttrain
from volt_tpu_torch.convert import load_jax_params, params_tree
from volt_tpu_torch.gp import variational as tvar
from volt_tpu_torch.gp.natural import ngvi_tridiag_fit
from volt_tpu_torch.likelihoods import VolatilityGaussianLikelihood
from volt_tpu_torch.models import GPCVModel, GPCVState
from volt_tpu_torch.ops import brownian as tbm
from volt_tpu_torch.ops import chol as tchol
from volt_tpu_torch.ops.mvn import mvn_kl
from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                     warm_start)
from volt_tpu_torch.parallel.pipeline import _resolve_config

RTOL, ATOL = 1e-5, 1e-6
B, N, DT = 2, 40, 1.0 / 252


def _grid(n, start=1):
    return (np.arange(start, n + start, dtype=np.float32)
            * np.float32(DT)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    f, _ = sabr_paths(steps=N + 1, seed=21, n_paths=B)
    x = _grid(N)
    yy = np.asarray(jtrain.scaled_returns(j32(x), j32(f)))
    return {"x": x, "prices": f.astype(np.float32), "yy": yy}


def _close_max(got, want, rtol):
    """rtol, with atol 1e-6 of the largest magnitude (sums that cancel)."""
    want = np.asarray(want)
    close(got, want, rtol, 1e-6 * float(np.max(np.abs(want))))


def _grads_close(module, jgrads, rtol):
    for path, p in module.named_parameters():
        g = jgrads
        for part in path.split("."):
            g = g[part]
        _close_max(p.grad, g, rtol)


def _covar(root):
    r = np.tril(np.asarray(root, np.float64))
    return r @ np.swapaxes(r, -1, -2)


# --- BM closed forms and mvn_kl ----------------------------------------------

@pytest.mark.parametrize("name", ["increments", "solve_lower", "solve_upper",
                                  "solve_lower_axis", "logdet"])
def test_bm_closed_forms(name):
    rs = np.random.default_rng(0)
    x = np.cumsum(rs.uniform(0.1, 1.0, 30)).astype(np.float32)
    b = rs.standard_normal((3, 30, 30)).astype(np.float32)
    jx, tx, jb, tb = j32(x), t32(x), j32(b), t32(b)
    want, got = {
        "increments": lambda: (jbm.bm_increments(jx), tbm.bm_increments(tx)),
        "solve_lower": lambda: (jbm.bm_solve_lower(jx, jb),
                                tbm.bm_solve_lower(tx, tb)),
        "solve_upper": lambda: (jbm.bm_solve_upper(jx, jb),
                                tbm.bm_solve_upper(tx, tb)),
        "solve_lower_axis": lambda: (jbm.bm_solve_lower(jx, jb, axis=-2),
                                     tbm.bm_solve_lower(tx, tb, axis=-2)),
        "logdet": lambda: (jbm.bm_logdet(jx), tbm.bm_logdet(tx)),
    }[name]()
    close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("start", [0, 1])
def test_bm_kl_against_prior(start):
    """Against the JAX closed form (on a grid from 0 the first increment
    is floored at jitter / vol), and against ``mvn_kl`` on the dense
    factor of ``vol * min(x)``, rtol 1e-4 (float32 Cholesky of the
    prior)."""
    rs = np.random.default_rng(1)
    n = 24
    x = _grid(n, start)
    vol = np.array([[0.3], [0.05]], np.float32)
    mq = rs.standard_normal((2, n)).astype(np.float32)
    mp = rs.standard_normal((2, n)).astype(np.float32)
    cq = np.tril(0.1 * rs.standard_normal((2, n, n))).astype(np.float32)
    cq[:, np.arange(n), np.arange(n)] = rs.uniform(-0.2, 0.2, (2, n))
    want = jax.vmap(jbm.bm_kl_against_prior, (None, 0, 0, 0, 0))(
        j32(x), j32(vol), j32(mq), j32(cq), j32(mp))
    got = tbm.bm_kl_against_prior(t32(x), t32(vol), t32(mq), t32(cq),
                                  t32(mp))
    close(got, want, RTOL)
    if start:
        kuu = t32(vol)[..., None] * torch.minimum(t32(x)[:, None],
                                                  t32(x)[None, :])
        dense = mvn_kl(t32(mq), t32(cq), t32(mp), torch.linalg.cholesky(kuu))
        close(got, dense, 1e-4)


def test_mvn_kl():
    rs = np.random.default_rng(2)
    n = 12
    a = rs.standard_normal((3, n, n)).astype(np.float32)
    lp = np.linalg.cholesky(a @ np.swapaxes(a, -1, -2) / n
                            + np.eye(n)).astype(np.float32)
    lq = np.tril(rs.standard_normal((3, n, n))).astype(np.float32)
    mq, mp = (rs.standard_normal((3, n)).astype(np.float32)
              for _ in range(2))
    close(mvn_kl(t32(mq), t32(lq), t32(mp), t32(lp)),
          j_mvn_kl(j32(mq), j32(lq), j32(mp), j32(lp)), RTOL)


# --- the cv likelihood -------------------------------------------------------

@pytest.fixture(scope="module")
def cv_params():
    jl = JLik(param="cv")
    keys = jax.random.split(jax.random.key(3), B)
    p = jax_tree_np(jax.vmap(lambda k: jl.init(key=k))(keys))
    # spread the triplets over their ranges
    rs = np.random.default_rng(4)
    return {k: (v + rs.standard_normal(v.shape)).astype(np.float32)
            for k, v in p.items()}


def _tlik(params):
    return load_jax_params(VolatilityGaussianLikelihood(param="cv"), params)


def _cv_inputs(seed, n=50):
    rs = np.random.default_rng(seed)
    f = (1.5 * rs.standard_normal((B, n))).astype(np.float32)
    y = (0.3 * rs.standard_normal((B, n))).astype(np.float32)
    mean = (rs.standard_normal((B, n)) - 1.0).astype(np.float32)
    var = (10.0 ** rs.uniform(-4, 0, (B, n))).astype(np.float32)
    target = np.exp(rs.standard_normal((B, n)) - 1.0).astype(np.float32)
    return f, y, mean, var, target


@pytest.mark.parametrize("fn", ["scale", "log_prob", "hessian",
                                "inv_hessian", "latent_from_scale",
                                "expected_log_prob", "expected_scale"])
def test_cv_likelihood(cv_params, fn):
    f, y, mean, var, target = _cv_inputs(5)
    jl, tl = JLik(param="cv"), _tlik(cv_params)
    jp = cv_params
    jf = {
        "scale": lambda p, a: jl.scale(p, a[0]),
        "log_prob": lambda p, a: jl.log_prob(p, a[1], a[0]),
        "hessian": lambda p, a: jl.neg_log_prob_hessian(p, a[1], a[0]),
        "inv_hessian": lambda p, a: jl.laplace_inv_hessian(p, a[1], a[0]),
        "latent_from_scale": lambda p, a: jl.latent_from_scale(p, a[4]),
        "expected_log_prob": lambda p, a: jl.expected_log_prob(
            p, a[1], a[2], a[3]),
        "expected_scale": lambda p, a: jl.expected_scale(p, a[2], a[3]),
    }[fn]
    args = tuple(j32(a) for a in (f, y, mean, var, target))
    want = jax.jit(jax.vmap(jf))(jp, args)
    t = [t32(a) for a in (f, y, mean, var, target)]
    got = {
        "scale": lambda: tl.scale(t[0]),
        "log_prob": lambda: tl.log_prob(t[1], t[0]),
        "hessian": lambda: tl.neg_log_prob_hessian(t[1], t[0]),
        "inv_hessian": lambda: tl.laplace_inv_hessian(t[1], t[0]),
        "latent_from_scale": lambda: tl.latent_from_scale(t[4]),
        "expected_log_prob": lambda: tl.expected_log_prob(t[1], t[2], t[3]),
        "expected_scale": lambda: tl.expected_scale(t[2], t[3]),
    }[fn]()
    if fn == "inv_hessian":
        # the inverse of a curvature that cancels: compared as the clamped
        # curvature it inverts, at the Hessian's tolerance
        got, want = 1.0 / got, 1.0 / np.asarray(want)
    _close_max(got, want, RTOL)
    if fn == "latent_from_scale":  # and it inverts the scale
        close(tl.scale(got), np.maximum(target, 1e-3), 1e-4)


def test_cv_expected_log_prob_gradients(cv_params):
    """d/d(raw triplets, mean, var) of the GH-75 term, rtol 1e-4."""
    _, y, mean, var, _ = _cv_inputs(6)
    jl = JLik(param="cv")

    def jsum(p, m, v):
        return jnp.sum(jax.vmap(lambda pp, yy, mm, vv: jl.expected_log_prob(
            pp, yy, mm, vv))(p, j32(y), m, v))

    gp, gm, gv = jax.jit(jax.grad(jsum, (0, 1, 2)))(cv_params, j32(mean),
                                                    j32(var))
    tl = _tlik(cv_params)
    m, v = t32(mean).requires_grad_(), t32(var).requires_grad_()
    tl.expected_log_prob(t32(y), m, v).sum().backward()
    for name in ("raw_a", "raw_b", "raw_c"):
        _close_max(getattr(tl, name).grad, gp[name], 1e-4)
    _close_max(m.grad, gm, 1e-4)
    _close_max(v.grad, gv, 1e-4)


def test_cv_clamped_scale():
    """Where the mixture is below 1e-3 the scale is the clamp, with zero
    curvature and zero derivative, in both packages."""
    p = {"raw_a": np.full((B, 5), -25.0, np.float32),
         "raw_b": np.zeros((B, 5), np.float32),
         "raw_c": np.zeros((B, 5), np.float32)}
    f, y, *_ = _cv_inputs(7, 20)
    jl, tl = JLik(param="cv"), _tlik(p)
    close(tl.scale(t32(f)), np.full(f.shape, 1e-3, np.float32), 0.0)
    want = jax.jit(jax.vmap(lambda pp, yy, ff: jl.neg_log_prob_hessian(
        pp, yy, ff)))(p, j32(y), j32(f))
    close(tl.neg_log_prob_hessian(t32(y), t32(f)), want, 0.0)
    assert not np.any(np.asarray(want))


def test_likelihood_defaults_and_init():
    lik = VolatilityGaussianLikelihood()
    assert (lik.param, lik.K, lik.batch_shape) == ("cv", 5, ())
    lik.init((3,), generator=torch.Generator().manual_seed(1))
    assert {n for n, _ in lik.named_parameters()} == {"raw_a", "raw_b",
                                                      "raw_c"}
    assert lik.raw_a.shape == (3, 5) and 0 <= float(lik.raw_b.max()) < 0.1
    again = VolatilityGaussianLikelihood(batch_shape=(3,)).init(
        generator=torch.Generator().manual_seed(1))
    close(again.raw_c, lik.raw_c.detach(), 0.0)
    assert not list(VolatilityGaussianLikelihood(param="exp").init(
        (3,)).parameters())
    with pytest.raises(ValueError):
        VolatilityGaussianLikelihood(param="softplus")
    with pytest.raises(ValueError):
        lik.expected_log_prob(*(torch.ones(3, 4),) * 3, method="analytic")


# --- the dense variational engine --------------------------------------------

def _dense_inputs(seed, n=20, m=12):
    rs = np.random.default_rng(seed)
    x = _grid(n)
    xu = x[np.linspace(0, n - 1, m).round().astype(int)]
    vol = np.float32(0.2)
    kuu = (vol * np.minimum(xu[:, None], xu[None, :])).astype(np.float32)
    kux = (vol * np.minimum(xu[:, None], x[None, :])).astype(np.float32)
    kxx = (vol * np.minimum(x[:, None], x[None, :])).astype(np.float32)
    state = ((rs.standard_normal((B, m)) - 1.0).astype(np.float32),
             np.tril(0.05 * rs.standard_normal((B, m, m))
                     + 0.1 * np.eye(m)).astype(np.float32))
    y = (0.2 * rs.standard_normal((B, m))).astype(np.float32)
    pu = np.full((B, m), -1.2, np.float32)
    px = np.full((B, n), -1.2, np.float32)
    return kuu, kux, kxx, state, y, pu, px


def _exp_ell(y, m, v):
    return -0.5 * y * y * jnp.exp(-2.0 * m + 2.0 * v) - m


def _exp_ell_t(y, m, v):
    return -0.5 * y * y * torch.exp(-2.0 * m + 2.0 * v) - m


@pytest.mark.parametrize("what", ["predict_diag", "predict_full",
                                  "predict_whitened", "elbo", "elbo_whitened"])
def test_variational_engine(what):
    kuu, kux, kxx, (m, r), y, pu, px = _dense_inputs(8)
    js = jvar.VariationalState(j32(m), j32(r))
    ts = tvar.VariationalState(t32(m), t32(r))
    if what == "predict_diag":
        want = jax.vmap(lambda s, a, b: jvar.variational_predict(
            s, a, j32(kuu), j32(kux), b, kxx_diag=j32(np.diag(kxx))))(
            js, j32(pu), j32(px))
        got = tvar.variational_predict(ts, t32(pu), t32(kuu), t32(kux),
                                       t32(px), kxx_diag=t32(np.diag(kxx)))
    elif what == "predict_full":
        want = jax.vmap(lambda s, a, b: jvar.variational_predict(
            s, a, j32(kuu), j32(kux), b, kxx=j32(kxx)))(js, j32(pu), j32(px))
        got = tvar.variational_predict(ts, t32(pu), t32(kuu), t32(kux),
                                       t32(px), kxx=t32(kxx))
    elif what == "predict_whitened":
        want = jax.vmap(lambda s, b: jvar.variational_predict_whitened(
            s, j32(kuu), j32(kux), b, kxx_diag=j32(np.diag(kxx))))(
            js, j32(px))
        got = tvar.variational_predict_whitened(
            ts, t32(kuu), t32(kux), t32(px), kxx_diag=t32(np.diag(kxx)))
    elif what == "elbo":
        want = jax.vmap(lambda s, a, yy: jvar.elbo_at_inducing(
            s, a, j32(kuu), yy, _exp_ell))(js, j32(pu), j32(y))
        got = tvar.elbo_at_inducing(ts, t32(pu), t32(kuu), t32(y), _exp_ell_t)
    else:
        want = jax.vmap(lambda s, a, yy: jvar.elbo_at_inducing_whitened(
            s, a, j32(kuu), yy, _exp_ell))(js, j32(pu), j32(y))
        got = tvar.elbo_at_inducing_whitened(ts, t32(pu), t32(kuu), t32(y),
                                             _exp_ell_t)
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close_max(g, w, 1e-4)
    else:
        close(got, want, 1e-4)


@pytest.mark.parametrize("exp_hessian", ["reference", "diag", "cv"])
def test_laplace_initialize(data, exp_hessian):
    """On ``S = R R^T`` at rtol 1e-3; the mean and constant exactly."""
    x, yy = data["x"], data["yy"]
    kuu = (0.2 * np.minimum(x[:, None], x[None, :])).astype(np.float32)
    inv_hess = None
    if exp_hessian == "cv":
        inv_hess = np.random.default_rng(9).uniform(1e-3, 1.0, yy.shape
                                                    ).astype(np.float32)

    def jinit(y, ih):
        if ih is None:
            return jvar.laplace_initialize(j32(kuu), y,
                                           exp_hessian=exp_hessian)
        return jvar.laplace_initialize(j32(kuu), y, f=jnp.log(jnp.abs(y)),
                                       inv_hess=ih)

    if inv_hess is None:
        (jm, jr), jc = jax.jit(jax.vmap(lambda y: jinit(y, None)))(j32(yy))
        (tm, tr), tc = tvar.laplace_initialize(t32(kuu), t32(yy),
                                               exp_hessian=exp_hessian,
                                               per_lane=True)
        close(tc, jc, RTOL)
    else:
        (jm, jr), _ = jax.jit(jax.vmap(jinit))(j32(yy), j32(inv_hess))
        (tm, tr), tc = tvar.laplace_initialize(
            t32(kuu), t32(yy), f=torch.log(torch.abs(t32(yy))),
            inv_hess=t32(inv_hess), per_lane=True)
        assert tc is None
    close(tm, jm, RTOL)
    _close_max(_covar(tr.numpy()), _covar(jr), 1e-3)
    with pytest.raises(ValueError):
        tvar.laplace_initialize(t32(kuu), t32(yy), exp_hessian="dense")


# --- the per-lane jitter ladder ----------------------------------------------

def test_cholesky_ladder_per_lane():
    """One lane of three needs jitter (a BM Gram on a grid from 0 is
    singular).  ``per_lane=True`` equals ``jax.vmap`` of the JAX function:
    the good lanes keep their bare factors.  The whole-batch ladder equals
    the JAX function on the batch: every lane takes the jitter."""
    rs = np.random.default_rng(10)
    n = 8
    a = rs.standard_normal((3, n, n))
    mats = 1e-3 * (a @ np.swapaxes(a, -1, -2) / n + np.eye(n))
    x0 = _grid(n, 0)
    mats[1] = 1e-3 * np.minimum(x0[:, None], x0[None, :]) / DT
    mats = mats.astype(np.float32)
    want_lane = jax.vmap(jchol.psd_safe_cholesky)(j32(mats))
    want_batch = jchol.psd_safe_cholesky(j32(mats))
    got_lane = tchol.psd_safe_cholesky(t32(mats), per_lane=True)
    got_batch = tchol.psd_safe_cholesky(t32(mats))
    close(got_lane, want_lane, RTOL, ATOL * 1e-3)
    close(got_batch, want_batch, RTOL, ATOL * 1e-3)
    # the lanes that needed no jitter differ between the two ladders
    bare = np.linalg.cholesky(mats[[0, 2]].astype(np.float64))
    close(got_lane[[0, 2]], bare, RTOL, ATOL * 1e-3)
    assert not np.allclose(got_batch[[0, 2]].numpy(), bare, rtol=1e-4)
    # the gradient is the Cholesky adjoint of the factor produced
    m = t32(mats).requires_grad_()
    tchol.psd_safe_cholesky(m, per_lane=True).sum().backward()
    g = jax.grad(lambda q: jnp.sum(jax.vmap(jchol.psd_safe_cholesky)(q)))(
        j32(mats))
    _close_max(m.grad, g, 1e-4)


# --- GPCVModel: the dense family, the cv likelihood, sparse, prediction ------

def _jax_gpcv_params(x, yy, **kw):
    jm = JGPCV(kernel="bm", **kw)
    keys = jax.random.split(jax.random.key(12), yy.shape[0])
    return jm, jax_tree_np(jax.jit(jax.vmap(
        lambda y, k: jm.init(j32(x), y, key=k)))(j32(yy), keys))


FAMILIES = [dict(q="full"), dict(q="full", param="cv"),
            dict(q="tridiag", param="cv")]
FAMILY_IDS = ["full-exp", "full-cv", "tridiag-cv"]


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_gpcv_init(data, kw):
    jm, want = _jax_gpcv_params(data["x"], data["yy"], **kw)
    tm = GPCVModel(**kw).init(t32(data["x"]), t32(data["yy"]), per_lane=True,
                              likelihood_params=want["likelihood"])
    got = params_tree(tm)
    if kw["q"] == "full":
        _close_max(_covar(got.pop("chol_variational_covar").numpy()),
                   _covar(want.pop("chol_variational_covar")), 1e-3)
    close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
def test_gpcv_elbo_and_gradient(data, kw):
    x, yy = data["x"], data["yy"]
    jm, params = _jax_gpcv_params(x, yy, **kw)

    def jelbo(p):
        return jax.vmap(lambda pp, y: jm.elbo(pp, j32(x), y))(p, j32(yy))

    want, grads = jax.jit(lambda p: (jelbo(p), jax.grad(
        lambda q: jnp.sum(jelbo(q)))(p)))(params)
    tm = load_jax_params(GPCVModel(**kw), params)
    elbo = tm.elbo(t32(x), t32(yy))
    close(elbo, want, 1e-4)
    elbo.sum().backward()
    _grads_close(tm, grads, 1e-4)


@pytest.mark.parametrize("param", ["exp", "cv"])
def test_gpcv_sparse_init_and_elbo(param):
    """Inducing points every fourth train point.  On a grid from dt: from
    0 the prior is singular at the first point, and the gradients through
    its jittered factor (condition about 6e4) differ by float32 rounding
    alone (``test_learn_gpcv_sparse`` runs that grid)."""
    f, _ = sabr_paths(steps=81, seed=22, n_paths=B)
    x = _grid(80)
    yy = np.asarray(jtrain.scaled_returns(j32(x), j32(f)))
    xu = x[::4]
    jm = JGPCV(kernel="bm", param=param)
    keys = jax.random.split(jax.random.key(13), B)
    want = jax_tree_np(jax.jit(jax.vmap(lambda y, k: jm.init_sparse(
        j32(x), j32(xu), y, key=k)))(j32(yy), keys))
    tm = GPCVModel(param=param).init_sparse(
        t32(x), t32(xu), t32(yy), likelihood_params=want["likelihood"])
    got = params_tree(tm)
    _close_max(_covar(got.pop("chol_variational_covar").numpy()),
               _covar(want["chol_variational_covar"]), 1e-3)
    close(got, {k: v for k, v in want.items()
                if k != "chol_variational_covar"}, RTOL, ATOL)

    def jelbo(p):
        return jax.vmap(lambda pp, y: jm.elbo_sparse(pp, j32(x), j32(xu), y))(
            p, j32(yy))

    jval, grads = jax.jit(lambda p: (jelbo(p), jax.grad(
        lambda q: jnp.sum(jelbo(q)))(p)))(want)
    tm = load_jax_params(GPCVModel(param=param), want)
    elbo = tm.elbo_sparse(t32(x), t32(xu), t32(yy))
    close(elbo, jval, 1e-4)
    elbo.sum().backward()
    _grads_close(tm, grads, 1e-4)


@pytest.mark.parametrize("q", ["full", "tridiag"])
def test_gpcv_prediction_on_test_grid(data, q):
    """``latent_marginals`` and ``predicted_scale`` at points between and
    after the train points (``_predict_tridiag`` for the tridiagonal q),
    from perturbed parameters; the variance, a float32 cancellation, at
    atol 1e-6 of its largest value."""
    x, yy = data["x"], data["yy"]
    jm, params = _jax_gpcv_params(x, yy, q=q)
    rs = np.random.default_rng(14)
    params = jax.tree.map(lambda a: (a + 0.02 * rs.standard_normal(a.shape))
                          .astype(np.float32), params)
    tx = np.concatenate([x[5:15] + np.float32(DT / 3),
                         x[-1] + np.float32(DT) * np.arange(1, 6)]
                        ).astype(np.float32)
    want_m, want_v, want_s = jax.jit(jax.vmap(lambda p: (
        *jm.latent_marginals(p, j32(x), j32(tx)),
        jm.predicted_scale(p, j32(x), j32(tx)))))(params)
    tm = load_jax_params(GPCVModel(q=q), params)
    with torch.no_grad():
        got_m, got_v = tm.latent_marginals(t32(x), t32(tx))
        got_s = tm.predicted_scale(t32(x), t32(tx))
    _close_max(got_m, want_m, 1e-4)
    _close_max(got_v, want_v, 1e-4)
    _close_max(got_s, want_s, 1e-4)
    state = GPCVState(module=tm, train_x=t32(x), targets=t32(yy))
    close(state.latent_marginals(t32(tx))[0], got_m, 0.0)


def test_gpcv_constructor_defaults_and_errors():
    m = GPCVModel()
    assert (m.q, m.likelihood.param) == ("full", "exp")
    fbm = GPCVModel(kernel="fbm")
    assert (fbm.q, type(fbm.kernel).__name__) == ("full", "FBMKernel")
    with pytest.raises(ValueError):
        GPCVModel(q="banded")


# --- NGVI with the cv likelihood ---------------------------------------------

def test_ngvi_cv_hyperparameters(data):
    """NGVI's hyperparameter step takes the cv triplets and the ELL term:
    5 iterations, losses, mean and triplets at rtol 1e-3."""
    x, yy = data["x"], data["yy"]
    jm, params = _jax_gpcv_params(x, yy, q="tridiag", param="cv")
    jp, jl = jax.jit(jax.vmap(lambda p, y: j_ngvi(jm, p, j32(x), y, 5)))(
        params, j32(yy))
    tm = load_jax_params(GPCVModel(q="tridiag", param="cv"), params)
    losses = ngvi_tridiag_fit(tm, t32(x), t32(yy), 5)
    _close_max(losses.T, jl, 1e-3)
    _close_max(tm.variational_mean, jp["variational_mean"], 1e-3)
    for name in ("raw_a", "raw_b", "raw_c"):
        _close_max(getattr(tm.likelihood, name), jp["likelihood"][name], 1e-3)
        assert not np.allclose(jp["likelihood"][name],
                               params["likelihood"][name])


# --- the training entries ----------------------------------------------------

@pytest.mark.parametrize("kw,iters,rtol", [(dict(q="full"), 20, 1e-3),
                                           (dict(q="full", param="cv"), 10,
                                            3e-3),
                                           (dict(param="cv"), 5, 1e-3)],
                         ids=["full-exp", "full-cv", "tridiag-cv-ngvi"])
def test_learn_gpcv_families(data, kw, iters, rtol):
    """One series (the JAX entry trains one), the cv triplets from the JAX
    key's draw: predicted scale rtol 1e-3; the dense cv fit 3e-3.  The two
    inits agree to 4e-6, but Adam's first steps move each parameter by
    about ``lr`` whatever its gradient's size, so the float32 rounding of
    the gradients near zero (which agree to 1e-6 of the largest) becomes
    an ``lr``-sized difference; ``test_dense_family_float64`` holds the
    same trajectory at 1e-9 in float64."""
    x, f = data["x"], data["prices"][0]
    key = jax.random.key(15)
    want = jax.jit(lambda a, b, k: jtrain.learn_gpcv(a, b, iters, key=k,
                                                     **kw))(j32(x), j32(f),
                                                            key)
    lik = jax_tree_np(JLik(param=kw.get("param", "exp")).init(key=key))
    got, state = ttrain.learn_gpcv(t32(x), t32(f), iters, return_model=True,
                                   init_params={"likelihood": lik}, **kw)
    _close_max(got, want, rtol)
    assert state.module.q == kw.get("q", "tridiag")


def _load64(module, tree):
    """``load_jax_params`` keeping float64 (it casts to float32)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _load64(getattr(module, k), v)
        else:
            module.register_parameter(k, torch.nn.Parameter(
                torch.tensor(np.asarray(v), dtype=torch.float64)))
    return module


@pytest.mark.parametrize("param,start", [("exp", 0), ("cv", 1)])
def test_dense_family_float64(param, start):
    """20 Adam steps of the dense family in float64, the per-step losses
    within rtol 1e-9.  In float32 the two libraries' trajectories drift
    apart by rounding alone: on a grid from 0 the first increment is
    floored at jitter / vol (5e-6), and a change of 9e-8 in the root after
    one step moves the ELBO by 6e-4 relative; the cv mixture's steps
    drift past 1e-3 by 20 steps."""
    f, _ = sabr_paths(steps=33, seed=25, n_paths=B)
    x = np.arange(start, 32 + start) * DT
    with jax.enable_x64(True):
        y = jtrain.scaled_returns(jnp.asarray(x), jnp.asarray(
            f, jnp.float64))
        jm = JGPCV(kernel="bm", q="full", param=param)
        keys = jax.random.split(jax.random.key(26), B)
        params = jax.jit(jax.vmap(lambda yy, k: jm.init(
            jnp.asarray(x), yy, key=k, dtype=jnp.float64)))(y, keys)
        _, want = jax.jit(jax.vmap(lambda p, yy: jtrain._adam_scan(
            lambda q: -jm.elbo(q, jnp.asarray(x), yy), p, 20, 0.01)))(
            params, y)
        params, want, y = jax_tree_np(params), np.asarray(want), np.asarray(y)
    tm = _load64(GPCVModel(q="full", param=param), params)
    tx, ty = torch.tensor(x), torch.tensor(y)
    got = ttrain.adam_loop(tm, lambda: -tm.elbo(tx, ty), 20, 0.01)
    close(got.T, want, 1e-9)


def test_adam_is_optax():
    """``optim.Adam`` against ``optax.adam`` on the same gradients, rtol
    1e-6 / atol 1e-7 over 20 steps (XLA's pow and its compiled update
    differ by an ulp at times); its first float32 step is optax's, about
    6.7e-6 relative short of ``lr``, where ``torch.optim.Adam``'s is
    ``lr``."""
    import optax

    from volt_tpu_torch.optim import Adam

    rs = np.random.default_rng(27)
    p0 = rs.standard_normal((3, 40)).astype(np.float32)
    grads = (rs.standard_normal((20, 3, 40))
             * 10.0 ** rs.uniform(-3, 1, (20, 3, 40))).astype(np.float32)
    opt = optax.adam(0.01)

    @jax.jit
    def run(p, gs):
        def step(carry, g):
            p, st = carry
            u, st = opt.update(g, st)
            p = optax.apply_updates(p, u)
            return (p, st), p
        return jax.lax.scan(step, (p, opt.init(p)), gs)[1]

    want = np.asarray(run(j32(p0), j32(grads)))
    p = torch.nn.Parameter(t32(p0))
    adam = Adam([p], 0.01, 20)
    for i in range(20):
        p.grad = t32(grads[i])
        adam.step()
        close(p, want[i], 1e-6, 1e-7)
    # the first step from 0, as a fraction of lr
    zero = torch.nn.Parameter(torch.zeros(3, 40))
    zero.grad = t32(grads[0])
    Adam([zero], 0.01, 1).step()
    first = -zero.detach().numpy() / (0.01 * np.sign(grads[0]))
    close(first, -np.asarray(run(j32(0 * p0), j32(grads[:1])))[0]
          / (0.01 * np.sign(grads[0])), 1e-6)
    big = np.abs(grads[0]) > 0.1  # where eps is below float32 resolution
    assert np.all(np.abs(first[big] - (1 - 6.7e-6)) < 1e-6)


def test_dense_family_on_a_grid_from_0():
    """On a grid from x = 0 the dense Laplace root's first diagonal entry
    is ``10 sqrt(1e-6) = 0.01 = lr``: optax's first step leaves it about
    7e-8 off zero, and so does the port's (``torch.optim.Adam`` put it on
    0 in 3 lanes of these 16, and their losses on inf).  Two steps: every
    loss finite, within rtol 1e-3 of JAX's."""
    f, _ = sabr_paths(steps=41, seed=28, n_paths=16)
    x = _grid(40, 0)
    yy = np.asarray(jtrain.scaled_returns(j32(x), j32(f)))
    jm = JGPCV(kernel="bm", q="full")
    params = jax_tree_np(jax.jit(jax.vmap(lambda y: jm.init(j32(x), y)))(
        j32(yy)))
    _, want = jax.jit(jax.vmap(lambda p, y: jtrain._adam_scan(
        lambda q: -jm.elbo(q, j32(x), y), p, 2, 0.01)))(params, j32(yy))
    tm = load_jax_params(GPCVModel(q="full"), params)
    got = ttrain.adam_loop(tm, lambda: -tm.elbo(t32(x), t32(yy)), 3, 0.01)
    assert torch.isfinite(got).all()
    assert (tm.chol_variational_covar[:, 0, 0] != 0).all()
    close(got[:2].T, want, 1e-3)


def test_learn_gpcv_sparse():
    """n = 150 on a grid from 0, 32 inducing points, 20 Adam steps:
    predicted scale rtol 1e-3; ``return_model`` reproduces it."""
    f, _ = sabr_paths(steps=151, seed=23)
    x = _grid(150, 0)
    want = jax.jit(lambda a, b: jtrain.learn_gpcv_sparse(
        a, b, num_inducing=32, train_iters=20))(j32(x), j32(f))
    got, state = ttrain.learn_gpcv_sparse(t32(x), t32(f), num_inducing=32,
                                          train_iters=20, return_model=True)
    assert got.shape == (150,)
    _close_max(got, want, 1e-3)
    assert state.inducing_x.shape == (32,)
    with torch.no_grad():
        close(state.predicted_scale(), got, 0.0)


# --- the pipeline with the dense family --------------------------------------

PB, PN, PH, PS = 2, 48, 6, 32
PIPE = dict(gpcv_iters=20, vol_iters=20, data_iters=20, k=20, nsample=PS,
            gpcv_q="full")


@pytest.fixture(scope="module")
def pipe_data():
    f, _ = sabr_paths(steps=PN + 1, seed=24, n_paths=PB)
    x = _grid(PN)
    test_x = (x[-1] + np.float32(DT) * np.arange(1, PH + 1)).astype(
        np.float32)
    return x, f, test_x


@pytest.fixture(scope="module")
def pipe_runs(pipe_data):
    x, f, test_x = pipe_data
    key = jax.random.key(16)
    jout, jaux = j_fit(key, jnp.asarray(x), jnp.asarray(f),
                       jnp.asarray(test_x),
                       JConfig(output="quantiles", **PIPE))
    tout, taux = fit_forecast_batch(
        None, t32(x), t32(f), t32(test_x),
        PipelineConfig(output="quantiles", **PIPE),
        noise=jax_pipeline_noise(key, PB, PS, PH))
    return (np.asarray(jout), jax_tree_np(jaux)), (tout, taux)


def test_pipeline_full_family(pipe_runs):
    """``gpcv_q="full"`` with JAX's normals: stage losses, vol and the fan
    at the pipeline tolerances (1e-3; fan 2e-3 / 1e-3).  On a grid from
    dt; from 0, see ``test_dense_family_on_a_grid_from_0``."""
    (jout, jaux), (tout, taux) = pipe_runs
    for key in ("gpcv_loss", "vol_loss", "data_loss", "vol"):
        close(taux[key], jaux[key], 1e-3)
    close(tout, jout, 2e-3, 1e-3)
    assert taux["ok"].all()
    assert taux["gpcv_params"]["chol_variational_covar"].shape == (PB, PN, PN)


def test_warm_start_dense_root(pipe_data, pipe_runs):
    """``warm_start(shift=3)`` of the dense root equals the JAX one on the
    same ``aux``; a 5-step warm refit from it matches at rtol 1e-3."""
    x, f, test_x = pipe_data
    (_, jaux), _ = pipe_runs
    want = jax_tree_np(j_warm_start(jaux, shift=3, n=PN))
    taux = {k: jax.tree.map(t32, jaux[k]) for k in
            ("gpcv_params", "vol_params", "volt_params")}
    got = warm_start(taux, shift=3, n=PN)
    close(got, want, 0.0)
    cfg = {**PIPE, "gpcv_iters": 5, "vol_iters": 5, "data_iters": 5}
    key = jax.random.key(17)
    _, jw = j_fit(key, jnp.asarray(x), jnp.asarray(f), jnp.asarray(test_x),
                  JConfig(output="quantiles", **cfg),
                  init_params=jax.tree.map(jnp.asarray, want))
    _, tw = fit_forecast_batch(None, t32(x), t32(f), t32(test_x),
                               PipelineConfig(output="quantiles", **cfg),
                               init_params=got,
                               noise=jax_pipeline_noise(key, PB, PS, PH))
    for k in ("gpcv_loss", "vol_loss", "data_loss", "vol"):
        close(tw[k], np.asarray(jw[k]), 1e-3)


def test_resolve_config_downgrades():
    """The JAX package's rules: NGVI with the dense family runs Adam; FBM
    takes the dense family and the Kalman vol MLL."""
    cfg = _resolve_config(PipelineConfig(gpcv_q="full", gpcv_opt="ngvi"))
    assert (cfg.gpcv_q, cfg.gpcv_opt) == ("full", "adam")
    cfg = _resolve_config(PipelineConfig(kernel="fbm"))
    assert (cfg.gpcv_q, cfg.vol_mll) == ("full", "kalman")

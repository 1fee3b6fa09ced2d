"""The port's models against the JAX package's, both started from the same
parameters (``volt_tpu_torch.convert``): GPCV init, ELBO and gradients,
predicted scale; the vol GP's spectral MLL and gradients, filtered state
and forecast samples; the Volt train mean and the Markov rollout.
float32; rtol 1e-5 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu.data import sabr_paths
from volt_tpu.models.bmgp import BMGP as JBMGP
from volt_tpu.models.gpcv import GPCVModel as JGPCV
from volt_tpu.models.volt import VoltGP as JVolt, make_mean as j_make_mean
from volt_tpu.rollouts import _rollout_volt_scan as j_rollout
from volt_tpu.train import scaled_returns as j_scaled_returns

from volt_tpu_torch.convert import load_jax_params, params_tree
from volt_tpu_torch.models import BMGP, GPCVModel, VoltGP, make_mean
from volt_tpu_torch.rollouts import _rollout_volt_scan as t_rollout

RTOL = 1e-5
B, N, DT = 2, 60, 1.0 / 252


@pytest.fixture(scope="module")
def data():
    f, vol = sabr_paths(steps=N + 1, seed=5, n_paths=B)
    x = (np.arange(1, N + 1, dtype=np.float32) * np.float32(DT)).astype(
        np.float32)
    yy = np.asarray(j_scaled_returns(j32(x), j32(f)))
    return {"x": x, "prices": f, "yy": yy, "vol": vol[:, 1:]}


def _grads_close(module, jgrads, rtol):
    """Each port parameter's ``.grad`` against the JAX gradient tree."""
    for path, p in module.named_parameters():
        g = jgrads
        for part in path.split("."):
            g = g[part]
        close(p.grad, g, rtol, 1e-6 * float(np.max(np.abs(g))))


# --- GPCV ------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpcv_params(data):
    jm = JGPCV(kernel="bm", q="tridiag")
    return jax_tree_np(jax.jit(jax.vmap(
        lambda y: jm.init(j32(data["x"]), y)))(j32(data["yy"])))


def test_gpcv_init(data, gpcv_params):
    tm = GPCVModel(q="tridiag").init(t32(data["x"]), t32(data["yy"]))
    close(params_tree(tm), gpcv_params, RTOL, 1e-6)


def _perturbed(tree, seed):
    rs = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rs.standard_normal(a.shape)).astype(np.float32),
        tree)


def test_gpcv_elbo_and_gradient(data, gpcv_params):
    params = _perturbed(gpcv_params, 1)
    jm = JGPCV(kernel="bm", q="tridiag")
    x, yy = j32(data["x"]), j32(data["yy"])

    @jax.jit
    def jelbo(p):
        return jax.vmap(lambda pp, y: jm.elbo(pp, x, y))(p, yy)

    tm = load_jax_params(GPCVModel(q="tridiag"), params)
    elbo = tm.elbo(t32(data["x"]), t32(data["yy"]))
    close(elbo, jelbo(params), RTOL)
    elbo.sum().backward()
    _grads_close(tm, jax.jit(jax.grad(lambda p: jnp.sum(jelbo(p))))(params),
                 1e-4)


def test_gpcv_predicted_scale(data, gpcv_params):
    params = _perturbed(gpcv_params, 2)
    jm = JGPCV(kernel="bm", q="tridiag")
    want = jax.vmap(lambda p: jm.predicted_scale(p, j32(data["x"])))(params)
    tm = load_jax_params(GPCVModel(q="tridiag"), params)
    close(tm.predicted_scale(), want, RTOL)


@pytest.mark.parametrize("kwargs,exc", [
    # the id this case carried while the kernel was not ported
    pytest.param({"kernel": "fbm"}, None, id="kwargs0-NotImplementedError"),
    ({"q": "full"}, None), ({"param": "cv"}, None),
    ({"kernel": "rbf"}, ValueError)])
def test_gpcv_outside_the_slice(kwargs, exc):
    """The FBM kernel, the dense family and the cv likelihood construct
    with the JAX package's defaults for the rest."""
    if exc is None:
        m = GPCVModel(**kwargs)
        want = {"q": "full", "param": "exp", **kwargs}
        assert (m.q, m.likelihood.param) == (want["q"], want["param"])
        return
    with pytest.raises(exc):
        GPCVModel(**kwargs)


# --- vol GP ----------------------------------------------------------------

def _bm_params(seed):
    rs = np.random.default_rng(seed)
    return {"kernel": {"raw_vol": (rs.standard_normal((B, 1)) - 1.0).astype(
                np.float32)},
            "likelihood": {"raw_noise": (rs.standard_normal((B, 1)) - 2.0)
                           .astype(np.float32)}}


def test_bmgp_init():
    tm = BMGP().init((B,))
    want = jax.vmap(lambda _: JBMGP().init())(jnp.arange(B))
    close(params_tree(tm), jax_tree_np(want), RTOL)


def test_bmgp_spectral_mll_and_gradient(data):
    params = _bm_params(3)
    log_vol = np.log(data["vol"]).astype(np.float32)
    jm = JBMGP()
    x = j32(data["x"])

    def jmll(p):
        cache = jm.spectral_cache(x, j32(log_vol))
        return jax.vmap(lambda pp, c: jm.mll_spectral(pp, c),
                        in_axes=(0, {"mu": None, "dx": None, "x0": None,
                                     "p_y": 0, "p_t": None, "w": None}))(
            p, cache)

    tm = load_jax_params(BMGP(), params)
    mll = tm.mll_spectral(tm.spectral_cache(t32(data["x"]), t32(log_vol)))
    close(mll, jmll(params), RTOL)
    mll.sum().backward()
    _grads_close(tm, jax.grad(lambda p: jnp.sum(jmll(p)))(params), 1e-4)


def test_bmgp_mll_fast(data):
    """The eigenbasis MLL (``grid_cache`` / ``mll_fast``) against JAX's,
    value and gradient, and against the spectral MLL; the FBM kernel has
    no cache."""
    params = _bm_params(4)
    log_vol = np.log(data["vol"]).astype(np.float32)
    jm, x = JBMGP(), j32(data["x"])
    cache = jm.grid_cache(x)

    def jmll(p):
        return jax.vmap(lambda pp, y: jm.mll_fast(pp, x, y, cache))(
            p, j32(log_vol))

    tm = load_jax_params(BMGP(), params)
    tx = t32(data["x"])
    mll = tm.mll_fast(tx, t32(log_vol), tm.grid_cache(tx))
    close(mll, jmll(params), 1e-4)
    with torch.no_grad():
        close(mll, tm.mll_spectral(tm.spectral_cache(tx, t32(log_vol))),
              1e-4)
    mll.sum().backward()
    _grads_close(tm, jax.grad(lambda p: jnp.sum(jmll(p)))(params), 1e-4)
    assert BMGP(kernel="fbm").grid_cache(tx) is None


def test_bmgp_forecast_state_and_samples(data):
    params = _bm_params(4)
    log_vol = np.log(data["vol"]).astype(np.float32)
    x = data["x"]
    h, s = 8, 16
    test_x = (x[-1] + np.arange(1, h + 1, dtype=np.float32)
              * np.float32(DT)).astype(np.float32)
    jm = JBMGP()
    keys = jax.random.split(jax.random.key(9), B)
    jstate = jax.vmap(lambda p, y: jm.forecast_state(p, j32(x), y))(
        params, j32(log_vol))
    jsamp = jax.vmap(lambda k, p, y: jm.sample_forecast(
        k, p, j32(x), y, j32(test_x), (s,)))(keys, params, j32(log_vol))
    noise = []
    for k in keys:
        k0, k1 = jax.random.split(k)
        noise.append((jax.random.normal(k0, (s,)),
                      jax.random.normal(k1, (s, h))))

    tm = load_jax_params(BMGP(), params)
    for got, want in zip(tm.forecast_state(t32(x), t32(log_vol)), jstate):
        close(got, want, RTOL, 1e-7)
    tnoise = (t32(np.stack([n[0] for n in noise])),
              t32(np.stack([n[1] for n in noise])))
    got = tm.sample_forecast(t32(x), t32(log_vol), t32(test_x), s,
                             noise=tnoise)
    assert got.shape == (B, s, h)
    close(got, jsamp, RTOL, 1e-6)
    # a grid that is not strictly future poisons every sample
    bad = tm.sample_forecast(t32(x), t32(log_vol), t32(test_x - 0.5), s,
                             noise=tnoise)
    assert torch.isnan(bad).all()


def test_bmgp_own_sampler_matches_the_closed_form(data):
    """With its own generator (torch's normals, not JAX's), the forecast
    sampler has the closed-form posterior: mean ``m(x*) + mu_n``, variance
    ``P_n + vol (x* - x_n)`` (within 5 standard errors at 40000 paths)."""
    params = _bm_params(5)
    log_vol = np.log(data["vol"]).astype(np.float32)
    x = data["x"]
    test_x = (x[-1] + np.arange(1, 6, dtype=np.float32)
              * np.float32(DT)).astype(np.float32)
    tm = load_jax_params(BMGP(), params)
    s = 40000
    with torch.no_grad():
        got = tm.sample_forecast(t32(x), t32(log_vol), t32(test_x), s,
                                 generator=torch.Generator().manual_seed(0))
        mu, p = tm.forecast_state(t32(x), t32(log_vol))
        vol = tm.kernel.vol()[..., 0]
        mean = tm.mean(t32(test_x)) + mu[..., None]
        var = p[..., None] + vol[..., None] * (t32(test_x) - float(x[-1]))
    sd = torch.sqrt(var)
    assert torch.all((got.mean(-2) - mean).abs() < 5 * sd / s ** 0.5)
    assert torch.all((got.var(-2) / var - 1.0).abs() < 5 * (2.0 / s) ** 0.5)


# --- Volt data model and rollout --------------------------------------------

@pytest.mark.parametrize("mean", ["ewma", "constant"])
def test_volt_init_and_train_mean(data, mean):
    log_y = np.log(data["prices"][:, 1:]).astype(np.float32)
    jv = JVolt(mean=j_make_mean(mean, k=20))
    tv = VoltGP(mean=make_mean(mean, k=20)).init((B,))
    jparams = jax.vmap(lambda _: jv.init())(jnp.arange(B))
    close(params_tree(tv), jax_tree_np(jparams), RTOL)
    want = jax.vmap(lambda p, y: jv.train_mean(p, j32(data["x"]), y))(
        jparams, j32(log_y))
    close(tv.train_mean(t32(data["x"]), t32(log_y)), want, RTOL, 1e-6)


@pytest.mark.parametrize("name", ["dewma", "linear"])
def test_means_outside_the_slice(name):
    """Every mean the JAX package names is ported: ``make_mean`` builds the
    same class, and only a name the JAX package does not know raises."""
    assert type(make_mean(name)).__name__ == type(j_make_mean(name)).__name__
    with pytest.raises(ValueError):
        make_mean("no-such-mean")


@pytest.mark.parametrize("mean,k,rule,theta", [
    ("ewma", 20, "reference", None),     # O(1) register (H <= k)
    ("ewma", 4, "reference", None),      # window protocol (H > k)
    ("ewma", 20, "trapezoid", 0.3),
    ("constant", 20, "reference", None),
])
def test_rollout_matches(data, mean, k, rule, theta):
    rs = np.random.default_rng(6)
    x = data["x"]
    log_y = np.log(data["prices"][0, 1:]).astype(np.float32)
    vol = data["vol"][0].astype(np.float32)
    h, s = 10, 32
    test_x = (x[-1] + np.arange(1, h + 1, dtype=np.float32)
              * np.float32(DT)).astype(np.float32)
    pred_vol = (0.2 + 0.05 * rs.random((s, h))).astype(np.float32)
    zs = rs.standard_normal((s, h)).astype(np.float32)
    latent = np.float32(np.mean(np.log(data["prices"][0])))
    use_theta = theta is not None

    jv = JVolt(mean=j_make_mean(mean, k=k), integral_rule=rule)
    jparams = jv.init()
    if mean == "constant":
        jparams["mean"]["constant"] = jnp.asarray([4.6], jnp.float32)
    jstate = jv.fit_state(jparams, j32(x), j32(log_y), j32(vol))
    want = j_rollout(jstate, jnp.float32(latent), j32(test_x), j32(pred_vol),
                     j32(zs), use_theta, jnp.float32(theta or 0.0))

    tv = load_jax_params(VoltGP(mean=make_mean(mean, k=k),
                                integral_rule=rule), jax_tree_np(jparams))
    tstate = tv.fit_state(t32(x), t32(log_y), t32(vol))
    got = t_rollout(tstate, torch.tensor(latent), t32(test_x), t32(pred_vol),
                    t32(zs), use_theta, theta or 0.0)
    close(got, want, RTOL, 1e-5)


# --- parameter conversion ----------------------------------------------------

def test_params_roundtrip(gpcv_params):
    tm = load_jax_params(GPCVModel(q="tridiag"), gpcv_params)
    close(params_tree(tm), gpcv_params, 0.0)
    assert {n for n, _ in tm.named_parameters()} == {
        "kernel.raw_vol", "mean.constant", "variational_mean", "q_log_d",
        "q_e"}

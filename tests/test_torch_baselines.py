"""The port's baselines against the JAX package's, from the same numpy
inputs and the JAX package's parameters carried across by ``convert``:
the stationary kernels (matrix and ``diag``), ``BasicGP`` (MLL, gradient,
joint posterior), ``_fit_basic`` and ``train_basic_model``, and the
baselines' autoregressive rollout ``nonvol_rollouts`` on JAX's own
normals and against its dense oracle.

Tolerances: kernels rtol 1e-5 (elementwise float32 formulas); the MLL and
its gradient rtol 1e-4, the gradient also atol 1e-4 of its largest entry
(a float32 Cholesky of a 60 x 60 matrix in two libraries); 10 Adam steps
rtol 1e-3, atol 1e-5 for parameters near zero (the Adam parity tolerance
of ``test_torch_train.py``); rollouts atol 1e-4 of max|y| (a float32
Cholesky grown row by row, against JAX's and against the dense loop that
re-factorises every step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu import kernels as jk
from volt_tpu import means as jm
from volt_tpu import rollouts as jroll
from volt_tpu import train as jtrain
from volt_tpu.models.basic import BasicGP as JBasic

from volt_tpu_torch import kernels as tk
from volt_tpu_torch import means as tm
from volt_tpu_torch import rollouts as troll
from volt_tpu_torch import train as ttrain
from volt_tpu_torch.convert import load_jax_params, params_tree
from volt_tpu_torch.data import sabr_paths
from volt_tpu_torch.models.basic import BasicGP, MaternGP, SMGP

N, H, S, DT = 60, 8, 16, 1.0 / 252


def _kernel_pair(name, batch=()):
    """(JAX kernel, its params, port kernel with those params)."""
    jmods = {
        "ou": lambda: jk.OUKernel(batch_shape=batch),
        "rbf": lambda: jk.RBFKernel(batch_shape=batch),
        "matern0.5": lambda: jk.MaternKernel(0.5, batch_shape=batch),
        "matern1.5": lambda: jk.MaternKernel(1.5, batch_shape=batch),
        "matern2.5": lambda: jk.MaternKernel(2.5, batch_shape=batch),
        "scale": lambda: jk.ScaleKernel(jk.MaternKernel(batch_shape=batch),
                                        batch_shape=batch),
        "sm": lambda: jk.SpectralMixtureKernel(4, batch_shape=batch)}
    tmods = {
        "ou": tk.OUKernel, "rbf": tk.RBFKernel,
        "matern0.5": lambda: tk.MaternKernel(0.5),
        "matern1.5": lambda: tk.MaternKernel(1.5),
        "matern2.5": lambda: tk.MaternKernel(2.5),
        "scale": lambda: tk.ScaleKernel(tk.MaternKernel()),
        "sm": lambda: tk.SpectralMixtureKernel(4)}
    jkern, tkern = jmods[name](), tmods[name]()
    if name == "sm":
        x = np.arange(30, dtype=np.float32) / 30
        y = np.sin(7 * x).astype(np.float32)
        params = jkern.initialize_from_data(jkern.init(), j32(x), j32(y),
                                            key=jax.random.key(3))
    else:
        params = jkern.init()
        # off the defaults, so every parameter matters
        params = jax.tree.map(lambda a: a + 0.3, params)
    tkern.init(batch)
    load_jax_params(tkern, jax_tree_np(params))
    return jkern, params, tkern


@pytest.mark.parametrize("name", ["ou", "rbf", "matern0.5", "matern1.5",
                                  "matern2.5", "scale", "sm"])
@pytest.mark.parametrize("batch", [(), (2,)], ids=["single", "batched"])
def test_kernel_matrix_and_diag(name, batch):
    jkern, params, tkern = _kernel_pair(name, batch)
    rng = np.random.default_rng(0)
    x1 = np.sort(rng.uniform(0, 2, 13)).astype(np.float32)
    x2 = np.sort(rng.uniform(0, 2, 13)).astype(np.float32)
    close(tkern(t32(x1), t32(x2)), jkern(params, j32(x1), j32(x2)), 1e-5,
          1e-7)
    close(tkern(t32(x1)), jkern(params, j32(x1)), 1e-5, 1e-7)
    close(tkern(t32(x1), t32(x2), diag=True),
          jkern(params, j32(x1), j32(x2), diag=True), 1e-5, 1e-7)
    assert tkern(t32(x1)).shape == (*batch, 13, 13)


def test_kernel_defaults_and_errors():
    with pytest.raises(ValueError, match="nu"):
        tk.MaternKernel(nu=1.0)
    for t, j in ((tk.RBFKernel().init(), jk.RBFKernel().init()),
                 (tk.ScaleKernel(tk.OUKernel()).init((3,)),
                  jk.ScaleKernel(jk.OUKernel(batch_shape=(3,)),
                                 batch_shape=(3,)).init())):
        close(params_tree(t), j, 1e-6)
    sm = tk.SpectralMixtureKernel(5).init((2,))
    assert sm.raw_weights.shape == sm.raw_means.shape == (2, 5)
    assert sm.constraint.forward(sm.raw_weights).max() <= 1.5 / 5 + 1e-6


def test_sm_initialize_from_data():
    """The data-driven init: weights ``std(y) / q`` exactly as JAX's;
    means below the Nyquist frequency; scales the heavy-tailed reciprocal
    ``1 / (|z| max_dist)``, whose median (``1 / (0.6745 max_dist)``) both
    packages' draws reach."""
    q = 4000
    x = np.arange(50, dtype=np.float32) * np.float32(0.1)
    y = np.cos(x).astype(np.float32)
    jkern = jk.SpectralMixtureKernel(q)
    jp = jkern.initialize_from_data(jkern.init(), j32(x), j32(y),
                                    key=jax.random.key(1))
    tkern = tk.SpectralMixtureKernel(q).init()
    tkern.initialize_from_data(t32(x), t32(y),
                               torch.Generator().manual_seed(1))
    sp = tkern.constraint.forward
    close(sp(tkern.raw_weights), jax.nn.softplus(jp["raw_weights"]), 1e-5)
    means = sp(tkern.raw_means).detach().numpy()
    assert means.max() < 0.5 / 0.1 * (1 + 1e-5) and means.min() >= 0
    want = 1.0 / (0.6745 * 4.9)
    for scales in (sp(tkern.raw_scales).detach().numpy(),
                   np.asarray(jax.nn.softplus(jp["raw_scales"]))):
        assert abs(np.median(scales) / want - 1) < 0.1
        assert scales.max() > 20 * want  # the heavy upper tail


# --- BasicGP ---------------------------------------------------------------


@pytest.fixture(scope="module")
def series():
    f, _ = sabr_paths(steps=N + H + 1, seed=5, F0=50.0)
    x = (np.arange(N, dtype=np.float32) * np.float32(DT)).astype(np.float32)
    test_x = (x[-1] + np.float32(DT) * np.arange(1, H + 1)).astype(np.float32)
    return x, np.log(f[1:N + 1]).astype(np.float32), test_x


def _models(kind, mean):
    """(JAX module, port module) pairs of a baseline with a mean by name."""
    jmean = {"loglinear": lambda: jm.LogLinearMean(1),
             "constant": jm.ConstantMean, "ewma": lambda: jm.EWMAMean(20),
             "dewma": lambda: jm.DEWMAMean(20),
             "tewma": lambda: jm.TEWMAMean(20)}[mean]()
    tmean = {"loglinear": lambda: tm.LogLinearMean(1),
             "constant": tm.ConstantMean, "ewma": lambda: tm.EWMAMean(20),
             "dewma": lambda: tm.DEWMAMean(20),
             "tewma": lambda: tm.TEWMAMean(20)}[mean]()
    if kind == "matern":
        return JBasic(jk.ScaleKernel(jk.MaternKernel()), jmean), \
            MaternGP(tmean)
    if kind == "rbf":
        return JBasic(jk.ScaleKernel(jk.RBFKernel()), jmean), \
            BasicGP(tk.ScaleKernel(tk.RBFKernel()), tmean)
    return JBasic(jk.SpectralMixtureKernel(5), jmean), SMGP(5, tmean)


def _jax_init(jmod, x, log_y, kind, mean):
    """JAX's initial tree as ``train_basic_model`` builds it."""
    key = jax.random.key(4)
    params = jmod.init(key=key)
    if kind == "sm":
        params["kernel"] = jmod.kernel.initialize_from_data(
            params["kernel"], j32(x), j32(log_y), key=key)
    if mean == "loglinear":
        params["mean"] = jmod.mean.initialize_from_data(params["mean"],
                                                        j32(x), j32(log_y))
    params["likelihood"] = jmod.likelihood.init(raw_noise_init=1e-5)
    return params


def _pair(series, kind, mean, fit_iters=0):
    """JAX and port baselines with the same parameters (JAX's init, then
    ``fit_iters`` JAX Adam steps)."""
    x, log_y, _ = series
    jmod, tmod = _models(kind, mean)
    params = _jax_init(jmod, x, log_y, kind, mean)
    if fit_iters:
        params, _ = jtrain._fit_basic(jmod, params, j32(x), j32(log_y),
                                      fit_iters, 0.1)
    tmod.init()
    load_jax_params(tmod, jax_tree_np(params))
    return jmod, params, tmod


@pytest.mark.parametrize("kind,mean", [("matern", "loglinear"),
                                       ("sm", "ewma"), ("rbf", "constant"),
                                       ("sm", "tewma")])
def test_basic_mll_and_gradient(series, kind, mean):
    x, log_y, _ = series
    jmod, params, tmod = _pair(series, kind, mean)
    want, jgrad = jax.value_and_grad(
        lambda p: jmod.mll(p, j32(x), j32(log_y)))(params)
    got = tmod.mll(t32(x), t32(log_y))
    got.backward()
    close(got, want, 1e-4)
    grads = {name: p.grad for name, p in tmod.named_parameters()}
    flat = {".".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    assert set(grads) == set(flat)
    for name in flat:
        close(grads[name], flat[name], 1e-4, 1e-4 * np.abs(flat[name]).max()
              + 1e-7)


@pytest.mark.parametrize("kind,mean", [("matern", "loglinear"),
                                       ("sm", "ewma")])
def test_fit_basic_ten_steps(series, kind, mean):
    x, log_y, _ = series
    jmod, params, tmod = _pair(series, kind, mean)
    jparams, jlosses = jtrain._fit_basic(jmod, params, j32(x), j32(log_y),
                                         10, 0.1)
    losses = ttrain._fit_basic(tmod, t32(x), t32(log_y), 10, 0.1)
    close(losses, jlosses, 1e-3)
    close(params_tree(tmod), jax_tree_np(jparams), 1e-3, 1e-5)


@pytest.mark.parametrize("model_type,mean_func", [("matern", "loglinear"),
                                                  ("sm", "constant")])
def test_train_basic_model(series, model_type, mean_func):
    """The entry on JAX's initial tree equals JAX's entry; its own random
    init (a generator) trains to finite values."""
    x, log_y, _ = series
    prices = np.exp(log_y).astype(np.float32)
    key = jax.random.key(4)
    want = jtrain.train_basic_model(j32(x), j32(prices), 10,
                                    model_type=model_type, num_mixtures=5,
                                    mean_func=mean_func, key=key)
    jmod = want.module
    init = jmod.init(key=key)
    if model_type == "sm":
        init["kernel"] = jmod.kernel.initialize_from_data(
            init["kernel"], j32(x), jnp.log(j32(prices)), key=key)
    if mean_func == "loglinear":
        init["mean"] = jmod.mean.initialize_from_data(
            init["mean"], j32(x), jnp.log(j32(prices)))
    init["likelihood"] = jmod.likelihood.init(raw_noise_init=1e-5)
    got = ttrain.train_basic_model(t32(x), t32(prices), 10,
                                   model_type=model_type, num_mixtures=5,
                                   mean_func=mean_func,
                                   init_params=jax_tree_np(init))
    close(params_tree(got.module), jax_tree_np(want.params), 1e-3, 1e-5)
    close(got.train_y, want.train_y, 1e-6)
    own = ttrain.TrainBasicModel(t32(x), t32(prices), 10,
                                 model_type=model_type, num_mixtures=5,
                                 mean_func=mean_func,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(own.module.mll(t32(x), own.train_y))


def test_joint_posterior(series):
    x, log_y, test_x = series
    jmod, params, tmod = _pair(series, "matern", "loglinear", fit_iters=10)
    jmean, jcov = jmod.posterior(params, j32(x), j32(log_y), j32(test_x))
    state = tmod.fit_state(t32(x), t32(log_y))
    mean, cov = state.posterior(t32(test_x))
    close(mean, jmean, 1e-4)
    close(cov, jcov, 1e-3, 1e-4 * float(jnp.abs(jcov).max()))
    z = np.random.default_rng(0).standard_normal((S, H)).astype(np.float32)
    got = state.sample(None, t32(test_x), (S,), noise=t32(z))
    chol = np.linalg.cholesky(np.asarray(jcov, np.float64)
                              + 1e-6 * np.eye(H))
    close(got, np.asarray(jmean) + z @ chol.T, 1e-4, 1e-4)


def test_posterior_refuses_a_magpie_mean(series):
    x, log_y, test_x = series
    _, _, tmod = _pair(series, "matern", "ewma")
    with pytest.raises(ValueError, match="nonvol_rollouts"):
        tmod.posterior(t32(x), t32(log_y), t32(test_x))


# --- nonvol_rollouts ---------------------------------------------------------


@pytest.mark.parametrize("kind,mean", [("matern", "constant"),
                                       ("matern", "loglinear"),
                                       ("matern", "ewma"), ("sm", "dewma"),
                                       ("rbf", "tewma")])
def test_nonvol_rollouts_on_jax_normals(series, kind, mean):
    """The port's rollout on JAX's draws ``normal(key, (H, S))`` equals
    JAX's, and the dense re-factorising loop on the same normals."""
    x, log_y, test_x = series
    jmod, params, tmod = _pair(series, kind, mean, fit_iters=10)
    key = jax.random.key(7)
    jstate = jmod.fit_state(params, j32(x), j32(log_y))
    want = jroll.nonvol_rollouts(key, jstate, j32(x), j32(np.exp(log_y)),
                                 j32(test_x), nsample=S)
    zs = t32(jax.random.normal(key, (H, S), jnp.float32)).T
    state = tmod.fit_state(t32(x), t32(log_y))
    got = troll.nonvol_rollouts(None, state, t32(x), None, t32(test_x),
                                nsample=S, zs=zs)
    scale = float(np.abs(log_y).max())
    assert got.shape == (S, H)
    close(got, want, 0.0, 1e-4 * scale)
    dense = troll.nonvol_rollouts_dense(None, state, t32(test_x), S, zs=zs)
    close(got, dense, 0.0, 1e-4 * scale)


def test_nonvol_rollouts_draws_from_the_generator(series):
    x, log_y, test_x = series
    _, _, tmod = _pair(series, "matern", "ewma")
    state = tmod.fit_state(t32(x), t32(log_y))
    a = troll.nonvol_rollouts(torch.Generator().manual_seed(3), state, None,
                              None, t32(test_x), nsample=S)
    b = troll.nonvol_rollouts(None, state, None, None, t32(test_x),
                              nsample=S, zs=torch.randn(
                                  S, H, generator=torch.Generator()
                                  .manual_seed(3)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    dense = troll.nonvol_rollouts_dense(torch.Generator().manual_seed(3),
                                        state, t32(test_x), S)
    assert dense.shape == (S, H) and torch.isfinite(dense).all()


def test_rollouts_method_points_to_nonvol(series):
    with pytest.raises(NotImplementedError, match="nonvol_rollouts"):
        troll.rollouts(None, None, None, None, None, method="sm")

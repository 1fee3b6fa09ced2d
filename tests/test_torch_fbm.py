"""The FBM kernel family of the port against the JAX package's on the same
numpy inputs and parameters: the increment-domain factors of
``volt_tpu_torch.ops.fbm``; ``FBMKernel``; the FBM branches of ``BMGP``
(its MLL and gradients at H = 0.1, 0.5, 0.9, the posterior, the Markov
closed forms refused); the FBM GPCV (init, ELBO and gradients, a short
fit); the per-lane jitter ladder against ``jax.vmap``; ``learn_gpcv``,
``train_vol_model`` and ``sample_vol_paths`` with the FBM kernel; and
``fit_forecast_batch(PipelineConfig(kernel="fbm"))`` at B=2 given JAX's
normals.

Tolerances (float32), with the largest share of each used on this
suite's inputs: covariances, factors and MLL values rtol 1e-5 with atol
1e-6 of the largest entry (0.41, the factors' products against ``K``
at 1e-4); gradients at a point rtol 1e-4 against a float64 run and 3e-4
against ``jax.grad``, whose own float32 gradient w.r.t. the raw Hurst
parameter is 1.1e-4 from float64 (0.35); the GPCV init on ``S = R R^T``
and ELBO gradients rtol 1e-3, as the dense family's tests state (three
Cholesky factorisations in two libraries; 0.44); short fits rtol 1e-3
(0.02); the pipeline's losses rtol 1e-3 and its fan 2e-3 / 1e-3, the
single-task pipeline tests' tolerances, but its vol path at 3e-3: the
dense family's Adam moves a root entry by about lr whatever the sign of
a near-zero gradient, so a 1e-7 relative change of the prices moves
this pipeline's vol by up to 2.1e-3 (measured on the CPU); the pipeline
used 0.24 of its tolerances, the same effect PR 5 measured on the BM
dense family (``test_torch_gpcv_families.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu import train as jtrain
from volt_tpu.data import sabr_paths
from volt_tpu.kernels import FBMKernel as JFBM
from volt_tpu.models.bmgp import BMGP as JBMGP
from volt_tpu.models.gpcv import GPCVModel as JGPCV
from volt_tpu.ops import fbm as jfbm
from volt_tpu.parallel import PipelineConfig as JConfig
from volt_tpu.parallel import fit_forecast_batch as j_fit

from volt_tpu_torch import train as ttrain
from volt_tpu_torch.convert import load_jax_params
from volt_tpu_torch.kernels import FBMKernel
from volt_tpu_torch.models import BMGP, GPCVModel
from volt_tpu_torch.ops import fbm as tfbm
from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch
from volt_tpu_torch.parallel.pipeline import _resolve_config
from volt_tpu_torch.rollouts import sample_vol_paths

B, N, H, S, DT = 2, 40, 8, 32, 1.0 / 252
HURSTS = (0.1, 0.5, 0.9)


def _grid(n, start=1):
    return (np.arange(start, n + start, dtype=np.float32)
            * np.float32(DT)).astype(np.float32)


def _raw(h):
    return float(np.log(h) - np.log1p(-h))


def _close_max(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol, 1e-6 * float(np.max(np.abs(want))))


def _two_h(hursts):
    return np.asarray([[2.0 * h] for h in hursts], np.float32)


@pytest.fixture(scope="module")
def data():
    f, _ = sabr_paths(steps=N + 1, seed=31, n_paths=B)
    x = _grid(N)
    yy = np.asarray(jtrain.scaled_returns(j32(x), j32(f)))
    return {"x": x, "prices": f.astype(np.float32), "yy": yy,
            "log_vol": np.log(np.abs(yy) + 0.2).astype(np.float32)}


# --- ops/fbm.py -----------------------------------------------------------------


@pytest.mark.parametrize("start", [0, 1])
def test_increment_cov(start):
    x, th = _grid(N, start), _two_h(HURSTS)
    _close_max(tfbm.fbm_increment_cov(t32(x), t32(th)),
               jfbm.fbm_increment_cov(j32(x), j32(th)), 1e-5)


def test_factors_match_jax_and_k():
    """Both factors against JAX, and their products against the Gram
    ``K`` (and ``K + noise I``) built by the kernel itself."""
    x, th = _grid(N), _two_h(HURSTS)
    noise = np.asarray([[0.3], [0.01], [1e-3]], np.float32)
    lk = tfbm.fbm_cholesky(t32(x), t32(th))
    ln = tfbm.fbm_noise_cholesky(t32(x), t32(th), t32(noise))
    _close_max(lk, jfbm.fbm_cholesky(j32(x), j32(th)), 1e-5)
    _close_max(ln, jfbm.fbm_noise_cholesky(j32(x), j32(th), j32(noise)),
               1e-5)
    kern = FBMKernel().init((3,))
    with torch.no_grad():
        kern.raw_vol.copy_(torch.tensor([[_raw(h)] for h in HURSTS]))
        k = kern(t32(x)).double()
    eye = torch.eye(N, dtype=torch.float64)
    _close_max(lk.double() @ lk.double().mT, k, 1e-4)
    _close_max(ln.double() @ ln.double().mT,
               k + torch.tensor(noise, dtype=torch.float64)[..., None] * eye,
               1e-4)


def test_per_lane_ladder_matches_vmap():
    """A batch where one lane (H = 0.9999) needs jitter: per lane, the other
    lane keeps its bare factor, as ``jax.vmap`` of the JAX ladder; the
    whole-batch ladder jitters both, as the JAX function on a batch."""
    x, th = _grid(N), _two_h((0.5, 0.9999))
    per = tfbm.fbm_cholesky(t32(x), t32(th), per_lane=True)
    whole = tfbm.fbm_cholesky(t32(x), t32(th))
    want = jax.vmap(lambda t: jfbm.fbm_cholesky(j32(x), t))(j32(th))
    want_whole = jfbm.fbm_cholesky(j32(x), j32(th))
    _close_max(per[0], want[0], 1e-5)
    _close_max(whole[0], want_whole[0], 1e-5)
    assert not torch.allclose(per[0], whole[0])
    # the jittered lane, a near-singular G + 1e-6 I, on L L^T
    for got, ref in ((per[1], want[1]), (whole[1], want_whole[1])):
        ref = np.asarray(ref, np.float64)
        _close_max(got.double() @ got.double().mT, ref @ ref.T, 1e-4)


def test_hurst_gradient_at_a_zero_base():
    """On a grid from 0, ``|t_{i-1} - t_{j-1}|^{2H}`` has a zero base on
    the first row and column (and the diagonal); the gradient w.r.t.
    ``2H`` is 0 there in both packages, so the total matches
    ``jax.grad``."""
    x = _grid(N, 0)
    cot = np.random.default_rng(3).standard_normal((N, N)).astype(np.float32)
    th = torch.tensor([[1.2]], requires_grad=True)
    (tfbm.fbm_increment_cov(t32(x), th) * t32(cot)).sum().backward()
    want = jax.grad(lambda t: jnp.sum(jfbm.fbm_increment_cov(j32(x), t)
                                      * j32(cot)))(jnp.asarray([[1.2]]))
    assert torch.isfinite(th.grad).all()
    close(th.grad, want, 1e-4)


# --- FBMKernel ----------------------------------------------------------------------


def test_kernel_values_and_diag():
    x1, x2 = _grid(N), _grid(7, 3)
    raw = np.asarray([[_raw(h)] for h in HURSTS], np.float32)
    kern = load_jax_params(FBMKernel(), {"raw_vol": raw})
    jk, p = JFBM(), {"raw_vol": j32(raw)}
    _close_max(kern(t32(x1)), jk(p, j32(x1)), 1e-5)
    _close_max(kern(t32(x1), t32(x1 * 0.5)), jk(p, j32(x1), j32(x1 * 0.5)),
               1e-5)
    _close_max(kern(t32(x2), diag=True), jk(p, j32(x2), diag=True), 1e-5)
    with torch.no_grad():
        close(kern(t32(x2), diag=True),
              torch.diagonal(kern(t32(x2)), dim1=-2, dim2=-1), 1e-6)
    assert torch.allclose(kern.vol(), torch.tensor([[h] for h in HURSTS]))


# --- BMGP ------------------------------------------------------------------------------


def _bmgp_params(h, noise_raw=-1.5):
    return {"kernel": {"raw_vol": np.full((B, 1), _raw(h), np.float32)},
            "likelihood": {"raw_noise": np.full((B, 1), noise_raw,
                                                np.float32)}}


@pytest.mark.parametrize("h", HURSTS)
def test_bmgp_mll_and_gradient(data, h):
    x, y = data["x"], data["log_vol"]
    params = _bmgp_params(h)
    jm = JBMGP(kernel="fbm", batch_shape=(B,))
    jp = jax.tree.map(j32, params)
    want = jm.mll(jp, j32(x), j32(y))
    jgrad = jax.grad(lambda p: jnp.sum(jm.mll(p, j32(x), j32(y))))(jp)
    tm = load_jax_params(BMGP(kernel="fbm"), params)
    got = tm.mll(t32(x), t32(y))
    got.sum().backward()
    ref = load_jax_params(BMGP(kernel="fbm"), params).double()
    ref.mll(torch.tensor(x, dtype=torch.float64),
            torch.tensor(y, dtype=torch.float64)).sum().backward()
    close(got, want, 1e-5)
    # JAX's own float32 gradient w.r.t. the raw Hurst parameter is up to
    # 1.1e-4 (relative) from the float64 run, the port's within 4e-5
    for grad, jg, g64 in (
            (tm.kernel.raw_vol.grad, jgrad["kernel"]["raw_vol"],
             ref.kernel.raw_vol.grad),
            (tm.likelihood.raw_noise.grad, jgrad["likelihood"]["raw_noise"],
             ref.likelihood.raw_noise.grad)):
        close(grad, jg, 3e-4, 1e-6)
        close(grad, g64.float(), 1e-4, 1e-6)


def test_bmgp_posterior_and_sample(data):
    x, y = data["x"], data["log_vol"]
    tx = _grid(H, N + 1)
    params = _bmgp_params(0.3)
    jm = JBMGP(kernel="fbm", batch_shape=(B,))
    jp = jax.tree.map(j32, params)
    jmean, jcov = jm.posterior(jp, j32(x), j32(y), j32(tx))
    tm = load_jax_params(BMGP(kernel="fbm"), params)
    with torch.no_grad():
        mean, cov = tm.posterior(t32(x), t32(y), t32(tx))
    _close_max(mean, jmean, 1e-5)
    _close_max(cov, jcov, 1e-4)
    # sample_vol_paths takes the dense sampler for FBM, on the normals
    # JAX's sample_mvn draws
    key = jax.random.key(2)
    jpaths = jnp.exp(jm.sample(key, jp, j32(x), j32(y), j32(tx), (S,)))
    z = jax.random.normal(key, (S, B, H), jnp.float32)
    state = tm.fit_state(t32(x), t32(y))
    with torch.no_grad():
        got = sample_vol_paths(state, t32(tx), S, noise=t32(z),
                               assume_future=True)
    assert got.shape == (B, S, H)
    _close_max(got, np.moveaxis(np.asarray(jpaths), 0, 1), 1e-4)


def test_markov_forms_refuse_fbm(data):
    x, y = t32(data["x"]), t32(data["log_vol"])
    tx = t32(_grid(H, N + 1))
    tm = BMGP(kernel="fbm").init((B,))
    for call in (lambda: tm.forecast_state(x, y),
                 lambda: tm.sample_forecast(x, y, tx, 4),
                 lambda: tm.posterior_forecast(x, y, tx)):
        with pytest.raises(ValueError, match="requires the BM kernel"):
            call()
    with pytest.raises(ValueError, match="requires the BM kernel"):
        GPCVModel(kernel="fbm", q="tridiag")


def test_bm_posterior_forecast_matches_jax(data):
    """``posterior_forecast`` (ported with ``_require_bm``) on the BM
    kernel against JAX's."""
    x, y = data["x"], data["log_vol"]
    tx = _grid(H, N + 1)
    params = {"kernel": {"raw_vol": np.full((B, 1), -1.0, np.float32)},
              "likelihood": {"raw_noise": np.full((B, 1), -2.0,
                                                  np.float32)}}
    jm = JBMGP(batch_shape=(B,))
    jmean, jcov = jm.posterior_forecast(jax.tree.map(j32, params), j32(x),
                                        j32(y), j32(tx))
    tm = load_jax_params(BMGP(), params)
    with torch.no_grad():
        mean, cov = tm.posterior_forecast(t32(x), t32(y), t32(tx))
    _close_max(mean, jmean, 1e-5)
    _close_max(cov, jcov, 1e-5)


# --- GPCV --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpcv_init(data):
    jm = JGPCV(kernel="fbm", q="full")
    return jax_tree_np(jax.vmap(lambda yy: jm.init(j32(data["x"]), yy))(
        j32(data["yy"])))


def test_gpcv_init(data, gpcv_init):
    """The FBM init (the increment-domain prior factor, no x10 inflation)
    on ``S = R R^T``."""
    tm = GPCVModel(kernel="fbm").init(t32(data["x"]), t32(data["yy"]),
                                      per_lane=True)
    r = torch.tril(tm.chol_variational_covar).double()
    jr = np.tril(gpcv_init["chol_variational_covar"]).astype(np.float64)
    _close_max(r @ r.mT, jr @ np.swapaxes(jr, -1, -2), 1e-3)
    close(tm.variational_mean, gpcv_init["variational_mean"], 1e-5)


def test_gpcv_elbo_and_gradient(data, gpcv_init):
    jm = JGPCV(kernel="fbm", q="full")
    x, yy = j32(data["x"]), j32(data["yy"])
    jp = jax.tree.map(jnp.asarray, gpcv_init)
    want = jax.vmap(lambda p, y: jm.elbo(p, x, y))(jp, yy)
    jgrad = jax.grad(lambda p: jnp.sum(jax.vmap(
        lambda q, y: jm.elbo(q, x, y))(p, yy)))(jp)
    tm = load_jax_params(GPCVModel(kernel="fbm"), gpcv_init)
    got = tm.elbo(t32(data["x"]), t32(data["yy"]))
    got.sum().backward()
    close(got, want, 1e-4)
    for path, p in tm.named_parameters():
        g = jgrad
        for part in path.split("."):
            g = g[part]
        _close_max(p.grad, g, 1e-3)


def test_learn_gpcv_and_train_vol_model(data):
    """``learn_gpcv(kernel="fbm")`` (the dense family by Adam) and
    ``train_vol_model(kernel="fbm")`` (the dense MLL), short fits."""
    x, f = data["x"], data["prices"][0]
    jscale = jtrain.learn_gpcv(j32(x), j32(f), 10, kernel="fbm")
    scale = ttrain.learn_gpcv(t32(x), t32(f), 10, kernel="fbm")
    close(scale, jscale, 1e-3)
    jstate = jtrain.train_vol_model(j32(x), jscale, 10, kernel="fbm")
    state = ttrain.train_vol_model(t32(x), t32(np.asarray(jscale)), 10,
                                   kernel="fbm")
    close(state.module.kernel.raw_vol, jstate.params["kernel"]["raw_vol"],
          1e-4)
    close(state.module.likelihood.raw_noise,
          jstate.params["likelihood"]["raw_noise"], 1e-4)


def test_learn_gpcv_sparse_fbm(data):
    """``learn_gpcv_sparse(kernel="fbm")``: the sparse init and ELBO with the
    increment-domain factor of the inducing points' prior and the dense
    KL against it, a short fit."""
    x, f = data["x"], data["prices"][0]
    want = jtrain.learn_gpcv_sparse(j32(x), j32(f), num_inducing=12,
                                    train_iters=10, kernel="fbm")
    got = ttrain.learn_gpcv_sparse(t32(x), t32(f), num_inducing=12,
                                   train_iters=10, kernel="fbm")
    close(got, want, 1e-3)


# --- the pipeline ---------------------------------------------------------------


STD = dict(gpcv_iters=20, vol_iters=20, data_iters=20, k=20, nsample=S,
           kernel="fbm", output="quantiles")


def jax_fbm_noise(key, batch, nsample, horizon):
    """The normals JAX's pipeline draws for the FBM kernel: per asset
    ``(k_lik, k_roll)``, then ``(k_vol, k_z)``; the dense vol sampler draws
    its ``(S, H)`` normals from ``k_vol`` itself (``ops/mvn.py``)."""
    vz, zs = [], []
    for k in jax.random.split(key, batch):
        _, k_roll = jax.random.split(k)
        k_vol, k_z = jax.random.split(k_roll)
        vz.append(jax.random.normal(k_vol, (nsample, horizon), jnp.float32))
        zs.append(jax.random.normal(k_z, (nsample, horizon), jnp.float32))
    return {"vol_z": t32(np.stack(vz)), "zs": t32(np.stack(zs))}


@pytest.fixture(scope="module")
def pipeline_runs(data):
    x, f = _grid(N, 0), data["prices"]
    tx = _grid(H, N)
    key = jax.random.key(0)
    jout, jaux = j_fit(key, j32(x), j32(f), j32(tx), JConfig(**STD))
    out, aux = fit_forecast_batch(None, t32(x), t32(f), t32(tx),
                                  PipelineConfig(**STD),
                                  noise=jax_fbm_noise(key, B, S, H))
    return (np.asarray(jout), jax_tree_np(jaux)), (out, aux)


def test_pipeline_resolves_like_jax():
    cfg = _resolve_config(PipelineConfig(kernel="fbm", gpcv_opt="ngvi"))
    assert (cfg.gpcv_q, cfg.vol_mll, cfg.gpcv_opt) == ("full", "kalman",
                                                      "adam")


def test_pipeline_matches_jax(pipeline_runs):
    (jout, jaux), (out, aux) = pipeline_runs
    for key in ("gpcv_loss", "vol_loss", "data_loss"):
        close(aux[key], jaux[key], 1e-3)
    close(aux["vol"], jaux["vol"], 3e-3)
    close(aux["vol_params"], jaux["vol_params"], 1e-3, 1e-4)
    assert out.shape == jout.shape == (B, 7, H)
    close(out, jout, 2e-3, 1e-3)
    for key in ("forecast_mean", "forecast_std"):
        close(aux[key], jaux[key], 2e-3, 1e-3)
    assert aux["ok"].tolist() == jaux["ok"].tolist() == [True] * B
    assert set(aux["gpcv_params"]) == set(jaux["gpcv_params"])


def test_pipeline_samples_without_noise(data):
    """Drawn from a generator: finite paths of the right shape."""
    x, f = t32(_grid(N, 0)), t32(data["prices"])
    cfg = dataclasses.replace(PipelineConfig(**STD), output="samples",
                              gpcv_iters=3, vol_iters=3, data_iters=3)
    out, aux = fit_forecast_batch(torch.Generator().manual_seed(0), x, f,
                                  t32(_grid(H, N)), cfg)
    assert out.shape == (B, S, H) and torch.isfinite(out).all()
    assert bool(aux["ok"].all())

"""The port's training entries against the JAX package's, from the same
inputs and initial parameters: ``learn_gpcv`` (NGVI and Adam, closed-form
and GH-75 ELL), ``ngvi_tridiag_fit``'s loss trajectory, ``train_vol_model``
(spectral and Kalman), ``train_volt_magpie`` for every mean and
``train_data_model`` (JAX's random initial weights carried by
``convert``), and the entries that stay unported.

Tolerances: these are float32 optimiser trajectories in two frameworks,
whose roundings differ from the first step on.  NGVI's Newton-like steps
keep them within rtol 1e-4; Adam's normalised step amplifies them where a
gradient is near zero, so Adam fits are held at rtol 1e-3 (the pipeline
parity tolerance)."""

import jax
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu.data import sabr_paths
from volt_tpu.gp.natural import ngvi_tridiag_fit as j_ngvi
from volt_tpu.models.gpcv import GPCVModel as JGPCV, GPCVState as JGPCVState
from volt_tpu.models.volt import VoltGP as JVolt, make_mean as j_make_mean
from volt_tpu.means import LogLinearMean as JLogLinear
from volt_tpu import train as jtrain

from volt_tpu_torch import train as ttrain
from volt_tpu_torch.gp.natural import ngvi_tridiag_fit
from volt_tpu_torch.models import GPCVModel, Volt

N, DT = 60, 1.0 / 252
ADAM_RTOL, NGVI_RTOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def data():
    f, vol = sabr_paths(steps=N + 1, seed=11)
    x = (np.arange(N, dtype=np.float32) * np.float32(DT)).astype(np.float32)
    return x, f.astype(np.float32), vol[1:].astype(np.float32)


# --- stage 1: GPCV -------------------------------------------------------------

@pytest.mark.parametrize("opt,ell,iters", [("ngvi", None, 8),
                                           ("adam", None, 30),
                                           ("ngvi", "quadrature", 8),
                                           ("adam", "quadrature", 30)])
def test_learn_gpcv(data, opt, ell, iters):
    x, f, _ = data
    if ell is None:
        want = jtrain.learn_gpcv(j32(x), j32(f), iters, opt=opt)
    else:  # the JAX entry has no ell_method: its own steps, with one
        module = JGPCV(kernel="bm", q="tridiag", ell_method=ell)
        yy = jtrain.scaled_returns(j32(x), j32(f))
        params, _ = jtrain._fit_gpcv(module, module.init(j32(x), yy), j32(x),
                                     yy, iters, 0.01, opt)
        want = JGPCVState(module=module, params=params, train_x=j32(x),
                          targets=yy).predicted_scale()
    got, state = ttrain.learn_gpcv(t32(x), t32(f), iters, opt=opt,
                                   ell_method=ell, return_model=True)
    close(got, want, NGVI_RTOL if opt == "ngvi" else ADAM_RTOL)
    assert state.module.ell_method == ell and state.targets.shape == (N,)


def test_ngvi_loss_trajectory(data):
    x, f, _ = data
    module = JGPCV(kernel="bm", q="tridiag")
    yy = jtrain.scaled_returns(j32(x), j32(f))
    params, losses = j_ngvi(module, module.init(j32(x), yy), j32(x), yy, 10)
    tm = GPCVModel(q="tridiag").init(t32(x), t32(np.asarray(yy)))
    got = ngvi_tridiag_fit(tm, t32(x), t32(np.asarray(yy)), 10)
    assert got.shape == (10,)
    close(got, losses, NGVI_RTOL, 1e-6)
    close(tm.variational_mean, params["variational_mean"], NGVI_RTOL, 1e-6)
    close(tm.kernel.raw_vol, params["kernel"]["raw_vol"], NGVI_RTOL)


def test_learn_gpcv_monte_carlo_scale(data):
    x, f, _ = data
    key = jax.random.key(2)
    want = jtrain.learn_gpcv(j32(x), j32(f), 4, key=key, mc_scale_samples=10)
    z = jax.random.normal(key, (10, N), np.float32)
    got = ttrain.learn_gpcv(t32(x), t32(f), 4, mc_scale_samples=10,
                            noise=t32(z))
    close(got, want, NGVI_RTOL)


# --- stage 2: vol GP -----------------------------------------------------------

@pytest.mark.parametrize("vol_mll", [None, "kalman"])
def test_train_vol_model(data, vol_mll):
    x, _, vol = data
    want = jtrain.train_vol_model(j32(x), j32(vol), 40, vol_mll=vol_mll)
    got = ttrain.train_vol_model(t32(x), t32(vol), 40, vol_mll=vol_mll)
    close(got.module.kernel.raw_vol, want.params["kernel"]["raw_vol"],
          ADAM_RTOL)
    close(got.module.likelihood.raw_noise,
          want.params["likelihood"]["raw_noise"], ADAM_RTOL)
    close(got.train_y, want.train_y, 1e-6)


# --- stage 3: the Volt data model ----------------------------------------------

@pytest.mark.parametrize("mean", ["ewma", "dewma", "tewma", "meanrevert",
                                  "constant", "linear", "loglinear"])
def test_train_volt_magpie(data, mean):
    x, f, vol = data
    key = jax.random.key(3)
    want = jtrain.train_volt_magpie(j32(x), j32(f[1:]), None, j32(vol), 30,
                                    k=10, mean_func=mean, key=key)
    init = jax_tree_np(JVolt(mean=j_make_mean(mean, k=10)).init(key=key))
    got = ttrain.train_volt_magpie(t32(x), t32(f[1:]), None, t32(vol), 30,
                                   k=10, mean_func=mean, init_params=init)
    close(got.module.likelihood.raw_noise,
          want.params["likelihood"]["raw_noise"], ADAM_RTOL)
    for name, p in got.module.mean.named_parameters():
        close(p, want.params["mean"][name], ADAM_RTOL, 1e-4)
    with torch.no_grad():
        close(got.mll(), want.mll(), ADAM_RTOL)


def test_train_data_model(data):
    x, f, vol = data
    key = jax.random.key(4)
    want = jtrain.train_data_model(j32(x), j32(f[1:]), None, j32(vol), 30,
                                   key=key)
    init = jax_tree_np(JVolt(mean=JLogLinear(1)).init(key=key))
    got = ttrain.train_data_model(t32(x), t32(f[1:]), None, t32(vol), 30,
                                  init_params=init)
    for name, p in got.module.mean.named_parameters():
        close(p, want.params["mean"][name], ADAM_RTOL, 1e-4)
    close(got.module.likelihood.raw_noise,
          want.params["likelihood"]["raw_noise"], ADAM_RTOL)


def test_aliases_and_unported_entries(data):
    x, f, _ = data
    assert ttrain.LearnGPCV is ttrain.learn_gpcv
    assert ttrain.TrainVolModel is ttrain.train_vol_model
    assert ttrain.TrainDataModel is ttrain.train_data_model
    assert ttrain.TrainVoltMagpieModel is ttrain.train_volt_magpie
    # ported: a short call of each runs
    got = ttrain.learn_gpcv(t32(x), t32(f), 2, q="full")
    assert got.shape == (N,) and torch.isfinite(got).all()
    got = ttrain.learn_gpcv_sparse(t32(x), t32(f), num_inducing=8,
                                   train_iters=2)
    assert got.shape == (N,) and torch.isfinite(got).all()
    fs = torch.stack([t32(f), t32(f) * 1.01])
    got = ttrain.learn_gpcv_multitask(t32(x), fs, 2)
    assert got.shape == (2, N) and torch.isfinite(got).all()
    volt, mt = ttrain.train_volt_multitask(t32(x), fs[:, 1:], got, 2, 2)
    assert volt.train_y.shape == (2, N) and mt.train_y.shape == (N, 2)
    got = ttrain.TrainBasicModel(t32(x), t32(f[1:]), 2)
    assert got.train_y.shape == (N,) and torch.isfinite(
        got.module.mll(got.train_x, got.train_y))
    # train_iters=0 fits nothing and returns no losses, as JAX's scan
    assert ttrain.adam_loop(got.module, lambda: got.module.mll(
        got.train_x, got.train_y), 0, 0.1).shape == (0,)
    batched = torch.nn.Module()
    batched.p = torch.nn.Parameter(torch.ones(2, dtype=torch.float64))
    empty = ttrain.adam_loop(batched, lambda: batched.p ** 2, 0, 0.1)
    assert empty.shape == (0, 2) and empty.dtype == torch.float64
    assert Volt(t32(x), torch.zeros(2, N)).batched
    with pytest.raises(ValueError):
        ttrain.learn_gpcv(t32(x), t32(f), 2, q="full", opt="ngvi")

"""The forecasts of the reference API against the JAX package's, each given
the normals the JAX function drew from its key (rebuilt by its own key
recipe): ``generate_prediction``, ``volt_posterior``,
``sample_prediction``, ``mean_prediction``, ``rollouts`` with ``theta``,
the vol sampler's dense fallback, the dense twins
(``generate_prediction_dense``, ``rollouts_dense`` with pinned draws) and
``Volt.Train`` / ``Forecast`` end to end.

Tolerances: closed forms rtol 1e-5 with atol 1e-5 on log prices near 4.6;
the dense twins (a Cholesky and a solve per step) atol 2e-4 (JAX against
port) and 5e-4 (dense against Markov, the JAX package's own bound); the
end-to-end forecast after NGVI and Adam fits rtol 2e-3 / atol 1e-3, the
pipeline parity tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu import rollouts as jro
from volt_tpu.data import sabr_paths
from volt_tpu.models.bmgp import BMGP as JBMGP
from volt_tpu.models.volt import VoltGP as JVolt, make_mean as j_make_mean
from volt_tpu.models.volt_api import Volt as JVoltAPI

from volt_tpu_torch import rollouts as tro
from volt_tpu_torch.convert import load_jax_params
from volt_tpu_torch.models import BMGP, Volt, VoltGP, make_mean

N, H, S, DT = 60, 8, 16, 1.0 / 252
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def base():
    f, vol = sabr_paths(steps=N + 1, seed=21)
    x = (np.arange(1, N + 1, dtype=np.float32) * np.float32(DT)).astype(
        np.float32)
    test_x = (x[-1] + np.arange(1, H + 1, dtype=np.float32)
              * np.float32(DT)).astype(np.float32)
    vol_params = {"kernel": {"raw_vol": np.asarray([-1.0], np.float32)},
                  "likelihood": {"raw_noise": np.asarray([-4.0], np.float32)}}
    return {"x": x, "f": f.astype(np.float32), "test_x": test_x,
            "vol": vol[1:].astype(np.float32), "vol_params": vol_params}


def _states(base, mean="constant", k=10, rule="reference"):
    """The same fitted state in both packages."""
    x, log_y, vol = base["x"], np.log(base["f"][1:]), base["vol"]
    jb = JBMGP()
    jvs = jb.fit_state(base["vol_params"], j32(x), j32(np.log(vol)))
    tb = load_jax_params(BMGP(), base["vol_params"])
    tvs = tb.fit_state(t32(x), t32(np.log(vol)))
    jv = JVolt(mean=j_make_mean(mean, k=k), integral_rule=rule)
    params = jv.init()
    params["likelihood"]["raw_noise"] = jnp.asarray([-5.0], jnp.float32)
    if mean == "constant":
        params["mean"]["constant"] = jnp.asarray([4.6], jnp.float32)
    jstate = jv.fit_state(params, j32(x), j32(log_y), j32(vol), jvs)
    tv = load_jax_params(VoltGP(mean=make_mean(mean, k=k),
                                integral_rule=rule), jax_tree_np(params))
    return jstate, tv.fit_state(t32(x), t32(log_y), t32(vol), tvs)


def _pred_vol(seed, shape):
    return (0.2 + 0.05 * np.random.default_rng(seed).random(shape)).astype(
        np.float32)


# --- one-shot predictions ----------------------------------------------------

@pytest.mark.parametrize("rule,latent", [("reference", None),
                                         ("trapezoid", 4.5)])
def test_generate_prediction_and_volt_posterior(base, rule, latent):
    jstate, tstate = _states(base, rule=rule)
    pv, key = _pred_vol(0, H), jax.random.key(5)
    lat = None if latent is None else np.float32(latent)
    want = jro.generate_prediction(key, jstate, j32(base["test_x"]), j32(pv),
                                   6, latent_mean=lat, theta=0.3)
    z = jax.random.normal(key, (6, H), jnp.float32)
    got = tro.generate_prediction(None, tstate, t32(base["test_x"]), t32(pv),
                                  6, latent_mean=lat, theta=0.3, noise=t32(z))
    close(got, want, RTOL, ATOL)
    for a, b in zip(tro.volt_posterior(tstate, t32(base["test_x"]), t32(pv),
                                       lat, 0.3),
                    jro.volt_posterior(jstate, j32(base["test_x"]), j32(pv),
                                       lat, 0.3)):
        close(a, b, RTOL, 1e-7)
    with pytest.raises(ValueError):
        tro.generate_prediction(None, _states(base, "ewma")[1],
                                t32(base["test_x"]), t32(pv))


def test_sample_and_mean_prediction(base):
    jstate, tstate = _states(base)
    tx = base["test_x"]
    key = jax.random.key(6)
    want, want_vol = jro.sample_prediction(key, jstate, j32(tx), 5,
                                           return_vol=True)
    k1, k2 = jax.random.split(key)
    noise = {"vol": t32(jax.random.normal(k1, (H,), jnp.float32)),
             "z": t32(jax.random.normal(k2, (5, H), jnp.float32))}
    got, got_vol = tro.sample_prediction(None, tstate, t32(tx), 5,
                                         return_vol=True, noise=noise)
    close(got_vol, want_vol, 1e-4, 1e-6)
    close(got, want, 1e-4, ATOL)

    want = jro.mean_prediction(key, jstate, j32(tx), 5)
    z = t32(jax.random.normal(key, (5, H), jnp.float32))
    close(tro.mean_prediction(None, tstate, t32(tx), 5, noise=z), want, 1e-4,
          ATOL)


# --- rollouts ----------------------------------------------------------------

@pytest.mark.parametrize("mean,theta", [("ewma", 0.05), ("dewma", None)])
def test_rollouts_with_jax_draws(base, mean, theta):
    jstate, tstate = _states(base, mean)
    key = jax.random.key(7)
    want = jro.rollouts(key, jstate, j32(base["x"]), j32(base["f"]),
                        j32(base["test_x"]), nsample=S, theta=theta)
    k_vol, k_z = jax.random.split(key)
    k0, k1 = jax.random.split(k_vol)
    noise = {"vol_r0": t32(jax.random.normal(k0, (S,), jnp.float32)),
             "vol_z": t32(jax.random.normal(k1, (S, H), jnp.float32)),
             "zs": t32(jax.random.normal(k_z, (S, H), jnp.float32))}
    got = tro.rollouts(None, tstate, t32(base["x"]), t32(base["f"]),
                       t32(base["test_x"]), nsample=S, theta=theta,
                       noise=noise)
    close(got, want, RTOL, ATOL)
    own = tro.rollouts(torch.Generator().manual_seed(0), tstate,
                       t32(base["x"]), t32(base["f"]), t32(base["test_x"]),
                       nsample=S)
    assert own.shape == (S, H) and torch.isfinite(own).all()


def test_vol_sampler_falls_back_to_the_dense_posterior(base):
    """A grid that is not strictly future takes the dense sampler, as in
    the JAX package; ``assume_future=True`` poisons it instead."""
    jstate, tstate = _states(base)
    inside = base["x"][20:26]
    key = jax.random.key(8)
    want = jro.sample_vol_paths(key, jstate.vol_state, j32(inside), 4)
    z = t32(jax.random.normal(key, (4, 6), jnp.float32))
    got = tro.sample_vol_paths(tstate.vol_state, t32(inside), 4, noise=z)
    close(got, want, 1e-4, 1e-6)
    poisoned = tro.sample_vol_paths(tstate.vol_state, t32(inside), 4,
                                    generator=torch.Generator().manual_seed(0),
                                    assume_future=True)
    assert torch.isnan(poisoned).all()


# --- the dense twins -----------------------------------------------------------

def test_generate_prediction_dense(base):
    jstate, tstate = _states(base)
    tx, pv, key = base["test_x"], _pred_vol(1, H), jax.random.key(9)
    want = jro.generate_prediction_dense(key, jstate, j32(tx), j32(pv), 6)
    z = jax.random.normal(key, (6, H), jnp.float32)
    got = tro.generate_prediction_dense(None, tstate, t32(tx), t32(pv), 6,
                                        noise=t32(z))
    close(got, want, 1e-4, 2e-4)
    # the conditional's Cholesky is the Brownian factor: with the same
    # normals the dense draw is the Markov one
    fast = tro.generate_prediction(None, tstate, t32(tx), t32(pv), 6,
                                   noise=t32(z))
    close(got, fast, 1e-4, 5e-4)
    # a Magpie mean takes single-point queries only
    _, tewma = _states(base, "ewma")
    one = tro.generate_prediction_dense(None, tewma, t32(tx[:1]),
                                        t32(pv[:1]), 3,
                                        noise=torch.zeros(3, 1))
    assert one.shape == (3, 1)
    with pytest.raises(ValueError):
        tro.generate_prediction_dense(None, tewma, t32(tx), t32(pv), 3)


@pytest.mark.parametrize("mean,theta", [("ewma", None), ("meanrevert", None),
                                        ("constant", 0.05)])
def test_rollouts_dense_pinned(base, mean, theta):
    jstate, tstate = _states(base, mean)
    pv = _pred_vol(2, (S, H))
    zs = np.random.default_rng(3).standard_normal((S, H)).astype(np.float32)
    args = (base["x"], base["f"], base["test_x"])
    want = jro.rollouts_dense(jax.random.key(0), jstate, *map(j32, args),
                              nsample=S, theta=theta, pred_vol=j32(pv),
                              zs=j32(zs))
    got = tro.rollouts_dense(None, tstate, *map(t32, args), nsample=S,
                             theta=theta, pred_vol=t32(pv), zs=t32(zs))
    close(got, want, 1e-4, 2e-4)
    use = theta is not None
    latent = torch.log(t32(base["f"])).mean()
    with torch.no_grad():
        fast = tro._rollout_volt_scan(tstate, latent, t32(base["test_x"]),
                                      t32(pv), t32(zs), use, theta or 0.0)
    close(got, fast, 1e-4, 5e-4)


def test_rollouts_dense_own_draws(base):
    _, tstate = _states(base, "ewma")
    got = tro.rollouts_dense(torch.Generator().manual_seed(1), tstate,
                             t32(base["x"]), t32(base["f"]),
                             t32(base["test_x"][:3]), nsample=4)
    assert got.shape == (4, 3) and torch.isfinite(got).all()


# --- Volt end to end -----------------------------------------------------------

@pytest.mark.parametrize("mean_revert", [False, True])
def test_volt_train_and_forecast(base, mean_revert):
    x_full = np.concatenate([[0.0], base["x"]]).astype(np.float32)
    log_data = np.log(base["f"]).astype(np.float32)
    iters = dict(gpcv_iters=6, vol_mod_iters=30, data_mod_iters=20)
    jv = JVoltAPI(j32(x_full), j32(log_data), mean="ewma", k=10)
    jv.Train(**iters)
    key = jax.random.key(10)
    want = jv.Forecast(j32(base["test_x"]), nsample=S,
                       mean_revert=mean_revert, key=key)
    k_vol, k_z = jax.random.split(key)
    k0, k1 = jax.random.split(k_vol)
    noise = {"vol_r0": t32(jax.random.normal(k0, (S,), jnp.float32)),
             "vol_z": t32(jax.random.normal(k1, (S, H), jnp.float32)),
             "zs": t32(jax.random.normal(k_z, (S, H), jnp.float32))}
    tv = Volt(t32(x_full), t32(log_data), mean="ewma", k=10)
    with pytest.raises(RuntimeError):
        tv.Forecast(t32(base["test_x"]))
    state = tv.Train(**iters)
    got = tv.Forecast(t32(base["test_x"]), nsample=S,
                      mean_revert=mean_revert, noise=noise)
    assert got.shape == (S, H)
    close(got, want, 2e-3, 1e-3)
    close(torch.exp(state.log_vol_path), jnp.exp(jv.model.log_vol_path), 1e-3)
    # a supplied vol path skips GPCV
    fixed = Volt(t32(x_full), t32(log_data), mean="constant",
                 vol_path=t32(base["vol"]))
    assert torch.allclose(torch.exp(fixed.Train(**iters).log_vol_path),
                          t32(base["vol"]))

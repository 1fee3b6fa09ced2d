"""Every mean of the port against the JAX package's: the deterministic means
(values and gradients from the same parameters), the Magpie means' full
filter forms, both scan protocols step by step, the scan states against
the full filter of the grown series, and the Markov rollout with each mean.
float32; rtol 1e-5 with atol 1e-5 on log-price-sized values (the O(1)
scan sums reassociate the filter), unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu import means as jmeans
from volt_tpu.models.volt import VoltGP as JVolt, make_mean as j_make_mean
from volt_tpu.rollouts import _rollout_volt_scan as j_rollout

from volt_tpu_torch import means as tmeans
from volt_tpu_torch.convert import load_jax_params
from volt_tpu_torch.models import VoltGP, make_mean
from volt_tpu_torch.rollouts import _rollout_volt_scan as t_rollout

RTOL, ATOL = 1e-5, 1e-5
HIST = {"ewma": "EWMAMean", "dewma": "DEWMAMean", "tewma": "TEWMAMean",
        "hewma": "HEWMAMean", "meanrevert": "MeanRevertingEMAMean"}


def _series(seed, shape=(2, 50)):
    rs = np.random.default_rng(seed)
    return (4.6 + 0.02 * np.cumsum(rs.standard_normal(shape), -1)).astype(
        np.float32)


def _pair(name, k):
    return getattr(jmeans, HIST[name])(k), getattr(tmeans, HIST[name])(k)


# --- deterministic means ----------------------------------------------------

@pytest.mark.parametrize("name", ["constant", "linear", "loglinear",
                                  "mulidentity"])
def test_deterministic_means(name):
    jcls = {"constant": jmeans.ConstantMean, "linear": jmeans.LinearMean,
            "loglinear": jmeans.LogLinearMean,
            "mulidentity": jmeans.MulIdentityMean}[name]
    jm = jcls()
    tm = getattr(tmeans, jcls.__name__)()
    x = (np.arange(1, 31, dtype=np.float32) / np.float32(252)).astype(
        np.float32)
    params = jax_tree_np(jax.vmap(lambda k: jm.init(key=k))(
        jax.random.split(jax.random.key(0), 2)))
    rs = np.random.default_rng(1)
    params = {k: (v + rs.random(v.shape) + (50.0 if k == "bias" else 0.0))
              .astype(np.float32) for k, v in params.items()}
    tm.init((2,))
    load_jax_params(tm, params)

    def jval(p):
        return jax.vmap(lambda pp: jm(pp, j32(x)))(p)

    got = tm(t32(x))
    close(got, jval(params), RTOL, 1e-6)
    got.sum().backward()
    grads = jax.grad(lambda p: jnp.sum(jval(p)))(params)
    for k, p in tm.named_parameters():
        close(p.grad, grads[k], 1e-4, 1e-6)


def test_loglinear_initialize_from_data_and_random_init():
    log_y = _series(2)
    x = np.arange(50, dtype=np.float32)
    jm = jmeans.LogLinearMean(1, batch_shape=(2,))
    want = jm.initialize_from_data(jm.init(), j32(x), j32(log_y))
    tm = tmeans.LogLinearMean(1).init((2,), generator=torch.Generator()
                                      .manual_seed(0))
    assert tm.weights.shape == (2, 1, 1) and tm.bias.shape == (2, 1)
    tm.initialize_from_data(t32(x), t32(log_y))
    close(tm.bias, want["bias"], RTOL)


# --- Magpie means: full filter forms ----------------------------------------

@pytest.mark.parametrize("name", list(HIST))
@pytest.mark.parametrize("k", [20, 7])
def test_history_mean_full_forms(name, k):
    y = _series(3)
    jm, tm = _pair(name, k)
    for form in ("full_values", "train_values", "last_value"):
        close(getattr(tm, form)(t32(y)), getattr(jm, form)({}, j32(y)), RTOL,
              ATOL)
    if name == "meanrevert":
        lat = np.float32(4.5)
        close(tm.full_values(t32(y), torch.tensor(lat)),
              jm.full_values({}, j32(y), j32(lat)), RTOL, ATOL)


# --- Magpie means: scan protocols -------------------------------------------

STEPS = 6


@pytest.mark.parametrize("name", ["ewma", "dewma", "tewma", "meanrevert"])
@pytest.mark.parametrize("k", [20, 7])
def test_scan_protocols_match_jax_and_the_full_filter(name, k):
    y = _series(4)
    new = _series(5, (STEPS, 2)) + np.float32(0.01)
    jm, tm = _pair(name, k)

    js, ts = jm.scan_init({}, j32(y)), tm.scan_init(t32(y))
    jc, jxs = jm.scan_fast_init({}, j32(y), STEPS)
    tc, txs = tm.scan_fast_init(t32(y), STEPS)
    grown = y
    for t in range(STEPS):
        want = jm.scan_value({}, js)
        close(tm.scan_value(ts), want, RTOL, ATOL)
        close(tm.scan_fast_value(tc), jm.scan_fast_value({}, jc), RTOL, ATOL)
        # both protocols give the full filter's last value on the series
        # grown so far (the meanrevert latent frozen at the train series)
        lat = (np.mean(y, -1, keepdims=True) if name == "meanrevert"
               else None)
        extra = () if lat is None else (t32(lat),)
        close(tm.scan_fast_value(tc),
              tm.full_values(t32(grown), *extra)[..., -1], 1e-5, 2e-5)
        js = jm.scan_append({}, js, j32(new[t]))
        ts = tm.scan_append(ts, t32(new[t]))
        jc = jm.scan_fast_append({}, jc, {kk: v[t] for kk, v in jxs.items()},
                                 j32(new[t]))
        tc = tm.scan_fast_append(tc, {kk: v[..., t] for kk, v in txs.items()},
                                 t32(new[t]))
        grown = np.concatenate([grown, new[t][:, None]], -1)
    assert tm.scan_fast_supported(k) and not tm.scan_fast_supported(k + 1)


def test_hewma_cannot_drive_rollouts():
    tm = tmeans.HEWMAMean(16)
    assert not tm.scan_fast_supported(1)
    with pytest.raises(NotImplementedError):
        tm.scan_init(t32(_series(6)))


# --- the Markov rollout with every mean --------------------------------------

@pytest.mark.parametrize("mean,k,theta", [
    ("dewma", 20, None), ("tewma", 20, None), ("meanrevert", 20, None),
    ("dewma", 4, 0.2), ("meanrevert", 4, None),   # window protocol (H > k)
    ("linear", 20, None), ("loglinear", 20, 0.3),
])
def test_rollout_with_each_mean(mean, k, theta):
    rs = np.random.default_rng(7)
    n, h, s = 60, 8, 16
    x = (np.arange(1, n + 1, dtype=np.float32) / np.float32(252)).astype(
        np.float32)
    log_y = _series(8, (n,))
    vol = (0.2 + 0.05 * rs.random(n)).astype(np.float32)
    test_x = (x[-1] + np.arange(1, h + 1, dtype=np.float32)
              / np.float32(252)).astype(np.float32)
    pred_vol = (0.2 + 0.05 * rs.random((s, h))).astype(np.float32)
    zs = rs.standard_normal((s, h)).astype(np.float32)
    latent = np.float32(4.55)

    jv = JVolt(mean=j_make_mean(mean, k=k))
    jparams = jv.init(key=jax.random.key(1))
    if mean == "loglinear":
        jparams["mean"]["bias"] = jnp.asarray([100.0], jnp.float32)
    jstate = jv.fit_state(jparams, j32(x), j32(log_y), j32(vol))
    use = theta is not None
    want = j_rollout(jstate, jnp.float32(latent), j32(test_x), j32(pred_vol),
                     j32(zs), use, jnp.float32(theta or 0.0))
    tv = load_jax_params(VoltGP(mean=make_mean(mean, k=k)),
                         jax_tree_np(jparams))
    got = t_rollout(tv.fit_state(t32(x), t32(log_y), t32(vol)),
                    torch.tensor(latent), t32(test_x), t32(pred_vol), t32(zs),
                    use, theta or 0.0)
    close(got, want, RTOL, ATOL)

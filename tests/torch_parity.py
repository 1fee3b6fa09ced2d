"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
inputs go through a ``volt_tpu`` function (JAX on the CPU) and its
``volt_tpu_torch`` counterpart, compared in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

# one thread per pytest worker: the suite runs several workers at once
torch.set_num_threads(1)


def t32(a):
    """numpy / JAX array -> float32 CPU tensor."""
    return torch.tensor(np.asarray(a, np.float32))


def j32(a):
    """numpy array -> float32 JAX array."""
    return jnp.asarray(np.asarray(a, np.float32))


def close(got, want, rtol, atol=0.0):
    """``assert_allclose`` of a tensor / array pair (or nested dicts)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (set(got), set(want))
        for k in want:
            close(got[k], want[k], rtol, atol)
        return
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def jax_tree_np(tree):
    """JAX pytree -> the same nesting of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def jax_pipeline_noise(key, batch: int, nsample: int, horizon: int):
    """The standard normals ``volt_tpu.parallel.fit_forecast_batch`` draws
    from ``key``, rebuilt by its own key recipe (``pipeline.py`` splits
    one key per asset, then ``(k_lik, k_roll)``, ``(k_vol, k_z)``, and
    ``BMGP.sample_forecast`` splits ``k_vol`` into ``(k0, k1)``), in the
    port's injected-noise layout."""
    r0, vz, zs = [], [], []
    for k in jax.random.split(key, batch):
        _, k_roll = jax.random.split(k)
        k_vol, k_z = jax.random.split(k_roll)
        k0, k1 = jax.random.split(k_vol)
        r0.append(jax.random.normal(k0, (nsample,), jnp.float32))
        vz.append(jax.random.normal(k1, (nsample, horizon), jnp.float32))
        zs.append(jax.random.normal(k_z, (nsample, horizon), jnp.float32))
    return {"vol_r0": t32(np.stack(r0)), "vol_z": t32(np.stack(vz)),
            "zs": t32(np.stack(zs))}


def jax_multitask_noise(key, tasks: int, n: int, nsample: int, horizon: int):
    """The standard normals ``volt_tpu.parallel.fit_forecast_multitask``
    draws from ``key`` (``(k_lik, k_roll)``, then ``(k_vol, k_z)``;
    ``MultitaskBMGP.sample_forecast`` splits ``k_vol`` into ``(k0, k1)``
    for its ``z`` and ``eps``), in the port's injected-noise layout."""
    _, k_roll = jax.random.split(key)
    k_vol, k_z = jax.random.split(k_roll)
    k0, k1 = jax.random.split(k_vol)
    return {"vol_z": t32(jax.random.normal(k0, (nsample, n + horizon, tasks))),
            "vol_eps": t32(jax.random.normal(k1, (nsample, n, tasks))),
            "zs": t32(jax.random.normal(k_z, (tasks, nsample, horizon)))}

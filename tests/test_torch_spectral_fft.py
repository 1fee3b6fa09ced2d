"""The port's min-kernel projection above n = 4096 (``method="fft"``, a
real FFT of length 2(2n+1)) against the JAX package's matmul and
Bluestein FFT branches, ``"auto"``'s switch at 4096, and
``BMGP.spectral_cache`` at n > 4096 against the Kalman MLL.

Tolerances: float32 projections within 2e-6 of max|out| (largest seen
5.9e-7, 0.29 of it, at n = 4096 against JAX's matmul: both are sums of
n terms rounded in float32); float64 FFT against the float64 matmul
1e-10 of max|out| (seen 9e-16); the spectral MLL at n = 5000 against the
Kalman MLL and JAX's spectral MLL rtol 1e-4 (float32; 0.28 of it used)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import j32, t32

from volt_tpu.ops import brownian as jbr

from volt_tpu_torch.models import BMGP
from volt_tpu_torch.ops import brownian as tbr

TOL32 = 2e-6


def _rel_max(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def rs():
    return np.random.default_rng(6)


@pytest.mark.parametrize("n", [11, 257, 4096])
@pytest.mark.parametrize("jax_method", ["matmul", "fft"])
def test_fft_matches_jax(rs, n, jax_method):
    y = rs.standard_normal((2, n)).astype(np.float32)
    want = jbr.min_kernel_project(j32(y), method=jax_method)
    assert _rel_max(tbr.min_kernel_project(t32(y), method="fft"),
                    want) <= TOL32


@pytest.mark.parametrize("n", [11, 257, 4096])
def test_fft_along_an_axis_and_a_vector(rs, n):
    y = rs.standard_normal((n, 3)).astype(np.float32)
    want = jbr.min_kernel_project(j32(y), axis=0, method="matmul")
    got = tbr.min_kernel_project(t32(y), axis=0, method="fft")
    assert got.shape == (n, 3) and _rel_max(got, want) <= TOL32
    v = y[:, 0]
    got = tbr.min_kernel_project(t32(v), method="fft")
    assert got.shape == (n,)
    assert _rel_max(got, jbr.min_kernel_project(j32(v), method="matmul")) \
        <= TOL32


def test_long_series_matches_jax_fft(rs):
    """n = 5003, above the switch: JAX projects by its Bluestein FFT."""
    y = rs.standard_normal((2, 5003)).astype(np.float32)
    want = jbr.min_kernel_project(j32(y))
    got = tbr.min_kernel_project(t32(y))
    assert _rel_max(got, want) <= TOL32


@pytest.mark.parametrize("n", [257, 4096])
def test_float64(rs, n):
    y = torch.tensor(rs.standard_normal((2, n)))
    got = tbr.min_kernel_project(y, method="fft")
    want = tbr.min_kernel_project(y, method="matmul")
    assert got.dtype == torch.float64
    assert _rel_max(got, want) <= 1e-10


def test_auto_switches_above_4096(rs):
    for n, way in ((4096, "matmul"), (4097, "fft")):
        y = t32(rs.standard_normal((2, n)))
        assert torch.equal(tbr.min_kernel_project(y),
                           tbr.min_kernel_project(y, method=way))
    with pytest.raises(ValueError):
        tbr.min_kernel_project(y, method="dst")


def test_spectral_cache_long_series(rs):
    """``BMGP.spectral_cache`` at n = 5000 (the FFT), its MLL against the
    Kalman MLL of the same module, and against JAX's spectral MLL."""
    from volt_tpu.models.bmgp import BMGP as JBMGP

    n = 5000
    x = (np.arange(1, n + 1) / 252.0).astype(np.float32)
    y = (-3.0 + 0.1 * np.cumsum(rs.standard_normal((2, n)), -1) / np.sqrt(
        n)).astype(np.float32)
    m = BMGP().init((2,))
    with torch.no_grad():
        m.kernel.raw_vol.fill_(0.3)
        m.likelihood.raw_noise.fill_(-2.0)
        got = m.mll_spectral(m.spectral_cache(t32(x), t32(y)))
        want = m.mll_kalman(t32(x), t32(y))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4)
    jm = JBMGP(batch_shape=(2,))
    params = {"kernel": {"raw_vol": jnp.full((2, 1), 0.3)},
              "likelihood": {"raw_noise": jnp.full((2, 1), -2.0)}}
    jwant = jm.mll_spectral(params, jm.spectral_cache(j32(x), j32(y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-4)

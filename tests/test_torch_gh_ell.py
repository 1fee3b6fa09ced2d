"""The GH-75 expected log-likelihood (K3's plain version) against the JAX
package's Pallas kernel in interpret mode, values and gradients, on inputs
that reach both clamp regions; the likelihood's three ELL methods, its
Monte-Carlo predicted scale, and the GPCV ELBO trained on the GH term.

Tolerances: values rtol 1e-5 with atol 1e-6 (where the node sum cancels to
near zero only the float32 rounding of its O(1) terms is left);
gradients rtol 1e-4 with atol 1e-6 of the largest, d/dvar plus the float32
resolution of its node sum (``var_grad_resolution``).

Kernel K3's node arithmetic (``csrc/gh_ell.cu``: no log, one reciprocal
per node, the gradient's three node sums kept by the forward, the node
loop split over lanes combined by a butterfly) is checked here too, by a
float32 emulation with the split as a parameter, against the Pallas kernel
and its ``jax.vjp`` at the same tolerances."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu.likelihoods import VolatilityGaussianLikelihood as JLik
from volt_tpu.models.gpcv import GPCVModel as JGPCV
from volt_tpu.ops.pallas import gh_expected_log_prob as j_gh
from volt_tpu.train import scaled_returns as j_scaled_returns

from volt_tpu_torch.convert import load_jax_params
from volt_tpu_torch.likelihoods import VolatilityGaussianLikelihood
from volt_tpu_torch.models import GPCVModel
from volt_tpu_torch.ops import gh_ell as tgh
from volt_tpu_torch.ops.gh_ell import (_gh_ell_plain, gh_expected_log_prob,
                                       var_grad_resolution)


def _inputs(seed, shape, wide):
    """``wide``: mean from -10 to 85 and variance from 1e-8 to 4, so both
    clamps (scale 1e-3 and f 80) are reached; else the fitted regime."""
    rs = np.random.default_rng(seed)
    y = (0.05 * rs.standard_normal(shape)).astype(np.float32)
    if wide:
        mu = (-10.0 + 95.0 * rs.random(shape)).astype(np.float32)
        s2 = (10.0 ** (-8.0 + 8.6 * rs.random(shape))).astype(np.float32)
    else:
        mu = (-1.5 + 0.3 * rs.standard_normal(shape)).astype(np.float32)
        s2 = (0.05 + 0.1 * rs.random(shape)).astype(np.float32)
    return y, mu, s2


INPUT_CASES = [((3, 37), True), ((2, 90), False), ((130,), True)]


@functools.cache
def _pallas(shape, wide):
    """Inputs, cotangent, and the Pallas kernel's value and gradients
    (computed once per case; callers must not modify them)."""
    y, mu, s2 = _inputs(0, shape, wide)
    cot = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: j_gh(a, b, c, interpret=True),
                        j32(y), j32(mu), j32(s2))
    return (y, mu, s2), cot, want, vjp(j32(cot))


def _check_grads(got, want, y, mu, s2, cot):
    extra = (0.0, 0.0, var_grad_resolution(t32(y), t32(mu), t32(s2),
                                           t32(cot)).numpy())
    for p, q, e in zip(got, want, extra):
        q = np.asarray(q)
        tol = 1e-4 * np.abs(q) + 1e-6 * np.abs(q).max() + e
        assert np.all(np.abs(p.numpy() - q) <= tol)


@pytest.mark.parametrize("shape,wide", INPUT_CASES)
def test_gh_plain_matches_pallas_values_and_gradients(shape, wide):
    (y, mu, s2), cot, want, want_grads = _pallas(shape, wide)
    ins = [t32(a).requires_grad_() for a in (y, mu, s2)]
    got = gh_expected_log_prob(*ins)
    close(got, want, 1e-5, 1e-6)
    (got * t32(cot)).sum().backward()
    _check_grads([t.grad for t in ins], want_grads, y, mu, s2, cot)


# ---------------------------------------------------------------------------
# Kernel K3's fused node pass, emulated
# ---------------------------------------------------------------------------

_LOG_SCALE_MIN = float(np.float32(np.log(np.float64(np.float32(1e-3)))))


def fused_node_pass(y, mu, s2, split, num_locs=75):
    """``(E, node sums (3, ...))`` as kernel K3's forward with ``save``
    computes them in float32: lane ``j`` of a datum's ``split`` lanes sums
    the nodes ``j, j + split, ...`` in order, and a butterfly over the
    lanes (``__shfl_xor_sync``) combines the lanes' sums."""
    x, w = (t.reshape(-1, *(1,) * y.dim())
            for t in tgh._nodes(num_locs, "cpu").chunk(2))
    sd = torch.sqrt(2.0 * s2)
    f = sd * x + mu
    fc = torch.where(f >= 80.0, 80.0, f)
    ef = torch.exp(fc)
    clamped = ef <= 1e-3
    inv = 1.0 / torch.where(clamped, torch.tensor(1e-3), ef)
    r = y * inv
    lp = -0.5 * r * r - torch.where(clamped, _LOG_SCALE_MIN, fc) - \
        tgh._HALF_LOG_2PI
    live = (ef > 1e-3) & (f < 80.0)
    dlp = (r * r - 1.0) * live
    sums = []
    for term in (w * lp, w * (-r * inv), w * dlp, (w * x) * dlp):
        lanes = []
        for j in range(split):
            acc = torch.zeros_like(y)
            for k in range(j, num_locs, split):
                acc = acc + term[k]
            lanes.append(acc)
        off = split // 2
        while off:
            lanes = [lanes[j] + lanes[j ^ off] for j in range(split)]
            off //= 2
        sums.append(lanes[0])
    return sums[0], torch.stack(sums[1:])


def fused_backward(s2, g, saved):
    """K3's elementwise backward: ``g`` times the node sums, and
    ``/ max(sd, 1e-20)`` for d/dvar."""
    inv_sd = 1.0 / torch.clamp(torch.sqrt(2.0 * s2), min=1e-20)
    return g * saved[0], g * saved[1], g * saved[2] * inv_sd


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("shape,wide", INPUT_CASES)
def test_fused_node_pass_matches_pallas(shape, wide, split):
    (y, mu, s2), cot, want, want_grads = _pallas(shape, wide)
    out, saved = fused_node_pass(t32(y), t32(mu), t32(s2), split)
    close(out, want, 1e-5, 1e-6)
    _check_grads(fused_backward(t32(s2), t32(cot), saved), want_grads,
                 y, mu, s2, cot)


def test_gh_overflow_region_finite():
    y, mu, _ = _inputs(2, (30,), False)
    s2 = torch.full((30,), 200.0)
    m = t32(mu).requires_grad_()
    val = gh_expected_log_prob(t32(y), m, s2)
    val.sum().backward()
    assert torch.isfinite(val).all() and torch.isfinite(m.grad).all()


@pytest.mark.parametrize("method", [None, "analytic", "quadrature"])
def test_likelihood_expected_log_prob(method):
    y, mu, s2 = _inputs(3, (2, 50), False)
    want = JLik(param="exp").expected_log_prob({}, j32(y), j32(mu), j32(s2),
                                               method=method)
    got = VolatilityGaussianLikelihood(param="exp").expected_log_prob(
        t32(y), t32(mu), t32(s2), method=method)
    close(got, want, 1e-5, 1e-6)
    if method == "quadrature":
        close(got, _gh_ell_plain(t32(y), t32(mu), t32(s2), 75), 0.0)
    with pytest.raises(ValueError):
        VolatilityGaussianLikelihood(param="exp").expected_log_prob(
            t32(y), t32(mu), t32(s2), method="mc")


def test_expected_scale_gh_and_monte_carlo():
    _, mu, s2 = _inputs(4, (2, 40), False)
    jl, tl = JLik(param="exp"), VolatilityGaussianLikelihood(param="exp")
    close(tl.expected_scale(t32(mu), t32(s2)),
          jl.expected_scale({}, j32(mu), j32(s2)), 1e-5)
    key = jax.random.key(7)
    want = jl.expected_scale({}, j32(mu), j32(s2), mc_samples=10, key=key)
    z = jax.random.normal(key, (10, 2, 40), jnp.float32)
    got = tl.expected_scale(t32(mu), t32(s2), mc_samples=10, noise=t32(z))
    close(got, want, 1e-5)
    own = tl.expected_scale(t32(mu), t32(s2), mc_samples=10,
                            generator=torch.Generator().manual_seed(0))
    assert own.shape == (2, 40) and torch.isfinite(own).all()


def test_gpcv_elbo_on_the_gh_term():
    from volt_tpu.data import sabr_paths

    f, _ = sabr_paths(steps=61, seed=5, n_paths=2)
    x = (np.arange(1, 61, dtype=np.float32) / np.float32(252)).astype(
        np.float32)
    yy = np.asarray(j_scaled_returns(j32(x), j32(f)))
    jm = JGPCV(kernel="bm", q="tridiag", ell_method="quadrature")
    params = jax_tree_np(jax.vmap(lambda y: jm.init(j32(x), y))(j32(yy)))
    rs = np.random.default_rng(6)
    params = jax.tree.map(lambda a: (a + 0.05 * rs.standard_normal(a.shape))
                          .astype(np.float32), params)

    def jelbo(p):
        return jax.vmap(lambda pp, y: jm.elbo(pp, j32(x), y))(p, j32(yy))

    tm = load_jax_params(GPCVModel(q="tridiag", ell_method="quadrature"),
                         params)
    elbo = tm.elbo(t32(x), t32(yy))
    close(elbo, jelbo(params), 1e-5)
    elbo.sum().backward()
    grads = jax.grad(lambda p: jnp.sum(jelbo(p)))(params)
    for path, p in tm.named_parameters():
        g = grads
        for part in path.split("."):
            g = g[part]
        close(p.grad, g, 1e-4, 1e-6 * float(np.max(np.abs(g))))
    with pytest.raises(ValueError):
        GPCVModel(ell_method="mc")

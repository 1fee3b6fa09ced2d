"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
one (which need not have JAX), run them alone, without the JAX test
harness::

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import copy
import importlib
import math

import numpy as np
import pytest
import torch

from volt_tpu_torch import native

tew = importlib.import_module("volt_tpu_torch.ops.ewma")
ttd = importlib.import_module("volt_tpu_torch.ops.tridiag")
tvc = importlib.import_module("volt_tpu_torch.ops.volt_cov")
tgh = importlib.import_module("volt_tpu_torch.ops.gh_ell")
tvi = importlib.import_module("volt_tpu_torch.ops.volint")
tge = importlib.import_module("volt_tpu_torch.ops.gpcv_elbo")
tmg = importlib.import_module("volt_tpu_torch.ops.mt_gpcv_elbo")
tmv = importlib.import_module("volt_tpu_torch.ops.mt_vol_mll")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,k", [((3, 50), 1), ((3, 50), 64),
                                     ((3, 50), 2000), ((2, 3, 37), 7),
                                     ((70000, 3), 2), ((500, 999), 300),
                                     ((500, 999), 25), ((16, 2100), 300)])
def test_ewma_kernel_matches_plain(cuda, shape, k):
    """K1 against a float64 run of the plain filter at 1e-6 max|y| (the
    kernel runs the recurrence in float64), and against the float32 plain
    filter at 1e-5 max|y|."""
    y = 4.0 + torch.randn(*shape, device="cuda", generator=cuda)
    before = native.launches["volt_ewma_filter"]
    got = tew.ewma(y, k)
    assert native.launches["volt_ewma_filter"] == before + 1
    scale = y.abs().max().item()
    torch.testing.assert_close(got.double(), tew._ewma_conv(y.double(), k),
                               rtol=0.0, atol=1e-6 * scale)
    torch.testing.assert_close(got, tew._ewma_conv(y, k), rtol=0.0,
                               atol=1e-5 * scale)


def test_ewma_kernel_nan_stays_in_its_row(cuda):
    """A NaN runs from its step to the end of its row (the recurrence
    carries it); every other row equals the plain filter."""
    y = 4.0 + torch.randn(64, 999, device="cuda", generator=cuda)
    y[5, 100] = float("nan")
    got, want = tew.ewma(y, 300), tew._ewma_conv(y, 300)
    others = torch.arange(64, device="cuda") != 5
    torch.testing.assert_close(got[others], want[others], rtol=0.0,
                               atol=1e-5 * y[others].abs().max().item())
    torch.testing.assert_close(got[5, :101], want[5, :101], rtol=0.0,
                               atol=1e-5 * y[5, :100].abs().max().item())
    assert bool(torch.isnan(got[5, 101:]).all())


def test_ewma_kernel_no_grad_call_launches_once(cuda):
    """Without a gradient the wrapper skips the autograd function and
    launches K1 once, as with one."""
    y = torch.randn(4, 40, device="cuda", generator=cuda, requires_grad=True)
    for ctx, wants_grad in ((torch.no_grad(), False),
                            (torch.enable_grad(), True)):
        before = native.launches["volt_ewma_filter"]
        with ctx:
            out = tew.ewma(y, 9)
        assert native.launches["volt_ewma_filter"] == before + 1
        assert out.requires_grad == wants_grad
    before = native.launches["volt_ewma_filter"]
    tew.ewma(y.detach(), 9)
    assert native.launches["volt_ewma_filter"] == before + 1


def test_ewma_kernel_gradient_is_the_plain_transpose(cuda):
    y = torch.randn(4, 40, device="cuda", generator=cuda)
    a, b = y.clone().requires_grad_(), y.clone().requires_grad_()
    torch.sin(tew.ewma(a, 9)).sum().backward()
    torch.sin(tew._ewma_conv(b, 9)).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


# the main path, the reference API, the edges, B=500 and 16 tiles of carry
@pytest.mark.parametrize("shape", [(64, 999), (1, 999), (3, 1), (5, 33),
                                   (500, 999), (16, 16000)])
@pytest.mark.parametrize("shared_v", [False, True])
def test_kalman_kernel_matches_plain(cuda, shared_v, shape):
    """S1 against the plain loop by ``ttd.kalman_agreement``: a float64
    run of it, outputs at rtol 1e-5, gradients at rtol 1e-4 and atol 1e-6
    of the largest."""
    b, n = shape
    vol = 0.2 + 0.05 * torch.rand(1 if shared_v else b, n, device="cuda",
                                  generator=cuda)
    v = torch.cumsum(vol * vol / 252.0, dim=-1)
    v = v[0] if shared_v else v
    s2 = 10.0 ** (-4.0 + 3.0 * torch.rand(b, device="cuda", generator=cuda))
    resid = 0.05 * torch.randn(b, n, device="cuda", generator=cuda)

    def run(how):
        dtype = torch.float64 if how == "float64" else torch.float32
        ins = [t.to(dtype).clone().requires_grad_() for t in (v, s2, resid)]
        if how == "kernel":
            before = native.launches["volt_kalman_backward"]
            ll, mean, var = ttd._kalman(*ins)
        else:
            delta = torch.diff(ins[0], dim=-1,
                               prepend=torch.zeros_like(ins[0][..., :1]))
            ll, mean, var = ttd._kalman_plain(
                delta.expand(b, n), ins[1], ins[2])
        (ll.sum() + 0.5 * mean.sum() + 2.0 * var.sum()).backward()
        if how == "kernel":
            assert native.launches["volt_kalman_backward"] == before + 1
        return (ll, mean, var), [t.grad for t in ins]

    got, plain, f64 = ([*outs, *grads] for outs, grads in
                       (run(how) for how in ("kernel", "plain", "float64")))
    for name, used, *record in ttd.kalman_agreement(got, plain, f64):
        assert used <= 1.0, (name, used, record)


@pytest.mark.parametrize("shape", [(64, 999), (1, 5), (3, 257), (2, 4, 33),
                                   (1003,)])
def test_volt_cov_kernel_matches_plain(cuda, shape):
    """K2 copies values of the integral: equal to the plain build exactly."""
    n = shape[-1]
    x = torch.arange(1, n + 1, device="cuda", dtype=torch.float32) / 252.0
    vol = 0.1 + 0.2 * torch.rand(*shape, device="cuda", generator=cuda)
    before = native.launches["volt_covariance"]
    got = tvc.volt_covariance(x, vol)
    assert native.launches["volt_covariance"] == before + 1
    want = tvi.min_index_covariance(tvi.vol_integral(x, vol))
    assert got.shape == (*shape, n)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


def test_volt_cov_kernel_gradient_is_the_plain_transpose(cuda):
    x = torch.arange(1, 131, device="cuda", dtype=torch.float32) / 252.0
    vol = 0.1 + 0.2 * torch.rand(2, 130, device="cuda", generator=cuda)
    a, b = vol.clone().requires_grad_(), vol.clone().requires_grad_()
    torch.cos(tvc.volt_covariance(x, a)).sum().backward()
    torch.cos(tvi.min_index_covariance(tvi.vol_integral(x, b))).sum() \
        .backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def _gh_inputs(gen, shape):
    """Data reaching both clamp regions: mean up to 85 and down to -10,
    variances from 1e-8 to 4."""
    y = 0.05 * torch.randn(*shape, device="cuda", generator=gen)
    mu = -10.0 + 95.0 * torch.rand(*shape, device="cuda", generator=gen)
    s2 = 10.0 ** (-8.0 + 8.6 * torch.rand(*shape, device="cuda",
                                          generator=gen))
    return y, mu, s2


@pytest.mark.parametrize("shape", [(64, 999), (500, 999), (3, 37)])
def test_gh_ell_kernels_match_plain(cuda, shape):
    """K3's fused path: one forward launch that keeps the gradient's node
    sums, one elementwise backward launch."""
    ins = _gh_inputs(cuda, shape)
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    before = {s: native.launches[s] for s in ("volt_gh_ell_forward",
                                              "volt_gh_ell_backward")}
    got = tgh.gh_expected_log_prob(*a)
    want = tgh._gh_ell_plain(*b, 75)
    # atol 1e-6: where the node sum cancels to near zero, only the float32
    # rounding of its O(1..10) terms is left (about 1e-7)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    g = torch.randn(*shape, device="cuda", generator=cuda)
    (got * g).sum().backward()
    (want * g).sum().backward()
    for sym, n in before.items():
        assert native.launches[sym] == n + 1, sym
    # d/dvar also gets the float32 resolution of its cancelling node sum
    extra = (0.0, 0.0, tgh.var_grad_resolution(*ins, g))
    for p, q, e in zip(a, b, extra):
        tol = 1e-4 * q.grad.abs() + 1e-6 * q.grad.abs().max() + e
        assert bool(((p.grad - q.grad).abs() <= tol).all())


@pytest.mark.parametrize("shape", [(64, 999), (500, 999), (3, 37)])
def test_gh_ell_kernel_without_grad(cuda, shape):
    """Without a gradient K3 computes E alone: one forward launch, equal to
    the forward that keeps the sums, and no backward."""
    ins = _gh_inputs(cuda, shape)
    fwd, bwd = (native.launches[s] for s in ("volt_gh_ell_forward",
                                              "volt_gh_ell_backward"))
    with torch.no_grad():
        got = tgh.gh_expected_log_prob(*ins)
    assert native.launches["volt_gh_ell_forward"] == fwd + 1
    assert native.launches["volt_gh_ell_backward"] == bwd
    torch.testing.assert_close(got, tgh._gh_ell_plain(*ins, 75), rtol=1e-5,
                               atol=1e-6)
    out, saved = tgh.gh_ell_forward_cuda(*ins, save=True)
    assert torch.equal(got, out)
    # the backward without the saved sums runs the forward for them
    g = torch.randn(*shape, device="cuda", generator=cuda)
    for p, q in zip(tgh.gh_ell_backward_cuda(*ins, g),
                    tgh.gh_ell_backward_cuda(*ins, g, saved=saved)):
        assert torch.equal(p, q)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    y64 = torch.zeros(2, 5, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        tew.ewma(y64, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tew.ewma_filter_cuda(torch.zeros(5, 2, device="cuda").t(), 3)
    z = torch.zeros(2, 5, device="cuda")
    with pytest.raises(ValueError):
        ttd.kalman_forward_cuda(z, torch.ones(3, device="cuda"), z, save=False)
    with pytest.raises(ValueError):
        tvc.volt_covariance_cuda(torch.zeros(5, device="cuda"))
    with pytest.raises(ValueError):
        tgh.gh_ell_forward_cuda(z, z, torch.zeros(2, 4, device="cuda"))


# --- G1: the tridiagonal GPCV ELBO and its gradient ------------------------

G1 = "volt_gpcv_tridiag_elbo"


def _g1_model(gen, batch, n, grid):
    """A tridiagonal GPCV model on the card, its grid and its returns: the
    Laplace init on returns of a drifting scale (n >= 11; below, parameters
    of the same sizes), every parameter then moved off it at random.  The
    grid: ``"zero"`` (shared, from 0: the jitter floor is taken at the
    first step), ``"dt"`` (shared, from one step) or ``"per_asset"`` (a
    step of its own per asset, from 0 for every other asset)."""
    from volt_tpu_torch.models import GPCVModel

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    dt = 1.0 / 252
    steps = torch.arange(n, device="cuda", dtype=torch.float32)
    if grid == "per_asset":
        dts = dt * (1.0 + 0.2 * torch.rand(*batch, 1, device="cuda",
                                           generator=gen))
        start = dts * (torch.arange(dts.numel(), device="cuda") % 2).reshape(
            dts.shape)
        x = steps * dts + start
    else:
        x = steps * dt + (dt if grid == "dt" else 0.0)
    scale = 0.2 * torch.exp(0.05 * torch.cumsum(randn(*batch, n), dim=-1))
    y = scale * randn(*batch, n)
    model = GPCVModel(q="tridiag")
    if n >= 11:
        model.init(x, y)
    else:
        model.kernel.init(batch, torch.float32, "cuda")
        model._set(-1.6 + 0.1 * randn(*batch), -1.6 + 0.1 * randn(*batch, n),
                   q_log_d=5.0 + 0.3 * randn(*batch, n),
                   q_e=-100.0 * (1.0 + 0.1 * randn(*batch, n - 1)))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.0 + 0.05 * randn(*p.shape))
    return model, x, y


def _g1_against_float64(gen, model, x, y):
    """``model.elbo`` (G1) and its gradients for a random cotangent, and the
    worst distance of each from a float64 copy's plain path on the CPU,
    over the largest value of the float64 one (``_worst_over_largest``)."""
    import copy

    ref = copy.deepcopy(model).cpu().double()
    cot = torch.randn(y.shape[:-1], device="cuda", generator=gen)
    before = native.launches[G1]
    got = model.elbo(x, y)
    (got * cot).sum().backward()
    assert native.launches[G1] == before + 1
    want = ref.elbo(x.cpu().double(), y.cpu().double())
    (want * cot.cpu().double()).sum().backward()
    assert native.launches[G1] == before + 1
    pairs = {"elbo": (got.detach(), want.detach())}
    on_ref = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        pairs[name] = (p.grad, on_ref[name].grad)
    for name, (a, b) in pairs.items():
        assert bool(torch.isfinite(a).all()), name
    pairs = {k: v for k, v in pairs.items() if v[1].numel()}  # q_e at n=1
    return _worst_over_largest(pairs)


def _worst_over_largest(pairs):
    """Each pair's worst distance over the largest float64 value (for a
    gradient, at least a thousandth of the largest entry of any
    parameter's: at n = 1 from x = 0 the vol gradient's terms cancel)."""
    floor = 1e-3 * max(b.abs().max().item() for name, (_, b) in pairs.items()
                       if name != "elbo")
    return {name: (a.double().cpu() - b).abs().max().item()
            / max(b.abs().max().item(), 0.0 if name == "elbo" else floor)
            for name, (a, b) in pairs.items()}


@pytest.mark.parametrize("grid", ["zero", "dt", "per_asset"])
@pytest.mark.parametrize("shape", [(505, 999), (64, 999), (3, 1), (3, 2),
                                   (5, 33), (2, 3, 37), (4, 2100)])
def test_gpcv_elbo_kernel_matches_float64(cuda, shape, grid):
    """G1's ELBO and each parameter's gradient (``raw_vol`` through the
    sigmoid, in autograd) against the plain composition in float64 on the
    same float32 values, in one launch: each within 1e-5 of the largest
    float64 value (``_g1_against_float64``; measured on an H100 80GB HBM3:
    at most 1.6e-7 over these cases, the float32 rounding of the
    outputs)."""
    model, x, y = _g1_model(cuda, shape[:-1], shape[-1], grid)
    errs = _g1_against_float64(cuda, model, x, y)
    print(f"G1 {shape} {grid}: worst error over the largest value "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert max(errs.values()) <= 1e-5, errs


def test_gpcv_elbo_kernel_nan_stays_in_its_row(cuda):
    """A NaN in one asset's returns leaves every other asset's ELBO and
    gradients bitwise as they are without it."""
    model, x, y = _g1_model(cuda, (64,), 999, "zero")
    runs = []
    for bad in (False, True):
        yy = y.clone()
        if bad:
            yy[5, 100] = float("nan")
        model.zero_grad()
        out = model.elbo(x, yy)
        out.sum().backward()
        runs.append([out.detach()] + [p.grad.clone()
                                      for p in model.parameters()])
    others = torch.arange(64, device="cuda") != 5
    for a, b in zip(*runs):
        assert torch.equal(a[others], b[others])
    assert bool(torch.isnan(runs[1][0][5]))


def test_gpcv_elbo_kernel_one_launch_an_adam_step(cuda):
    """A 30-step warm fit (the live tick's GPCV) launches G1 30 times,
    once a step, and nothing of it when no gradient is wanted."""
    from volt_tpu_torch.train import adam_loop

    model, x, y = _g1_model(cuda, (64,), 999, "zero")
    before = native.launches[G1]
    losses = adam_loop(model, lambda: -model.elbo(x, y), 30, 0.01)
    assert native.launches[G1] == before + 30
    assert bool(torch.isfinite(losses).all())
    with torch.no_grad():
        again = model.elbo(x, y)
    assert native.launches[G1] == before + 31
    assert not again.requires_grad


@pytest.mark.parametrize("kw", [{"q": "full"}, {"ell_method": "quadrature"},
                                {"param": "cv"}])
def test_gpcv_elbo_kernel_bypassed(cuda, kw):
    """The dense family, the GH term and the cv likelihood keep the plain
    path on the card: no G1 launch."""
    from volt_tpu_torch.models import GPCVModel

    _, x, y = _g1_model(cuda, (4,), 60, "dt")
    model = GPCVModel(**kw).init(x, y, per_lane=kw.get("q") == "full")
    before = native.launches[G1]
    model.elbo(x, y).sum().backward()
    assert native.launches[G1] == before


def test_small_pipeline_with_g1_card_matches_cpu(cuda):
    """``fit_forecast_batch`` at B=2, n=72 from x = 0 (the small input that
    ``chip_smoke.py`` compares), G1 on the card and the plain path on the
    CPU, on the same normals: losses and vols rtol 1e-3, the fan rtol 2e-3
    / atol 1e-3 (the small-pipeline tests' tolerances).  G1 runs once a
    GPCV step on the card and never on the CPU."""
    from volt_tpu_torch.data import sabr_paths
    from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch

    b, n, h, s = 2, 72, 10, 64
    f, _ = sabr_paths(steps=n + 1, seed=77, n_paths=b)
    x = torch.arange(n, dtype=torch.float32) / 252.0
    test_x = x[-1] + torch.arange(1, h + 1) / 252.0
    cfg = PipelineConfig(gpcv_iters=60, vol_iters=60, data_iters=40, k=20,
                         nsample=s, output="quantiles")
    g = torch.Generator().manual_seed(5)
    noise = {"vol_r0": torch.randn(b, s, generator=g),
             "vol_z": torch.randn(b, s, h, generator=g),
             "zs": torch.randn(b, s, h, generator=g)}
    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        before = native.launches[G1]
        out[dev] = fit_forecast_batch(
            None, x.to(dev), torch.tensor(f, device=dev), test_x.to(dev),
            cfg, noise={k: v.to(dev) for k, v in noise.items()})
        launched[dev] = native.launches[G1] - before
    assert launched == {"cpu": 0, "cuda": cfg.gpcv_iters}
    (fan_c, aux_c), (fan_g, aux_g) = out["cpu"], out["cuda"]
    assert bool(aux_g["ok"].all())
    for key in ("gpcv_loss", "vol_loss", "data_loss", "vol"):
        torch.testing.assert_close(aux_g[key].cpu(), aux_c[key], rtol=1e-3,
                                   atol=0.0, msg=key)
    torch.testing.assert_close(fan_g.cpu(), fan_c, rtol=2e-3, atol=1e-3)


def test_gpcv_elbo_wrapper_refuses_what_g1_does_not_take(cuda):
    z = torch.zeros(2, 5, device="cuda")
    c = torch.zeros(2, 1, device="cuda")
    with pytest.raises(ValueError):
        tge.tridiag_elbo_cuda(z[0], z, z, z, z, c, c)
    with pytest.raises(TypeError):
        tge.tridiag_elbo_cuda(z[0], z.double(), z, z, z[:, 1:], c, c)
    # float64 on the card is refused through the model too, not sent to
    # the plain path
    model, x, y = _g1_model(cuda, (2,), 9, "dt")
    with pytest.raises(TypeError):
        model.double().elbo(x.double(), y.double())


# --- G3: the joint tridiagonal GPCV ELBO of the multitask model -------------

G3 = "volt_mt_gpcv_tridiag_elbo"


def _g3_model(gen, n, t, r, grid, **kw):
    """A tridiagonal multitask GPCV model on the card, its likelihood, grid
    and returns ``(n, T)``: the Laplace init on returns of a drifting
    scale (n >= 11; below, parameters of the same sizes), every parameter
    then moved off it at random (the task root
    gains a random lower triangle).  ``grid``: ``"zero"`` (from 0: the
    jitter floor is taken at the first step) or ``"dt"`` (from one
    step)."""
    from volt_tpu_torch.likelihoods import VolatilityGaussianLikelihood
    from volt_tpu_torch.models.multitask import MultitaskVariationalGP

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    dt = 1.0 / 252
    x = torch.arange(n, device="cuda", dtype=torch.float32) * dt \
        + (dt if grid == "dt" else 0.0)
    scale = 0.2 * torch.exp(0.05 * torch.cumsum(randn(t, n), dim=-1))
    y = (scale * randn(t, n)).T.contiguous()
    lik = VolatilityGaussianLikelihood(param=kw.pop("param", "exp"))
    lik.init((), torch.float32, "cuda", torch.Generator().manual_seed(0))
    model = MultitaskVariationalGP(t, rank=r, q=kw.pop("q", "tridiag"))
    model.init(x, torch.float32, torch.Generator().manual_seed(1))
    if n >= 11:
        model.initialize_variational_parameters(lik, x, y)
    else:  # below the Laplace init's length: values of the same sizes
        with torch.no_grad():
            model.variational_mean.copy_(-1.5 + 0.3 * randn(n, t))
            model.mean_constants.fill_(-1.5)
            model.q_log_d.copy_(2.0 + 0.3 * randn(n))
            model.q_e.copy_(-5.0 + randn(n - 1))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.0 + 0.05 * randn(*p.shape))
        model.variational_task_covar_root.add_(
            torch.tril(0.05 * randn(t, t), diagonal=-1))
    return model, lik, x, y


def _g3_pairs(gen, model, lik, x, y):
    """``model.elbo`` (G3, one call) and its gradients for a random
    cotangent, beside a float64 copy's plain path on the CPU on the same
    values."""
    import copy

    ref = copy.deepcopy(model).cpu().double()
    cot = torch.randn((), device="cuda", generator=gen)
    before = native.launches[G3]
    got = model.elbo(x, y, lik)
    (got * cot).backward()
    assert native.launches[G3] == before + 1
    want = ref.elbo(x.cpu().double(), y.cpu().double(),
                    copy.deepcopy(lik).cpu().double())
    (want * cot.cpu().double()).backward()
    assert native.launches[G3] == before + 1
    pairs = {"elbo": (got.detach(), want.detach())}
    on_ref = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        pairs[name] = (p.grad, on_ref[name].grad)
    return {k: v for k, v in pairs.items() if v[1].numel()}  # q_e at n=1


@pytest.mark.parametrize("grid", ["zero", "dt"])
@pytest.mark.parametrize("shape", [(999, 505, 1), (200, 64, 4), (64, 8, 2),
                                   (2, 3, 1), (1, 1, 1)])
def test_mt_gpcv_elbo_kernel_matches_float64(cuda, shape, grid):
    """G3's ELBO and each parameter's gradient (``raw_var`` through the
    softplus and ``raw_vol`` through the sigmoid, in autograd) against the
    plain composition in float64 on the same float32 values, in one call:
    each within 1e-5 of the largest float64 value."""
    model, lik, x, y = _g3_model(cuda, *shape, grid)
    pairs = _g3_pairs(cuda, model, lik, x, y)
    for name, (a, _) in pairs.items():
        assert bool(torch.isfinite(a).all()), name
    errs = _worst_over_largest(pairs)
    print(f"G3 {shape} {grid}: worst error over the largest value "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert max(errs.values()) <= 1e-5, errs


def test_mt_gpcv_elbo_kernel_where_the_float32_ladder_adds_jitter(cuda):
    """A task covariance ``F F^T + diag(v)`` with ``v`` near 1e-7, whose
    bare float32 Cholesky fails: the float32 plain path (on the CPU, where
    G3 does not run) climbs the jitter ladder, the float64 one does not.
    G3 agrees with the float64 plain path within 1e-5 of the largest value
    and is far from the float32 one."""
    import copy

    model, lik, x, y = _g3_model(cuda, 64, 8, 1, "dt")
    with torch.no_grad():
        model.index_kernel.raw_var.fill_(-16.1)  # v = 1.0e-7
        # equal entries: 9 + v rounds to 9 in float32, so its second pivot
        # is 9 - 9 = 0; in float64 it is about 2 v
        model.index_kernel.covar_factor.fill_(3.0)
        k32 = model.index_kernel.covar_matrix()
        k64 = copy.deepcopy(model.index_kernel).double().covar_matrix()
    assert int(torch.linalg.cholesky_ex(k32.cpu()).info) != 0
    assert int(torch.linalg.cholesky_ex(k64).info) == 0
    with torch.no_grad():
        plain32 = copy.deepcopy(model).cpu().elbo(x.cpu(), y.cpu(),
                                                  lik).item()
    pairs = _g3_pairs(cuda, model, lik, x, y)
    errs = _worst_over_largest(pairs)
    print("G3 where the float32 ladder adds jitter: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert max(errs.values()) <= 1e-5, errs
    got, want = (v.item() for v in pairs["elbo"])
    assert abs(plain32 - want) > 1e-3 * abs(want) > abs(got - want)


def test_mt_gpcv_elbo_kernel_non_finite_entry(cuda):
    """A NaN in one return makes G3's ELBO NaN and leaves its gradients
    NaN exactly where the float64 plain path's are, the rest within 1e-5
    of the largest finite float64 value."""
    model, lik, x, y = _g3_model(cuda, 64, 8, 1, "zero")
    y[5, 3] = float("nan")
    pairs = _g3_pairs(cuda, model, lik, x, y)
    assert all(bool(torch.isnan(v)) for v in pairs.pop("elbo"))
    for name, (a, b) in pairs.items():
        a, bad = a.cpu(), torch.isnan(b)
        assert torch.equal(torch.isnan(a), bad), name
        a, b = a[~bad].double(), b[~bad]
        if b.numel():
            err = (a - b).abs().max() / b.abs().max()
            assert err.item() <= 1e-5, (name, err.item())


def test_mt_gpcv_elbo_kernel_one_call_an_adam_step(cuda):
    """A 30-step warm fit (the live tick's joint GPCV) calls G3 30 times,
    once a step, and once more for an ELBO with no gradient."""
    from volt_tpu_torch.train import _Packed, adam_loop

    model, lik, x, y = _g3_model(cuda, 999, 64, 1, "dt")
    packed = _Packed(model, lik)
    before = native.launches[G3]
    losses = adam_loop(packed, lambda: -model.elbo(x, y, lik), 30, 0.01)
    assert native.launches[G3] == before + 30
    assert bool(torch.isfinite(losses).all())
    with torch.no_grad():
        again = model.elbo(x, y, lik)
    assert native.launches[G3] == before + 31
    assert not again.requires_grad


@pytest.mark.parametrize("kw", [{"q": "full"}, {"param": "cv"},
                                {"rank": 5}, {"dtype": torch.float64}])
def test_mt_gpcv_elbo_kernel_bypassed(cuda, kw):
    """The dense family and the cv likelihood keep the plain path on the
    card: no G3 call.  A task factor of rank 5 and float64 tensors, which
    G3 does not take, are refused there (a ``ValueError``, a
    ``TypeError``), not sent to the plain path."""
    kw = dict(kw)
    dtype = kw.pop("dtype", torch.float32)
    refused = dtype is torch.float64 or "rank" in kw
    model, lik, x, y = _g3_model(cuda, 40, 6, kw.pop("rank", 1), "dt", **kw)
    model.to(dtype)
    before = native.launches[G3]
    if refused:
        with pytest.raises(TypeError if dtype is torch.float64
                           else ValueError):
            model.elbo(x.to(dtype), y.to(dtype), lik)
    else:
        model.elbo(x.to(dtype), y.to(dtype), lik).backward()
    assert native.launches[G3] == before


def test_small_multitask_pipeline_with_g3_card_matches_cpu(cuda):
    """``fit_forecast_multitask`` at T=4, n=72 on a grid from x = 0, G3 on
    the card and the plain path on the CPU, on the same initial values and
    normals: losses and vols rtol 1e-3, the fan rtol 2e-3 / atol 1e-3 (the
    small-pipeline tests' tolerances).  G3 runs once a GPCV step on the
    card and never on the CPU."""
    from volt_tpu_torch.data import sabr_paths
    from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                         fit_forecast_multitask)

    t, n, h, s = 4, 72, 8, 32
    f, _ = sabr_paths(steps=n + 1, seed=21, n_paths=t)
    x = torch.arange(n, dtype=torch.float32) / 252.0
    test_x = x[-1] + torch.arange(1, h + 1) / 252.0
    g = torch.Generator().manual_seed(22)
    noise = {"vol_z": torch.randn(s, n + h, t, generator=g),
             "vol_eps": torch.randn(s, n, t, generator=g),
             "zs": torch.randn(t, s, h, generator=g)}
    cfg = MultitaskPipelineConfig(gpcv_iters=30, vol_iters=20, data_iters=20,
                                  k=10, nsample=s, output="quantiles")
    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        before = native.launches[G3]
        out[dev] = fit_forecast_multitask(
            torch.Generator().manual_seed(23), x.to(dev),
            torch.tensor(f, device=dev), test_x.to(dev), cfg,
            noise={k: v.to(dev) for k, v in noise.items()})
        launched[dev] = native.launches[G3] - before
    assert launched == {"cpu": 0, "cuda": cfg.gpcv_iters}
    (fan_c, aux_c), (fan_g, aux_g) = out["cpu"], out["cuda"]
    assert bool(aux_g["ok"].all())
    for key in ("gpcv_loss", "vol_loss", "data_losses", "vols"):
        torch.testing.assert_close(aux_g[key].cpu(), aux_c[key], rtol=1e-3,
                                   atol=0.0, msg=key)
    torch.testing.assert_close(fan_g.cpu(), fan_c, rtol=2e-3, atol=1e-3)


def test_mt_gpcv_elbo_wrapper_refuses_what_g3_does_not_take(cuda):
    def zeros(*shape):
        return torch.zeros(*shape, device="cuda")

    z, v = zeros(5, 3), zeros(3) + 1.0
    args = [zeros(5), z, z, zeros(5), zeros(4), torch.eye(3, device="cuda"),
            v, zeros(3, 1), v, zeros(1) + 0.2]
    elbo, _ = tmg.mt_tridiag_elbo_cuda(*args)
    assert elbo.shape == ()
    for i, bad in ((4, zeros(5)), (7, zeros(3, 5)),
                   (5, torch.eye(4, device="cuda"))):
        with pytest.raises(ValueError):
            tmg.mt_tridiag_elbo_cuda(*args[:i], bad, *args[i + 1:])
    with pytest.raises(TypeError):
        tmg.mt_tridiag_elbo_cuda(*args[:1], z.double(), *args[2:])


# --- G4: the multitask vol GP's Woodbury MLL ---------------------------------

G4 = "volt_mt_vol_woodbury_mll"
G4_STARTS = {"c<0": 0.0, "c=0": 1.0, "c>0": 2.0}


def _g4_model(n, t, r, start, dtype=torch.float32, seed=0):
    """A multitask vol GP on the card with random parameters near a fit's,
    its grid from ``start`` (``G4_STARTS``: the sign of c = vol (x0 -
    dx)) and the spectral cache of log vols on a random walk."""
    from volt_tpu_torch.models.multitask import MultitaskBMGP

    g = torch.Generator().manual_seed(seed)
    model = MultitaskBMGP(t, rank=r).init(dtype, "cuda", g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(p))
    x = ((torch.arange(n) + G4_STARTS[start]) / 252.0).to("cuda", dtype)
    y = (math.log(0.2) + torch.cumsum(0.05 * torch.randn(
        n, t, generator=g), dim=0)).to("cuda", dtype)
    return model, model.spectral_cache(x, y)


def _mll_and_grads(model, cache, cot=1.0):
    model.zero_grad(set_to_none=True)
    n, t = cache["p_y"].shape[-2:]
    out = model.mll_spectral(cache, n, t)
    (out * cot).sum().backward()
    return {"mll": out.detach(), **{name: p.grad for name, p in
                                    model.named_parameters()}}


@pytest.mark.parametrize("n,t,r,start", [
    (999, 505, 1, "c<0"), (999, 505, 1, "c=0"), (999, 505, 1, "c>0"),
    (505, 64, 4, "c<0"), (200, 64, 4, "c>0"), (64, 8, 2, "c<0"),
    (60, 8, 4, "c=0"), (17, 3, 2, "c<0"), (9, 1, 1, "c<0"),
    (2, 3, 1, "c>0"), (999, 1, 1, "c<0"), (3, 505, 1, "c<0")])
def test_mt_vol_mll_kernel_matches_float64(cuda, n, t, r, start):
    """G4's MLL and its gradients with respect to ``raw_vol``, the task
    factor, ``raw_var`` and ``raw_noise`` (the constraints in autograd),
    in one call, against the plain composition in float64 on the CPU on
    the same float32 values: the MLL within 1e-6 of its float64 value, each
    gradient within 1e-4 of its largest float64 entry.  The block algebra
    runs in float64, the T x T coupling (one LU of ``m = I + S c K``) in
    float32 as on the plain path, whose own errors set the gradients'
    tolerance: measured on an H100 80GB HBM3, G4 at most 3.2e-5 over these
    cases, the float32 plain path up to 4.5e-3 on the same inputs (the
    task factor's gradient at the cell's shape, c < 0)."""
    model, cache = _g4_model(n, t, r, start)
    ref = copy.deepcopy(model).cpu().double()
    cot = torch.randn((), device="cuda", generator=cuda)
    before = native.launches[G4]
    got = _mll_and_grads(model, cache, cot)
    assert native.launches[G4] == before + 1
    want = _mll_and_grads(ref, {k: v.cpu().double() for k, v in
                                cache.items()}, cot.cpu().double())
    assert native.launches[G4] == before + 1
    errs = {k: ((got[k].double().cpu() - want[k]).abs().max()
                / want[k].abs().max()).item() for k in want}
    print(f"G4 {(n, t, r, start)}: worst error over the largest value "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert errs.pop("mll") <= 1e-6
    assert max(errs.values()) <= 1e-4, errs


def test_mt_vol_mll_kernel_non_finite_entry(cuda):
    """A NaN among the projected vols makes G4's MLL NaN, as the float64
    plain path's (on the CPU), without a wait or an error."""
    model, cache = _g4_model(64, 8, 1, "c<0")
    cache["p_y"][5, 3] = float("nan")
    ref = copy.deepcopy(model).cpu().double()
    got = _mll_and_grads(model, cache)
    want = _mll_and_grads(ref, {k: v.cpu().double() for k, v in
                                cache.items()})
    assert bool(torch.isnan(got["mll"])) and bool(torch.isnan(want["mll"]))


def test_mt_vol_mll_kernel_one_call_an_adam_step(cuda):
    """A 30-step warm fit at the live cell's shape (the tick's vol stage)
    calls G4 30 times, once a step, and once more for an MLL with no
    gradient."""
    from volt_tpu_torch.train import adam_loop

    model, cache = _g4_model(999, 505, 1, "c<0")
    before = native.launches[G4]
    losses = adam_loop(model, lambda: -model.mll_spectral(cache, 999, 505),
                       30, 0.01)
    assert native.launches[G4] == before + 30
    assert bool(torch.isfinite(losses).all())
    with torch.no_grad():
        again = model.mll_spectral(cache, 999, 505)
    assert native.launches[G4] == before + 31
    assert not again.requires_grad


@pytest.mark.parametrize("case", ["float64", "batched", "rank_5"])
def test_mt_vol_mll_kernel_bypassed(cuda, case):
    """float64 tensors, a batch of caches and a task factor of rank 5,
    which G4 does not take, are refused on the card (a ``TypeError``, a
    ``ValueError``), not sent to the plain path: no G4 call."""
    dtype = torch.float64 if case == "float64" else torch.float32
    model, cache = _g4_model(40, 6, 5 if case == "rank_5" else 1, "c<0",
                             dtype=dtype)
    if case == "batched":
        cache["p_y"] = torch.stack([cache["p_y"], 2.0 * cache["p_y"]])
    before = native.launches[G4]
    with pytest.raises(TypeError if case == "float64" else ValueError):
        _mll_and_grads(model, cache)
    assert native.launches[G4] == before


def test_mt_vol_mll_wrapper_refuses_what_g4_does_not_take(cuda):
    def zeros(*shape):
        return torch.zeros(*shape, device="cuda")

    one = zeros(1) + 0.2
    args = [zeros(5, 3), zeros(5), zeros(5) + 1.0, zeros(5) + 1.0,
            zeros(()) + 0.004, zeros(()), one, zeros(3, 1) + 0.1,
            zeros(3) + 1.0, one]
    out, grads = tmv.mt_vol_mll_cuda(*args)
    assert out.shape == () and [g.shape for g in grads] == [
        (1,), (3, 1), (3,), (1,)]
    for i, bad in ((0, zeros(2, 5, 3)), (1, zeros(4)), (7, zeros(3, 5)),
                   (8, zeros(4)), (6, zeros(2))):
        with pytest.raises(ValueError):
            tmv.mt_vol_mll_cuda(*args[:i], bad, *args[i + 1:])
    with pytest.raises(TypeError):
        tmv.mt_vol_mll_cuda(args[0].double(), *args[1:])


def test_small_multitask_pipeline_with_g4_card_matches_cpu(cuda):
    """``fit_forecast_multitask`` at T=4, n=72 on a grid from one step
    (c = 0), G4 on the card and the plain path on the CPU, on the same
    initial values and normals: losses and vols rtol 1e-3, the fan rtol
    2e-3 / atol 1e-3 (the small-pipeline tests' tolerances).  G4 runs once
    a vol step on the card and never on the CPU."""
    from volt_tpu_torch.data import sabr_paths
    from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                         fit_forecast_multitask)

    t, n, h, s = 4, 72, 8, 32
    f, _ = sabr_paths(steps=n + 1, seed=31, n_paths=t)
    x = torch.arange(1, n + 1, dtype=torch.float32) / 252.0
    test_x = x[-1] + torch.arange(1, h + 1) / 252.0
    g = torch.Generator().manual_seed(32)
    noise = {"vol_z": torch.randn(s, n + h, t, generator=g),
             "vol_eps": torch.randn(s, n, t, generator=g),
             "zs": torch.randn(t, s, h, generator=g)}
    cfg = MultitaskPipelineConfig(gpcv_iters=30, vol_iters=20, data_iters=20,
                                  k=10, nsample=s, output="quantiles")
    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        before = native.launches[G4]
        out[dev] = fit_forecast_multitask(
            torch.Generator().manual_seed(33), x.to(dev),
            torch.tensor(f, device=dev), test_x.to(dev), cfg,
            noise={k: v.to(dev) for k, v in noise.items()})
        launched[dev] = native.launches[G4] - before
    assert launched == {"cpu": 0, "cuda": cfg.vol_iters}
    (fan_c, aux_c), (fan_g, aux_g) = out["cpu"], out["cuda"]
    assert bool(aux_g["ok"].all())
    for key in ("gpcv_loss", "vol_loss", "data_losses", "vols"):
        torch.testing.assert_close(aux_g[key].cpu(), aux_c[key], rtol=1e-3,
                                   atol=0.0, msg=key)
    torch.testing.assert_close(fan_g.cpu(), fan_c, rtol=2e-3, atol=1e-3)


# --- the GPCV families and the option layer on the card ---------------------
# (plain PyTorch on both devices: the card against the CPU, whose runs the
# parity tests hold against the JAX package)

def _sabr(b, n, seed):
    from volt_tpu_torch.data import sabr_paths

    f, _ = sabr_paths(steps=n + 1, seed=seed, n_paths=b)
    x = torch.arange(1, n + 1, dtype=torch.float32) / 252.0
    return x, torch.tensor(f)


def test_optax_adam_card_equals_cpu(cuda):
    """The same gradients give the same parameters on both devices: every
    step is IEEE multiplies, adds, divisions and square roots."""
    from volt_tpu_torch.optim import Adam

    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(3, 40, generator=g)
    grads = torch.randn(10, 3, 40, generator=g) * 10.0 ** (
        -4 + 4 * torch.rand(10, 3, 40, generator=g))
    out = {}
    for dev in ("cpu", "cuda"):
        p = torch.nn.Parameter(p0.clone().to(dev))
        opt = Adam([p], 0.01, 10)
        for i in range(10):
            p.grad = grads[i].to(dev)
            opt.step()
        out[dev] = p.detach().cpu()
    assert torch.equal(out["cpu"], out["cuda"])


def test_cholesky_ladder_per_lane_on_the_card(cuda):
    """One lane of three needs jitter (a BM Gram from x = 0); per lane, the
    other two keep their bare factors, as on the CPU."""
    tch = importlib.import_module("volt_tpu_torch.ops.chol")
    g = torch.Generator().manual_seed(2)
    a = torch.randn(3, 8, 8, generator=g)
    mats = 1e-3 * (a @ a.mT / 8 + torch.eye(8))
    x0 = torch.arange(8.0)
    mats[1] = 1e-3 * torch.minimum(x0[:, None], x0[None, :])
    got = tch.psd_safe_cholesky(mats.cuda(), per_lane=True).cpu()
    want = tch.psd_safe_cholesky(mats, per_lane=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
    bare = torch.linalg.cholesky(mats[[0, 2]].double()).float()
    torch.testing.assert_close(got[[0, 2]], bare, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("param", ["exp", "cv"])
def test_dense_gpcv_card_matches_cpu(cuda, param):
    """The dense family's Laplace init on ``S = R R^T`` (1e-3 of its largest
    entry: three float32 factorisations in cuSOLVER and LAPACK), and its
    ELBO and gradient at the CPU's init (rtol 1e-4)."""
    from volt_tpu_torch.convert import load_jax_params, params_tree
    from volt_tpu_torch.models import GPCVModel
    from volt_tpu_torch.train import scaled_returns

    x, f = _sabr(4, 60, 3)
    yy = scaled_returns(x, f)
    cpu = GPCVModel(q="full", param=param).init(x, yy, per_lane=True)
    card = GPCVModel(q="full", param=param).init(x.cuda(), yy.cuda(),
                                                 per_lane=True)
    r_c, r_g = (torch.tril(m.chol_variational_covar.detach()).double().cpu()
                for m in (cpu, card))
    s_c, s_g = r_c @ r_c.mT, r_g @ r_g.mT
    assert (s_g - s_c).abs().max() <= 1e-3 * s_c.abs().max()
    card = load_jax_params(GPCVModel(q="full", param=param),
                           params_tree(cpu), "cuda")
    e_c, e_g = cpu.elbo(x, yy), card.elbo(x.cuda(), yy.cuda())
    torch.testing.assert_close(e_g.cpu(), e_c, rtol=1e-4, atol=0.0)
    e_c.sum().backward()
    e_g.sum().backward()
    on_card = dict(card.named_parameters())
    for name, p in cpu.named_parameters():
        scale = p.grad.abs().max().item()
        torch.testing.assert_close(on_card[name].grad.cpu(), p.grad,
                                   rtol=1e-4, atol=1e-6 * scale, msg=name)


@pytest.mark.parametrize("fn", ["scale", "hessian", "latent_from_scale",
                                "expected_log_prob"])
def test_cv_likelihood_card_matches_cpu(cuda, fn):
    """The cv mixture on the card (its Hessian by ``torch.func``): rtol
    1e-5, atol 1e-6 of the largest value."""
    lik = importlib.import_module("volt_tpu_torch.likelihoods")
    g = torch.Generator().manual_seed(4)
    f = 1.5 * torch.randn(2, 50, generator=g)
    y = 0.3 * torch.randn(2, 50, generator=g)
    var = 10.0 ** (-4 + 4 * torch.rand(2, 50, generator=g))
    target = torch.exp(torch.randn(2, 50, generator=g) - 1.0)
    out = {}
    for dev in ("cpu", "cuda"):
        m = lik.VolatilityGaussianLikelihood(param="cv").init(
            (2,), device=dev, generator=torch.Generator().manual_seed(5))
        a = [t.to(dev) for t in (f, y, var, target)]
        with torch.no_grad():
            out[dev] = {
                "scale": lambda: m.scale(a[0]),
                "hessian": lambda: m.neg_log_prob_hessian(a[1], a[0]),
                "latent_from_scale": lambda: m.latent_from_scale(a[3]),
                "expected_log_prob": lambda: m.expected_log_prob(a[1], a[0],
                                                                 a[2]),
            }[fn]().cpu()
    scale = out["cpu"].abs().max().item()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5,
                               atol=1e-6 * scale)


def test_price_options_batch_card_matches_cpu(cuda):
    """The pricing entry on the same normals: values at the pipeline's fan
    tolerance (rtol 2e-3, atol 1e-3 of the largest strike), percentiles
    within 2 / S (a path that close to the realised price may change
    side); K1 and S1 launched on the card."""
    from volt_tpu_torch.parallel import PipelineConfig, price_options_batch

    b, n, h, s = 2, 48, 8, 64
    x, f = _sabr(b, n, 6)
    test_x = x[-1] + torch.arange(1, h + 1) / 252.0
    g = torch.Generator().manual_seed(7)
    noise = {"vol_r0": torch.randn(b, s, generator=g),
             "vol_z": torch.randn(b, s, h, generator=g),
             "zs": torch.randn(b, s, h, generator=g)}
    cfg = PipelineConfig(gpcv_iters=20, vol_iters=20, data_iters=20, k=20,
                         nsample=s, output="samples")
    strikes = (f[:, -1].mean() * torch.linspace(0.9, 1.1, 5)).tolist()
    realized = f[:, -1:] * torch.tensor([[0.99, 1.0, 1.02]])
    out = {}
    for dev in ("cpu", "cuda"):
        before = dict(native.launches)
        out[dev] = price_options_batch(
            None, x.to(dev), f.to(dev), test_x.to(dev), strikes, [1, 4, 7],
            cfg, realized=realized.numpy(),
            noise={k: v.to(dev) for k, v in noise.items()})
    for sym in ("volt_ewma_filter", "volt_kalman_forward",
                "volt_kalman_backward"):
        assert native.launches[sym] > before.get(sym, 0)
    torch.testing.assert_close(out["cuda"]["values"].cpu(),
                               out["cpu"]["values"], rtol=2e-3,
                               atol=1e-3 * max(strikes))
    pct = out["cuda"]["percentiles"].cpu() - out["cpu"]["percentiles"]
    assert pct.abs().max() <= 2.0 / s


def test_fft_projection_on_the_card(cuda):
    """The spectral projection at n = 16000 (the FFT branch) on the card
    against a float64 CPU run: 2e-6 of max|out|, as the CPU tests hold
    float32 against JAX."""
    tbr = importlib.import_module("volt_tpu_torch.ops.brownian")
    y = torch.randn(2, 16000, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    want = tbr.min_kernel_project(y)
    got = tbr.min_kernel_project(y.float().cuda()).cpu().double()
    assert (got - want).abs().max() <= 2e-6 * want.abs().max()


def test_fbm_ladder_per_lane_on_the_card(cuda):
    """A batch where one lane (H = 0.9999) needs jitter: per lane, the other
    keeps its bare factor; both lanes' ``L L^T`` equal the CPU's at 1e-4 of
    the largest entry."""
    tfbm = importlib.import_module("volt_tpu_torch.ops.fbm")
    x = torch.arange(1, 41, dtype=torch.float32) / 252.0
    th = torch.tensor([[1.0], [1.9998]])
    out = {dev: tfbm.fbm_cholesky(x.to(dev), th.to(dev), per_lane=True).cpu()
           for dev in ("cpu", "cuda")}
    bare = torch.linalg.cholesky(tfbm.fbm_increment_cov(x, th[:1]))
    torch.testing.assert_close(out["cuda"][0], torch.cumsum(bare, -2)[0],
                               rtol=1e-5, atol=1e-6)
    for lane in range(2):
        c, g = (out[d][lane].double() for d in ("cpu", "cuda"))
        want = c @ c.mT
        assert ((g @ g.mT) - want).abs().max() <= 1e-4 * want.abs().max()


def test_kron_backward_on_the_card_at_the_degenerate_init(cuda):
    """``kron_mvn_log_prob``'s closed-form backward where the task
    covariance has repeated eigenvalues (``F F^T + log(2) I``): finite, and
    equal to the CPU's at rtol 1e-4, atol 1e-5 of the largest (the two
    ``eigh`` round differently)."""
    tkr = importlib.import_module("volt_tpu_torch.gp.kronecker")
    g = torch.Generator().manual_seed(8)
    n, t = 40, 5
    x = torch.arange(1, n + 1) / 252.0
    f = 0.1 * torch.randn(t, 1, generator=g)
    base = {"y": torch.randn(n, t, generator=g),
            "mean": 0.1 * torch.randn(n, t, generator=g),
            "k_data": 0.3 * torch.minimum(x[:, None], x[None, :]),
            "k_task": f @ f.T + torch.log(torch.tensor(2.0)) * torch.eye(t),
            "noise": torch.tensor(0.05)}
    grads = {}
    for dev in ("cpu", "cuda"):
        ins = {k: v.to(dev).detach().requires_grad_()
               for k, v in base.items()}
        tkr.kron_mvn_log_prob(*ins.values()).backward()
        grads[dev] = {k: v.grad.cpu() for k, v in ins.items()}
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k]
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())


def test_small_fbm_pipeline_card_matches_cpu(cuda):
    """``fit_forecast_batch(kernel="fbm")`` at B=2, n=48 on the same normals,
    at rtol 1e-2: the dense family's Adam turns rounding into lr-sized
    moves; measured on the CPU, a 1e-7 relative change of the prices moves
    this pipeline's vol by up to 2.1e-3 and its GPCV loss by 5.3e-4."""
    from volt_tpu_torch.parallel import PipelineConfig, fit_forecast_batch

    b, n, h, s = 2, 48, 8, 32
    x, f = _sabr(b, n, 9)
    test_x = x[-1] + torch.arange(1, h + 1) / 252.0
    g = torch.Generator().manual_seed(10)
    noise = {"vol_z": torch.randn(b, s, h, generator=g),
             "zs": torch.randn(b, s, h, generator=g)}
    cfg = PipelineConfig(kernel="fbm", gpcv_iters=20, vol_iters=20,
                         data_iters=20, k=20, nsample=s, output="quantiles")
    out = {dev: fit_forecast_batch(
        None, x.to(dev), f.to(dev), test_x.to(dev), cfg,
        noise={k: v.to(dev) for k, v in noise.items()})
        for dev in ("cpu", "cuda")}
    (fan_c, aux_c), (fan_g, aux_g) = out["cpu"], out["cuda"]
    assert bool(aux_g["ok"].all())
    for key in ("gpcv_loss", "vol_loss", "data_loss", "vol"):
        torch.testing.assert_close(aux_g[key].cpu(), aux_c[key], rtol=1e-2,
                                   atol=0.0)
    torch.testing.assert_close(fan_g.cpu(), fan_c, rtol=1e-2, atol=0.0)


def test_small_multitask_pipeline_card_matches_cpu(cuda):
    """``fit_forecast_multitask`` at T=3, n=48 on the same initial values and
    normals: losses and vols rtol 1e-3, the fan rtol 2e-3 / atol 1e-3 (the
    single-task pipeline's); measured on the CPU, a 1e-7 relative change
    of the prices moves the GPCV loss by 3.9e-5 and the fan by 2e-7."""
    from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                         fit_forecast_multitask)

    t, n, h, s = 3, 48, 8, 32
    x, f = _sabr(t, n, 11)
    test_x = x[-1] + torch.arange(1, h + 1) / 252.0
    g = torch.Generator().manual_seed(12)
    noise = {"vol_z": torch.randn(s, n + h, t, generator=g),
             "vol_eps": torch.randn(s, n, t, generator=g),
             "zs": torch.randn(t, s, h, generator=g)}
    cfg = MultitaskPipelineConfig(gpcv_iters=20, vol_iters=20, data_iters=20,
                                  nsample=s, output="quantiles")
    out = {}
    for dev in ("cpu", "cuda"):
        before = dict(native.launches)
        out[dev] = fit_forecast_multitask(
            torch.Generator().manual_seed(13), x.to(dev), f.to(dev),
            test_x.to(dev), cfg,
            noise={k: v.to(dev) for k, v in noise.items()})
    for sym in ("volt_ewma_filter", "volt_kalman_forward",
                "volt_kalman_backward"):
        assert native.launches[sym] > before.get(sym, 0)
    (fan_c, aux_c), (fan_g, aux_g) = out["cpu"], out["cuda"]
    assert bool(aux_g["ok"].all())
    for key in ("gpcv_loss", "vol_loss", "data_losses", "vols"):
        torch.testing.assert_close(aux_g[key].cpu(), aux_c[key], rtol=1e-3,
                                   atol=0.0)
    torch.testing.assert_close(fan_g.cpu(), fan_c, rtol=2e-3, atol=1e-3)


def _basic_pair(mean_k=20, n=60):
    """A spectral-mixture baseline with an EWMA mean on a SABR series, on
    the CPU and (a copy) on the card."""
    import copy

    from volt_tpu_torch.means import EWMAMean
    from volt_tpu_torch.models import SMGP

    x, f = _sabr(1, n, 14)
    y = torch.log(f.reshape(-1)[1:])
    cpu = SMGP(5, EWMAMean(mean_k)).init(
        generator=torch.Generator().manual_seed(0))
    cpu.kernel.initialize_from_data(x, y, torch.Generator().manual_seed(1))
    return x, y, cpu, copy.deepcopy(cpu).cuda()


def test_basic_gp_mll_card_matches_cpu(cuda):
    """The baseline's exact MLL and gradient (K1 for the EWMA mean, the
    (n, n, q) spectral-mixture build, a cuSOLVER factor) against the CPU
    at rtol 1e-4."""
    x, y, cpu, card = _basic_pair()
    before = native.launches["volt_ewma_filter"]
    out = {}
    for dev, mod in (("cpu", cpu), ("cuda", card)):
        mll = mod.mll(x.to(dev), y.to(dev))
        mll.backward()
        out[dev] = (mll.detach().cpu(), torch.cat(
            [p.grad.reshape(-1).cpu() for p in mod.parameters()]))
    assert native.launches["volt_ewma_filter"] > before
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0.0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-4 * out["cpu"][1].abs().max().item())


def test_nonvol_rollouts_on_the_card(cuda):
    """The grown-Cholesky rollout on the card equals the dense loop on the
    card and the CPU run, on the same normals, at atol 1e-4 max|y|."""
    from volt_tpu_torch.rollouts import nonvol_rollouts, nonvol_rollouts_dense

    x, y, cpu, card = _basic_pair()
    test_x = x[-1] + torch.arange(1, 9) / 252.0
    zs = torch.randn(16, 8, generator=torch.Generator().manual_seed(2))
    tol = 1e-4 * y.abs().max().item()
    gstate = card.fit_state(x.cuda(), y.cuda())
    got = nonvol_rollouts(None, gstate, None, None, test_x.cuda(), 16,
                          zs=zs.cuda())
    dense = nonvol_rollouts_dense(None, gstate, test_x.cuda(), 16,
                                  zs=zs.cuda())
    want = nonvol_rollouts(None, cpu.fit_state(x, y), None, None, test_x, 16,
                           zs=zs)
    torch.testing.assert_close(got.cpu(), dense.cpu(), rtol=0.0, atol=tol)
    torch.testing.assert_close(got.cpu(), want, rtol=0.0, atol=tol)


def test_lstm_card_matches_cpu(cuda):
    """The LSTM forward (cuDNN against the CPU, TF32 off) at 1e-5, and two
    training epochs on the same initial values and permutations (losses
    rtol 1e-4)."""
    import copy

    from volt_tpu_torch.models.lstm import _Net, _train

    net = _Net(25, 16, 2).init_flax(torch.Generator().manual_seed(3))
    gnet = copy.deepcopy(net).cuda()
    wins = torch.randn(32, 25, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        torch.testing.assert_close(gnet(wins.cuda()).cpu(), net(wins),
                                   rtol=1e-5, atol=1e-6)
    _, f = _sabr(1, 60, 15)
    y = torch.log(f.reshape(-1))
    perms = torch.stack([torch.randperm(60, generator=torch.Generator()
                                        .manual_seed(5 + e))
                         for e in range(2)])
    lc = _train(net, y, 25, 2, 16, 0.01, None, perms)[3]
    lg = _train(gnet, y.cuda(), 25, 2, 16, 0.01, None, perms)[3]
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=0.0)


def test_baseline_drivers_on_the_card(cuda, tmp_path):
    """The drivers at a tiny size on their default device, the card."""
    from volt_tpu_torch.experiments import (basic_wind_rollouts,
                                            generate_basic_predictions)

    _, f = _sabr(1, 139, 16)
    f = f.reshape(-1)
    out = generate_basic_predictions(
        "T", f.numpy(), "sm", mean_name="ewma", k=20, forecast_horizon=4,
        train_iters=10, nsample=6, ntrain=100, ntimes=2, save=True,
        outdir=str(tmp_path))
    assert len(out) == 2 and len(list((tmp_path / "T").iterdir())) == 2
    for s in out.values():
        assert s.shape == (6, 4) and torch.isfinite(torch.as_tensor(s)).all()
    x = torch.arange(60) / 365.0
    s = basic_wind_rollouts(x, f[:60] / f[0], x[-1] + x[1:5], "rbf",
                            mean_name="constant", train_iters=10, nsample=8)
    assert s.shape == (8, 4) and s.is_cuda and torch.isfinite(s).all()


def test_one_rank_nccl_mesh_equals_unsharded(cuda):
    """A world of one over NCCL: ``fit_forecast_batch(mesh=make_mesh())``
    runs its collectives (a path all-gather for the fan) and equals the
    unsharded call on the same normals within 1e-6 of max|fan|."""
    import datetime
    import socket

    import torch.distributed as dist

    from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                         make_mesh, multihost_initialize)

    b, n, h, s = 4, 48, 5, 16
    x, f = _sabr(b, n, 9)
    x, f = x.cuda(), f.cuda()
    test_x = x[-1] + torch.arange(1, h + 1, device="cuda") / 252.0
    g = torch.Generator(device="cuda").manual_seed(8)
    noise = {"vol_r0": torch.randn(b, s, device="cuda", generator=g),
             "vol_z": torch.randn(b, s, h, device="cuda", generator=g),
             "zs": torch.randn(b, s, h, device="cuda", generator=g)}
    cfg = PipelineConfig(gpcv_iters=12, vol_iters=12, data_iters=12, k=10,
                         nsample=s, output="quantiles")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert multihost_initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                                timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh()
        assert mesh.backend == "nccl" and mesh.device == torch.device("cuda",
                                                                      0)
        got, _ = fit_forecast_batch(None, x, f, test_x, cfg, noise=noise,
                                    mesh=mesh)
    finally:
        dist.destroy_process_group()
    want, _ = fit_forecast_batch(None, x, f, test_x, cfg, noise=noise)
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=1e-6 * want.abs().max().item())


def test_checkpoint_roundtrip_from_the_card(cuda, tmp_path):
    """A Volt state fitted on the card, saved, restored onto the card:
    identical forecasts on the same draws."""
    from volt_tpu_torch.models import BMGP, VoltGP, make_mean
    from volt_tpu_torch.rollouts import rollouts
    from volt_tpu_torch.train import train_vol_model, train_volt_magpie
    from volt_tpu_torch.utils import restore_volt_state, save_volt_state

    x, f = _sabr(1, 60, 10)
    x, f = x.cuda(), f.reshape(-1).cuda()
    vol = torch.full((60,), 0.2, device="cuda")
    vol_state = train_vol_model(x, vol, train_iters=10)
    model = train_volt_magpie(x, f[1:], vol_state, vol, train_iters=10, k=20)
    path = str(tmp_path / "volt.pt")
    save_volt_state(path, model)
    restored = restore_volt_state(path, VoltGP(mean=make_mean("ewma", k=20)),
                                  BMGP())
    assert restored.train_y.is_cuda
    test_x = x[-1] + torch.arange(1, 6, device="cuda") / 252.0
    s1, s2 = (rollouts(torch.Generator(device="cuda").manual_seed(0), st, x,
                       f, test_x, nsample=16) for st in (model, restored))
    torch.testing.assert_close(s2, s1, rtol=0.0, atol=0.0)


def test_dryrun_multichip_on_the_card(cuda):
    """``dryrun_multichip``'s default device: two gloo ranks on the card
    run every sharded pipeline at tiny shapes."""
    from volt_tpu_torch import graft_entry

    graft_entry.dryrun_multichip(2, timeout=300.0)


def test_fixed_cov_mll_card_matches_cpu(cuda):
    """``VoltGP.make_cov_cache`` (K2, then MAGMA's ``eigh``) and
    ``mll_fixed_cov`` with its gradient in the raw noise, on a small state
    (``sabr_paths(steps=121, seed=8, n_paths=2)``, raw noise -6 and -3),
    against the CPU at rtol 1e-4 (gradients 1e-3, atol 1e-5 of the
    largest); K2 launched once."""
    from volt_tpu_torch.data import sabr_paths
    from volt_tpu_torch.models import VoltGP, make_mean

    f, vol = sabr_paths(steps=121, seed=8, n_paths=2)
    x = torch.arange(120, dtype=torch.float32) / 252.0
    log_y = torch.log(torch.tensor(f[:, 1:]))
    vol = torch.tensor(vol[:, 1:])
    out = {}
    for dev in ("cpu", "cuda"):
        volt = VoltGP(mean=make_mean("ewma", k=20)).init((2,), device=dev)
        with torch.no_grad():
            volt.likelihood.raw_noise.copy_(torch.tensor([[-6.0], [-3.0]]))
        before = native.launches["volt_covariance"]
        cache = volt.make_cov_cache(x.to(dev), vol.to(dev))
        launched = native.launches["volt_covariance"] - before
        assert launched == (1 if dev == "cuda" else 0)
        mll = volt.mll_fixed_cov(cache, x.to(dev), log_y.to(dev))
        grad, = torch.autograd.grad(mll.sum(), volt.likelihood.raw_noise)
        out[dev] = (mll.detach().cpu(), grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0.0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-3,
                               atol=1e-5 * out["cpu"][1].abs().max().item())


def test_fixed_cov_cache_restores_the_linalg_backend(cuda):
    """``make_fixed_cov_cache`` on the card takes its ``eigh`` through
    MAGMA and leaves torch's preferred linalg library as it found it; its
    eigenvalues equal float64's at atol 1e-5 of the largest (a min-kernel
    covariance, n=300, from ``default_rng(3)``)."""
    from volt_tpu_torch.gp.exact import make_fixed_cov_cache
    from volt_tpu_torch.ops.volint import min_index_covariance

    rng = np.random.default_rng(3)
    s = torch.tensor(np.cumsum(rng.uniform(0.5, 1.5, (2, 300)), axis=-1),
                     dtype=torch.float32)
    cov = min_index_covariance(s)
    want = torch.linalg.eigvalsh(cov.double())
    before = torch.backends.cuda.preferred_linalg_library()
    try:
        torch.backends.cuda.preferred_linalg_library("cusolver")
        cache = make_fixed_cov_cache(cov.cuda())
        assert torch.backends.cuda.preferred_linalg_library() == \
            torch._C._LinalgBackend.Cusolver
    finally:
        torch.backends.cuda.preferred_linalg_library(before)
    assert torch.cuda.has_magma
    torch.testing.assert_close(cache.evals.double().cpu(), want, rtol=0.0,
                               atol=1e-5 * want.abs().max().item())


def test_spans_hold_their_kernels_on_the_profilers_clock(cuda):
    """A span around ``synchronize``, one K1 launch and ``synchronize``
    holds K1's device interval as the profiler stamps it: spans and the
    card's events lie on one clock.  Prints the margins."""
    from torch.profiler import ProfilerActivity, profile

    from volt_tpu_torch.utils.profiling import annotate, recording, spans

    y = 4.0 + torch.randn(64, 999, device="cuda", generator=cuda)
    tew.ewma(y, 300)
    torch.cuda.synchronize()
    spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, recording():
        with annotate("k1"):
            torch.cuda.synchronize()
            tew.ewma(y, 300)
            torch.cuda.synchronize()
    (span,) = spans()
    k1 = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA
          and "ewma_filter_kernel" in e.name()]
    assert len(k1) == 1
    start, end = k1[0].start_ns(), k1[0].start_ns() + k1[0].duration_ns()
    print(f"K1 {end - start} ns on the card, {start - span.start_ns} ns "
          f"after the span opened, {span.end_ns - end} ns before it closed")
    assert span.start_ns <= start and end <= span.end_ns


def sync_warnings(fn):
    """``fn()`` with spans recorded under ``set_sync_debug_mode("warn")``:
    for each host-device sync that PyTorch reports, the names of the
    spans open at it and the line that made it."""
    import warnings

    from volt_tpu_torch.utils import profiling

    found = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            found.append(([profiling._buffer[i][0]
                           for i, _ in profiling._open],
                          f"{filename}:{lineno}"))

    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():  # the switch itself reports a sync
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(), profiling.recording():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(before)
    profiling.spans()
    return found


def test_every_sync_of_a_tick_is_in_a_sync_span(cuda):
    """Over one warm tick of the batched pipeline (warm start, refit,
    forecast), every sync that PyTorch reports falls inside a ``sync:``
    span: the spans count every sync the program makes."""
    from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                         warm_start)

    b, n, h = 8, 200, 20
    x = torch.arange(n, device="cuda") / 252.0
    test_x = x[-1] + torch.arange(1, h + 1, device="cuda") / 252.0
    ys = 100.0 * torch.exp(torch.cumsum(0.01 * torch.randn(
        b, n + 2, device="cuda", generator=cuda), dim=-1))
    cfg = PipelineConfig(gpcv_iters=3, vol_iters=3, data_iters=3, k=20,
                         nsample=64, output="quantiles")
    _, aux = fit_forecast_batch(cuda, x, ys[:, :-1], test_x, cfg)

    def tick():
        init = warm_start(aux, shift=1, n=n)
        fit_forecast_batch(cuda, x, ys[:, 1:], test_x, cfg, init)

    found = sync_warnings(tick)
    print("syncs of a tick:", found)
    assert found
    assert [f for f in found if not any(
        s.startswith("sync:") for s in f[0])] == []


def test_a_second_warm_tick_syncs_only_at_the_grid_check(cuda):
    """In a second warm tick of the batched pipeline every sync that
    PyTorch reports falls in ``sync:equispaced`` or a stage wait: the
    fixed constants reached the card once, in the earlier calls."""
    from volt_tpu_torch.parallel import (PipelineConfig, fit_forecast_batch,
                                         warm_start)

    b, n, h = 8, 200, 20
    x = torch.arange(n, device="cuda") / 252.0
    test_x = x[-1] + torch.arange(1, h + 1, device="cuda") / 252.0
    ys = 100.0 * torch.exp(torch.cumsum(0.01 * torch.randn(
        b, n + 2, device="cuda", generator=cuda), dim=-1))
    cold = PipelineConfig(gpcv_iters=5, vol_iters=5, data_iters=5, k=20,
                          nsample=64, output="quantiles")
    warm = PipelineConfig(gpcv_iters=3, vol_iters=3, data_iters=3, k=20,
                          nsample=64, output="quantiles")
    _, aux = fit_forecast_batch(cuda, x, ys[:, :-1], test_x, cold)

    def tick():
        init = warm_start(aux, shift=1, n=n)
        fit_forecast_batch(cuda, x, ys[:, 1:], test_x, warm, init)

    tick()
    found = sync_warnings(tick)
    print("syncs of a second warm tick:", found)
    assert found
    waits = {"sync:equispaced", "sync:stage_start", "sync:stage_end"}
    assert [f for f in found if not waits.intersection(f[0])] == []


def test_multitask_tick_spans_on_the_card(cuda):
    """Over one warm tick of the multitask pipeline every sync that
    PyTorch reports falls inside a ``sync:`` span, and the Kronecker
    spans nest: ``mt_elbo`` (kernel G3) in each GPCV forward, with no
    ``sync:jitter`` anywhere in the GPCV stage, ``woodbury`` (kernel G4)
    in each vol forward, with no ``sync:solve`` or ``sync:jitter`` anywhere
    in the vol stage, and the sampler's stage
    ``sample_vol`` (``prior_draw``, ``eigh`` with its ``sync:eigh``,
    ``kron_solve``) inside ``rollout``."""
    import collections

    from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                         fit_forecast_multitask,
                                         warm_start_multitask)
    from volt_tpu_torch.utils import profiling

    t, n, h, steps = 8, 200, 20, 3
    x = torch.arange(n, device="cuda") / 252.0
    test_x = x[-1] + torch.arange(1, h + 1, device="cuda") / 252.0
    ys = 100.0 * torch.exp(torch.cumsum(0.01 * torch.randn(
        t, n + 2, device="cuda", generator=cuda), dim=-1))
    cfg = MultitaskPipelineConfig(gpcv_iters=steps, vol_iters=steps,
                                  data_iters=steps, k=20, nsample=64,
                                  output="quantiles")
    _, aux = fit_forecast_multitask(cuda, x, ys[:, :-1], test_x, cfg)
    ticks = []

    def tick():
        init = warm_start_multitask(aux, shift=1, n=n)
        ticks.append(fit_forecast_multitask(cuda, x, ys[:, 1:], test_x,
                                            cfg, init))

    found = sync_warnings(tick)
    print("syncs of a multitask tick:", found)
    assert found
    assert [f for f in found if not any(
        s.startswith("sync:") for s in f[0])] == []
    with profiling.recording():
        tick()
    rows = profiling.spans()

    def path(i):
        names = []
        while i is not None:
            names.append(rows[i].name)
            i = rows[i].parent
        return "/".join(reversed(names))

    paths = collections.Counter(path(i) for i in range(len(rows)))
    forward = "call/{}/adam_step/forward/"
    for p, count in {forward.format("gpcv") + "mt_elbo": steps,
                     forward.format("gpcv") + "ell": 0,
                     forward.format("gpcv") + "kron_kl": 0,
                     forward.format("vol") + "woodbury": steps,
                     forward.format("vol") + "woodbury/sync:solve": 0,
                     "call/rollout/sample_vol/prior_draw": 1,
                     "call/rollout/sample_vol/eigh/sync:eigh": 1,
                     "call/rollout/sample_vol/kron_solve": 1}.items():
        assert paths[p] == count, (p, paths[p])
    assert not [p for p in paths if p.startswith("call/gpcv/")
                and "sync:jitter" in p]
    assert not [p for p in paths if p.startswith("call/vol/")
                and ("sync:jitter" in p or "sync:solve" in p)]
    assert set(ticks[-1][1]["stage_seconds"]) == {"gpcv", "vol", "data",
                                                  "rollout", "sample_vol"}


def test_a_second_warm_multitask_tick_syncs_only_at_the_vol_stage_wait(cuda):
    """In a second warm tick of the multitask pipeline no sync that
    PyTorch reports falls in the ``vol`` stage but its closing wait
    (``sync:stage_end``): kernel G4 takes the vol steps, so the plain
    path's ``sync:jitter`` and ``sync:solve`` are gone from them.  The
    tick's other stages still report theirs (the grid check, the
    sampler's), so the hook sees syncs."""
    from volt_tpu_torch.parallel import (MultitaskPipelineConfig,
                                         fit_forecast_multitask,
                                         warm_start_multitask)

    t, n, h = 8, 200, 20
    x = torch.arange(n, device="cuda") / 252.0
    test_x = x[-1] + torch.arange(1, h + 1, device="cuda") / 252.0
    ys = 100.0 * torch.exp(torch.cumsum(0.01 * torch.randn(
        t, n + 2, device="cuda", generator=cuda), dim=-1))
    cfg = MultitaskPipelineConfig(gpcv_iters=3, vol_iters=3, data_iters=3,
                                  k=20, nsample=64, output="quantiles")
    _, aux = fit_forecast_multitask(cuda, x, ys[:, :-1], test_x, cfg)

    def tick():
        init = warm_start_multitask(aux, shift=1, n=n)
        fit_forecast_multitask(cuda, x, ys[:, 1:], test_x, cfg, init)

    tick()
    before = native.launches[G4]
    found = sync_warnings(tick)
    assert native.launches[G4] == before + cfg.vol_iters
    print("syncs of a second warm multitask tick:", found)
    assert found
    assert [f for f in found if "vol" in f[0]
            and "sync:stage_end" not in f[0]] == []

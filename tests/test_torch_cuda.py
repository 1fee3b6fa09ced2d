"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
one (which need not have JAX), run them alone, without the JAX test
harness::

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import importlib

import pytest
import torch

from volt_tpu_torch import native

tew = importlib.import_module("volt_tpu_torch.ops.ewma")
ttd = importlib.import_module("volt_tpu_torch.ops.tridiag")
tvc = importlib.import_module("volt_tpu_torch.ops.volt_cov")
tgh = importlib.import_module("volt_tpu_torch.ops.gh_ell")
tvi = importlib.import_module("volt_tpu_torch.ops.volint")

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

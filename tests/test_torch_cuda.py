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

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,k", [((3, 50), 1), ((3, 50), 64),
                                     ((3, 50), 2000), ((2, 3, 37), 7),
                                     ((70000, 3), 2)])
def test_ewma_kernel_matches_plain(cuda, shape, k):
    y = 4.0 + torch.randn(*shape, device="cuda", generator=cuda)
    before = native.launches["volt_ewma_filter"]
    got = tew.ewma(y, k)
    assert native.launches["volt_ewma_filter"] == before + 1
    want = tew._ewma_conv(y, k)
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=1e-5 * y.abs().max().item())


def test_ewma_kernel_gradient_is_the_plain_transpose(cuda):
    y = torch.randn(4, 40, device="cuda", generator=cuda)
    a, b = y.clone().requires_grad_(), y.clone().requires_grad_()
    torch.sin(tew.ewma(a, 9)).sum().backward()
    torch.sin(tew._ewma_conv(b, 9)).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shared_v", [False, True])
def test_kalman_kernel_matches_plain(cuda, shared_v):
    b, n = 5, 300
    vol = 0.2 + 0.05 * torch.rand(1 if shared_v else b, n, device="cuda",
                                  generator=cuda)
    v = torch.cumsum(vol * vol / 252.0, dim=-1)
    v = v[0] if shared_v else v
    s2 = 10.0 ** (-4.0 + 3.0 * torch.rand(b, device="cuda", generator=cuda))
    resid = 0.05 * torch.randn(b, n, device="cuda", generator=cuda)

    def run(kernel):
        ins = [t.clone().requires_grad_() for t in (v, s2, resid)]
        if kernel:
            ll, mean, var = ttd._kalman(*ins)
        else:
            delta = torch.diff(ins[0], dim=-1,
                               prepend=torch.zeros_like(ins[0][..., :1]))
            ll, mean, var = ttd._kalman_plain(
                delta.expand(b, n), ins[1], ins[2])
        (ll.sum() + 0.5 * mean.sum() + 2.0 * var.sum()).backward()
        return (ll, mean, var), [t.grad for t in ins]

    outs, grads = run(True)
    outs_p, grads_p = run(False)
    for a, p in zip(outs, outs_p):
        torch.testing.assert_close(a, p, rtol=1e-5, atol=0.0)
    for a, p in zip(grads, grads_p):
        torch.testing.assert_close(a, p, rtol=1e-4,
                                   atol=1e-6 * max(1.0, p.abs().max().item()))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    y64 = torch.zeros(2, 5, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        tew.ewma(y64, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tew.ewma_filter_cuda(torch.zeros(5, 2, device="cuda").t(), 3)
    z = torch.zeros(2, 5, device="cuda")
    with pytest.raises(ValueError):
        ttd.kalman_forward_cuda(z, torch.ones(3, device="cuda"), z, save=False)

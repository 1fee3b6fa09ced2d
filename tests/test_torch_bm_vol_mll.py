"""Kernel G2 (``csrc/bm_vol_mll.cu``) on the CPU: its closed-form spectral
vol MLL and gradient (``ops/bm_vol_mll``'s ``bm_vol_mll_reference``, the
computation the kernel runs) against autograd of ``BMGP.mll_spectral`` in
float64; and the rule by which ``mll_spectral`` takes it.  The kernel
itself runs in ``tests/test_torch_cuda.py``."""

import itertools
import math

import pytest
import torch

from volt_tpu_torch import native
from volt_tpu_torch.models import bmgp
from volt_tpu_torch.models.bmgp import BMGP
from volt_tpu_torch.ops import bm_vol_mll

DT = 1.0 / 252
# the grid's first point in steps: a = vol (x0 - dx) < 0, = 0, > 0
STARTS = {"a<0": 0.0, "a=0": 1.0, "a>0": 2.0}
BATCHES = {"()": (), "(4,)": (4,), "(3, 2)": (3, 2)}


def _model(n, start, batch, per_asset=False, dtype=torch.float64, seed=0):
    """A vol GP with random parameters near a fit's, its grid from
    ``start`` steps (shared, or a step of its own per asset) and the
    spectral cache of log vols on a random walk."""
    g = torch.Generator().manual_seed(seed)
    model = BMGP().init(batch, dtype)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g, dtype=dtype))
    steps = torch.arange(n, dtype=dtype) + STARTS[start]
    if per_asset:
        dt = DT * (1.0 + 0.2 * torch.rand(*batch, 1, generator=g,
                                          dtype=dtype))
        x = steps * dt
    else:
        x = steps * DT
    y = math.log(0.2) + torch.cumsum(
        0.05 * torch.randn(*batch, n, generator=g, dtype=dtype), dim=-1)
    return model, model.spectral_cache(x, y)


def _g2_args(model, cache):
    return ([cache[k] for k in ("p_y", "p_t", "mu", "w", "dx", "x0")]
            + [model.kernel.vol(), model.likelihood.noise()])


@pytest.mark.parametrize("n,start,batch,grid", list(itertools.product(
    (2, 17, 60, 999), STARTS, BATCHES, ("shared", "per_asset"))))
def test_g2_closed_form_equals_autograd_of_the_mll(n, start, batch, grid):
    """The MLL and its gradients with respect to ``raw_vol`` (through the
    sigmoid) and ``raw_noise`` (through the softplus), on a grid from 0
    (a < 0), from one step (a = 0) and from two (a > 0), shared or per
    asset: within 1e-9 of autograd of the composition (float64 rounding
    reads ~1e-15)."""
    model, cache = _model(n, start, BATCHES[batch], grid == "per_asset")
    want = model.mll_spectral(cache)
    want.sum().backward()
    args = _g2_args(model, cache)
    got, grads = bm_vol_mll.bm_vol_mll_reference(
        *(a.detach() for a in args))
    assert got.shape == want.shape
    params = dict(model.named_parameters())
    have = torch.autograd.grad(args[6:], list(params.values()), grads)
    errs = {"mll": ((got - want).abs().max()
                    / want.abs().max()).item()}
    for (name, p), h in zip(params.items(), have):
        errs[name] = ((h - p.grad).abs().max()
                      / p.grad.abs().max()).item()
    assert max(errs.values()) <= 1e-9, errs


# what the call is -> whether mll_spectral takes G2: on the card every call
# goes to G2, whose wrapper raises on float64 (tests/test_torch_cuda.py)
# and on a gradient wanted for the spectral cache (here)
PREDICATE_CASES = {
    "float32": ({}, True),
    "per_asset": ({"per_asset": True}, True),
    "float64": ({"dtype": torch.float64}, True),
    "cache_requires_grad": ({"cache_grad": True}, True),
    "cpu": ({"cpu": True}, False),
}


@pytest.mark.parametrize("case", list(PREDICATE_CASES))
def test_g2_dispatch_rule(case, monkeypatch):
    """``BMGP.mll_spectral`` takes G2 for every call on the card
    (``native.on_card``) and the plain composition for every call on the
    CPU: nothing falls back to the plain path on the card, and G2 refuses
    a gradient wanted for the spectral cache.  Evaluated without a card:
    the tensors count as the card's unless the case is the CPU, and G2's
    entry in the model is a stub that records its calls."""
    kw, takes = PREDICATE_CASES[case]
    model, cache = _model(9, "a<0", (3,), kw.get("per_asset", False),
                          dtype=kw.get("dtype", torch.float32))
    if kw.get("cache_grad"):
        cache["p_y"] = cache["p_y"].clone().requires_grad_()
    calls = []
    monkeypatch.setattr(bmgp, "bm_vol_mll",
                        lambda *a: calls.append(a) or torch.zeros(3))
    if not kw.get("cpu"):
        monkeypatch.setattr(native, "on_card", lambda t: True)
    model.mll_spectral(cache)
    assert bool(calls) is takes
    if kw.get("cache_grad"):
        with pytest.raises(ValueError, match="no gradient"):
            bm_vol_mll.bm_vol_mll(*_g2_args(model, cache))


@pytest.mark.parametrize("start", list(STARTS))
@pytest.mark.parametrize("grid", ["shared", "per_asset"])
def test_g2_cpu_path_is_the_plain_composition(start, grid):
    """On the CPU ``mll_spectral`` launches nothing and returns, bit for
    bit, the plain composition's MLL."""
    model, cache = _model(17, start, (4,), grid == "per_asset",
                          dtype=torch.float32)
    before = dict(native.launches)
    got = model.mll_spectral(cache)
    assert dict(native.launches) == before
    mu, dx, x0 = cache["mu"], cache["dx"], cache["x0"]
    p_y, p_t, w = cache["p_y"], cache["p_t"], cache["w"]
    vol = model.kernel.vol()[..., 0]
    noise = model.likelihood.noise()[..., 0]
    d = vol[..., None] * dx[..., None] * mu + noise[..., None]
    p_r = p_y + 0.5 * (vol ** 2.0)[..., None] * p_t
    a = vol * (x0 - dx)
    wd = w / d
    s = 1.0 + a * torch.sum(w * wd, dim=-1)
    quad = (torch.sum(p_r * p_r / d, dim=-1)
            - a * torch.sum(wd * p_r, dim=-1) ** 2 / s)
    logdet = torch.sum(torch.log(d), dim=-1) + torch.log(s)
    want = -0.5 * (quad + logdet + 17 * math.log(2.0 * math.pi)) / 17
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_g2_wrapper_refuses_cpu_tensors(dtype):
    """The kernel's wrapper takes CUDA tensors only: on the CPU, float32
    or float64, it raises, it does not fall back."""
    model, cache = _model(9, "a<0", (3,), dtype=dtype)
    args = [a.detach() for a in _g2_args(model, cache)]
    with pytest.raises(ValueError, match="CUDA"):
        bm_vol_mll.bm_vol_mll_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        bm_vol_mll.bm_vol_mll(*args)

"""Kernel G4 (``csrc/mt_vol_mll.cu``) on the CPU: its closed-form
multitask Woodbury vol MLL and gradient (``ops/mt_vol_mll``'s
``mt_vol_mll_reference``, the computation the kernel runs, around the same
coupling code) against autograd of ``MultitaskBMGP.mll_spectral`` in
float64; and the rule by which ``mll_spectral`` takes it.  The kernel
itself runs in ``tests/test_torch_cuda.py``."""

import itertools

import pytest
import torch

from volt_tpu_torch import native
from volt_tpu_torch.gp.kronecker import kron_mvn_log_prob_blockdiag_lowrank
from volt_tpu_torch.models import multitask
from volt_tpu_torch.models.multitask import MultitaskBMGP
from volt_tpu_torch.ops import mt_vol_mll

DT = 1.0 / 252
# the grid's first point in steps: c = vol (x0 - dx) < 0, = 0, > 0
STARTS = {"c<0": 0.0, "c=0": 1.0, "c>0": 2.0}


def _model(n, t, r, start, dtype=torch.float64, seed=0):
    """A multitask vol GP with random parameters near a fit's, its grid
    from ``start`` steps and the spectral cache of random log vols."""
    g = torch.Generator().manual_seed(seed)
    model = MultitaskBMGP(t, rank=r).init(dtype, generator=g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g, dtype=dtype))
    x = (torch.arange(n, dtype=dtype) + STARTS[start]) * DT
    y = -1.5 + 0.3 * torch.randn(n, t, generator=g, dtype=dtype)
    return model, model.spectral_cache(x, y)


def _g4_args(model, cache):
    factor, task_diag = model.task_kernel.factor_and_diag()
    return ([cache[k] for k in ("p_y", "p_x", "mu", "w", "dx", "x0")]
            + [model.data_kernel.vol(), factor, task_diag,
               model.likelihood.noise()])


def _against_autograd(n, t, r, start):
    """The closed form's MLL and gradients, carried to the raw parameters
    through the constraints by autograd, against ``mll_spectral`` and its
    autograd: each one's worst distance over its largest value."""
    model, cache = _model(n, t, r, start)
    want = model.mll_spectral(cache, n, t)
    want.backward()
    args = _g4_args(model, cache)
    got, grads = mt_vol_mll.mt_vol_mll_reference(
        *(a.detach() for a in args))
    params = dict(model.named_parameters())
    have = torch.autograd.grad(args[6:], list(params.values()), grads)
    errs = {"mll": abs(got.item() - want.item()) / abs(want.item())}
    for (name, p), h in zip(params.items(), have):
        errs[name] = ((h - p.grad).abs().max()
                      / p.grad.abs().max()).item()
    return errs


@pytest.mark.parametrize("n,t,r,start", list(itertools.product(
    (2, 17, 60), (1, 3, 8), (1, 2, 4), STARTS)) + [(999, 505, 1, "c<0")])
def test_g4_closed_form_equals_autograd_of_the_mll(n, t, r, start):
    """The MLL and the gradients with respect to ``raw_vol`` (through the
    sigmoid), the task factor, ``raw_var`` (through the softplus) and
    ``raw_noise``, on a grid from 0 (c < 0), from one step (c = 0) and
    from two (c > 0), and at the live cell's shape on its grid from 0:
    within 1e-9 of autograd of the composition."""
    errs = _against_autograd(n, t, r, start)
    assert max(errs.values()) <= 1e-9, errs


# (what the model is, what the tensors are) -> whether mll_spectral takes G4:
# on the card every call goes to G4, whose wrapper raises on a rank above
# 4, float64 and a batch (tests/test_torch_cuda.py) and on a gradient
# wanted for the spectral cache (here)
PREDICATE_CASES = {
    "rank_1": ({"r": 1}, {}, True),
    "rank_4": ({"r": 4}, {}, True),
    "rank_5": ({"r": 5}, {}, True),
    "float64": ({"dtype": torch.float64}, {}, True),
    "batched": ({}, {"batched": True}, True),
    "cache_requires_grad": ({}, {"cache_grad": True}, True),
    "cpu": ({}, {"cpu": True}, False),
}


@pytest.mark.parametrize("case", list(PREDICATE_CASES))
def test_g4_dispatch_rule(case, monkeypatch):
    """``MultitaskBMGP.mll_spectral`` takes G4 for every call on the card
    (``native.on_card``) and the plain composition for every call on the
    CPU: nothing falls back to the plain path on the card, and G4 refuses
    a gradient wanted for the spectral cache.  Evaluated without a card:
    the tensors count as the card's unless the case is the CPU, and G4's
    entry in the model is a stub that records its calls."""
    model_kw, data_kw, takes = PREDICATE_CASES[case]
    dtype = model_kw.get("dtype", torch.float32)
    model, cache = _model(9, 3, model_kw.get("r", 1), "c<0", dtype=dtype)
    if data_kw.get("batched"):
        cache["p_y"] = cache["p_y"].expand(2, 9, 3)
    if data_kw.get("cache_grad"):
        cache["p_y"] = cache["p_y"].clone().requires_grad_()
    calls = []
    monkeypatch.setattr(multitask, "mt_vol_mll",
                        lambda *a: calls.append(a) or torch.zeros(()))
    if not data_kw.get("cpu"):
        monkeypatch.setattr(native, "on_card", lambda t: True)
    model.mll_spectral(cache, 9, 3)
    assert bool(calls) is takes
    if data_kw.get("cache_grad"):
        with pytest.raises(ValueError, match="no gradient"):
            mt_vol_mll.mt_vol_mll(*_g4_args(model, cache))


@pytest.mark.parametrize("start", list(STARTS))
def test_g4_cpu_path_is_the_plain_composition(start):
    """On the CPU ``mll_spectral`` launches nothing and returns, bit for
    bit, the plain composition's MLL."""
    model, cache = _model(17, 3, 2, start, dtype=torch.float32)
    before = dict(native.launches)
    got = model.mll_spectral(cache, 17, 3)
    assert dict(native.launches) == before
    vol = model.data_kernel.vol()[..., 0]
    factor, task_diag = model.task_kernel.factor_and_diag()
    diag_b = torch.sum(factor * factor, dim=-1) + task_diag
    r_tilde = cache["p_y"] + (0.5 * vol ** 2.0 * cache["p_x"])[
        ..., :, None] * diag_b[..., None, :]
    want = kron_mvn_log_prob_blockdiag_lowrank(
        r_tilde, vol * cache["dx"] * cache["mu"],
        vol * (cache["x0"] - cache["dx"]), factor, task_diag,
        model.likelihood.noise()[..., 0], cache["w"]) / (17 * 3)
    assert torch.equal(got, want)


def test_g4_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: on the CPU it
    raises, it does not fall back."""
    model, cache = _model(9, 3, 1, "c<0", dtype=torch.float32)
    args = [a.detach() for a in _g4_args(model, cache)]
    with pytest.raises(ValueError, match="CUDA"):
        mt_vol_mll.mt_vol_mll_cuda(*args)

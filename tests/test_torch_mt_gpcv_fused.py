"""Kernel G3 (``csrc/mt_gpcv_elbo.cu``) on the CPU: its closed-form joint
ELBO and gradient, written here as the plain float64 computation it runs
(sequential recurrences on the data side, Woodbury on the task side, hand
gradients), against autograd of ``MultitaskVariationalGP.elbo`` in
float64; and the rule by which ``elbo`` takes it.  The kernel itself runs
in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch import nn

from volt_tpu_torch import native
from volt_tpu_torch.likelihoods import VolatilityGaussianLikelihood
from volt_tpu_torch.models.multitask import MultitaskVariationalGP
from volt_tpu_torch.ops.chol import psd_safe_cholesky

DT = 1.0 / 252
JITTER = 1e-6


def g3_oracle(x, y, m, ld, e, root, c, f, v, vol):
    """G3's ELBO and gradients as ``csrc/mt_gpcv_elbo.cu`` states them, on
    float64 arrays: ``x (n,)``, ``y``, ``m`` ``(n, T)``, ``ld (n,)``, ``e
    (n-1,)``, ``root (T, T)``, ``c (T,)``, ``f (T, r)``, ``v (T,)``, ``vol``
    a float.  Returns the ELBO and the gradients with respect to ``m``,
    ``q_log_d``, ``q_e``, ``root``, ``c``, ``f``, ``v`` and ``vol``."""
    n, t = y.shape
    r = f.shape[1]
    d_inv = np.exp(-ld)
    a = d_inv ** 2
    rr = np.zeros(n)
    rr[:-1] = e * d_inv[:-1]
    jit = JITTER / vol
    raw = np.diff(x, prepend=0.0)
    dx = np.maximum(raw, jit)
    share = np.where(jit > raw, 1.0, np.where(jit == raw, 0.5, 0.0))
    inv = np.zeros(n + 1)
    inv[:n] = 1.0 / dx
    # the Takahashi band of the data factor, from the end
    sx = np.zeros(n + 1)
    for j in range(n - 1, -1, -1):
        sx[j] = a[j] + rr[j] ** 2 * sx[j + 1]
    cv = -rr * sx[1:]
    tj = (inv[:n] + inv[1:]) * sx[:n] - 2.0 * inv[1:] * cv
    trx = np.sum(tj) / vol
    # the task side through K = F F^T + diag(v), by Woodbury
    low = np.tril(root)
    dt = np.sum(low * low, axis=1)
    g = f / v[:, None]
    ci = np.linalg.inv(np.eye(r) + f.T @ g)
    logk = np.sum(np.log(v)) - np.linalg.slogdet(ci)[1]
    p = low.T @ g  # P_b = sum_{a >= b} R_ab G_a
    tau = np.sum(dt / v) - np.sum((p @ ci) * p)
    gap = np.concatenate([c[None, :] - m[:1], m[:-1] - m[1:]], axis=0)
    dg = gap @ g
    qq = np.sum(gap * gap / v, axis=1) - np.sum((dg @ ci) * dg, axis=1)
    q = np.sum(inv[:n] * qq)
    # the expected log-likelihood
    u = 2.0 * sx[:n, None] * dt[None, :] - 2.0 * m
    w = np.exp(np.minimum(u, 80.0))
    yw = np.where(u <= 80.0, y * y * w, 0.0)
    ell = np.sum(-0.5 * y * y * w - m - 0.5 * np.log(2.0 * np.pi))
    kl = 0.5 * (tau * trx + q / vol - n * t
                + t * (n * np.log(vol) + np.sum(np.log(dx))) + n * logk
                + 2.0 * t * np.sum(ld)
                - 2.0 * n * np.sum(np.log(np.abs(np.diag(root)))))
    # the gradient of ELL - KL
    eta = np.zeros((n + 1, t))
    eta[:n] = inv[:n, None] * (gap / v - (dg @ ci) @ g.T) / vol
    gsx = -(yw @ dt) - 0.5 * tau * (inv[:n] + inv[1:]) / vol
    lam = np.zeros(n)
    prev = 0.0
    for j in range(n):  # the adjoint of the sx recurrence, from the start
        rp = rr[j - 1] if j else 0.0
        prev = rp ** 2 * prev + gsx[j] - tau * rp * inv[j] / vol
        lam[j] = prev
    gr = sx[1:] * (2.0 * rr * lam - tau * inv[1:] / vol)
    before = np.zeros(n)
    before[1:] = sx[:n - 1] + 2.0 * rr[:n - 1] * sx[1:n]
    dkl_ddx = 0.5 * (t * inv[:n] - inv[:n] ** 2
                     * (tau * (sx[:n] + before) + qq) / vol)
    gdt = -(yw.T @ sx[:n])
    a_root = low / v[:, None] - g @ ci @ p.T  # K^{-1} R
    eg = trx * (low @ p) + gap.T @ (inv[:n, None] * dg) / vol  # E G
    geg = g.T @ eg
    cig = g @ ci
    e_diag = trx * dt + np.sum(inv[:n, None] * gap * gap, axis=0) / vol
    aea = (e_diag / v ** 2 - 2.0 * np.sum(cig * eg, axis=1) / v
           + np.sum((cig @ geg) * cig, axis=1))
    grads = {
        "variational_mean": yw - 1.0 + eta[:n] - eta[1:],
        "q_log_d": -2.0 * a * lam - rr * gr - t,
        "q_e": (gr * d_inv)[:n - 1],
        "variational_task_covar_root": np.tril(2.0 * low * gdt[:, None]
                                               - trx * a_root)
        + np.diag(n / np.diag(root)),
        "mean_constants": -eta[0],
        "covar_factor": -n * cig + (eg @ ci) / v[:, None] - cig @ geg @ ci,
        "v": -0.5 * (n * (1.0 / v - np.sum(g * cig, axis=1)) - aea),
        "vol": (((tau * np.sum(tj) + q) / vol - n * t) / (2.0 * vol)
                + jit / vol * np.sum(share * dkl_ddx)),
        # the size of the vol gradient's terms, which cancel on a grid
        # from 0
        "vol_terms": (((tau * np.sum(np.abs(tj)) + q) / vol + n * t)
                      / (2.0 * vol)
                      + jit / vol * np.sum(np.abs(share * dkl_ddx))),
    }
    return (ell - kl) / (n * t), {k: val / (n * t) for k, val in
                                  grads.items()}


def _model(rng, n, t, r, dtype=torch.float64, q="tridiag", kernel="bm",
           raw_var=-2.0):
    """A multitask variational GP with random parameters near those a
    fit reaches (the task root near the identity)."""
    x = torch.zeros(n, dtype=dtype)
    model = MultitaskVariationalGP(t, rank=r, kernel=kernel, q=q)
    model.init(x, dtype)

    def param_(*shape, loc=0.0, scale=1.0):
        return nn.Parameter(torch.tensor(
            loc + scale * rng.standard_normal(shape), dtype=dtype))

    model.data_kernel.raw_vol = param_(1, loc=-1.4, scale=0.3)
    model.index_kernel.covar_factor = param_(t, r, scale=0.3)
    model.index_kernel.raw_var = param_(t, loc=raw_var, scale=0.3)
    model.mean_constants = param_(t, loc=-1.5, scale=0.2)
    model.variational_mean = param_(n, t, loc=-1.5, scale=0.3)
    model.variational_task_covar_root = param_(t, t, scale=0.1)
    with torch.no_grad():
        model.variational_task_covar_root += torch.eye(t, dtype=dtype)
    if q == "tridiag":
        model.q_log_d = param_(n, loc=2.0, scale=0.3)
        model.q_e = param_(n - 1, loc=-5.0, scale=1.0)
    return model


def _likelihood(dtype=torch.float64, param="exp"):
    lik = VolatilityGaussianLikelihood(param=param)
    lik.init((), dtype, None, torch.Generator().manual_seed(0))
    return lik


def _against_oracle(model, x, y):
    """The oracle's ELBO and gradients against ``model.elbo`` and its
    autograd (``raw_var`` through the softplus, ``raw_vol`` through the
    sigmoid): each parameter's worst distance over its largest value (for
    ``vol``, over the largest of its terms, which cancel on a grid from
    0)."""
    lik = _likelihood()
    assert not model._takes_g3(x, y, lik)
    elbo = model.elbo(x, y, lik)
    elbo.backward()
    vol = model.data_kernel.vol().detach()
    factor, task_diag = model.index_kernel.factor_and_diag()
    want, grads = g3_oracle(*(a.detach().numpy() for a in (
        x, y, model.variational_mean, model.q_log_d, model.q_e,
        model.variational_task_covar_root, model.mean_constants, factor,
        task_diag)), vol.item())
    errs = {"elbo": abs(want - elbo.item()) / abs(elbo.item())}

    def err(name, want, have, scale=None):
        scale = np.abs(want).max(initial=0.0) if scale is None else scale
        errs[name] = (np.abs(have - want).max(initial=0.0)
                      / max(scale, np.finfo(float).tiny))

    for name in ("variational_mean", "q_log_d", "q_e",
                 "variational_task_covar_root", "mean_constants"):
        err(name, grads[name], getattr(model, name).grad.numpy())
    kernel = model.index_kernel
    err("covar_factor", grads["covar_factor"], kernel.covar_factor.grad.numpy())
    dsoft = torch.sigmoid(kernel.raw_var.detach()).numpy()
    err("raw_var", grads["v"] * dsoft, kernel.raw_var.grad.numpy())
    dsig = (vol * (1.0 - vol)).item()
    err("raw_vol", grads["vol"] * dsig,
        model.data_kernel.raw_vol.grad.numpy()[0], grads["vol_terms"] * dsig)
    return errs, grads


@pytest.mark.parametrize("start", ["zero", "dt"])
@pytest.mark.parametrize("n,t,r", [(1, 1, 1), (2, 3, 1), (7, 5, 2),
                                   (64, 8, 2), (999, 505, 1)])
def test_g3_closed_form_equals_autograd_of_the_elbo(n, t, r, start):
    """The oracle's ELBO and its gradient with respect to every parameter
    equal ``MultitaskVariationalGP.elbo`` (``q="tridiag"``, the exp term)
    and its autograd in float64 within 1e-9 of the largest value, on a
    grid from 0 (the jitter floor taken at the first step) and from one
    step, with one entry of the mean placed so that its exponent ``2 var -
    2 m`` passes the cap of 80."""
    rng = np.random.default_rng(n + t + r)
    model = _model(rng, n, t, r)
    x = torch.tensor(np.arange(n) * DT + (DT if start == "dt" else 0.0))
    with torch.no_grad():
        model.variational_mean[n // 2, t // 2] = -45.0
    y = torch.tensor(0.2 * rng.standard_normal((n, t)))
    errs, _ = _against_oracle(model, x, y)
    with torch.no_grad():
        var = model.marginal_variances()
    u = 2.0 * (var - model.variational_mean)
    assert (u > 80.0).sum() == 1
    assert max(errs.values()) <= 1e-9, errs


def test_g3_closed_form_at_a_tie_with_the_floor():
    """At a grid whose first increment equals the floor ``1e-6 / vol``
    (``torch.maximum`` gives each side half the gradient), the oracle's vol
    gradient is autograd's."""
    rng = np.random.default_rng(3)
    n, t = 9, 4
    model = _model(rng, n, t, 1)
    with torch.no_grad():
        # vol 1/2 exactly, so 1e-6 / vol rounds alike however computed
        model.data_kernel.raw_vol.zero_()
    x = torch.tensor(2.0 * JITTER + np.arange(n) * DT)
    y = torch.tensor(0.2 * rng.standard_normal((n, t)))
    errs, grads = _against_oracle(model, x, y)
    assert max(errs.values()) <= 1e-9, errs


def test_g3_closed_form_where_the_float32_ladder_adds_jitter():
    """A task covariance ``F F^T + diag(v)`` with ``v`` near 1e-8: its bare
    float32 Cholesky fails, so the float32 plain path climbs the jitter
    ladder, while the float64 one factors it as it is.  The oracle (the
    kernel's float64 Woodbury, which needs no jitter) agrees with the
    float64 plain path within 1e-6 of the largest value, and the float32
    plain path's ELBO is far from both."""
    rng = np.random.default_rng(5)
    n, t = 64, 8
    model = _model(rng, n, t, 1, raw_var=-18.4)
    with torch.no_grad():
        model.index_kernel.covar_factor.mul_(3.0)
        k_task = model.index_kernel.covar_matrix()
    assert int(torch.linalg.cholesky_ex(k_task.float()).info) != 0
    assert int(torch.linalg.cholesky_ex(k_task).info) == 0
    # what the float32 ladder gives differs from the bare factor
    chol32 = psd_safe_cholesky(k_task.float())
    assert not torch.allclose(chol32 @ chol32.mT, k_task.float(), rtol=0.0,
                              atol=1e-7)
    x = torch.tensor(np.arange(n) * DT + DT)
    y = torch.tensor(0.2 * rng.standard_normal((n, t)))
    with torch.no_grad():
        model32 = _model(np.random.default_rng(0), n, t, 1,
                         dtype=torch.float32)
        model32.load_state_dict({k: p.float() for k, p in
                                 model.state_dict().items()})
        elbo32 = model32.elbo(x.float(), y.float(),
                              _likelihood(torch.float32)).item()
    errs, _ = _against_oracle(model, x, y)
    elbo64 = model.elbo(x, y, _likelihood()).item()
    assert max(errs.values()) <= 1e-6, errs
    assert abs(elbo32 - elbo64) > 1e-3 * abs(elbo64)


# (what the model is, what the tensors are) -> whether elbo takes G3: on
# the card every call of the family goes to G3, whose wrapper raises on a
# rank above 4, float64 and a batch (tests/test_torch_cuda.py) and on a
# gradient wanted for the grid or the returns (here)
PREDICATE_CASES = {
    "tridiag_exp": ({}, {}, True),
    "rank_4": ({"r": 4}, {}, True),
    "rank_5": ({"r": 5}, {}, True),
    "full": ({"q": "full"}, {}, False),
    "fbm_full": ({"q": "full", "kernel": "fbm"}, {}, False),
    "cv": ({}, {"param": "cv"}, False),
    "float64": ({"dtype": torch.float64}, {}, True),
    "y_requires_grad": ({}, {"y_grad": True}, True),
    "x_requires_grad": ({}, {"x_grad": True}, True),
    "batched": ({}, {"batched": True}, True),
    "cpu": ({}, {"cpu": True}, False),
}


@pytest.mark.parametrize("case", list(PREDICATE_CASES))
def test_g3_dispatch_rule(case, monkeypatch):
    """``MultitaskVariationalGP.elbo`` takes G3 for the tridiagonal family
    with the closed-form exp term on the card (``native.on_card``), and
    for nothing else: nothing falls back to the plain path there, and G3
    refuses a gradient wanted for the grid or the returns.  Evaluated
    without a card: the tensors count as the card's unless the case is
    the CPU; on the CPU ``elbo`` launches nothing."""
    model_kw, data_kw, takes = PREDICATE_CASES[case]
    dtype = model_kw.pop("dtype", torch.float32)
    rng = np.random.default_rng(0)
    n, t = 9, 3
    model = _model(rng, n, t, model_kw.pop("r", 1), dtype=dtype, **model_kw)
    lik = _likelihood(dtype, data_kw.get("param", "exp"))
    x = torch.tensor(np.arange(n) * DT, dtype=dtype)
    y = torch.tensor(0.2 * rng.standard_normal((n, t)), dtype=dtype)
    if data_kw.get("batched"):
        y = y.expand(2, n, t)
    x.requires_grad_(data_kw.get("x_grad", False))
    y.requires_grad_(data_kw.get("y_grad", False))
    if data_kw.get("cpu"):
        before = dict(native.launches)
        model.elbo(x, y, lik)
        assert dict(native.launches) == before
    else:
        monkeypatch.setattr(native, "on_card", lambda t: True)
    assert model._takes_g3(x, y, lik) is takes
    if data_kw.get("x_grad") or data_kw.get("y_grad"):
        with pytest.raises(ValueError, match="no gradient"):
            model.elbo(x, y, lik)

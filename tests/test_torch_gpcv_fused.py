"""Kernel G1 (``csrc/gpcv_elbo.cu``) on the CPU: its closed-form ELBO and
gradient, written here as the plain sequential recurrences it runs,
against autograd of ``GPCVModel.elbo`` in float64; and the rule by which
``GPCVModel.elbo`` takes it.  The kernel itself runs in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch import nn

from volt_tpu_torch import native
from volt_tpu_torch.models import GPCVModel

BATCH = (3, 2)
DT = 1.0 / 252
JITTER = 1e-6
CAPPED = (1, 0)  # the asset whose exponent passes the cap of 80


def g1_oracle(x, y, m, ld, e, c, vol):
    """G1's ELBO and gradients as ``csrc/gpcv_elbo.cu`` states them, by
    sequential recurrences over the rows of float64 arrays: ``x``, ``y``,
    ``m``, ``ld`` ``(b, n)``, ``e`` ``(b, n-1)``, ``c``, ``vol`` ``(b,)``.
    Returns the ELBO ``(b,)`` and the gradients with respect to ``m``,
    ``q_log_d``, ``q_e``, ``c`` and ``vol``."""
    b, n = y.shape
    volc = vol[:, None]
    d_inv = np.exp(-ld)
    a = d_inv ** 2
    r = np.zeros((b, n))
    r[:, :-1] = e * d_inv[:, :-1]
    jit = JITTER / vol
    raw = np.diff(x, axis=1, prepend=0.0)
    dx = np.maximum(raw, jit[:, None])
    share = np.where(jit[:, None] > raw, 1.0,
                     np.where(jit[:, None] == raw, 0.5, 0.0))
    inv = np.zeros((b, n + 1))
    inv[:, :n] = 1.0 / dx
    # the Takahashi band: var_j = 1/d_j^2 + r_j^2 var_{j+1}, from the end
    var = np.zeros((b, n + 1))
    for j in range(n - 1, -1, -1):
        var[:, j] = a[:, j] + r[:, j] ** 2 * var[:, j + 1]
    cov = -r * var[:, 1:]
    u = 2.0 * var[:, :n] - 2.0 * m
    w = np.exp(np.minimum(u, 80.0))
    yw = np.where(u <= 80.0, y * y * w, 0.0)
    ell = -0.5 * y * y * w - m - 0.5 * np.log(2.0 * np.pi)
    diff = np.concatenate([c[:, None] - m[:, :1], m[:, :-1] - m[:, 1:]], 1)
    tq = ((inv[:, :n] + inv[:, 1:]) * var[:, :n] - 2.0 * inv[:, 1:] * cov
          + diff ** 2 * inv[:, :n])
    g = (np.sum(ell - 0.5 * tq / volc - 0.5 * np.log(dx) - ld, axis=1)
         + 0.5 * n - 0.5 * n * np.log(vol))
    # the adjoint of the var recurrence, from the start
    gv = -yw - 0.5 * (inv[:, :n] + inv[:, 1:]) / volc
    lam = np.zeros((b, n))
    prev = np.zeros(b)
    for j in range(n):
        rp = r[:, j - 1] if j else np.zeros(b)
        prev = rp ** 2 * prev + gv[:, j] - rp * inv[:, j] / vol
        lam[:, j] = prev
    gr = var[:, 1:] * (2.0 * r * lam - inv[:, 1:] / volc)
    h = np.zeros((b, n + 1))
    h[:, :n] = diff * inv[:, :n] / volc
    before = np.zeros((b, n))
    before[:, 1:] = var[:, :n - 1] + 2.0 * r[:, :n - 1] * var[:, 1:n]
    dkl_ddx = 0.5 * (inv[:, :n] - inv[:, :n] ** 2
                     * (var[:, :n] + before + diff ** 2) / volc)
    grads = {
        "variational_mean": yw - 1.0 + h[:, :n] - h[:, 1:],
        "q_log_d": -2.0 * a * lam - r * gr - 1.0,
        "q_e": (gr * d_inv)[:, :n - 1],
        "c": -h[:, 0],
        "vol": (0.5 * (np.sum(tq, axis=1) / vol - n) / vol
                + jit / vol * np.sum(share * dkl_ddx, axis=1)),
        # the size of the vol gradient's terms, which cancel on a grid
        # from 0 (with n = 1 exactly: the floor's 1 / vol undoes the KL's)
        "vol_terms": (0.5 * (np.sum(np.abs(tq), axis=1) / vol + n) / vol
                      + jit / vol * np.sum(np.abs(share * dkl_ddx), axis=1)),
    }
    return g / n, {k: v / n for k, v in grads.items()}


def _model(rng, n, dtype=torch.float64, kernel="bm", param="exp",
           q="tridiag", ell_method=None):
    """A GPCV model with random parameters of batch ``BATCH``."""
    model = GPCVModel(kernel=kernel, param=param, q=q, ell_method=ell_method)
    model.kernel.init(BATCH, dtype)
    model.likelihood.init(BATCH, dtype, None,
                          torch.Generator().manual_seed(0))

    def param_(*shape, loc=0.0, scale=1.0):
        return nn.Parameter(torch.tensor(
            loc + scale * rng.standard_normal((*BATCH, *shape)), dtype=dtype))

    model.kernel.raw_vol = param_(1, loc=-1.4, scale=0.3)
    model.mean.constant = param_(1, loc=-1.5, scale=0.2)
    model.variational_mean = param_(n, loc=-1.5, scale=0.3)
    if q == "tridiag":
        model.q_log_d = param_(n, loc=2.0, scale=0.3)
        model.q_e = param_(n - 1, loc=-5.0, scale=1.0)
    else:
        model.chol_variational_covar = param_(n, n, scale=0.05)
    return model


def _grid(rng, n, kind):
    """The grid: shared ``(n,)`` or per asset, from 0 (the jitter floor
    taken at the first step) or from one step; the test moves a ``tie``
    grid's first point onto the floor ``1e-6 / vol``."""
    steps = np.arange(n, dtype=np.float64) * DT
    if kind == "shared_zero":
        return torch.tensor(steps)
    if kind == "shared_dt":
        return torch.tensor(steps + DT)
    dts = DT * (1.0 + 0.1 * rng.random(BATCH))[..., None]
    return torch.tensor(np.arange(n) * dts + (dts if kind == "per_asset_dt"
                                              else 0.0))


@pytest.mark.parametrize("kind", ["shared_zero", "shared_dt", "per_asset_zero",
                                  "per_asset_dt", "per_asset_tie"])
@pytest.mark.parametrize("n", [1, 2, 7, 999])
def test_g1_closed_form_equals_autograd_of_the_elbo(n, kind):
    """The oracle's ELBO and its gradient with respect to every parameter
    (``raw_vol`` through the sigmoid) equal ``GPCVModel.elbo`` and its
    autograd in float64, at rtol 1e-9 and atol 1e-9 of the largest value
    (for ``vol``, of the largest of its terms, which cancel on a grid from
    0), on a ``(3, 2)`` batch in which one asset's exponent ``2 var - 2 m``
    passes the cap of 80 over half its steps."""
    rng = np.random.default_rng(n)
    model = _model(rng, n)
    x = _grid(rng, n, kind)
    with torch.no_grad():
        model.variational_mean[CAPPED][::2] = -45.0
        if kind == "per_asset_tie":
            # vol 1/2 exactly, so 1e-6 / vol rounds alike however computed
            model.kernel.raw_vol.zero_()
            x[..., 1:] += 2.0 * JITTER
            x[..., 0] = 2.0 * JITTER
    y = torch.tensor(0.2 * rng.standard_normal((*BATCH, n)))
    assert not model._takes_g1(x, y)

    elbo = model.elbo(x, y)
    elbo.sum().backward()
    vol = model.kernel.vol().detach()
    rows = int(np.prod(BATCH))
    as_rows = lambda t: t.detach().expand(*BATCH, t.shape[-1]).reshape(
        rows, -1).numpy()
    got, grads = g1_oracle(
        as_rows(x), as_rows(y), as_rows(model.variational_mean),
        as_rows(model.q_log_d), as_rows(model.q_e),
        as_rows(model.mean.constant)[:, 0], as_rows(vol)[:, 0])
    u = 2.0 * (model.latent_marginals()[1] - model.variational_mean)
    assert (u[CAPPED] > 80.0).any() and (u <= 80.0).any()

    def close(name, want, have, scale=None):
        want = np.asarray(want).reshape(have.shape)
        scale = np.abs(want).max(initial=0.0) if scale is None else scale
        np.testing.assert_allclose(have, want, rtol=1e-9, atol=1e-9 * scale,
                                   err_msg=name)

    close("elbo", got, elbo.detach().numpy())
    close("variational_mean", grads["variational_mean"],
          model.variational_mean.grad.numpy())
    close("q_log_d", grads["q_log_d"], model.q_log_d.grad.numpy())
    close("q_e", grads["q_e"], model.q_e.grad.numpy())
    close("constant", grads["c"], model.mean.constant.grad.numpy())
    dsig = (vol * (1.0 - vol)).reshape(-1).numpy()
    close("raw_vol", grads["vol"] * dsig, model.kernel.raw_vol.grad.numpy(),
          np.max(grads["vol_terms"] * dsig))


# (what the model is, what the tensors are) -> whether elbo takes G1: on
# the card every call of the family goes to G1, whose wrapper raises on
# float64 (tests/test_torch_cuda.py) and on a gradient wanted for the grid
# or the returns (here)
PREDICATE_CASES = {
    "tridiag_bm_exp": ({}, {}, True),
    "analytic": ({"ell_method": "analytic"}, {}, True),
    "quadrature": ({"ell_method": "quadrature"}, {}, False),
    "cv": ({"param": "cv"}, {}, False),
    "full": ({"q": "full"}, {}, False),
    "fbm": ({"kernel": "fbm", "q": "full"}, {}, False),
    "float64": ({"dtype": torch.float64}, {}, True),
    "y_requires_grad": ({}, {"y_grad": True}, True),
    "x_requires_grad": ({}, {"x_grad": True}, True),
    "cpu": ({}, {"cpu": True}, False),
}


@pytest.mark.parametrize("case", list(PREDICATE_CASES))
def test_g1_dispatch_rule(case, monkeypatch):
    """``GPCVModel.elbo`` takes G1 for the tridiagonal family with the BM
    kernel and the closed-form exp term on the card (``native.on_card``),
    and for nothing else: nothing falls back to the plain path there, and
    G1 refuses a gradient wanted for the grid or the returns.  Evaluated
    without a card: the tensors count as the card's unless the case is
    the CPU; on the CPU ``elbo`` launches nothing."""
    model_kw, data_kw, takes = PREDICATE_CASES[case]
    dtype = model_kw.pop("dtype", torch.float32)
    rng = np.random.default_rng(0)
    n = 9
    model = _model(rng, n, dtype=dtype, **model_kw)
    x = _grid(rng, n, "shared_zero").to(dtype)
    y = torch.tensor(0.2 * rng.standard_normal((*BATCH, n)), dtype=dtype)
    x.requires_grad_(data_kw.get("x_grad", False))
    y.requires_grad_(data_kw.get("y_grad", False))
    if data_kw.get("cpu"):
        before = dict(native.launches)
        model.elbo(x, y)
        assert dict(native.launches) == before
    else:
        monkeypatch.setattr(native, "on_card", lambda t: True)
    assert model._takes_g1(x, y) is takes
    if data_kw.get("x_grad") or data_kw.get("y_grad"):
        with pytest.raises(ValueError, match="no gradient"):
            model.elbo(x, y)

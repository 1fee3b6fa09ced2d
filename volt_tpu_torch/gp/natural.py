"""Natural-gradient VI for the tridiagonal-precision GPCV family (port of
:mod:`volt_tpu.gp.natural`).

Per iteration, every piece O(n):

* precision ``Q <- (1 - rho) Q + rho (P + curv)``, ``P`` the BM prior
  precision and ``curv = max(-2 dELL/ds, 0)`` the expected curvature;
* mean ``m <- m + beta Q^{-1} (dELL/dm - P (m - mu0))`` by two bidiagonal
  solves;
* one Adam step (optax's, :class:`volt_tpu_torch.optim.Adam`) on the
  hyperparameters, holding q: the kernel vol and constant mean, through
  the KL alone for the exp likelihood (its ELL depends on no
  hyperparameter), and with the cv mixture's triplets through the whole
  ELBO for ``param="cv"``.

``(dELL/dm, dELL/ds)`` come from autograd through the expected
log-likelihood, so with ``ell_method="quadrature"`` they run kernel K3's
backward on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ..optim import Adam
from ..ops.bidiag import (bidiag_chol_from_tridiag, bidiag_solve_lower,
                          bidiag_solve_upper, min_precision, takahashi_band,
                          tridiag_q_kl_bm_prior)

__all__ = ["ngvi_tridiag_fit", "tridiag_matvec"]


def tridiag_matvec(diag, off, v):
    """``T v`` for symmetric tridiagonal ``T`` (main ``diag``, first
    ``off``)."""
    zero = torch.zeros_like(v[..., :1])
    upper = torch.cat([off * v[..., 1:], zero], dim=-1)
    lower = torch.cat([zero, off * v[..., :-1]], dim=-1)
    return diag * v + upper + lower


def ngvi_tridiag_fit(module, train_x, y, train_iters: int,
                     hyper_lr: float = 0.01, rho: float = 0.5,
                     beta: float = 1.0):
    """Fit a ``q="tridiag"`` :class:`~volt_tpu_torch.models.GPCVModel` (its
    parameters already initialised) by natural-gradient VI, in place.
    Returns the per-iteration negative ELBO ``(train_iters, *batch)``.

    ``rho`` damps the precision update, ``beta`` the mean step;
    ``hyper_lr`` is the Adam rate of the hyperparameters (kernel vol,
    constant mean, and the cv likelihood's triplets).
    """
    if module.q != "tridiag":
        raise ValueError("ngvi_tridiag_fit requires a q='tridiag' module")
    jitter = module._KL_JITTER
    n = y.shape[-1]
    # the exp ELL depends on no hyperparameter: the hyper step needs only
    # the KL's gradient; the cv mixture's triplets enter the ELL
    ell_depends_on_hypers = module.likelihood.param != "exp"
    hypers = [module.kernel.raw_vol, module.mean.constant,
              *module.likelihood.parameters()]
    opt = Adam(hypers, hyper_lr, train_iters)

    def ell_mean(m, s):
        return torch.mean(module.likelihood.expected_log_prob(
            y, m, s, num_locs=module.num_locs, method=module.ell_method),
            dim=-1)

    with torch.no_grad():
        d0, e = torch.exp(module.q_log_d), module.q_e.detach()
        # tridiagonal precision from its bidiagonal Cholesky:
        # (L L^T)_ii = d_i^2 + e_{i-1}^2, (L L^T)_{i+1,i} = d_i e_i
        q_diag = d0 * d0 + torch.cat([torch.zeros_like(d0[..., :1]), e * e],
                                     dim=-1)
        q_off = d0[..., :-1] * e
        m = module.variational_mean.detach().clone()
        d, e = bidiag_chol_from_tridiag(q_diag, q_off)
        s = takahashi_band(d, e)[0]

    losses = []
    for _ in range(train_iters):
        ms = [m.requires_grad_(), s.requires_grad_()]
        with torch.enable_grad():
            g_m, g_s = torch.autograd.grad((n * ell_mean(*ms)).sum(), ms)
        with torch.no_grad():
            vol = module.kernel.vol()[..., 0]
            p_diag, p_off, _ = min_precision(train_x, jitter / vol)
            p_diag, p_off = p_diag / vol[..., None], p_off / vol[..., None]
            curv = torch.clamp(-2.0 * g_s, min=0.0)
            q_diag = (1.0 - rho) * q_diag + rho * (p_diag + curv)
            q_off = (1.0 - rho) * q_off + rho * p_off
            grad_m = g_m - tridiag_matvec(p_diag, p_off,
                                          m.detach() - module.mean(train_x))
            d, e = bidiag_chol_from_tridiag(q_diag, q_off)
            m = m.detach() + beta * bidiag_solve_upper(
                d, e, bidiag_solve_lower(d, e, grad_m))
            s = takahashi_band(d, e)[0]
        opt.zero_grad()
        kl = tridiag_q_kl_bm_prior(train_x, module.kernel.vol(), m, d, e,
                                   module.mean(train_x), jitter=jitter)
        if ell_depends_on_hypers:
            loss = kl / n - ell_mean(m, s)
            loss.sum().backward()
            losses.append(loss.detach())
        else:
            (kl.sum() / n).backward()
            with torch.no_grad():
                losses.append(kl.detach() / n - ell_mean(m, s))
        opt.step()

    module.variational_mean = nn.Parameter(m.detach())
    module.q_log_d = nn.Parameter(torch.log(d))
    module.q_e = nn.Parameter(e)
    return torch.stack(losses)

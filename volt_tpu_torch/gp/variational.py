"""The unwhitened variational GP strategy, the GPCV inference engine (port
of :mod:`volt_tpu.gp.variational`).

With inducing == train == query points the training-time posterior is
``q(u) = N(m, L L^T)`` itself, so the ELBO is the expected log-likelihood
of its marginals less ``KL(q || p)``; :func:`variational_predict` gives
the posterior at other points.  :func:`laplace_initialize` is the
reference's Laplace-style start: ``S = L (L^T H^{-1} L + I)^{-1} L^T``
(``L = chol(Kuu)``), root inflated by 10.

The dense products and triangular solves are ``torch.matmul`` and
``torch.linalg`` calls, in float32 on the card only while TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32``, False by default), as the JAX
package asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.chol import (add_jitter, cholesky_solve, psd_safe_cholesky,
                        solve_lower_triangular)
from ..ops.mvn import mvn_kl
from ..utils.profiling import annotate

__all__ = [
    "VariationalState",
    "elbo_at_inducing",
    "elbo_at_inducing_whitened",
    "variational_predict",
    "variational_predict_whitened",
    "laplace_initialize",
    "running_std_latent_init",
    "exp_laplace_inv_hessian",
]


class VariationalState(NamedTuple):
    """The variational parameters: mean ``(..., n)`` and a raw Cholesky
    root ``(..., n, n)``, of which the lower triangle is used."""

    variational_mean: torch.Tensor
    chol_variational_covar: torch.Tensor


def elbo_at_inducing(state: VariationalState, prior_mean, kuu, y,
                     expected_log_prob_fn, num_data=None, beta: float = 1.0,
                     chol_jitter: float | None = None,
                     chol_max_tries: int = 3, chol_p=None):
    """``mean_i E_q[log p(y_i | f_i)] - beta KL(q || p) / num_data`` with
    inducing == train == query points.  ``expected_log_prob_fn(y, mean,
    var)`` is per datum; ``chol_p`` optionally gives the factor of
    ``kuu``, otherwise the jitter ladder makes it.  The dense KL is a
    ``dense_kl`` span."""
    if num_data is None:
        num_data = y.shape[-1]
    chol_q = torch.tril(state.chol_variational_covar)
    marg_var = torch.sum(chol_q * chol_q, dim=-1)
    ell = expected_log_prob_fn(y, state.variational_mean, marg_var)
    if chol_p is None:
        chol_p = psd_safe_cholesky(kuu, jitter=chol_jitter,
                                   max_tries=chol_max_tries)
    with annotate("dense_kl"):
        kl = mvn_kl(state.variational_mean, chol_q, prior_mean, chol_p)
    return torch.mean(ell, dim=-1) - kl * beta / num_data


def variational_predict(state: VariationalState, prior_mean_u, kuu, kux,
                        prior_mean_x, kxx_diag=None, kxx=None, chol_kuu=None):
    """The unwhitened predictive at points ``x``:
    ``mean = Kxu Kuu^{-1} (m - mu_u) + mu_x``,
    ``cov = Kxx - Kxu Kuu^{-1} (Kuu - S) Kuu^{-1} Kux``.
    ``kxx`` gives the full covariance, ``kxx_diag`` the marginals only.
    Returns ``(mean, var_or_cov)``."""
    chol = chol_kuu if chol_kuu is not None else psd_safe_cholesky(kuu)
    kuu_inv_kux = cholesky_solve(chol, kux)  # (..., n_u, n_x)
    diff = (state.variational_mean - prior_mean_u)[..., None]
    mean = (kuu_inv_kux.mT @ diff)[..., 0] + prior_mean_x
    chol_q = torch.tril(state.chol_variational_covar)
    half = chol_q.mT @ kuu_inv_kux  # S Kuu^{-1} Kux through the root
    if kxx is not None:
        return mean, kxx - kux.mT @ kuu_inv_kux + half.mT @ half
    if kxx_diag is None:
        raise ValueError("pass kxx or kxx_diag")
    data_term = torch.sum(kux * kuu_inv_kux, dim=-2)
    s_term = torch.sum(half * half, dim=-2)
    return mean, kxx_diag - data_term + s_term


def elbo_at_inducing_whitened(state: VariationalState, prior_mean, kuu, y,
                              expected_log_prob_fn, num_data=None,
                              beta: float = 1.0):
    """The whitened strategy's ELBO (``f = mu + L_K u'``, ``u' ~ q``):
    marginals ``mu + L_K m`` and ``row_i(L_K S L_K^T)``, KL against the
    standard normal."""
    n = y.shape[-1]
    if num_data is None:
        num_data = n
    chol_q = torch.tril(state.chol_variational_covar)
    chol_k = psd_safe_cholesky(kuu)
    mean = prior_mean + (chol_k @ state.variational_mean[..., None])[..., 0]
    half = chol_k @ chol_q
    ell = expected_log_prob_fn(y, mean, torch.sum(half * half, dim=-1))
    eye = torch.eye(n, dtype=kuu.dtype, device=kuu.device).expand(
        chol_q.shape)
    kl = mvn_kl(state.variational_mean, chol_q,
                torch.zeros_like(state.variational_mean), eye)
    return torch.mean(ell, dim=-1) - kl * beta / num_data


def variational_predict_whitened(state: VariationalState, kuu, kux,
                                 prior_mean_x, kxx_diag=None, kxx=None):
    """The whitened predictive: ``mean = Kxu L_K^{-T} m + mu_x``,
    ``cov = Kxx - Kxu Kuu^{-1} Kux + (Kxu L_K^{-T}) S (L_K^{-1} Kux)``."""
    chol_k = psd_safe_cholesky(kuu)
    interp = solve_lower_triangular(chol_k, kux)  # (..., n_u, n_x)
    mean = (interp.mT @ state.variational_mean[..., None])[..., 0] \
        + prior_mean_x
    chol_q = torch.tril(state.chol_variational_covar)
    half = chol_q.mT @ interp
    if kxx is not None:
        return mean, kxx - interp.mT @ interp + half.mT @ half
    if kxx_diag is None:
        raise ValueError("pass kxx or kxx_diag")
    data_term = torch.sum(interp * interp, dim=-2)
    s_term = torch.sum(half * half, dim=-2)
    return mean, kxx_diag - data_term + s_term


def running_std_latent_init(y, clamp_min: float = 1e-4):
    """``rs[i] = std(y[:i], ddof=1)`` with the first 10 entries pinned to
    ``rs[10]``; returns ``(f, rs)`` with ``f = log(clamp(rs, 1e-4))``."""
    n = y.shape[-1]
    if n <= 10:
        raise ValueError(
            f"running-std init needs at least 11 points (the first 10 "
            f"entries are pinned to the 11th), got n={n}")
    zeros = torch.zeros_like(y[..., :1])
    s1 = torch.cat([zeros, torch.cumsum(y, dim=-1)[..., :-1]], dim=-1)
    s2 = torch.cat([zeros, torch.cumsum(y * y, dim=-1)[..., :-1]], dim=-1)
    counts = torch.arange(n, dtype=y.dtype, device=y.device)
    var = (s2 - s1 * s1 / torch.clamp(counts, min=1.0)) / torch.clamp(
        counts - 1.0, min=1.0)
    rs = torch.sqrt(torch.clamp(var, min=0.0))
    rs = torch.where(counts < 10, rs[..., 10:11], rs)
    return torch.log(torch.clamp(rs, min=clamp_min)), rs


def exp_laplace_inv_hessian(y, f):
    """``clamp(0.5 y^-2 exp(2 f), 1e-4, 1e3)``: the exp-parameterisation
    Laplace curvature inverse."""
    return torch.clamp(0.5 * y ** -2.0 * torch.exp(2.0 * f), min=1e-4,
                       max=1000.0)


def laplace_initialize(kuu, y, f=None, root_scale: float = 10.0,
                       inv_hess=None, chol_kuu=None,
                       exp_hessian: str = "reference",
                       per_lane: bool = False):
    """The reference's Laplace-style variational init.

    ``f`` from the running-std heuristic unless given; ``S = L (L^T H^{-1}
    L + I)^{-1} L^T`` with ``L = chol(Kuu)`` (or ``chol_kuu``); the stored
    root ``tril(chol(S)) * root_scale``.  ``inv_hess`` gives ``H^{-1}``'s
    diagonal (the cv init's); otherwise the exp form, and with
    ``exp_hessian="reference"`` the reference's clamp after
    ``diag_embed``, which raises the off-diagonal zeros to 1e-4: the dense
    ``diag(clamp(.)) + 1e-4 (11^T - I)``; ``"diag"`` the plain diagonal.
    ``per_lane`` runs each Cholesky's jitter ladder per matrix (the
    batched pipeline, one asset a lane).  Returns ``(VariationalState,
    mean_constant)``, the constant ``log(mean(rs))`` when ``f`` was not
    given, else ``None``."""
    mean_const = None
    if f is None:
        f, rs = running_std_latent_init(y)
        mean_const = torch.log(torch.mean(rs, dim=-1))
    dense_m = None
    if inv_hess is None:
        inv_hess = exp_laplace_inv_hessian(y, f)
        if exp_hessian == "reference":
            n = inv_hess.shape[-1]
            eye = torch.eye(n, dtype=torch.bool, device=inv_hess.device)
            dense_m = torch.where(eye, inv_hess[..., :, None],
                                  torch.tensor(1e-4, dtype=inv_hess.dtype,
                                               device=inv_hess.device))
        elif exp_hessian != "diag":
            raise ValueError("exp_hessian must be 'reference' or 'diag'")

    def chol(a):
        return psd_safe_cholesky(a, per_lane=per_lane)

    if chol_kuu is None:
        chol_kuu = chol(kuu)
    if dense_m is not None:
        inner = chol_kuu.mT @ (dense_m @ chol_kuu)
    else:
        inner = (chol_kuu.mT * inv_hess[..., None, :]) @ chol_kuu
    inner = add_jitter(inner, 1.0)
    s = chol_kuu @ cholesky_solve(chol(inner), chol_kuu.mT)
    s_root = torch.tril(chol(s)) * root_scale
    return VariationalState(f, s_root), mean_const

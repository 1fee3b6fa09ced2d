"""Likelihoods of the slice (port of :mod:`volt_tpu.likelihoods.likelihoods`)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.constraints import GreaterThan, Interval, Positive, softplus
from ..ops.gh_ell import exp_log_prob, exp_scale, gh_expected_log_prob
from ..ops.quadrature import DEFAULT_NUM_LOCS, expected_value

__all__ = ["GaussianLikelihood", "MultitaskGaussianLikelihood",
           "VolatilityGaussianLikelihood"]

_LOG_2PI = math.log(2.0 * math.pi)


class GaussianLikelihood(nn.Module):
    """Homoskedastic Gaussian noise, ``noise = softplus(raw_noise) + 1e-4``;
    parameter ``raw_noise`` ``(*batch, 1)``."""

    def __init__(self, noise_constraint=None):
        super().__init__()
        self.constraint = noise_constraint or GreaterThan(1e-4)

    def init(self, batch_shape=(), dtype=torch.float32, device=None,
             raw_noise_init: float = 0.0):
        self.raw_noise = nn.Parameter(torch.full(
            (*batch_shape, 1), raw_noise_init, dtype=dtype, device=device))
        return self

    def init_with_noise(self, noise: float, batch_shape=(),
                        dtype=torch.float32, device=None):
        """Init from a transformed noise value (the working setter)."""
        raw = self.constraint.inverse(torch.tensor(noise, dtype=dtype))
        return self.init(batch_shape, dtype, device, raw.item())

    def noise(self):
        return self.constraint.forward(self.raw_noise)

    def marginal_covariance(self, cov):
        """``K + noise I`` over the trailing two dims."""
        noise = self.noise()[..., 0]
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        return cov + noise[..., None, None] * eye

    def log_prob(self, y, f):
        """The elementwise Gaussian log density of ``y`` about ``f``."""
        noise = self.noise()
        return -0.5 * ((y - f) ** 2 / noise + torch.log(noise) + _LOG_2PI)


class MultitaskGaussianLikelihood(GaussianLikelihood):
    """One noise shared by ``num_tasks`` outputs (the reference sets it to
    1e-3 through the working setter, ``models/VoltronGP.py:47-48``)."""

    def __init__(self, num_tasks: int, noise_constraint=None):
        super().__init__(noise_constraint)
        self.num_tasks = num_tasks


class VolatilityGaussianLikelihood(nn.Module):
    """Heteroscedastic volatility observations ``y ~ N(0, scale(f)^2)``.

    ``"cv"`` (Wilson & Ghahramani's copula-process form, the default):
    ``scale = sum_k a_k softplus(b_k f + c_k)`` over ``K`` triplets, ``a``
    under ``Positive``, ``b`` under ``Interval(0, 3)``, ``c`` under
    ``Interval(-3, 3)``; parameters ``raw_a``, ``raw_b``, ``raw_c``
    ``(*batch, K)`` after :meth:`init`.  ``"exp"``: ``scale = exp(min(f,
    80))``, no parameters.  Both clamp the scale at 1e-3.

    Shapes: ``f`` carries a trailing data axis ``(*batch, n)`` (and any
    leading node axes); the cv triplets broadcast against its batch dims.
    """

    def __init__(self, K: int = 5, batch_shape: tuple = (),
                 param: str = "cv"):
        super().__init__()
        if param not in ("cv", "exp"):
            raise ValueError("param must be 'cv' or 'exp'")
        self.K = K
        self.batch_shape = tuple(batch_shape)
        self.param = param
        self.a_constraint = Positive()
        self.b_constraint = Interval(0.0, 3.0)
        self.c_constraint = Interval(-3.0, 3.0)

    def init(self, batch_shape=None, dtype=torch.float32, device=None,
             generator=None):
        """The cv triplets' random uniform init (``raw_b`` scaled by 0.1),
        drawn from ``generator`` on its device (default: a CPU generator
        seeded 0, so that the values do not depend on the device).
        Nothing for ``"exp"``."""
        if self.param == "exp":
            return self
        batch = self.batch_shape if batch_shape is None else tuple(batch_shape)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        shape = (*batch, self.K)
        draws = [torch.rand(shape, dtype=dtype, generator=generator,
                            device=generator.device) for _ in range(3)]
        for name, d, scale in zip(("raw_a", "raw_b", "raw_c"), draws,
                                  (1.0, 0.1, 1.0)):
            setattr(self, name, nn.Parameter((scale * d).to(device)))
        return self

    def trans_a(self):
        return self.a_constraint.forward(self.raw_a)

    def trans_b(self):
        return self.b_constraint.forward(self.raw_b)

    def trans_c(self):
        return self.c_constraint.forward(self.raw_c)

    def _mixture_args(self, f):
        """``b_k f + c_k`` ``(..., n, K)`` with the triplets ``(*batch, 1,
        K)``."""
        return (self.trans_b()[..., None, :] * f[..., None]
                + self.trans_c()[..., None, :])

    def scale(self, f):
        """Observation std; the exp form caps ``f`` at 80 so GH tail nodes
        of a wide ``q`` cannot overflow ``exp``."""
        if self.param == "exp":
            return exp_scale(f)
        t = softplus(self._mixture_args(f)) * self.trans_a()[..., None, :]
        return torch.clamp(torch.sum(t, dim=-1), min=1e-3)

    def log_prob(self, y, f):
        """``log N(y; 0, scale(f)^2)`` elementwise."""
        if self.param == "exp":
            return exp_log_prob(y, f)
        s = self.scale(f)
        return -0.5 * (y / s) ** 2 - torch.log(s) - 0.5 * _LOG_2PI

    def latent_from_scale(self, target_scale, newton_iters: int = 30):
        """Solve ``scale(f) = target`` for ``f`` elementwise (``target``
        clamped at 1e-3): ``log`` for ``"exp"``; for ``"cv"``, whose
        mixture is strictly increasing in ``f``, ``newton_iters`` damped
        Newton steps from 0, each step clipped to [-5, 5]."""
        target = torch.clamp(target_scale, min=1e-3)
        if self.param == "exp":
            return torch.log(target)
        a = self.trans_a()[..., None, :]
        b = self.trans_b()[..., None, :]
        f = torch.zeros_like(target)
        for _ in range(newton_iters):
            # ds/df = sum_k a_k b_k sigmoid(b_k f + c_k) > 0
            ds = torch.sum(a * b * torch.sigmoid(self._mixture_args(f)),
                           dim=-1)
            step = (self.scale(f) - target) / torch.clamp(ds, min=1e-8)
            f = f - torch.clamp(step, min=-5.0, max=5.0)
        return f

    def neg_log_prob_hessian(self, y, f):
        """Exact per-datum ``-d^2 log p(y | f) / df^2``, by autodiff:
        ``torch.func.grad`` twice under ``torch.func.vmap`` over the data.
        (The reference hand-derived the cv curvature and got it wrong.)"""
        f, y = torch.broadcast_tensors(f, y)
        shape = f.shape
        raws = [] if self.param == "exp" else [
            t[..., None, :].expand(*shape, self.K).reshape(-1, self.K)
            for t in (self.raw_a, self.raw_b, self.raw_c)]
        lik = self

        def nlp(ff, yy, *raw):
            if raw:  # one datum's cv scale from its own triplets
                ra, rb, rc = raw
                s = torch.sum(softplus(lik.b_constraint.forward(rb) * ff
                                       + lik.c_constraint.forward(rc))
                              * lik.a_constraint.forward(ra))
                s = torch.clamp(s, min=1e-3)
            else:
                s = exp_scale(ff)
            return 0.5 * (yy / s) ** 2 + torch.log(s)

        hess = torch.func.vmap(torch.func.grad(torch.func.grad(nlp)))
        return hess(f.reshape(-1), y.reshape(-1), *raws).reshape(shape)

    def laplace_inv_hessian(self, y, f):
        """The Laplace init's clamped inverse curvature: the Hessian
        floored at 1e-3, its inverse clipped to [1e-4, 1e3]."""
        hess = self.neg_log_prob_hessian(y, f)
        return torch.clamp(1.0 / torch.clamp(hess, min=1e-3), min=1e-4,
                           max=1000.0)

    def expected_log_prob(self, y, mean, var,
                          num_locs: int = DEFAULT_NUM_LOCS,
                          method: str | None = None):
        """``E_{f ~ N(mean, var)}[log p(y | f)]``.

        ``method=None`` is the closed form for ``"exp"`` and the
        ``num_locs``-node Gauss–Hermite sum for ``"cv"``, which has no
        closed form.  ``"analytic"`` (exp only): the lognormal moments
        ``-y^2/2 e^{-2 mean + 2 var} - mean - log(2 pi)/2``, the exponent
        capped at 80.  ``"quadrature"``: the reference's GH term, for
        ``"exp"`` by kernel K3 on CUDA tensors, for ``"cv"`` the plain
        node sum (as the JAX package computes it, outside any kernel).
        The two exp forms differ below float32 resolution outside the
        clamp regions (``scale >= 1e-3``, ``f <= 80``)."""
        if method is None:
            method = "analytic" if self.param == "exp" else "quadrature"
        if method == "analytic":
            if self.param != "exp":
                raise ValueError("analytic expected_log_prob exists only "
                                 "for param='exp'")
            e = torch.exp(torch.clamp(-2.0 * mean + 2.0 * var, max=80.0))
            return -0.5 * y * y * e - mean - 0.5 * _LOG_2PI
        if method == "quadrature":
            if self.param == "exp":
                return gh_expected_log_prob(y, mean, var, num_locs)
            return expected_value(lambda f: self.log_prob(y, f), mean, var,
                                  num_locs)
        raise ValueError("method must be None, 'analytic' or 'quadrature'")

    def expected_scale(self, mean, var, mc_samples: int | None = None,
                       generator=None, noise=None):
        """Posterior-mean predicted scale ``E_f[scale(f)]``: 75-node
        Gauss–Hermite, or with ``mc_samples`` the reference's Monte-Carlo
        estimate from ``(mc_samples, *mean.shape)`` standard normals
        (``noise``, else drawn from ``generator``)."""
        if mc_samples is None:
            return expected_value(self.scale, mean, var)
        if noise is None:
            noise = torch.randn(mc_samples, *mean.shape, dtype=mean.dtype,
                                device=mean.device, generator=generator)
        return torch.mean(self.scale(noise * torch.sqrt(var) + mean), dim=0)

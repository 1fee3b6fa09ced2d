"""Kronecker multitask models: correlated assets or stations (port of
:mod:`volt_tpu.models.multitask`).

* :class:`MultitaskBMGP`: the exact multitask GP over log-vol paths,
  ``K = BM(x) (x) IndexKernel``, with the per-task Itô drift scaled by the
  task covariance's diagonal;
* :class:`MultitaskVariationalGP`: the Kronecker variational GP of the
  multitask GPCV stage, ``q(vec(U)) = N(vec(M), Sx (x) St)``.

Data are laid out ``(N, T)`` (points, tasks) as in the JAX package; the
``NT x NT`` covariance is never built for training
(:mod:`..gp.kronecker`).  Parameters are held by the modules under the
JAX leaf names (``data_kernel.raw_vol``, ``task_kernel.covar_factor``,
``variational_mean``, ...), so :func:`..convert.load_jax_params` carries a
JAX pytree across.  Randomness comes from a ``torch.Generator`` or from
the standard normals passed as ``noise``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import native
from ..gp.kronecker import (kron_kl, kron_kl_bm_prior,
                            kron_kl_bm_prior_tridiag, kron_mvn_log_prob,
                            kron_mvn_log_prob_blockdiag_lowrank,
                            kron_posterior)
from ..gp.variational import exp_laplace_inv_hessian, running_std_latent_init
from ..kernels import BMKernel, FBMKernel, IndexKernel
from ..likelihoods import (MultitaskGaussianLikelihood,
                           VolatilityGaussianLikelihood)
from ..ops.bidiag import (bidiag_chol_from_tridiag, bidiag_solve_lower,
                          min_precision, takahashi_band)
from ..ops.brownian import (future_grid_ok, min_kernel_eigenvalues,
                            min_kernel_project, nan_poison)
from ..ops.chol import cholesky_solve, psd_safe_cholesky
from ..ops.mt_gpcv_elbo import mt_tridiag_elbo
from ..ops.mt_vol_mll import mt_vol_mll
from ..ops.mvn import sample_mvn
from ..utils.profiling import annotate

__all__ = ["MultitaskBMGP", "MultitaskBMGPState", "MultitaskVariationalGP"]


@dataclasses.dataclass
class MultitaskBMGPState:
    """A fitted multitask vol GP (holding its parameters) and its data:
    ``train_x (N,)``, ``train_y (N, T)`` log vols."""

    module: "MultitaskBMGP"
    train_x: torch.Tensor
    train_y: torch.Tensor

    def mll(self):
        return self.module.mll(self.train_x, self.train_y)

    def posterior(self, test_x):
        return self.module.posterior(self.train_x, self.train_y, test_x)

    def sample(self, test_x, sample_shape=(), generator=None, noise=None):
        """Joint posterior samples ``(*sample_shape, M, T)`` through the
        ``(M T, M T)`` covariance; ``noise``: its standard normals
        ``(*sample_shape, M T)``."""
        mean, cov = self.posterior(test_x)
        m, t = mean.shape[-2], mean.shape[-1]
        flat = sample_mvn(mean.reshape(*mean.shape[:-2], m * t), cov,
                          sample_shape, generator=generator, noise=noise)
        return flat.reshape(*flat.shape[:-1], m, t)

    def sample_forecast(self, test_x, nsample: int, generator=None,
                        noise=None):
        return self.module.sample_forecast(self.train_x, self.train_y,
                                           test_x, nsample, generator, noise)


class MultitaskBMGP(nn.Module):
    """The exact Kronecker multitask GP over log vol.  Parameters (after
    :meth:`init`): ``data_kernel.raw_vol (1,)``,
    ``task_kernel.covar_factor (T, rank)``, ``task_kernel.raw_var (T,)``,
    ``likelihood.raw_noise (1,)``."""

    def __init__(self, num_tasks: int, kernel: str = "bm", rank: int = 1):
        super().__init__()
        self.num_tasks = num_tasks
        self.data_kernel = BMKernel() if kernel == "bm" else FBMKernel()
        self.task_kernel = IndexKernel(num_tasks, rank)
        self.likelihood = MultitaskGaussianLikelihood(num_tasks)

    def init(self, dtype=torch.float32, device=None, generator=None,
             noise: float = 1e-3):
        """The task factor drawn from ``generator`` and shrunk by 10 (the
        reference's ``BMGP.py:38-40``); the noise at 1e-3 through the
        working setter (``VoltronGP.py:48``)."""
        self.data_kernel.init((), dtype, device)
        self.task_kernel.init(dtype, device, generator)
        with torch.no_grad():
            self.task_kernel.covar_factor /= 10.0
        self.likelihood.init_with_noise(noise, (), dtype, device)
        return self

    def task_covar(self):
        return self.task_kernel.covar_matrix()

    def _noise(self):
        return self.likelihood.noise()[..., 0]

    def mean(self, x):
        """Per-task drift ``-0.5 vol^2 x diag(B)``, ``(N, T)``."""
        base = -0.5 * self.data_kernel.vol() ** 2.0 * x  # (N,)
        diag = torch.diagonal(self.task_covar(), dim1=-2, dim2=-1)
        return base[..., :, None] * diag[..., None, :]

    def mll(self, x, y):
        """Exact multitask MLL / (N T), through one ``eigh`` of each
        factor (any grid, either data kernel)."""
        lp = kron_mvn_log_prob(y, self.mean(x), self.data_kernel(x),
                               self.task_covar(), self._noise())
        return lp / (y.shape[-2] * y.shape[-1])

    def spectral_cache(self, x, y):
        """The closed-form data-side eigenbasis of ``min(x)`` on an
        equispaced grid (as ``BMGP.spectral_cache``), with ``y (N, T)``
        and ``x`` projected onto it once per fit; BM data kernel only."""
        if not isinstance(self.data_kernel, BMKernel):
            raise ValueError("spectral_cache/mll_spectral require the BM "
                             "data kernel; use mll for FBM")
        n = x.shape[-1]
        return {"mu": min_kernel_eigenvalues(n, x.dtype, x.device),
                "dx": x[..., 1] - x[..., 0], "x0": x[..., 0],
                "p_y": min_kernel_project(y, axis=-2),
                "p_x": min_kernel_project(x),
                "w": min_kernel_project(torch.ones(n, dtype=x.dtype,
                                                   device=x.device))}

    def mll_spectral(self, cache, n: int, t: int):
        """Exact multitask MLL / (N T) with no factor of the data kernel
        and, through ``B = F F^T + diag(v)``, no ``T x T`` factor of the
        blocks (``kron_mvn_log_prob_blockdiag_lowrank``).  Kernel G4 on the
        card (one call for the MLL and its gradient, one LU and no wait for
        the card; it raises on a batch, a task factor of rank above 4 and
        float64), the plain composition on the CPU."""
        vol = self.data_kernel.vol()
        factor, task_diag = self.task_kernel.factor_and_diag()
        noise = self.likelihood.noise()
        if native.on_card(cache["p_y"]):
            with annotate("woodbury"):
                return mt_vol_mll(cache["p_y"], cache["p_x"], cache["mu"],
                                  cache["w"], cache["dx"], cache["x0"], vol,
                                  factor, task_diag, noise)
        vol = vol[..., 0]
        diag_b = torch.sum(factor * factor, dim=-1) + task_diag
        # U^T mean = (-0.5 vol^2 p_x) outer diag(B)
        r_tilde = cache["p_y"] + (0.5 * vol ** 2.0 * cache["p_x"])[
            ..., :, None] * diag_b[..., None, :]
        ld = vol * cache["dx"] * cache["mu"]
        c = vol * (cache["x0"] - cache["dx"])
        with annotate("woodbury"):
            lp = kron_mvn_log_prob_blockdiag_lowrank(
                r_tilde, ld, c, factor, task_diag, noise[..., 0], cache["w"])
        return lp / (n * t)

    def posterior(self, train_x, train_y, test_x):
        """``(mean (M, T), cov (M T, M T))`` at ``test_x``."""
        k = self.data_kernel
        mean, cov = kron_posterior(k(train_x), k(train_x, test_x), k(test_x),
                                   self.task_covar(),
                                   train_y - self.mean(train_x),
                                   self._noise())
        return mean + self.mean(test_x), cov

    def sample_forecast(self, train_x, train_y, test_x, nsample: int,
                        generator=None, noise=None):
        """``(nsample, M, T)`` joint posterior samples at strictly-future
        ``test_x`` by Matheron's rule, with no ``(M T, M T)`` covariance:

            ``f* = prior*(w) + K_*^T (K + s I)^{-1} (y - prior(w) - eps)``

        with one joint prior draw over ``[train; test]`` (a BM path, the
        cumsum of scaled normals, times ``L_t^T``) and ``eps ~ N(0, s I)``.
        The solve diagonalises in the factors' ``eigh`` bases (one ``N x
        N`` ``eigh`` a call), and on a future grid the cross-covariance is
        rank one in the data dimension, so the correction is one ``(T,)``
        vector a sample.  ``noise``: ``(z (S, N+M, T), eps (S, N, T))``
        standard normals, else drawn from ``generator``.  Grids that break
        the contract come back all-NaN; BM data kernel only."""
        if not isinstance(self.data_kernel, BMKernel):
            raise ValueError("sample_forecast requires the BM data kernel; "
                             "use MultitaskBMGPState.sample for FBM")
        vol = self.data_kernel.vol()[..., 0]
        k_task = self.task_covar()
        s2 = self._noise()
        n, m, t = train_x.shape[-1], test_x.shape[-1], self.num_tasks
        if noise is None:
            kw = dict(dtype=train_y.dtype, device=train_y.device,
                      generator=generator)
            z = torch.randn(nsample, n + m, t, **kw)
            eps_z = torch.randn(nsample, n, t, **kw)
        else:
            z, eps_z = noise
        with annotate("prior_draw"):
            lt_root = psd_safe_cholesky(k_task)
            joint_x = torch.cat([train_x, test_x], dim=-1)
            dx = torch.diff(joint_x, dim=-1,
                            prepend=torch.zeros_like(joint_x[..., :1]))
            sd = torch.sqrt(torch.clamp(vol * dx, min=0.0))  # (N+M,)
            w_paths = torch.cumsum(sd[:, None] * z, dim=-2) @ lt_root.mT
        # the Kronecker solve in the factors' eigenbases
        with annotate("eigh"), annotate("sync:eigh"):
            lam, qd = torch.linalg.eigh(torch.minimum(train_x[:, None],
                                                      train_x[None, :]))
            lt, qt = torch.linalg.eigh(k_task)
        with annotate("kron_solve"):
            u = (train_y - self.mean(train_x)) - w_paths[..., :n, :] \
                - torch.sqrt(s2) * eps_z
            ld = vol * torch.clamp(lam, min=0.0)
            denom = ld[:, None] * torch.clamp(lt, min=0.0)[None, :] + s2
            rot = (qd.mT @ (u @ qt)) / denom
            # rank-one cross block: vol (x^T alpha) K_t per sample
            xa = ((train_x @ qd) @ rot) @ qt.mT  # (S, T)
            corr = vol * (xa @ k_task)
        ok = future_grid_ok(test_x, train_x)
        return nan_poison(self.mean(test_x) + w_paths[..., n:, :]
                          + corr[..., None, :], ok[..., None, None])

    def fit_state(self, train_x, train_y) -> MultitaskBMGPState:
        return MultitaskBMGPState(module=self, train_x=train_x,
                                  train_y=train_y)


class MultitaskVariationalGP(nn.Module):
    """The Kronecker variational GP (multitask GPCV engine), inducing
    points at the train inputs.  ``q`` selects the data factor: ``"full"``
    an explicit lower root ``variational_covar_root (N, N)``, the
    reference's; ``"tridiag"`` a tridiagonal precision with bidiagonal
    Cholesky ``(exp(q_log_d), q_e)``, O(N) parameters, BM kernel only.
    The task root ``variational_task_covar_root (T, T)`` stays dense.
    Parameters also: ``data_kernel.raw_vol (1,)``,
    ``index_kernel.{covar_factor, raw_var}``, ``mean_constants (T,)``,
    ``variational_mean (N, T)``."""

    def __init__(self, num_tasks: int, rank: int = 1, kernel: str = "bm",
                 q: str = "full"):
        super().__init__()
        if q not in ("full", "tridiag"):
            raise ValueError("q must be 'full' or 'tridiag'")
        if q == "tridiag" and kernel != "bm":
            raise ValueError("q='tridiag' requires the BM kernel")
        self.num_tasks = num_tasks
        self.data_kernel = BMKernel() if kernel == "bm" else FBMKernel()
        self.index_kernel = IndexKernel(num_tasks, rank)
        self.q = q

    def init(self, train_x, dtype=torch.float32, generator=None):
        """The task factor and ``0.01 N(0, 1)`` variational mean from
        ``generator`` (default: a CPU generator seeded 0); identity roots (``q_log_d = 0``, ``q_e = 0`` for
        ``"tridiag"``); zero mean constants."""
        n, t = train_x.shape[-1], self.num_tasks
        device = train_x.device
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.data_kernel.init((), dtype, device)
        self.index_kernel.init(dtype, device, generator)
        self.mean_constants = nn.Parameter(torch.zeros(t, dtype=dtype,
                                                       device=device))
        self.variational_mean = nn.Parameter(0.01 * torch.randn(
            n, t, dtype=dtype, generator=generator,
            device=generator.device).to(device))
        self.variational_task_covar_root = nn.Parameter(
            torch.eye(t, dtype=dtype, device=device))
        if self.q == "tridiag":
            self.q_log_d = nn.Parameter(torch.zeros(n, dtype=dtype,
                                                    device=device))
            self.q_e = nn.Parameter(torch.zeros(n - 1, dtype=dtype,
                                                device=device))
        else:
            self.variational_covar_root = nn.Parameter(
                torch.eye(n, dtype=dtype, device=device))
        return self

    def _q_chol(self):
        return torch.exp(self.q_log_d), self.q_e

    def _data_chol(self, x):
        """The FBM data prior's increment-domain factor, or ``None``."""
        if isinstance(self.data_kernel, FBMKernel):
            return self.data_kernel.prior_cholesky(x)
        return None

    @torch.no_grad()
    def initialize_variational_parameters(self, likelihood, x, y):
        """The reference's Laplace-style init (``:38-91``), in place:
        per-task running-std latent, task-averaged inverse curvature
        (exp: the closed form; cv: the autodiff Hessian), ``S_root =
        chol(Kuu) inner^{-1/2} x 10`` with ``inner^{-1/2}`` from ``inner``'s
        Cholesky (``"full"``), or the Laplace precision in the family
        (``"tridiag"``); the task factor divided by 10 and the mean
        constants raised by ``log mean(rs)``.  ``y`` is ``(N, T)``."""
        cv = getattr(likelihood, "param", "exp") == "cv"
        f, rs = running_std_latent_init(y.T)  # (T, N)
        if cv:
            f = likelihood.latent_from_scale(rs)
            inv_hess = likelihood.laplace_inv_hessian(y.T, f)
        else:
            inv_hess = exp_laplace_inv_hessian(y.T, f)
        f = f.T  # (N, T)
        mean_inv_hess = torch.mean(inv_hess, dim=0)  # (N,)
        mean_rs = torch.mean(torch.clamp(rs, min=1e-4), dim=-1)  # (T,)
        log_means = (likelihood.latent_from_scale(mean_rs[..., None])[..., 0]
                     if cv else torch.log(mean_rs))
        self.index_kernel.covar_factor /= 10.0
        self.mean_constants += log_means
        self.variational_mean.copy_(f)
        if self.q == "tridiag":
            # the Laplace precision K^{-1} / vol + diag(curvature), in the
            # family and not inflated
            vol = self.data_kernel.vol()[..., 0]
            a_diag, a_off, _ = min_precision(x, 1e-6 / vol)
            d, e = bidiag_chol_from_tridiag(a_diag / vol + mean_inv_hess,
                                            a_off / vol)
            self.q_log_d.copy_(torch.log(d))
            self.q_e.copy_(e)
            return self
        chol = self._data_chol(x)
        if chol is None:
            chol = psd_safe_cholesky(self.data_kernel(x))
        if cv:
            inner = (chol.mT * mean_inv_hess[None, :]) @ chol
        else:
            # the reference's exp branch clamps after diag_embed, so the
            # task-averaged inverse curvature is the dense diag(mean) +
            # 1e-4 (11^T - I)
            n = mean_inv_hess.shape[-1]
            dense = torch.full((n, n), 1e-4, dtype=f.dtype, device=f.device)
            dense = dense + torch.diag(mean_inv_hess - 1e-4)
            inner = chol.mT @ (dense @ chol)
        inner = inner + torch.eye(inner.shape[-1], dtype=inner.dtype,
                                  device=inner.device)
        c = psd_safe_cholesky(inner)
        eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
        inner_inv_root = torch.linalg.solve(c.mT, eye)
        self.variational_covar_root.copy_((chol @ inner_inv_root) * 10.0)
        return self

    def prior_mean(self, x):
        return self.mean_constants.expand(x.shape[-1], self.num_tasks)

    def kl_divergence(self, x):
        """``KL(q || p)``, both Kronecker: against the BM data prior the
        closed-form difference-and-scale factor (``kron_kl_bm_prior``, or
        its tridiagonal form), against the FBM one the dense ``kron_kl``
        with the increment-domain factor."""
        k_task = self.index_kernel.covar_matrix()
        root_t = self.variational_task_covar_root
        if self.q == "tridiag":
            d, e = self._q_chol()
            return kron_kl_bm_prior_tridiag(
                self.variational_mean, d, e, root_t, self.prior_mean(x), x,
                self.data_kernel.vol(), k_task)
        if isinstance(self.data_kernel, BMKernel):
            return kron_kl_bm_prior(
                self.variational_mean, self.variational_covar_root, root_t,
                self.prior_mean(x), x, self.data_kernel.vol(), k_task)
        return kron_kl(self.variational_mean, self.variational_covar_root,
                       root_t, self.prior_mean(x), self.data_kernel(x),
                       k_task, chol_data=self._data_chol(x))

    def marginal_variances(self):
        """``diag(Sx (x) St)`` at the inducing points, ``(N, T)``."""
        rt = torch.tril(self.variational_task_covar_root)
        dt = torch.sum(rt * rt, dim=-1)
        if self.q == "tridiag":
            dx = takahashi_band(*self._q_chol())[0]
        else:
            rx = torch.tril(self.variational_covar_root)
            dx = torch.sum(rx * rx, dim=-1)
        return dx[..., :, None] * dt[..., None, :]

    def _takes_g3(self, x, y, likelihood) -> bool:
        """Whether :meth:`elbo` runs kernel G3: the tridiagonal family (so
        the BM kernel) and the closed-form exp term, on the card
        (:func:`~volt_tpu_torch.native.on_card`; G3's wrapper raises on what
        it does not take)."""
        return (self.q == "tridiag"
                and isinstance(likelihood, VolatilityGaussianLikelihood)
                and likelihood.param == "exp" and native.on_card(y))

    def elbo(self, x, y, likelihood, num_locs: int = 75):
        """The ELBO at inducing == train: the mean expected log-likelihood
        of ``y (N, T)`` less ``KL / (N T)``.  The tridiagonal family's,
        with the closed-form exp term, is kernel G3 on the card (one call
        for the ELBO and its gradient, no wait for the card) and the plain
        composition on the CPU."""
        if self._takes_g3(x, y, likelihood):
            with annotate("mt_elbo"):
                factor, task_diag = self.index_kernel.factor_and_diag()
                return mt_tridiag_elbo(
                    x, y, self.variational_mean, self.q_log_d, self.q_e,
                    self.variational_task_covar_root, self.mean_constants,
                    factor, task_diag, self.data_kernel.vol())
        with annotate("ell"):
            ell = torch.mean(likelihood.expected_log_prob(
                y, self.variational_mean, self.marginal_variances(),
                num_locs=num_locs), dim=(-2, -1))
        with annotate("kron_kl"):
            kl = self.kl_divergence(x)
        return ell - kl / (y.shape[-2] * y.shape[-1])

    def predict(self, train_x, test_x):
        """The unwhitened Kronecker predictive ``(mean (M, T), cov (M T,
        M T))``, assembled from ``(Kxx - Q) (x) B + (A Sx A^T) (x) St``."""
        k = self.data_kernel
        kux, kxx = k(train_x, test_x), k(test_x)
        b = self.index_kernel.covar_matrix()
        chol = self._data_chol(train_x)
        if chol is None:
            chol = psd_safe_cholesky(k(train_x))
        kuu_inv_kux = cholesky_solve(chol, kux)  # (N, M)
        mean = kuu_inv_kux.mT @ (self.variational_mean
                                 - self.prior_mean(train_x))
        mean = mean + self.mean_constants
        first = kxx - kux.mT @ kuu_inv_kux
        if self.q == "tridiag":
            d, e = self._q_chol()
            bt = kuu_inv_kux.mT  # (M, N)
            half = bidiag_solve_lower(
                d[..., None, :].expand(bt.shape),
                e[..., None, :].expand(*bt.shape[:-1], bt.shape[-1] - 1), bt)
        else:
            half = kuu_inv_kux.mT @ torch.tril(self.variational_covar_root)
        third = half @ half.mT
        rt = torch.tril(self.variational_task_covar_root)
        st = rt @ rt.mT
        m, t = test_x.shape[-1], self.num_tasks
        cov = (torch.einsum("...ij,...ab->...iajb", first, b)
               + torch.einsum("...ij,...ab->...iajb", third, st))
        return mean, cov.reshape(*first.shape[:-2], m * t, m * t)

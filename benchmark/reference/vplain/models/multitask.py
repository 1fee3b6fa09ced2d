"""Kronecker multitask models: correlated assets (the port's
``models/multitask.py``, trimmed to what the cells run: the BM data
kernel, the tridiagonal family, the exp likelihood).

* :class:`MultitaskBMGP`: the exact multitask GP over log-vol paths,
  ``K = BM(x) (x) IndexKernel``, with the per-task Itô drift scaled by the
  task covariance's diagonal;
* :class:`MultitaskVariationalGP`: the Kronecker variational GP of the
  multitask GPCV stage, ``q(vec(U)) = N(vec(M), Sx (x) St)``.

Data are laid out ``(N, T)`` (points, tasks) as in the JAX package; the
``NT x NT`` covariance is never built for training
(:mod:`..gp.kronecker`).  Parameters are held by the modules under the
JAX leaf names (``data_kernel.raw_vol``, ``task_kernel.covar_factor``,
``variational_mean``, ...), which :func:`..convert.load_params` loads
from a nested dict.  Randomness comes from a ``torch.Generator`` or from
the standard normals passed as ``noise``.
"""

from __future__ import annotations

import dataclasses
import torch
from torch import nn
from ..gp.kronecker import (kron_kl_bm_prior_tridiag, kron_mvn_log_prob_blockdiag_lowrank)
from ..gp.variational import exp_laplace_inv_hessian, running_std_latent_init
from ..kernels import BMKernel, IndexKernel
from ..likelihoods import MultitaskGaussianLikelihood
from ..ops.bidiag import (bidiag_chol_from_tridiag, min_precision, takahashi_band)
from ..ops.brownian import (future_grid_ok, min_kernel_eigenvalues, min_kernel_project, nan_poison)
from ..ops.chol import psd_safe_cholesky


@dataclasses.dataclass
class MultitaskBMGPState:
    """A fitted multitask vol GP (holding its parameters) and its data:
    ``train_x (N,)``, ``train_y (N, T)`` log vols."""

    module: "MultitaskBMGP"
    train_x: torch.Tensor
    train_y: torch.Tensor

    def sample_forecast(self, test_x, nsample: int, generator=None,
                        noise=None):
        return self.module.sample_forecast(self.train_x, self.train_y,
                                           test_x, nsample, generator, noise)


class MultitaskBMGP(nn.Module):
    """The exact Kronecker multitask GP over log vol.  Parameters (after
    :meth:`init`): ``data_kernel.raw_vol (1,)``,
    ``task_kernel.covar_factor (T, rank)``, ``task_kernel.raw_var (T,)``,
    ``likelihood.raw_noise (1,)``."""

    def __init__(self, num_tasks: int, rank: int = 1):
        super().__init__()
        self.num_tasks = num_tasks
        self.data_kernel = BMKernel()
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

    def spectral_cache(self, x, y):
        """The closed-form data-side eigenbasis of ``min(x)`` on an
        equispaced grid (as ``BMGP.spectral_cache``), with ``y (N, T)``
        and ``x`` projected onto it once per fit."""
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
        blocks (``kron_mvn_log_prob_blockdiag_lowrank``)."""
        vol = self.data_kernel.vol()[..., 0]
        factor, task_diag = self.task_kernel.factor_and_diag()
        diag_b = torch.sum(factor * factor, dim=-1) + task_diag
        # U^T mean = (-0.5 vol^2 p_x) outer diag(B)
        r_tilde = cache["p_y"] + (0.5 * vol ** 2.0 * cache["p_x"])[
            ..., :, None] * diag_b[..., None, :]
        ld = vol * cache["dx"] * cache["mu"]
        c = vol * (cache["x0"] - cache["dx"])
        lp = kron_mvn_log_prob_blockdiag_lowrank(
            r_tilde, ld, c, factor, task_diag, self._noise(), cache["w"])
        return lp / (n * t)

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
        the contract come back all-NaN."""
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
        lt_root = psd_safe_cholesky(k_task)
        joint_x = torch.cat([train_x, test_x], dim=-1)
        dx = torch.diff(joint_x, dim=-1,
                        prepend=torch.zeros_like(joint_x[..., :1]))
        sd = torch.sqrt(torch.clamp(vol * dx, min=0.0))  # (N+M,)
        w_paths = torch.cumsum(sd[:, None] * z, dim=-2) @ lt_root.mT
        u = (train_y - self.mean(train_x)) - w_paths[..., :n, :] \
            - torch.sqrt(s2) * eps_z
        # the Kronecker solve in the factors' eigenbases
        lam, qd = torch.linalg.eigh(torch.minimum(train_x[:, None],
                                                  train_x[None, :]))
        ld = vol * torch.clamp(lam, min=0.0)
        lt, qt = torch.linalg.eigh(k_task)
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
    points at the train inputs: a tridiagonal data precision with
    bidiagonal Cholesky ``(exp(q_log_d), q_e)``, O(N) parameters, and a
    dense task root ``variational_task_covar_root (T, T)``.  Parameters
    also: ``data_kernel.raw_vol (1,)``, ``index_kernel.{covar_factor,
    raw_var}``, ``mean_constants (T,)``, ``variational_mean (N, T)``."""

    def __init__(self, num_tasks: int, rank: int = 1, q: str = "tridiag"):
        super().__init__()
        if q != "tridiag":
            raise ValueError("the reference has the tridiagonal family only")
        self.num_tasks = num_tasks
        self.data_kernel = BMKernel()
        self.index_kernel = IndexKernel(num_tasks, rank)

    def init(self, train_x, dtype=torch.float32, generator=None):
        """The task factor and ``0.01 N(0, 1)`` variational mean from
        ``generator`` (default: a CPU generator seeded 0); identity roots
        (``q_log_d = 0``, ``q_e = 0``); zero mean constants."""
        n, t = train_x.shape[-1], self.num_tasks
        device = train_x.device
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.data_kernel.init((), dtype, device)
        self.index_kernel.init(dtype, device, generator)
        self.mean_constants = nn.Parameter(torch.zeros(t, dtype=dtype,
                                                       device=device))
        # drawn in float32, as the program draws it, then cast
        self.variational_mean = nn.Parameter(0.01 * torch.randn(
            n, t, dtype=torch.float32, generator=generator,
            device=generator.device).to(device, dtype))
        self.variational_task_covar_root = nn.Parameter(
            torch.eye(t, dtype=dtype, device=device))
        self.q_log_d = nn.Parameter(torch.zeros(n, dtype=dtype,
                                                device=device))
        self.q_e = nn.Parameter(torch.zeros(n - 1, dtype=dtype,
                                            device=device))
        return self

    def _q_chol(self):
        return torch.exp(self.q_log_d), self.q_e

    @torch.no_grad()
    def initialize_variational_parameters(self, likelihood, x, y):
        """The reference's Laplace-style init, in place: per-task
        running-std latent, task-averaged inverse curvature (the exp
        likelihood's closed form), the Laplace precision in the family;
        the task factor divided by 10 and the mean constants raised by
        ``log mean(rs)``.  ``y`` is ``(N, T)``."""
        f, rs = running_std_latent_init(y.T)  # (T, N)
        inv_hess = exp_laplace_inv_hessian(y.T, f)
        f = f.T  # (N, T)
        mean_inv_hess = torch.mean(inv_hess, dim=0)  # (N,)
        mean_rs = torch.mean(torch.clamp(rs, min=1e-4), dim=-1)  # (T,)
        self.index_kernel.covar_factor /= 10.0
        self.mean_constants += torch.log(mean_rs)
        self.variational_mean.copy_(f)
        # the Laplace precision K^{-1} / vol + diag(curvature), in the
        # family and not inflated
        vol = self.data_kernel.vol()[..., 0]
        a_diag, a_off, _ = min_precision(x, 1e-6 / vol)
        d, e = bidiag_chol_from_tridiag(a_diag / vol + mean_inv_hess,
                                        a_off / vol)
        self.q_log_d.copy_(torch.log(d))
        self.q_e.copy_(e)
        return self

    def prior_mean(self, x):
        return self.mean_constants.expand(x.shape[-1], self.num_tasks)

    def kl_divergence(self, x):
        """``KL(q || p)``, both Kronecker, against the BM data prior in
        its closed tridiagonal form."""
        d, e = self._q_chol()
        return kron_kl_bm_prior_tridiag(
            self.variational_mean, d, e, self.variational_task_covar_root,
            self.prior_mean(x), x, self.data_kernel.vol(),
            self.index_kernel.covar_matrix())

    def marginal_variances(self):
        """``diag(Sx (x) St)`` at the inducing points, ``(N, T)``."""
        rt = torch.tril(self.variational_task_covar_root)
        dt = torch.sum(rt * rt, dim=-1)
        dx = takahashi_band(*self._q_chol())[0]
        return dx[..., :, None] * dt[..., None, :]

    def elbo(self, x, y, likelihood, num_locs: int = 75):
        """The ELBO at inducing == train: the mean expected log-likelihood
        of ``y (N, T)`` less ``KL / (N T)``."""
        ell = likelihood.expected_log_prob(y, self.variational_mean,
                                           self.marginal_variances(),
                                           num_locs=num_locs)
        return torch.mean(ell, dim=(-2, -1)) \
            - self.kl_divergence(x) / (y.shape[-2] * y.shape[-1])

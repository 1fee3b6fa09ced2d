"""The PSD-safe Cholesky with its jitter ladder and the triangular solves
(the port's ``ops/chol.py``, trimmed to what the FBM cell runs).

:func:`psd_safe_cholesky` tries the bare factor, and while it fails adds
``jitter * 10**i`` to the diagonal for ``i = 0..max_tries-1``; failure is
read from ``torch.linalg.cholesky_ex``'s ``info`` and a factor that still
fails comes back NaN in its lower triangle.  With ``per_lane=True`` each
matrix of the batch climbs its own ladder (one asset a lane, as the JAX
pipeline's ``vmap``); otherwise one failed matrix retries the whole batch.
Its backward is the standard Cholesky adjoint of the factor the ladder
produced.  Every ladder here takes its first rung ``jitter`` from the
caller: the pipeline passes the rung of the precision the program runs
in, whatever precision the copy computes in.
"""

from __future__ import annotations

import torch


def add_jitter(a, jitter):
    """``a + jitter * I`` over the trailing two dims."""
    return a + jitter * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def default_jitter(dtype) -> float:
    """gpytorch's dtype-based first rung, the port's default."""
    return 1e-8 if dtype == torch.float64 else 1e-6


def _factor(a):
    """Lower Cholesky factor, NaN where it failed, and whether every
    factor succeeded."""
    chol, info = torch.linalg.cholesky_ex(a)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    good = (info == 0) & torch.all(torch.isfinite(diag) & (diag > 0), dim=-1)
    chol = torch.tril(torch.where(good[..., None, None], chol, torch.nan))
    return chol, bool(good.all())


def _jitter_ladder(a, base_jitter: float, max_tries: int):
    chol, ok = _factor(a)
    i = 0
    while not ok and i < max_tries:
        chol, ok = _factor(add_jitter(a, base_jitter * 10.0 ** i))
        i += 1
    return chol


def _jitter_ladder_per_lane(a, base_jitter: float, max_tries: int):
    """The ladder of each matrix of the batch on its own: a lane keeps the
    first factor of ``a, a + j I, a + 10 j I, ...`` that succeeds."""
    n = a.shape[-1]
    flat = a.reshape(-1, n, n)
    chol, _ = _factor(flat)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    bad = ~torch.all(torch.isfinite(diag) & (diag > 0), dim=-1)
    for i in range(max_tries):
        idx = torch.nonzero(bad).flatten()
        if idx.numel() == 0:
            break
        retry, _ = _factor(add_jitter(flat[idx], base_jitter * 10.0 ** i))
        chol = chol.index_copy(0, idx, retry)
        rdiag = torch.diagonal(retry, dim1=-2, dim2=-1)
        bad = bad.index_copy(0, idx, ~torch.all(
            torch.isfinite(rdiag) & (rdiag > 0), dim=-1))
    return chol.reshape(a.shape)


class _PSDSafeCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, base_jitter, max_tries, per_lane):
        ladder = _jitter_ladder_per_lane if per_lane else _jitter_ladder
        chol = ladder(a, base_jitter, max_tries)
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, g):
        # Murray (2016): Phi(L^T g), then L^{-T} (.) L^{-1}, symmetrised
        (chol,) = ctx.saved_tensors
        m = torch.tril(chol.mT @ g)
        m = m - 0.5 * torch.diag_embed(torch.diagonal(m, dim1=-2, dim2=-1))
        x1 = torch.linalg.solve_triangular(chol.mT, m, upper=True)
        x2 = torch.linalg.solve_triangular(chol, x1, upper=False, left=False)
        return 0.5 * (x2 + x2.mT), None, None, None


def psd_safe_cholesky(a, jitter: float, max_tries: int = 3,
                      per_lane: bool = False):
    """Lower Cholesky factor with the deterministic jitter ladder from
    ``jitter``, climbed by the whole batch, or with ``per_lane`` by each
    matrix alone."""
    return _PSDSafeCholesky.apply(a, float(jitter), int(max_tries),
                                  bool(per_lane))


def solve_lower_triangular(chol, b):
    """Solve ``L x = b`` (batch dims broadcast)."""
    return torch.linalg.solve_triangular(chol, b, upper=False)


def solve_upper_triangular(chol, b):
    """Solve ``L^T x = b`` for lower-triangular ``L``."""
    return torch.linalg.solve_triangular(chol.mT, b, upper=True)


def cholesky_solve(chol, b):
    """Solve ``(L L^T) x = b`` given the lower factor."""
    return solve_upper_triangular(chol, solve_lower_triangular(chol, b))

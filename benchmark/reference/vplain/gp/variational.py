"""The GPCV's Laplace-style start (the port's ``gp/variational.py``,
trimmed to what the cells run): the running-std latent and the exp
likelihood's curvature."""

from __future__ import annotations

import torch


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


"""Training helpers of the slice (port of the slice's part of
:mod:`volt_tpu.train`)."""

from __future__ import annotations

import torch

__all__ = ["scaled_returns", "adam_loop"]


def scaled_returns(train_x, train_y):
    """``(y[t+1] - y[t]) / y[t] / sqrt(dt)``; ``train_y`` holds prices on a
    grid one point longer than ``train_x``."""
    if train_y.shape[-1] != train_x.shape[-1] + 1:
        raise ValueError(
            f"expected len(train_y) == len(train_x) + 1 (prices vs. return "
            f"grid), got {train_y.shape[-1]} vs {train_x.shape[-1]}")
    dt = train_x[..., 1] - train_x[..., 0]
    diffs = train_y[..., 1:] - train_y[..., :-1]
    return diffs / train_y[..., :-1] / torch.sqrt(dt)[..., None]


def adam_loop(module, loss_fn, iters: int, lr: float):
    """Minimise the per-asset losses ``loss_fn()`` ``(*batch)`` with Adam
    over every parameter of ``module``; returns the losses ``(iters,
    *batch)``, each taken before its step's update.

    One Adam on the summed losses equals one Adam per asset: the
    gradient of the sum w.r.t. an asset's parameters is that asset's own
    gradient, and Adam updates elementwise (optax's defaults: b1 0.9,
    b2 0.999, eps 1e-8 outside the square root).  Every op of the losses
    is per asset, so a non-finite asset leaves the others untouched.
    """
    opt = torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.sum().backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses)

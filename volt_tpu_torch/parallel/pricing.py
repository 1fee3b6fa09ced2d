"""Option pricing at scale (port of :mod:`volt_tpu.parallel.pricing`):
fit, roll out, and reduce the paths to call values over an ``(asset,
strike, expiry)`` grid on the device.

The BASELINE configuration is 500 tickers x 10k Monte-Carlo paths; the
payoff grid ``(B, K, S, E)`` is one broadcast there (about 1.7 GB at
K=21, E=4) and only the ``(B, K, E)`` values and ``(B, E)`` forwards are
small.  On a mesh each rank reduces its own paths to sums, and a sum over
the ``path`` axis makes the means: only those small tensors leave a rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import PipelineConfig, fit_forecast_batch

__all__ = ["price_options_batch", "option_grid"]


def _on(a, device, dtype=None):
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def price_options_batch(generator, train_x, train_ys, test_x, strikes,
                        expiry_steps, config: PipelineConfig, realized=None,
                        noise=None, mesh=None):
    """Monte-Carlo call values over an ``(asset, strike, expiry)`` grid.

    :func:`fit_forecast_batch` (``output="samples"``; ``generator``,
    ``noise`` and ``mesh`` as there) on ``train_ys``'s device, then
    ``strikes (K,)`` absolute strike prices, ``expiry_steps (E,)`` integer
    offsets into ``test_x`` and ``realized`` (optional ``(B, E)`` realised
    prices) are moved there (numpy arrays or lists are taken).

    Returns a dict with ``values (B, K, E)``, ``forwards (B, E)``, the
    log-price ``samples (B, S, H)``, the pipeline's ``aux`` and, with
    ``realized``, ``percentiles (B, E)``: the fraction of paths below the
    realised price, compared in log space (the paths are log prices).
    With ``mesh`` every output holds the rank's assets, ``samples`` its
    paths, and the means are over all the paths of its assets.
    """
    if config.output != "samples":
        # a quantile fan's levels are no Monte-Carlo paths to average
        raise ValueError(
            "price_options_batch needs raw MC paths; use "
            "PipelineConfig(output='samples'), got "
            f"output={config.output!r}")
    samples, aux = fit_forecast_batch(generator, train_x, train_ys, test_x,
                                      config, noise=noise, mesh=mesh)
    if realized is not None and mesh is not None:
        realized = mesh.shard(_on(realized, samples.device, torch.float32),
                              ("asset",))
    return {**option_grid(samples, strikes, expiry_steps, realized, mesh),
            "samples": samples, "aux": aux}


def option_grid(log_paths, strikes, expiry_steps, realized=None, mesh=None):
    """The payoff reduction of :func:`price_options_batch` on log-price
    paths ``(B, S, H)``: ``values (B, K, E)``, ``forwards (B, E)`` and,
    with ``realized``, ``percentiles (B, E)``.  With ``mesh`` the paths are
    the rank's share: its sums are added over the ``path`` axis and divided
    by the number of all the paths."""
    device = log_paths.device
    expiry_steps = _on(expiry_steps, device, torch.long)
    strikes = _on(strikes, device, torch.float32)
    paths = log_paths.shape[1] * (1 if mesh is None
                                  else mesh.axis_size("path"))

    def mean_over_paths(sums):
        return (sums if mesh is None else mesh.all_reduce(sums, "path")) \
            / paths

    with torch.no_grad():
        log_px = log_paths[..., expiry_steps]  # (B, S, E)
        px = torch.exp(log_px)
        payoff = torch.clamp(px[:, None, :, :]
                             - strikes[None, :, None, None], min=0.0)
        out = {"values": mean_over_paths(torch.sum(payoff, dim=2)),
               "forwards": mean_over_paths(torch.sum(px, dim=1))}
        del payoff
        if realized is not None:
            # in log space: the paths are log prices
            realized = _on(realized, device, torch.float32)
            out["percentiles"] = mean_over_paths(torch.sum(
                (log_px < torch.log(realized)[:, None, :]).to(torch.float32),
                dim=1))
    return out

"""Option pricing at scale (port of :mod:`volt_tpu.parallel.pricing`,
without a mesh): fit, roll out, and reduce the paths to call values over
an ``(asset, strike, expiry)`` grid on the device.

The BASELINE configuration is 500 tickers x 10k Monte-Carlo paths; the
payoff grid ``(B, K, S, E)`` is one broadcast there (about 1.7 GB at
K=21, E=4) and only the ``(B, K, E)`` values and ``(B, E)`` forwards are
small.
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
                        noise=None):
    """Monte-Carlo call values over an ``(asset, strike, expiry)`` grid.

    :func:`fit_forecast_batch` (``output="samples"``; ``generator`` and
    ``noise`` as there) on ``train_ys``'s device, then ``strikes (K,)``
    absolute strike prices, ``expiry_steps (E,)`` integer offsets into
    ``test_x`` and ``realized`` (optional ``(B, E)`` realised prices) are
    moved there (numpy arrays or lists are taken).

    Returns a dict with ``values (B, K, E)``, ``forwards (B, E)``, the
    log-price ``samples (B, S, H)``, the pipeline's ``aux`` and, with
    ``realized``, ``percentiles (B, E)``: the fraction of paths below the
    realised price, compared in log space (the paths are log prices).
    """
    if config.output != "samples":
        # a quantile fan's levels are no Monte-Carlo paths to average
        raise ValueError(
            "price_options_batch needs raw MC paths; use "
            "PipelineConfig(output='samples'), got "
            f"output={config.output!r}")
    samples, aux = fit_forecast_batch(generator, train_x, train_ys, test_x,
                                      config, noise=noise)
    return {**option_grid(samples, strikes, expiry_steps, realized),
            "samples": samples, "aux": aux}


def option_grid(log_paths, strikes, expiry_steps, realized=None):
    """The payoff reduction of :func:`price_options_batch` on log-price
    paths ``(B, S, H)``: ``values (B, K, E)``, ``forwards (B, E)`` and,
    with ``realized``, ``percentiles (B, E)``."""
    device = log_paths.device
    expiry_steps = _on(expiry_steps, device, torch.long)
    strikes = _on(strikes, device, torch.float32)
    with torch.no_grad():
        log_px = log_paths[..., expiry_steps]  # (B, S, E)
        px = torch.exp(log_px)
        payoff = torch.clamp(px[:, None, :, :]
                             - strikes[None, :, None, None], min=0.0)
        out = {"values": torch.mean(payoff, dim=2),  # (B, K, E)
               "forwards": torch.mean(px, dim=1)}   # (B, E)
        del payoff
        if realized is not None:
            # in log space: the paths are log prices
            realized = _on(realized, device, torch.float32)
            out["percentiles"] = torch.mean(
                (log_px < torch.log(realized)[:, None, :]).to(torch.float32),
                dim=1)
    return out

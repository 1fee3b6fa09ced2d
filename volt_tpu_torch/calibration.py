"""Forecast-calibration metrics (port of :mod:`volt_tpu.calibration`).

Empirical-CDF percentiles of realised values among forecast samples, and
the fraction of them inside centred bands: the reference's offline
evaluation (its calibration notebook and ``option_utils.py:48-51``).
Inputs are tensors, or anything ``torch.as_tensor`` takes; the work runs
on their device.  :func:`interval_coverage` stays numpy, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_percentiles", "calibration", "calibration_curve", "crps",
           "coverage_from_quantiles", "interval_coverage"]


def _t(a, like=None):
    if torch.is_tensor(a):
        return a
    device = like.device if like is not None else None
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def sample_percentiles(samples, truth):
    """Per-step fraction of the samples ``(n_paths, H)`` below the truth
    ``(H,)``; uniform on [0, 1] for a calibrated forecaster."""
    samples = _t(samples)
    truth = _t(truth, samples)
    return torch.mean((samples < truth[None, :]).to(torch.float32), dim=0)


def calibration(percentiles, levels=None):
    """For each level ``p`` (default 0.05, 0.10, ..., 0.95) the fraction
    of the percentiles inside ``[0.5 - p/2, 0.5 + p/2]``, ideally ``p``.
    Returns ``(levels, observed_fractions)``."""
    percentiles = _t(percentiles).reshape(-1)
    if levels is None:
        levels = torch.linspace(0.05, 0.95, 19, device=percentiles.device)
    levels = _t(levels, percentiles)
    lo, hi = 0.5 - levels / 2, 0.5 + levels / 2
    inside = ((percentiles[None, :] >= lo[:, None])
              & (percentiles[None, :] <= hi[:, None]))
    return levels, torch.mean(inside.to(torch.float32), dim=1)


def coverage_from_quantiles(levels, fan, truth):
    """Coverage from a quantile fan ``(..., L, H)`` with ascending
    ``levels`` ``(L,)`` and the truth ``(..., H)``: the fraction of (asset,
    step) cells with ``truth <= fan[..., l, :]`` for each level.  Returns
    ``(levels, observed)``."""
    fan = _t(fan)
    levels, truth = _t(levels, fan), _t(truth, fan)
    below = (truth[..., None, :] <= fan).to(torch.float32)
    dims = tuple(i for i in range(below.dim()) if i != below.dim() - 2)
    return levels, torch.mean(below, dim=dims)


def calibration_curve(samples_list, truths_list, levels=None):
    """:func:`calibration` of the percentiles of many forecast windows."""
    pcts = torch.cat([sample_percentiles(s, t).reshape(-1)
                      for s, t in zip(samples_list, truths_list)])
    return calibration(pcts, levels)


def interval_coverage(samples, truth, levels):
    """Central-interval coverage per nominal level: ``samples (W, S, H)``,
    ``truth (W, H)``, ``levels (L,)``; the ``(L,)`` fraction of realised
    points inside each central interval, over windows and steps (numpy)."""
    samples, truth, levels = (np.asarray(a.detach().cpu() if torch.is_tensor(a)
                                         else a)
                              for a in (samples, truth, levels))
    lo = np.quantile(samples, 0.5 - levels / 2, axis=1)  # (L, W, H)
    hi = np.quantile(samples, 0.5 + levels / 2, axis=1)
    inside = (truth[None] >= lo) & (truth[None] <= hi)
    return inside.mean(axis=(1, 2))


def crps(samples, truth):
    """The continuous ranked probability score per step (lower is
    better): ``E|X - y| - 0.5 E|X - X'|`` from the samples ``(S, H)``,
    the second term in its sorted form
    ``2/S^2 sum_i (2i - S - 1) x_(i)``."""
    samples = _t(samples)
    truth = _t(truth, samples)
    term1 = torch.mean(torch.abs(samples - truth[None, :]), dim=0)
    s_sorted = torch.sort(samples, dim=0).values
    n = samples.shape[0]
    i = torch.arange(1, n + 1, dtype=samples.dtype, device=samples.device)
    coef = (2.0 * i - n - 1.0) / (n * n)
    term2 = 2.0 * torch.sum(coef[:, None] * s_sorted, dim=0)
    return term1 - 0.5 * term2

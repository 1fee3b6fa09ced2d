"""Multitask (correlated-station) wind forecasting (port of
:mod:`volt_tpu.experiments.mt_wind`).

The producer of the reference's multitask wind analysis inputs
(``x_paths`` / ``names_list``, ``mtwind_plotting-checkpoint.ipynb``): a
GPCV fit per station, a Kronecker multitask vol GP coupling the stations,
and jointly correlated rollouts.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..rollouts import rollouts_multitask
from ..train import learn_gpcv, train_volt_multitask
from ._common import as_f32, default_generator

__all__ = ["run_multitask_wind"]


def _clean(series):
    s = np.asarray(series, np.float32).copy()
    s[s == -99.0] = 0.0
    return s


def run_multitask_wind(names, station_data, ntrain: int = 400,
                       forecast_horizon: int = 126, nsample: int = 1000,
                       gpcv_iters: int = 200, vol_iters: int = 400,
                       k: int = 400, theta: float = 0.05,
                       mean_func: str = "ewma", out_path=None,
                       generator=None, lonlat=None, conus_only: bool = False,
                       device="cuda"):
    """Joint forecast of every live station: returns (and with
    ``out_path`` pickles) ``{"x_paths": (T, S, H), "names_list": [...]}``.

    ``station_data``: per-station wind series, preprocessed as the weather
    CLI's (``-99 -> 0``, ``+1``); a station whose mean is then 0 is dropped.
    ``conus_only`` drops stations at longitude <= -128 (the notebook's
    CONUS filter)."""
    generator = default_generator(generator, device)
    keep = []
    for idx in range(len(station_data)):
        if conus_only and lonlat is not None and lonlat[idx][0] <= -128:
            continue
        # the dead-station test after the -99 -> 0 replacement: an
        # all-missing station would otherwise feed a constant series into
        # the joint Kronecker fit
        if _clean(station_data[idx]).mean() != 0:
            keep.append(idx)
    names_list = [names[i] for i in keep]

    train_x = torch.arange(ntrain - 1, dtype=torch.float32,
                           device=device) / 365
    test_x = torch.arange(ntrain, ntrain + forecast_horizon,
                          dtype=torch.float32, device=device) / 365
    prices = torch.stack([as_f32(_clean(station_data[i])[:ntrain] + 1.0,
                                 device) for i in keep])  # (T, ntrain)
    vols = torch.stack([learn_gpcv(train_x, y, train_iters=gpcv_iters)
                        for y in prices])  # (T, ntrain - 1)

    volt_state, mt_state = train_volt_multitask(
        train_x, prices[:, 1:], vols,
        train_iters=0 if mean_func in ("ewma", "dewma", "tewma") else 200,
        vol_iters=vol_iters, k=k, mean_func=mean_func, generator=generator)
    x_paths = rollouts_multitask(generator, volt_state, mt_state, prices,
                                 test_x, nsample=nsample, theta=theta)
    result = {"x_paths": x_paths.cpu().numpy(), "names_list": names_list}
    if out_path:
        with open(out_path, "wb") as fh:
            pickle.dump(result, fh)
    return result

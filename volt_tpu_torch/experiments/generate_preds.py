"""Stock backtest generators (port of
:mod:`volt_tpu.experiments.generate_preds`; reference
``experiments/stocks/GenerateMultiMeanPreds.py``).

Outputs are ``.npy`` sample arrays named ``<model>_<date>.npy`` under
``<outdir>/<ticker>/``, the reference's backtest layout.
``generate_stock_predictions(batch_windows=True)`` runs every rolling
window as one batched :func:`~volt_tpu_torch.parallel.fit_forecast_batch`
call; the other generators loop over the windows.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.pipeline import PipelineConfig, fit_forecast_batch
from ..rollouts import (generate_prediction, nonvol_rollouts, rollouts,
                        sample_vol_paths)
from ..train import learn_gpcv, train_vol_model, train_volt_magpie
from ._common import DETERMINISTIC_MEANS, as_f32, default_generator
from .basic_wind import make_basic_model

__all__ = [
    "rolling_windows",
    "generate_stock_predictions",
    "generate_one_day_predictions",
    "generate_basic_predictions",
    "generate_gpcv_predictions",
]

DT = 1.0 / 252


def rolling_windows(prices, ntrain: int, ntimes: int):
    """End indices of the rolling backtest windows (reference ``:69-73``)."""
    n = len(prices)
    if ntimes == -1:
        return list(range(ntrain, n))
    step = max(int((n - ntrain) / ntimes), 1)
    return list(range(ntrain, n, step))


def _grids(ntrain: int, ntest: int, device):
    train_x = torch.arange(ntrain - 1, dtype=torch.float32,
                           device=device) * DT
    test_x = (torch.arange(ntest, dtype=torch.float32, device=device) * DT
              + train_x[-1] + DT)
    return train_x, test_x


def _save(savepath, name, samples):
    os.makedirs(savepath, exist_ok=True)
    if torch.is_tensor(samples):
        samples = samples.cpu().numpy()
    np.save(os.path.join(savepath, name + ".npy"), np.asarray(samples))


def _labels(ends, dates):
    return [str(dates[e]) if dates is not None else str(e) for e in ends]


def generate_stock_predictions(ticker, prices, dates=None,
                               forecast_horizon: int = 20,
                               train_iters: int = 400, nsample: int = 1000,
                               ntrain: int = 400, mean: str = "ewma",
                               kernel: str = "volt", save: bool = False,
                               k: int = 300, ntimes: int = -1,
                               outdir: str = "./saved-outputs",
                               batch_windows: bool = True, generator=None,
                               device="cuda"):
    """Rolling-window Volt backtest (reference ``:63-137``).  ``prices``:
    1-D close prices; ``dates``: optional date labels for the file names.
    Returns ``{date_or_index: samples (nsample, H)}`` as numpy arrays."""
    generator = default_generator(generator, device)
    prices = np.asarray(prices, np.float32)
    ends = rolling_windows(prices, ntrain, ntimes)
    train_x, test_x = _grids(ntrain, forecast_horizon, device)
    savepath = os.path.join(outdir, str(ticker))
    model_name = f"{kernel}_{mean}{k}_"
    results = {}

    if batch_windows and kernel == "volt":
        cfg = PipelineConfig(gpcv_iters=train_iters, vol_iters=train_iters,
                             data_iters=train_iters, mean_func=mean, k=k,
                             nsample=nsample)
        train_ys = as_f32(np.stack([prices[e - ntrain:e] for e in ends]),
                          device)
        samples, _ = fit_forecast_batch(generator, train_x, train_ys, test_x,
                                        cfg)
        for label, s in zip(_labels(ends, dates), samples.cpu().numpy()):
            results[label] = s
            if save:
                _save(savepath, model_name + label, s)
        return results

    for label, e in zip(_labels(ends, dates), ends):
        train_y = as_f32(prices[e - ntrain:e], device)
        vol = learn_gpcv(train_x, train_y, train_iters=train_iters)
        vol_state = train_vol_model(train_x, vol, train_iters=train_iters)
        model = train_volt_magpie(train_x, train_y[1:], vol_state, vol,
                                  train_iters=train_iters, k=k,
                                  mean_func=mean, generator=generator)
        if mean in ("ewma", "dewma", "tewma"):
            s = rollouts(generator, model, train_x, train_y, test_x,
                         nsample=nsample)
        else:
            pred_vol = sample_vol_paths(vol_state, test_x, nsample,
                                        generator)
            s = generate_prediction(generator, model, test_x,
                                    pred_vol)[..., 0, :]
        results[label] = s.cpu().numpy()
        if save:
            _save(savepath, model_name + label, s)
    return results


def generate_one_day_predictions(ticker, train_y, date,
                                 forecast_horizon: int = 20,
                                 train_iters: int = 400, nsample: int = 1000,
                                 ntrain: int = 400, save: bool = False,
                                 mean=None, outdir: str = "./saved-outputs",
                                 generator=None,
                                 ks=(25, 50, 100, 200, 300, 400),
                                 device="cuda"):
    """Mean-family x k sweep for one window (reference ``:141-206``): one
    GPCV and vol fit shared by the whole {ewma, dewma, tewma} x ``ks``
    grid (the reference's k grid), with no data-model iterations."""
    generator = default_generator(generator, device)
    train_y = as_f32(train_y, device)
    train_x, test_x = _grids(train_y.shape[-1], forecast_horizon, device)
    savepath = os.path.join(outdir, str(ticker))
    vol = learn_gpcv(train_x, train_y, train_iters=train_iters)
    vol_state = train_vol_model(train_x, vol, train_iters=train_iters)
    results = {}
    if mean == "constant":
        model = train_volt_magpie(train_x, train_y[1:], vol_state, vol,
                                  train_iters=200, mean_func="constant")
        s = rollouts(generator, model, train_x, train_y, test_x,
                     nsample=nsample)
        results["volt_constant"] = s.cpu().numpy()
        if save:
            _save(savepath, f"volt_constant_{date}", s)
        return results
    for mean_name in ("ewma", "dewma", "tewma"):
        for k in ks:
            model = train_volt_magpie(train_x, train_y[1:], vol_state, vol,
                                      train_iters=0, k=k,
                                      mean_func=mean_name)
            s = rollouts(generator, model, train_x, train_y, test_x,
                         nsample=nsample)
            results[f"volt_{mean_name}{k}"] = s.cpu().numpy()
            if save:
                _save(savepath, f"volt_{mean_name}{k}_{date}", s)
    return results


def generate_basic_predictions(ticker, prices, kernel_name, dates=None,
                               mean_name: str = "ewma", k: int = 400,
                               forecast_horizon: int = 100,
                               train_iters: int = 600, nsample: int = 1000,
                               ntrain: int = 400, save: bool = False,
                               ntimes: int = -1,
                               outdir: str = "./saved-outputs",
                               generator=None, device="cuda"):
    """Baseline-model backtest (reference ``:210-298``): a spectral mixture
    of 15 mixtures, or a scaled Matérn / RBF, per window."""
    generator = default_generator(generator, device)
    prices = np.asarray(prices, np.float32)
    ends = rolling_windows(prices, ntrain, ntimes)
    train_x, test_x = _grids(ntrain, forecast_horizon, device)
    savepath = os.path.join(outdir, str(ticker))
    results = {}
    for label, e in zip(_labels(ends, dates), ends):
        train_y = as_f32(prices[e - ntrain:e], device)[1:]
        log_y = torch.log(train_y)
        model = make_basic_model(train_x, log_y, kernel_name, mean_name, k,
                                 train_iters, num_mixtures=15,
                                 generator=generator)
        if mean_name.lower() in DETERMINISTIC_MEANS:
            s = model.sample(generator, test_x, (nsample,))
        else:
            s = nonvol_rollouts(generator, model, train_x, train_y, test_x,
                                nsample=nsample)
        results[label] = s.cpu().numpy()
        if save:
            _save(savepath, f"{kernel_name}_{mean_name}{k}_{label}", s)
    return results


def generate_gpcv_predictions(ticker, prices, dates=None,
                              forecast_horizon: int = 20, ntimes: int = 25,
                              train_iters: int = 400, nsample: int = 1000,
                              ntrain: int = 400, save: bool = False,
                              outdir: str = "./saved-outputs", generator=None,
                              device="cuda"):
    """GPCV-only forecasts: cumulative sums of sampled scaled returns
    (reference ``:26-61``), from the GPCV's latent predictive on the
    horizon."""
    generator = default_generator(generator, device)
    prices = np.asarray(prices, np.float32)
    ends = rolling_windows(prices, ntrain, ntimes)
    train_x, test_x = _grids(ntrain, forecast_horizon, device)
    savepath = os.path.join(outdir, str(ticker))
    results = {}
    for label, e in zip(_labels(ends, dates), ends):
        train_y = as_f32(prices[e - ntrain:e], device)
        _, state = learn_gpcv(train_x, train_y, train_iters=train_iters,
                              return_model=True)
        with torch.no_grad():
            mean, var = state.latent_marginals(test_x)
            z = torch.randn(nsample, *mean.shape, device=device,
                            generator=generator)
            scale = state.module.likelihood.scale(mean + torch.sqrt(var) * z)
            returns = scale * torch.randn(scale.shape, device=device,
                                          generator=generator)
            log_samples = (torch.cumsum(returns, -1) * DT ** 0.5
                           + torch.log(train_y[-1]))
        results[label] = log_samples.cpu().numpy()
        if save:
            _save(savepath, f"gpcv_{label}", log_samples)
    return results

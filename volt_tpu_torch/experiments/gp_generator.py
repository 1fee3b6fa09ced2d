"""Wind-speed backtest CLI (port of :mod:`volt_tpu.experiments.gp_generator`;
reference ``experiments/weather/GPGenerator.py``).

Per-station rolling windows over USCRN sub-hourly wind data: the volt path
runs GPCV (200 iterations), the vol GP (500), then the Volt data model
with a constant mean (200 iterations) or EWMA k=400 (no data-model
iterations), and rollouts with theta=0.01; the baselines go through
``basic_wind_rollouts``.  Preprocessing as the reference's: ``-99.0 -> 0``
and a ``+1`` level shift (``GPGenerator.py:49,56``).

Data: a ``wind_data.p`` pickle of ``(names, lonlat, data)`` as the
reference's ``make_wind_dataset`` scrape (or
:func:`volt_tpu_torch.data.wind.build_wind_dataset_from_files`) writes
it, or ``--synthetic``.

Usage::

    python -m volt_tpu_torch.experiments.gp_generator --device cuda \\
        --wind_data wind_data.p --kernel volt --mean ewma
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..rollouts import rollouts
from ..train import learn_gpcv, train_vol_model, train_volt_magpie
from ._common import as_f32, default_generator
from .basic_wind import basic_wind_rollouts

__all__ = ["main", "wind_volt_window"]


def load_wind(path: str, synthetic: bool = False, n_stations: int = 4,
              ntime: int = 4000):
    """``(names, lonlat, data)`` from the pickle at ``path``, or (with
    ``synthetic`` or no file) ``n_stations`` positive AR(1)-like series of
    ``ntime`` points from ``np.random.default_rng(0)``."""
    if not synthetic and os.path.exists(path):
        with open(path, "rb") as fh:
            names, lonlat, data = pickle.load(fh)
        return names, lonlat, data
    rng = np.random.default_rng(0)
    data = []
    for _ in range(n_stations):
        x = np.abs(rng.standard_normal(ntime)).astype(np.float32)
        for t in range(1, ntime):
            x[t] = 0.95 * x[t - 1] + 0.3 * abs(rng.standard_normal()) + 0.05
        data.append(x)
    names = {i: f"synthetic{i}" for i in range(n_stations)}
    return names, None, data


def wind_volt_window(train_x, train_y, test_x, mean: str, nsample: int,
                     theta: float = 0.01, k: int = 400, generator=None,
                     device="cuda"):
    """One volt window (reference ``GPGenerator.py:62-105``): log samples
    ``(nsample, H)``."""
    generator = default_generator(generator, device)
    train_x, test_x = as_f32(train_x, device), as_f32(test_x, device)
    train_y = as_f32(train_y, device)
    vol = learn_gpcv(train_x, train_y, train_iters=200)
    vol_state = train_vol_model(train_x, vol, train_iters=500)
    if mean == "constant":
        model = train_volt_magpie(train_x, train_y[1:], vol_state, vol,
                                  train_iters=200, mean_func="constant")
    else:
        model = train_volt_magpie(train_x, train_y[1:], vol_state, vol,
                                  train_iters=0, mean_func="ewma", k=k)
    return rollouts(generator, model, train_x, train_y, test_x,
                    nsample=nsample, theta=theta)


def main(args):
    device = args.device
    names, _, full_data = load_wind(args.wind_data, args.synthetic)
    stn = args.stn_idx
    ntrain, ntest = args.ntrain, args.forecast_horizon
    stn_data = np.asarray(full_data[stn], np.float32).copy()
    stn_data[stn_data == -99.0] = 0.0
    if stn_data.mean() == 0:
        print("empty station", stn)
        return

    ntime = stn_data.shape[0]
    test_idxs = range(ntrain, ntime - ntest,
                      max(int((ntime - ntest - ntrain) / args.n_test_times), 1))
    n_x = ntrain - 1 if args.kernel == "volt" else ntrain
    train_x = torch.arange(n_x, dtype=torch.float32, device=device) / 365
    test_x = torch.arange(ntrain, ntrain + ntest, dtype=torch.float32,
                          device=device) / 365

    savepath = os.path.join(args.outdir, f"stn{stn}")
    os.makedirs(savepath, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(stn)
    for last_day in test_idxs:
        train_y = as_f32(stn_data[last_day - ntrain:last_day] + 1, device)
        if args.kernel == "volt":
            theta = 0.01
            samples = wind_volt_window(train_x, train_y, test_x, args.mean,
                                       args.nsample, theta=theta,
                                       generator=generator, device=device)
            tag = (f"volt_theta{theta}" if args.mean == "constant"
                   else f"volt_ema400_theta{theta}")
        else:
            samples = basic_wind_rollouts(
                train_x, train_y, test_x, kernel_name=args.kernel,
                mean_name=args.mean, k=200, train_iters=args.train_epochs,
                nsample=200, generator=generator, device=device)
            tag = f"{args.kernel}_{args.mean}200"
        np.save(os.path.join(savepath, f"{tag}_{last_day}.npy"),
                samples.cpu().numpy())
        print("stn", stn, "idx", last_day)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--stn_idx", type=int, default=0)
    p.add_argument("--mean", type=str, default="constant")
    p.add_argument("--n_test_times", type=int, default=10)
    p.add_argument("--forecast_horizon", type=int, default=100)
    p.add_argument("--kernel", type=str, default="matern")
    p.add_argument("--ntrain", type=int, default=400)
    p.add_argument("--nsample", type=int, default=1000)
    p.add_argument("--train_epochs", type=int, default=500)
    p.add_argument("--wind_data", type=str, default="./wind_data.p")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--outdir", type=str, default="./saved-outputs")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())

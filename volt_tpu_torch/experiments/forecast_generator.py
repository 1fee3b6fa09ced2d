"""Stock backtest CLI (port of
:mod:`volt_tpu.experiments.forecast_generator`; reference
``experiments/stocks/ForecastGenerator.py``).

Flags as the reference's.  Prices come from per-ticker CSVs (``--csv_dir``,
the yfinance ``DataGetter`` dump layout, read with the ``csv`` module),
from live yfinance when it is installed, or from the synthetic SDE
generator (``--synthetic``, and the fallback when both fail), seeded per
ticker.

Usage::

    python -m volt_tpu_torch.experiments.forecast_generator --device cuda \\
        --ticker_fname test_tickers --kernel volt --mean ewma --ntimes 25 \\
        --save
"""

from __future__ import annotations

import argparse
import csv
import os
import zlib

import numpy as np

from ..data import make_ticker_list
from ..data.synthetic import sabr_paths
from .generate_preds import (generate_basic_predictions,
                             generate_stock_predictions)

__all__ = ["main"]


def load_prices(ticker: str, history: int, csv_dir=None,
                synthetic: bool = False, seed: int = 0):
    """``(prices, dates or None)`` for one ticker: the last ``history``
    closes (float32) and their dates."""
    if csv_dir:
        path = os.path.join(csv_dir, f"{ticker}.csv")
        if os.path.exists(path):
            with open(path, newline="") as fh:
                rows = list(csv.DictReader(fh))
            close = np.asarray([float(r["Close"]) for r in rows],
                               np.float32)[-history:]
            dates = ([r["Date"] for r in rows][-history:]
                     if rows and "Date" in rows[0] else None)
            return close, dates
    if not synthetic:
        try:
            from ..data.tickers import get_stock_history

            df = get_stock_history(ticker, history=history)
            return df["Close"].to_numpy(np.float32), [
                str(d.date()) for d in df.index]
        except Exception:
            pass
    # a stable per-ticker seed: str hash() is salted per process
    f, _ = sabr_paths(steps=history, seed=zlib.crc32(ticker.encode()),
                      F0=100.0, V0=0.2)
    return f, None


def main(args):
    for tckr in make_ticker_list(args.ticker_fname + ".txt"):
        try:
            prices, dates = load_prices(tckr, args.ntrain + args.lookback,
                                        args.csv_dir, args.synthetic)
            if args.kernel.lower() == "volt":
                generate_stock_predictions(
                    tckr, prices, dates=dates,
                    forecast_horizon=args.forecast_horizon,
                    train_iters=args.train_iters, nsample=args.nsample,
                    mean=args.mean, ntrain=args.ntrain, save=args.save,
                    ntimes=args.ntimes, k=args.k, outdir=args.outdir,
                    device=args.device)
            else:
                generate_basic_predictions(
                    tckr, prices, args.kernel, dates=dates,
                    mean_name=args.mean, k=args.k,
                    forecast_horizon=args.forecast_horizon,
                    train_iters=args.train_iters, nsample=args.nsample,
                    ntrain=args.ntrain, save=args.save, ntimes=args.ntimes,
                    outdir=args.outdir, device=args.device)
            print("done", tckr)
        except Exception as e:  # per-ticker skip, as the reference's
            print("FAILED", tckr, e)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ticker_fname", type=str, default="test_tickers")
    p.add_argument("--ntrain", type=int, default=400)
    p.add_argument("--ntimes", type=int, default=25)
    p.add_argument("--forecast_horizon", type=int, default=100)
    p.add_argument("--kernel", type=str, default="volt")
    p.add_argument("--mean", type=str, default="ewma")
    p.add_argument("--nsample", type=int, default=1000)
    p.add_argument("--train_iters", type=int, default=300)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--lookback", type=int, default=500)
    p.add_argument("--end_date", type=str, default="none")
    p.add_argument("--save", action="store_true")
    p.add_argument("--csv_dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--outdir", type=str, default="./saved-outputs")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())

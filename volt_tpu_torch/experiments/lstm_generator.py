"""LSTM baseline backtest CLI (port of
:mod:`volt_tpu.experiments.lstm_generator`; reference
``experiments/stocks/LSTMGenerator.py`` and ``LSTMUtils.py``).

Per window: the log prices, normalised; the LSTM fitted by Adam(0.01) on
the Gaussian NLL; ``nsample`` paths sampled autoregressively over the
horizon and de-normalised.  A ticker that fails is printed and skipped,
as in the reference.

Usage::

    python -m volt_tpu_torch.experiments.lstm_generator --device cuda \\
        --ticker_fname test_tickers --csv_dir prices/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import make_ticker_list
from ..models.lstm import train_lstm
from .forecast_generator import load_prices
from .generate_preds import rolling_windows

__all__ = ["main"]


def main(args):
    device = args.device
    for tckr in make_ticker_list(args.ticker_fname + ".txt"):
        try:
            prices, dates = load_prices(tckr, args.ntrain + args.lookback,
                                        args.csv_dir, args.synthetic)
            ends = rolling_windows(prices, args.ntrain, args.ntimes)
            savepath = os.path.join(args.outdir, tckr)
            os.makedirs(savepath, exist_ok=True)
            generator = torch.Generator(device=device).manual_seed(0)
            for e in ends:
                label = str(dates[e]) if dates is not None else str(e)
                log_y = np.log(prices[e - args.ntrain:e].astype(np.float32))
                state = train_lstm(
                    log_y, seq_len=args.seq_length, hidden_size=128,
                    num_layers=1, epochs=args.train_epochs,
                    batch_size=args.batch_size, generator=generator,
                    device=device)
                samples = state.forecast(generator, args.forecast_horizon,
                                         args.nsample)
                np.save(os.path.join(savepath, f"lstm_{label}.npy"),
                        samples.cpu().numpy())
            print("done", tckr)
        except Exception as e:
            print("FAILED", tckr, e)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ticker_fname", type=str, default="test_tickers")
    p.add_argument("--ntrain", type=int, default=400)
    p.add_argument("--ntimes", type=int, default=25)
    p.add_argument("--forecast_horizon", type=int, default=20)
    p.add_argument("--seq_length", type=int, default=25)
    p.add_argument("--nsample", type=int, default=1000)
    p.add_argument("--train_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lookback", type=int, default=500)
    p.add_argument("--end_date", type=str, default="none")
    p.add_argument("--csv_dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--outdir", type=str, default="./saved-outputs")
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())

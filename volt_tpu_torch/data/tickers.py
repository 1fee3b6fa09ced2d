"""Ticker universes and market-data ingestion (a copy of
:mod:`volt_tpu.data.tickers`, which the port keeps because importing the
JAX package pulls in JAX).

The universes (S&P 500 / Nasdaq-100 / test sets) ship as plain data files.
Live ingestion (yfinance / robinhood, reference ``voltron/data/MakeData.py``
and ``voltron/robinhood_utils.py``) is an optional edge: its packages are
imported inside the functions, which raise a clear ``ImportError`` when
one is missing (yfinance, and the pandas it returns, are not needed for
anything else: the backtests read the CSV dumps with the ``csv`` module).
"""

from __future__ import annotations

import datetime
import os

__all__ = [
    "make_ticker_list",
    "ticker_file_path",
    "make_price_files",
    "data_getter",
    "get_stock_history",
    "get_stock_data",
]

_DATA_DIR = os.path.dirname(__file__)


def ticker_file_path(name: str = "test_tickers.txt") -> str:
    return os.path.join(_DATA_DIR, name)


def make_ticker_list(file_name: str):
    """Read one ticker per line (reference ``MakeData.py:7-10``)."""
    if not os.path.exists(file_name):
        file_name = ticker_file_path(file_name)
    with open(file_name) as fh:
        return [line.strip() for line in fh if line.strip()]


def _require_yfinance():
    try:
        import yfinance as yf  # type: ignore
    except ImportError as e:
        raise ImportError(
            "yfinance is not installed; market ingestion "
            "is an optional data edge (reference voltron/data/MakeData.py)"
        ) from e
    return yf


def make_price_files(tickers, start, end, fpath, printing: bool = False):
    """Download and dump per-ticker CSVs (reference ``MakeData.py:12-21``)."""
    yf = _require_yfinance()
    for t in tickers:
        history = yf.download(tickers=t, start=start, end=end, progress=False)
        history.to_csv(os.path.join(fpath, f"{t}.csv"))
        if printing:
            print(t)


def data_getter(history: int = 500, fpath: str = "../data/",
                printing: bool = False, end_date=None,
                ticker_file: str = "test_tickers.txt"):
    """Reference ``MakeData.DataGetter:24-35``."""
    if end_date is None:
        end_date = datetime.date.today()
    else:
        end_date = datetime.datetime.strptime(end_date, "%Y-%m-%d").date()
    start_date = end_date - datetime.timedelta(history)
    tickers = make_ticker_list(os.path.join(fpath, ticker_file))
    make_price_files(tickers, start_date, str(end_date), fpath, printing)


def get_stock_history(ticker: str, end_date=None, history: int = 500):
    """10-year download sliced to a window (reference ``MakeData.py:37-42``)."""
    yf = _require_yfinance()
    import numpy as np
    import pandas as pd  # yfinance's own dependency

    if end_date is None:
        end_date = str(datetime.date.today())
    end = datetime.datetime.strptime(end_date, "%Y-%m-%d").date()
    data = yf.download(tickers=ticker, period="10y", progress=False)
    end_idx = np.where(data.index == pd.to_datetime(end))[0][0]
    return data.iloc[end_idx - history:end_idx]


def get_stock_data(symbols, interval: str = "day", span: str = "5year"):
    """Robinhood OHLC fetch (reference ``robinhood_utils.py:6-22``)."""
    try:
        import robin_stocks.robinhood as r  # type: ignore
        from dotenv import load_dotenv  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise ImportError("robin_stocks / python-dotenv not installed") from e
    import pandas as pd

    load_dotenv()
    r.login(os.getenv("robinhood_username"), os.getenv("robinhood_password"))
    data = pd.DataFrame(r.stocks.get_stock_historicals(symbols, interval, span))
    data["date"] = pd.to_datetime(data["begins_at"], format="%Y-%m-%d").dt.date
    ohlc = ["open_price", "close_price", "high_price", "low_price"]
    data[ohlc] = data[ohlc].astype("float")
    return data[["date", "symbol", *ohlc]]

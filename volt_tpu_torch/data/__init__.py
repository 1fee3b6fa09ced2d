"""Host-side data for the port (numpy only): the synthetic SDE generator,
the evaluation universes, the ticker lists and the ingestion edges, and
the offline fixtures (two tickers in the yfinance ``DataGetter`` CSV
layout, two truncated USCRN station files) under :func:`fixtures_dir`."""

import os as _os

from .synthetic import sabr_paths
from .tickers import make_ticker_list, ticker_file_path
from .universes import (corrvol_windows, gbm_windows, gusty_wind_windows,
                        sabr_windows, wind_windows)

__all__ = ["sabr_paths", "make_ticker_list", "ticker_file_path",
           "corrvol_windows", "gbm_windows", "gusty_wind_windows",
           "sabr_windows", "wind_windows", "fixtures_dir"]


def fixtures_dir() -> str:
    """The vendored offline ingestion sample: the ingestion -> backtest
    path runs with no network access."""
    return _os.path.join(_os.path.dirname(__file__), "fixtures")

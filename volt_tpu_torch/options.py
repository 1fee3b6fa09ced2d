"""Option valuation from Monte-Carlo price paths (port of
:mod:`volt_tpu.options`).

The reference's ``option_utils.py``: call payoffs averaged over sampled
paths per expiry and strike, set beside the bid/ask quotes, and the
empirical-CDF percentile of the realised price among the samples.  The
payoff runs over the whole ``strike x expiry`` grid in one broadcast
(:func:`price_call_grid`) on the samples' device; pandas appears only at
the DataFrame edge (:func:`pricer`), imported there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ecdf",
    "price_call_grid",
    "price_put_grid",
    "pricer",
    "get_training_data",
    "get_true_value",
    "get_trading_days",
    "find_last_trading_days",
    "ECDF",
    "Pricer",
]


def _t(a, like=None):
    if torch.is_tensor(a):
        return a
    device = like.device if like is not None else None
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def ecdf(sample_pxs, true_px):
    """Fraction of the sampled prices whose log is below the realised
    price's log, over the last axis (``option_utils.py:48-51``)."""
    smp = torch.log(_t(sample_pxs))
    true = torch.log(_t(true_px, smp))
    return torch.mean((smp < true).to(torch.float32), dim=-1)


def price_call_grid(mc_pxs, strikes):
    """``mean(max(S - K, 0))`` over the paths: ``mc_pxs (n_paths,
    n_expiries)``, ``strikes (n_strikes,)`` -> ``(n_strikes,
    n_expiries)``."""
    mc_pxs = _t(mc_pxs)
    strikes = _t(strikes, mc_pxs)
    payoff = torch.clamp(mc_pxs[None, :, :] - strikes[:, None, None], min=0.0)
    return torch.mean(payoff, dim=1)


def price_put_grid(mc_pxs, strikes):
    """``mean(max(K - S, 0))`` over the same grid (no reference analogue;
    ``call - put = mean(S) - K`` on the same paths)."""
    mc_pxs = _t(mc_pxs)
    strikes = _t(strikes, mc_pxs)
    payoff = torch.clamp(strikes[:, None, None] - mc_pxs[None, :, :], min=0.0)
    return torch.mean(payoff, dim=1)


def pricer(mc_pxs, options, edays, true_pxs, quote_price):
    """The option-chain valuation DataFrame (the reference's ``Pricer``,
    ``option_utils.py:26-45``).

    ``mc_pxs``: ``(n_paths, n_expiries)`` MC prices; ``options``: a
    DataFrame with ``expiration``, ``strike``, ``bid`` and ``ask``;
    ``edays``: the expiry dates of ``mc_pxs``'s columns; ``true_pxs``: the
    realised price at each expiry.  Needs pandas.
    """
    import pandas as pd

    mc = (mc_pxs.detach().cpu().numpy() if torch.is_tensor(mc_pxs)
          else np.asarray(mc_pxs))
    true_pxs = (true_pxs.detach().cpu().numpy() if torch.is_tensor(true_pxs)
                else np.asarray(true_pxs))
    logger = []
    for eday_idx, eday in enumerate(edays):
        eday = pd.Timestamp(eday)
        year = pd.DatetimeIndex([eday])[0].year
        opts = options[options.expiration == eday]
        if len(opts) == 0:
            continue
        strikes = np.asarray(opts.strike.to_numpy(), np.float32)
        vals = price_call_grid(mc[:, eday_idx:eday_idx + 1],
                               strikes)[:, 0].numpy()
        pct = float(ecdf(mc[:, eday_idx], float(true_pxs[eday_idx])))
        for i, (_, row) in enumerate(opts.iterrows()):
            rtn = max(true_pxs[eday_idx] - row.strike, 0.0)
            logger.append([
                eday, row.strike, row.bid, row.ask, float(vals[i]),
                float(rtn), float(true_pxs[eday_idx]), quote_price, year,
                pct,
            ])
    # the columns go to the constructor, so that an empty chain gives an
    # empty frame with the schema
    return pd.DataFrame(
        logger,
        columns=["Expiry", "Strike", "Bid", "Ask", "Voltron", "Return",
                 "ExpClose", "QuoteClose", "Year", "Sample_Percentile"],
    )


# --- pandas date helpers (option_utils.py:6-24) ----------------------------


def get_training_data(spy, date, n):
    idx = spy[spy["Date"] == date].index.item()
    return spy["Close"].iloc[(idx - n):idx]


def get_true_value(spy, date, strike):
    close_px = spy["Close"][spy["Date"] == date].item()
    return np.maximum(close_px - strike, 0)


def get_trading_days(spy, start, stop):
    start_idx = spy[spy["Date"] == start].index.item()
    stop_idx = spy[spy["Date"] == stop].index.item()
    return stop_idx - start_idx


def find_last_trading_days(spy, dates):
    last_days = [np.max(np.where(spy.Date < date)[0]) for date in dates]
    return np.array(spy.Date[last_days])


# Reference-style aliases
ECDF = ecdf
Pricer = pricer

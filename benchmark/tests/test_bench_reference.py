"""The frozen reference against the port's CPU path at a tiny size: in
float32 they compute the same fit and forecast (the data MLL by its scan
form against the Kalman loop), so the check's numbers of the port's own
outputs against the reference in float32 sit at rounding."""

import torch
from conftest import load, shrink

import cells
from entries.common import call_seed


def _items(entry, prices, kept, seed):
    return [{"kept": kept, "prev": None, "shift": 0, "prices": prices,
             "iters": entry.cfg["pipeline"]["gpcv_iters"],
             "seed": call_seed(seed, 0),
             "rows": list(range(len(entry.watch)))}]


def test_batched_reference_matches_the_port():
    spec = shrink(load("sp500.backtest"), assets=4)
    spec["config"]["check_assets"] = 4
    entry = cells.entry("batched").Entry(spec["config"], "cpu", 9)
    from sabr import sabr_prices
    prices = sabr_prices(torch.Generator().manual_seed(9), 4, 60,
                         **spec["config"]["sabr"])
    out, aux = entry.call(prices, entry.settings(), None,
                          entry.noise(call_seed(9, 0)))
    kept = entry.keep(entry.deliver(out, aux), aux)
    items = _items(entry, prices, kept, 9)
    got = entry.numbers(items, entry.reference(items, dtype=torch.float32))
    assert got["vol_gap"] < 1e-4 and got["loss_gap"] < 1e-5
    assert got["data_gap"] < 1e-4
    assert got["fan_gap"] < 1e-5 and got["std_gap"] < 1e-4
    # a forecast from the program's own fitted state, no step taken
    roll = [dict(it, prev=kept, iters=0) for it in items]
    got = entry.numbers(roll, entry.reference(roll, dtype=torch.float32))
    assert got["fan_gap"] < 1e-5 and got["std_gap"] < 1e-4


def test_multitask_reference_matches_the_port():
    spec = shrink(load("mt505.live_refit"), assets=3)
    entry = cells.entry("multitask").Entry(spec["config"], "cpu", 9)
    from sabr import sabr_prices
    prices = sabr_prices(torch.Generator().manual_seed(9), 3, 60,
                         **spec["config"]["sabr"])
    out, aux = entry.call(prices, entry.settings(), None,
                          entry.noise(call_seed(9, 0)))
    kept = entry.keep(entry.deliver(out, aux), aux)
    items = _items(entry, prices, kept, 9)
    got = entry.numbers(items, entry.reference(items, dtype=torch.float32))
    assert got["vol_gap"] < 1e-4 and got["loss_gap"] < 1e-5
    assert got["data_gap"] < 1e-4
    assert got["fan_gap"] < 1e-5 and got["std_gap"] < 1e-4
    # a forecast from the program's own fitted state, no step taken
    roll = [dict(it, prev=kept, iters=0) for it in items]
    got = entry.numbers(roll, entry.reference(roll, dtype=torch.float32))
    assert got["fan_gap"] < 1e-5 and got["std_gap"] < 1e-4

"""Option pricing from Volt forecasts: the reference's ``option_utils``
flow (``Pricer``/``ECDF``, ``option_utils.py:26-51``) end to end:

1. simulate a price history (SABR, known dynamics),
2. fit the Volt pipeline and draw a Monte-Carlo forecast fan,
3. value a strike x expiry call grid from the sampled paths
   (``price_call_grid``) plus an option-chain DataFrame through ``pricer``
   (where pandas is installed),
4. check put-call parity and the realised-price percentile.

Run:  python -m volt_tpu_torch.examples.option_pricing [--device cpu]
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch

from ..data import sabr_paths
from ..options import ecdf, price_call_grid, price_put_grid, pricer
from ..parallel import PipelineConfig, fit_forecast_batch
from ._common import parser


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--ntrain", type=int, default=252)
    p.add_argument("--horizon", type=int, default=60)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--nsample", type=int, default=1000)
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    ntrain, horizon = args.ntrain, args.horizon
    dt = 1.0 / 252
    prices, _ = sabr_paths(steps=ntrain + horizon, seed=3, n_paths=1)
    prices = np.atleast_2d(np.asarray(prices, np.float32))
    spot = float(prices[0, ntrain - 1])

    train_x = torch.arange(ntrain - 1, dtype=torch.float32, device=dev) * dt
    test_x = (torch.arange(horizon, dtype=torch.float32, device=dev) * dt
              + train_x[-1] + dt)
    cfg = PipelineConfig(gpcv_iters=args.iters, vol_iters=args.iters,
                         data_iters=args.iters, mean_func="ewma", k=50,
                         nsample=args.nsample)
    g = torch.Generator(device=dev).manual_seed(0)
    samples, aux = fit_forecast_batch(
        g, train_x, torch.tensor(prices[:, :ntrain], device=dev), test_x,
        cfg)
    if not bool(aux["ok"].all()):
        raise RuntimeError("the fit failed")
    mc_pxs = torch.exp(samples[0])  # (S, H) price paths

    # strike x expiry call/put grids straight from the MC paths
    expiry_idx = np.array([horizon // 4, horizon // 2, horizon - 1])
    strikes = torch.tensor(spot * np.linspace(0.9, 1.1, 5), dtype=torch.float32,
                           device=dev)
    px_at_exp = mc_pxs[:, torch.as_tensor(expiry_idx, device=dev)]
    calls = price_call_grid(px_at_exp, strikes).cpu().numpy()
    puts = price_put_grid(px_at_exp, strikes).cpu().numpy()
    fwd = px_at_exp.mean(dim=0).cpu().numpy()
    strikes_np = strikes.cpu().numpy()

    print(f"spot {spot:.2f}; call values (rows = strikes, cols = expiry "
          f"days {[int(i) + 1 for i in expiry_idx]}):")
    for k, row in zip(strikes_np, calls):
        print("  K=%7.2f  " % k + "  ".join(f"{v:7.3f}" for v in row))
    parity_gap = np.abs((calls - puts) - (fwd[None, :]
                                          - strikes_np[:, None]))
    print(f"put-call parity max gap: {parity_gap.max():.4f} (0 for "
          f"undiscounted MC by construction)")

    true_pxs = prices[0, ntrain + expiry_idx]
    # the reference-style option-chain DataFrame through pricer(), which
    # needs pandas
    if importlib.util.find_spec("pandas") is None:
        print("(pandas is not installed: the option-chain table of "
              "pricer() is left out)")
    else:
        import pandas as pd

        edays = pd.bdate_range("2024-01-02", periods=horizon)[expiry_idx]
        chain = pd.DataFrame({
            "expiration": np.repeat(edays, len(strikes_np)),
            "strike": np.tile(strikes_np, len(edays)),
            "bid": 0.0, "ask": 0.0,
        })
        df = pricer(px_at_exp, chain, edays, true_pxs, spot)
        print(df.head(len(strikes_np)).to_string(index=False))

    pct = float(ecdf(mc_pxs[:, -1], float(true_pxs[-1])))
    print(f"realized-price percentile at the last expiry: {pct:.2f} "
          f"(calibrated forecasts put this ~Uniform(0,1))")
    return {"calls": calls, "puts": puts, "forwards": fwd,
            "parity_gap": float(parity_gap.max()), "percentile": pct}


if __name__ == "__main__":
    main()

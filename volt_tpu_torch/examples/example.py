"""End-to-end walkthrough: the reference's ``example.ipynb`` as a script.

Simulates a SABR-like SDE with known volatility, runs the full two-stage
pipeline (GPCV volatility inference -> vol GP -> Volt price model), draws
hierarchical forecasts (vol paths x price paths), and reports how well the
learned volatility tracks the truth.

Run:  python -m volt_tpu_torch.examples.example [--steps 400
      --gpcv_iters 500] [--device cpu] [--plot example_output.png]
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import sabr_paths
from ..rollouts import generate_prediction
from ..train import learn_gpcv, train_data_model, train_vol_model
from ._common import parser, pyplot


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--gpcv_iters", type=int, default=500)
    p.add_argument("--vol_iters", type=int, default=500)
    p.add_argument("--data_iters", type=int, default=400)
    p.add_argument("--plot", metavar="PATH",
                   help="save the tutorial's 3-panel figure there")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    # --- synthetic SDE with known vol (example.ipynb cells 2-3) ---
    f, v_true = sabr_paths(steps=args.steps, seed=2019)
    n = args.steps - 1
    t_max = 1.0
    dt = t_max / args.steps
    train_x = torch.linspace(0, t_max, n, device=dev) + dt
    test_x = torch.linspace(t_max + dt, 1.5 * t_max, args.steps // 2 - 1,
                            device=dev) + dt
    prices = torch.tensor(f, device=dev)

    # --- stage 1: GPCV (cells 8-9) ---
    vol = learn_gpcv(train_x, prices, train_iters=args.gpcv_iters,
                     printing=True)
    truth = torch.tensor(v_true[1:], device=dev)
    err = float(torch.mean(torch.abs(vol - truth)) / torch.mean(truth))
    print(f"\nlearned vol vs truth: mean |rel err| = {err:.3f}")

    # --- stage 2: vol GP (cell 11) ---
    vol_state = train_vol_model(train_x, vol, train_iters=args.vol_iters,
                                printing=True)

    # --- stage 3: Volt data model (cell 12) ---
    model = train_data_model(train_x, prices[1:], vol_state, vol,
                             train_iters=args.data_iters, printing=True)

    # --- hierarchical sampling: nvol vol paths x npx price paths (cell 15)
    nvol, npx = 8, 1
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        vol_paths = torch.exp(vol_state.sample(test_x, (nvol,), g))
    px_paths = torch.exp(generate_prediction(g, model, test_x, vol_paths,
                                             n_sample=npx)
                         ).reshape(nvol * npx, -1)

    print(f"\nforecast horizon: {test_x.shape[0]} steps")
    print(f"vol paths:   {tuple(vol_paths.shape)}  "
          f"(mean {float(vol_paths.mean()):.3f})")
    print(f"price paths: {tuple(px_paths.shape)}  "
          f"(start {float(px_paths[:, 0].mean()):.2f} "
          f"vs last price {float(prices[-1]):.2f})")

    q = np.quantile(px_paths.cpu().numpy(), [0.1, 0.5, 0.9], axis=0)
    print("\nforecast fan (10/50/90% quantiles at horizon end):",
          [round(float(x), 2) for x in q[:, -1]])

    if args.plot:
        make_figure(args.plot, train_x.cpu().numpy(), f, v_true,
                    vol.cpu().numpy(), test_x.cpu().numpy(),
                    vol_paths.cpu().numpy(), px_paths.cpu().numpy())
    return {"vol_rel_err": err, "vol_paths": vol_paths,
            "px_paths": px_paths}


def make_figure(out_path, train_x, prices, v_true, vol, test_x, vol_paths,
                px_paths):
    """The tutorial's 3-panel figure (example.ipynb cell 17): data and vol,
    learned against true vol with forecasts, price forecasts."""
    plt = pyplot()
    fig, ax = plt.subplots(3, 1, figsize=(8, 10), dpi=100)
    plt.subplots_adjust(hspace=0.3)

    ax[0].plot(train_x, prices[1:], label="Data", alpha=0.8)
    ax0b = ax[0].twinx()
    ax0b.plot(train_x, v_true[1:], color="tab:orange", label="Volatility")
    ax[0].set_ylabel("Price")
    ax0b.set_ylabel("Vol")
    ax[0].set_title("data and true volatility")

    ax[1].plot(train_x, v_true[1:], color="tab:orange", alpha=0.75,
               label="True Vol.")
    ax[1].plot(train_x, vol, color="tab:purple", label="Learned Vol.")
    ax[1].plot(test_x, vol_paths.T, color="tab:red", alpha=0.4)
    ax[1].set_ylabel("Vol")
    ax[1].legend(loc="upper left")
    ax[1].set_title("GPCV volatility recovery + forecasts")

    ax[2].plot(train_x, prices[1:], alpha=0.8, label="Data")
    ax[2].plot(test_x, px_paths.T, color="tab:green", alpha=0.6)
    ax[2].set_ylabel("Price")
    ax[2].set_xlabel("t")
    ax[2].set_title("Monte-Carlo price forecasts")
    fig.savefig(out_path, bbox_inches="tight")
    print("figure saved to", out_path)


if __name__ == "__main__":
    main()

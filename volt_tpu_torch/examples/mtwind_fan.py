"""Multitask wind forecast quantile fans: the ``mtwind_plotting`` analog.

The reference's multitask wind notebook loads the saved rollout dict
(``x_paths`` / ``names_list``) and draws a per-station forecast fan over
the observed series.  This example generates a small correlated-station
wind universe (a squared-OU surrogate with a shared innovation, so the
stations co-move), runs the multitask producer
(:func:`volt_tpu_torch.experiments.mt_wind.run_multitask_wind`: per-station
GPCV, the Kronecker multitask vol GP, jointly correlated rollouts), prints
the 90% band's coverage of the held-out truth and, with ``--plot``, draws
the fan per station.

Run:  python -m volt_tpu_torch.examples.mtwind_fan [--device cpu]
      [--plot mtwind_fan.png]
"""

from __future__ import annotations

import numpy as np

from ..experiments.mt_wind import run_multitask_wind
from ._common import parser, pyplot


def make_stations(rng, t_stations, n, rho=0.02, sig=0.25, share=0.6):
    """Correlated squared-OU stations: shared and own innovations.  Returns
    the raw series (``run_multitask_wind`` applies the reference's ``-99 ->
    0`` and ``+1`` itself)."""
    x = np.empty((t_stations, n))
    x[:, 0] = 0.5 * rng.standard_normal(t_stations)
    z_shared = rng.standard_normal(n)
    z_own = rng.standard_normal((t_stations, n))
    z = np.sqrt(share) * z_shared[None, :] + np.sqrt(1 - share) * z_own
    for i in range(1, n):
        x[:, i] = (1.0 - rho) * x[:, i - 1] + sig * z[:, i]
    return (2.0 * x * x).astype(np.float32)  # level - 1 (run adds the +1)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--stations", type=int, default=4)
    ap.add_argument("--ntrain", type=int, default=300)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--nsample", type=int, default=512)
    ap.add_argument("--gpcv-iters", type=int, default=150)
    ap.add_argument("--vol-iters", type=int, default=300)
    ap.add_argument("--k", type=int, default=100,
                    help="EWMA window (the sweep's best wind config)")
    ap.add_argument("--theta", type=float, default=0.05)
    ap.add_argument("--plot", metavar="PATH",
                    help="save the per-station fans there")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(11)
    series = make_stations(rng, args.stations, args.ntrain + args.horizon)
    names = {i: f"Station_{i}" for i in range(args.stations)}
    result = run_multitask_wind(
        names, series[:, :args.ntrain], ntrain=args.ntrain,
        forecast_horizon=args.horizon, nsample=args.nsample,
        gpcv_iters=args.gpcv_iters, vol_iters=args.vol_iters, k=args.k,
        theta=args.theta, device=args.device)
    # x_paths are log levels (the rollouts sample log space)
    paths = np.exp(np.asarray(result["x_paths"]))  # (T, S, H)
    truth = series + 1.0                            # the +1-shifted level
    if args.plot:
        plot(args.plot, paths, truth, result["names_list"], args.ntrain,
             args.horizon)
    # the 90% fan should cover most held-out points
    cover = np.mean(
        (truth[:, args.ntrain:] >= np.quantile(paths, 0.05, axis=1))
        & (truth[:, args.ntrain:] <= np.quantile(paths, 0.95, axis=1)))
    print(f"90% band empirical coverage over held-out horizon: {cover:.3f}")
    return {"paths": paths, "coverage": float(cover)}


def plot(out, paths, truth, names, ntrain, horizon):
    """One panel per station: nested central intervals, light to dark in
    one hue, the median darkest, the observed series in neutral ink."""
    plt = pyplot()
    t_stations = paths.shape[0]
    ncols = 2
    nrows = (t_stations + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(11, 3.2 * nrows),
                             dpi=110, sharex=True)
    axes = np.atleast_1d(axes).ravel()
    tx = np.arange(ntrain)
    hx = np.arange(ntrain, ntrain + horizon)
    bands = [(0.05, 0.95, "#c6dbef", "90%"),
             (0.15, 0.85, "#9ecae1", "70%"),
             (0.25, 0.75, "#6baed6", "50%")]
    for i in range(t_stations):
        ax = axes[i]
        qs = {p: np.quantile(paths[i], p, axis=0)
              for p in {q for lo, hi, *_ in bands for q in (lo, hi)}}
        for lo, hi, color, label in bands:
            ax.fill_between(hx, qs[lo], qs[hi], color=color, lw=0,
                            label=f"{label} interval" if i == 0 else None)
        ax.plot(hx, np.median(paths[i], axis=0), color="#2171b5", lw=1.6,
                label="median forecast" if i == 0 else None)
        ax.plot(np.r_[tx[-60:], hx], truth[i, max(ntrain - 60, 0):],
                color="#333333", lw=1.2,
                label="observed" if i == 0 else None)
        ax.axvline(ntrain - 0.5, color="#999999", lw=0.8, ls=":")
        ax.set_title(names[i], fontsize=10)
        ax.grid(alpha=0.25, lw=0.5)
        ax.set_ylabel("wind level (+1)")
    for ax in axes[t_stations:]:
        ax.set_visible(False)
    axes[0].legend(loc="upper left", fontsize=8, framealpha=0.9)
    fig.suptitle("Multitask wind forecast fans (correlated stations, "
                 "Kronecker vol GP)", fontsize=12)
    fig.supxlabel("day")
    fig.tight_layout()
    fig.savefig(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()

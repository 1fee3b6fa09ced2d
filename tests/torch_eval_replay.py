"""The baseline lanes of ``eval_compare`` on the JAX package's own draws,
through the port on the card and on the CPU: whether a baseline metric
that lies far from JAX's comes from the random stream or from the port.

Four cases, each at ``eval_compare``'s settings (H=20, S=256, 400 Adam
steps for the exact GPs, an LSTM of hidden 64 for 40 epochs):

* the Matérn and spectral-mixture lanes on GBM at W=4 (ntrain 252, EWMA
  k=50), as the ``evaluation`` phase runs them;
* the spectral-mixture lane on WIND and the LSTM lane on WINDGUST, on the
  first ``WIND_W`` windows of the universes that ``eval_compare
  --windows 32 --ntrain 400`` draws (EWMA k=399, the wind settings), the
  rows of the full-size table that lay far from ``EVALUATION.md``.

``dump`` runs the JAX tool's lanes there (key 0, as ``tools/eval_compare.py``
draws it) and writes their samples, metrics and every draw they made: per
window the initial tree (of ``make_basic_model``, or the LSTM's flax
tree), the LSTM's per-epoch permutations, and the rollout's normals.
For the LSTM it also runs the JAX tool with every price 1 to ``NUDGES``
float32 steps up: its training over 40 epochs carries a rounding
difference from 1e-5 to O(1) in the loss, so those runs' distances from
JAX's are the yardstick for the port's.  ``run`` puts those draws through the port's lanes on
each device it names and prints, per case and device, the metrics beside
JAX's and the largest distance of the port's log samples from JAX's and
from the first device's; on the card the LSTM lane runs twice, at PyTorch's default
precision (cuDNN may use TF32) and with TF32 off.  Run from the
repository root::

    JAX_PLATFORMS=cpu python tests/torch_eval_replay.py dump REPLAY.npz
    python tests/torch_eval_replay.py run REPLAY.npz --devices cuda,cpu

``dump`` imports JAX, the JAX tools and ``test_torch_eval``'s replay of
their draws; ``run`` imports only the port, so it runs where JAX is not
installed.  ``--cases`` picks cases by name.  Not collected by pytest.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
H, S, BASIC_ITERS, LSTM_EPOCHS = 20, 256, 400, 40
WIND_W = 8
NUDGES = 4
# name: (universe, lane, windows, ntrain, EWMA k)
CASES = {
    "gbm-matern": ("GBM", "matern", 4, 252, 50),
    "gbm-sm": ("GBM", "sm", 4, 252, 50),
    "wind-sm": ("WIND", "sm", WIND_W, 400, 399),
    "windgust-lstm": ("WINDGUST", "lstm", WIND_W, 400, None),
}


def prices(universe, w, ntrain):
    """The case's windows as ``eval_compare`` draws them: GBM at ``w``
    windows (the first draw of ``default_rng(7)``); the wind universes at
    32 windows, after GBM's draw, cut to their first ``w``."""
    from volt_tpu_torch.data import (gbm_windows, gusty_wind_windows,
                                     wind_windows)

    rng = np.random.default_rng(7)
    if universe == "GBM":
        return gbm_windows(rng, w, ntrain, H)
    gbm_windows(rng, 32, ntrain, H)
    wind = wind_windows(rng, 32, ntrain, H)
    if universe == "WINDGUST":
        wind = gusty_wind_windows(rng, 32, ntrain, H)
    return wind[:w]


def _flatten(tree, prefix, out):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flatten(leaf, f"{prefix}{name}/", out)
        else:
            out[prefix + name] = np.asarray(leaf)


def _unflatten(arrays, prefix):
    tree = {}
    for key, value in arrays.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def dump(path, cases):
    import jax

    jax.config.update("jax_platforms", "cpu")
    # the JAX tool and the draws of its lanes, by its own key recipe
    from test_torch_eval import _jax_basic_draws, _jax_lstm_draws, jec

    arrays, meta = {}, {"jax": jax.__version__}
    for case in cases:
        universe, lane, w, ntrain, k = CASES[case]
        p = prices(universe, w, ntrain)
        truth = np.log(p[:, ntrain:])
        t0 = time.perf_counter()
        if lane == "lstm":
            samples = jec.lstm_lane(p, ntrain, H, LSTM_EPOCHS, S)
            inits, perms, zs = _jax_lstm_draws(p, ntrain, H, LSTM_EPOCHS, S)
            # JAX against itself: the same draws, every price 1 to NUDGES
            # float32 steps up (the training's sensitivity to rounding)
            nudged, q = [], p
            for _ in range(NUDGES):
                q = np.nextafter(q, np.float32(np.inf))
                nudged.append(jec.lstm_lane(q, ntrain, H, LSTM_EPOCHS, S))
            yardstick = {
                "metrics_nudged": [jec.metrics(a, truth) for a in nudged],
                "max_abs_nudged": max(float(np.abs(a - samples).max())
                                      for a in nudged)}
        else:
            samples = jec.basic_lane(p, ntrain, H, BASIC_ITERS, S, k, lane)
            inits, zs = _jax_basic_draws(p, lane, ntrain, H, S, k)
            perms = [None] * w
            yardstick = {}
        meta[case] = {"metrics": jec.metrics(samples, truth),
                      "s": round(time.perf_counter() - t0, 1), **yardstick}
        arrays[f"{case}:samples"] = samples.astype(np.float32)
        for widx in range(w):
            _flatten(inits[widx], f"{case}:init{widx}/", arrays)
            arrays[f"{case}:zs{widx}"] = zs[widx].numpy()
            if perms[widx] is not None:
                arrays[f"{case}:perm{widx}"] = perms[widx].numpy()
        print(json.dumps({"case": case, "jax_key0": meta[case]}), flush=True)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


@contextlib.contextmanager
def _cudnn_tf32(torch, allow):
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = flag


def run(path, devices, cases):
    import torch

    from volt_tpu_torch.tools import eval_compare as tec

    arrays = dict(np.load(path))
    meta = json.loads(arrays.pop("meta").tobytes().decode())
    results = []
    for case in cases:
        if case not in meta:
            continue
        universe, lane, w, ntrain, k = CASES[case]
        p = prices(universe, w, ntrain)
        truth = np.log(p[:, ntrain:])
        want = arrays[f"{case}:samples"]
        inits = [_unflatten(arrays, f"{case}:init{i}/") for i in range(w)]
        zs = [torch.from_numpy(arrays[f"{case}:zs{i}"]) for i in range(w)]
        # on the card the LSTM also runs with cuDNN's TF32 off
        runs = [(dev, True) for dev in devices] + [
            ("cuda", False) for dev in devices
            if lane == "lstm" and dev == "cuda"]
        first = None
        for dev, tf32 in runs:
            t0 = time.perf_counter()
            with _cudnn_tf32(torch, tf32):
                if lane == "lstm":
                    perms = [torch.from_numpy(arrays[f"{case}:perm{i}"])
                             for i in range(w)]
                    got = tec.lstm_lane(p, ntrain, H, LSTM_EPOCHS, S,
                                        device=dev, init_params=inits,
                                        perms=perms,
                                        zs=[z.to(dev) for z in zs])
                else:
                    got = tec.basic_lane(p, ntrain, H, BASIC_ITERS, S, k,
                                         lane, device=dev,
                                         init_params=inits,
                                         zs=[z.to(dev) for z in zs])
            secs = time.perf_counter() - t0
            first = got if first is None else first
            label = dev if tf32 else f"{dev} (TF32 off)"
            row = {"case": case, "device": label,
                   "metrics": tec.metrics(got, truth),
                   "jax_key0": meta[case]["metrics"],
                   **{k: v for k, v in meta[case].items()
                      if k.endswith("nudged")},
                   "max_abs_from_jax": float(np.abs(got - want).max()),
                   f"max_abs_from_{devices[0]}":
                       float(np.abs(got - first).max()),
                   "max_abs_log_y": float(np.abs(want).max()),
                   "s": round(secs, 1)}
            if dev == "cuda":
                row["card"] = torch.cuda.get_device_name(0)
            print(json.dumps(row), flush=True)
            results.append(row)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("dump", "run"))
    ap.add_argument("path")
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated subset of {','.join(CASES)}")
    a = ap.parse_args(argv)
    cases = a.cases.split(",")
    if a.what == "dump":
        dump(a.path, cases)
    else:
        run(a.path, a.devices.split(","), cases)


if __name__ == "__main__":
    main()

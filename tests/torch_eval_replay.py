"""The baseline lanes of ``eval_compare`` on the JAX package's own draws,
through the port on the card and on the CPU: whether a baseline metric of
the ``evaluation`` phase that lies far from JAX's comes from the random
stream or from the card.

The phase runs the Matérn and spectral-mixture lanes on GBM at W=4
(ntrain 252, H=20, S=256, 400 Adam steps, EWMA k=50).  ``dump`` runs the
JAX tool's ``basic_lane`` there (key 0, as ``tools/eval_compare.py``
prints it) and writes its samples, metrics and every draw it made: per
window the initial tree of ``make_basic_model`` and the rollout's normals.
``run`` puts those draws through the port's ``basic_lane`` on each device
it names and prints, per lane and device, the metrics beside JAX's and the
largest distance of the port's log samples from JAX's and from the first
device's.  Run from the repository root::

    JAX_PLATFORMS=cpu python tests/torch_eval_replay.py dump REPLAY.npz
    python tests/torch_eval_replay.py run REPLAY.npz --devices cuda,cpu

``dump`` imports JAX, the JAX tools and ``test_torch_eval``'s replay of
their draws; ``run`` imports only the port, so it runs where JAX is not
installed.  Not collected by pytest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
W, NTRAIN, H, S, ITERS, K = 4, 252, 20, 256, 400, 50
LANES = {"matern-ewma": "matern", "sm-ewma": "sm"}


def prices():
    """GBM's windows as both tools draw them (the first draw of
    ``default_rng(7)``)."""
    from volt_tpu_torch.data import gbm_windows

    return gbm_windows(np.random.default_rng(7), W, NTRAIN, H)


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


def dump(path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    # the JAX tool and the draws of its basic_lane, by its own key recipe
    from test_torch_eval import _jax_basic_draws, jec

    p = prices()
    truth = np.log(p[:, NTRAIN:])
    arrays, meta = {}, {"jax": jax.__version__}
    for lane, kernel_name in LANES.items():
        t0 = time.perf_counter()
        samples = jec.basic_lane(p, NTRAIN, H, ITERS, S, K, kernel_name)
        meta[lane] = {"metrics": jec.metrics(samples, truth),
                      "s": round(time.perf_counter() - t0, 1)}
        arrays[f"{lane}:samples"] = samples.astype(np.float32)
        inits, zs = _jax_basic_draws(p, kernel_name, NTRAIN, H, S, K)
        for widx in range(W):
            _flatten(inits[widx], f"{lane}:init{widx}/", arrays)
            arrays[f"{lane}:zs{widx}"] = zs[widx].numpy()
        print(json.dumps({"lane": lane, "jax_key0": meta[lane]}), flush=True)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def run(path, devices):
    import torch

    from volt_tpu_torch.tools import eval_compare as tec

    arrays = dict(np.load(path))
    meta = json.loads(arrays.pop("meta").tobytes().decode())
    p = prices()
    truth = np.log(p[:, NTRAIN:])
    results = []
    for lane, kernel_name in LANES.items():
        want = arrays[f"{lane}:samples"]
        inits = [_unflatten(arrays, f"{lane}:init{w}/") for w in range(W)]
        zs = [torch.from_numpy(arrays[f"{lane}:zs{w}"]) for w in range(W)]
        first = None
        for dev in devices:
            t0 = time.perf_counter()
            got = tec.basic_lane(p, NTRAIN, H, ITERS, S, K, kernel_name,
                                 device=dev, init_params=inits,
                                 zs=[z.to(dev) for z in zs])
            secs = time.perf_counter() - t0
            first = got if first is None else first
            row = {"lane": lane, "device": dev,
                   "metrics": tec.metrics(got, truth),
                   "jax_key0": meta[lane]["metrics"],
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
    a = ap.parse_args(argv)
    if a.what == "dump":
        dump(a.path)
    else:
        run(a.path, a.devices.split(","))


if __name__ == "__main__":
    main()

"""The port's examples (``python -m volt_tpu_torch.examples.<name>``) at
tiny arguments on the CPU, each with finite outputs, the figures under
``--plot`` only; and ``graft_entry.entry``'s step against the JAX
package's Volt MLL on the same series."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close

from volt_tpu.models.volt import VoltGP as JVolt
from volt_tpu.models.volt import make_mean as j_make_mean

from volt_tpu_torch import graft_entry

TINY = {
    "example": ["--steps", "60", "--gpcv_iters", "5", "--vol_iters", "5",
                "--data_iters", "5"],
    "live_serving": ["--assets", "2", "--steps", "40", "--ticks", "2",
                     "--horizon", "5", "--iters", "5", "--warm-iters", "3",
                     "--nsample", "16"],
    "long_series": ["--steps", "300", "--horizon", "5", "--iters", "5",
                    "--nsample", "16", "--k", "20"],
    "multi_asset": ["--assets", "3", "--steps", "40", "--iters", "5"],
    "option_pricing": ["--ntrain", "60", "--horizon", "12", "--iters", "5",
                       "--nsample", "64"],
    "calibration_study": ["--windows", "3", "--ntrain", "40", "--horizon",
                          "4", "--iters", "5", "--nsample", "32"],
    "mtwind_fan": ["--stations", "2", "--ntrain", "40", "--horizon", "5",
                   "--nsample", "32", "--gpcv-iters", "5", "--vol-iters",
                   "5", "--k", "10"],
}
PLOTS = ("example", "calibration_study", "mtwind_fan")


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(np.isfinite(tree))
    arr = tree.detach().cpu().numpy() if torch.is_tensor(tree) \
        else np.asarray(tree)
    return bool(np.isfinite(arr.astype(np.float64)).all())


@pytest.mark.parametrize("name", sorted(TINY))
def test_example_runs(name, tmp_path, capsys):
    mod = importlib.import_module(f"volt_tpu_torch.examples.{name}")
    argv = ["--device", "cpu", *TINY[name]]
    if name in PLOTS:
        argv += ["--plot", str(tmp_path / "fig.png")]
    out = mod.main(argv)
    assert _finite(out)
    assert capsys.readouterr().out.strip()
    if name in PLOTS:
        assert (tmp_path / "fig.png").stat().st_size > 0
    # nothing else written where it ran
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        (["fig.png"] if name in PLOTS else [])


def test_entry_step_on_the_cpu():
    """The step's MLL is the JAX package's Volt MLL of the same series (the
    dense exact MLL there, the Kalman filter here); the paths are finite."""
    step, args = graft_entry.entry("cpu")
    mll, samples = step(*args)
    assert samples.shape == (32, 16) and bool(torch.isfinite(samples).all())
    _, x, y, vol, _ = args
    volt = JVolt(mean=j_make_mean("ewma", k=25))
    want = volt.mll(volt.init(), jnp.asarray(x.numpy()),
                    jnp.asarray(y.numpy()), jnp.asarray(vol.numpy()))
    close(mll, np.asarray(want), 1e-4)

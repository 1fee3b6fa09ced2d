"""``volt_tpu_torch.utils``: checkpoints of fitted states round trip to
identical forecasts on the same draws (as ``tests/test_utils_checkpoint.py``
checks the JAX package's orbax checkpoints), and the profiling helpers."""

import json

import numpy as np
import pytest
import torch

from torch_parity import close

from volt_tpu_torch.convert import load_jax_params, params_tree
from volt_tpu_torch.data import sabr_paths
from volt_tpu_torch.models import BMGP, MultitaskBMGP, VoltGP, make_mean
from volt_tpu_torch.models.multitask import MultitaskBMGPState
from volt_tpu_torch.rollouts import rollouts
from volt_tpu_torch.train import learn_gpcv, train_vol_model, \
    train_volt_magpie
from volt_tpu_torch.utils import (annotate, restore_pytree,
                                  restore_volt_state, save_pytree,
                                  save_volt_state, timed, timed_best, trace)

N, DT = 40, 1.0 / 252


@pytest.fixture(scope="module")
def fitted():
    f, _ = sabr_paths(steps=N + 1, seed=77)
    y = torch.tensor(f)
    x = torch.arange(N, dtype=torch.float32) * DT
    vol = learn_gpcv(x, y, train_iters=10)
    vol_state = train_vol_model(x, vol, train_iters=10)
    model = train_volt_magpie(x, y[1:], vol_state, vol, train_iters=10, k=20,
                              mean_func="ewma")
    return x, y, model


def test_volt_state_roundtrip(tmp_path, fitted):
    x, y, model = fitted
    path = str(tmp_path / "volt.pt")
    save_volt_state(path, model)
    restored = restore_volt_state(path, VoltGP(mean=make_mean("ewma", k=20)),
                                  BMGP())
    for key in ("train_x", "train_y", "log_vol_path"):
        close(getattr(restored, key), getattr(model, key), 0.0)
    close(params_tree(restored.module), params_tree(model.module), 0.0)
    close(params_tree(restored.vol_state.module),
          params_tree(model.vol_state.module), 0.0)
    # the restored state forecasts identically on the same draws
    test_x = torch.arange(4, dtype=torch.float32) * DT + x[-1] + DT
    s1 = rollouts(torch.Generator().manual_seed(0), model, x, y, test_x,
                  nsample=8)
    s2 = rollouts(torch.Generator().manual_seed(0), restored, x, y, test_x,
                  nsample=8)
    close(s2, s1, 0.0)


def test_multitask_state_roundtrip(tmp_path):
    t, n = 3, 12
    mt = MultitaskBMGP(num_tasks=t, rank=1).init(
        generator=torch.Generator().manual_seed(2))
    x = torch.arange(n, dtype=torch.float32) * 0.01
    y = np.log(0.2) + 0.1 * torch.randn(n, t,
                                        generator=torch.Generator()
                                        .manual_seed(3))
    state = mt.fit_state(x, y)
    path = str(tmp_path / "mt.pt")
    save_pytree(path, {"params": params_tree(mt), "train_x": x,
                       "train_y": y})
    fresh = MultitaskBMGP(num_tasks=t, rank=1).init(
        generator=torch.Generator().manual_seed(0))
    like = {"params": params_tree(fresh), "train_x": torch.zeros_like(x),
            "train_y": torch.zeros_like(y)}
    tree = restore_pytree(path, like)
    restored = MultitaskBMGPState(
        module=load_jax_params(fresh, tree["params"]),
        train_x=tree["train_x"], train_y=tree["train_y"])
    test_x = x[-1] + x[:4] + 0.01
    with torch.no_grad():
        s1, s2 = (st.sample_forecast(test_x, 6,
                                     torch.Generator().manual_seed(5))
                  for st in (state, restored))
    close(s2, s1, 0.0)


def test_restore_checks_the_template(tmp_path):
    path = str(tmp_path / "tree.pt")
    save_pytree(path, {"a": torch.ones(3), "b": {"c": torch.zeros(2)}})
    got = restore_pytree(path, {"a": torch.zeros(3, dtype=torch.float64),
                                "b": {"c": torch.zeros(2)}})
    assert got["a"].dtype == torch.float64
    for like in ({"a": torch.zeros(4), "b": {"c": torch.zeros(2)}},
                 {"a": torch.zeros(3)}):
        with pytest.raises(ValueError):
            restore_pytree(path, like)


def test_timed():
    out, secs = timed(lambda a: a * 2.0, torch.ones(16), warmup=1, repeats=3)
    close(out, torch.full((16,), 2.0), 0.0)
    assert secs >= 0.0
    out, best = timed_best(lambda: {"x": [torch.ones(2)]}, repeats=2)
    assert best >= 0.0 and out["x"][0].shape == (2,)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("volt-step"):
            torch.ones(8) @ torch.ones(8)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "volt-step" for e in events)
    assert any(k.key == "volt-step" for k in prof.key_averages())

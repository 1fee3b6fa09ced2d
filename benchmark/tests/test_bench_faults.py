"""The check sees a broken timed path: each fault that a cell can have,
planted in the program under a shrunk run of the harness (the look for a
card skipped), makes ``correct`` false; and the control, the reference a
precision below float32 in the program's place, fails a limit.  A cell
runs on one card, so no exchange between cards can be left out."""

import pytest
import torch

import volt_tpu_torch.parallel as parallel
import volt_tpu_torch.train as train
from volt_tpu_torch.optim import Adam

CELLS = ["sp500.backtest", "sp500.live_refit", "mt505.live_refit"]


def _half(loss_fn):
    """The losses with the upper half of the assets (tasks) left out."""
    def masked():
        loss = loss_fn()
        if loss.dim() == 0:
            return loss
        keep = torch.ones_like(loss)
        keep[loss.shape[0] // 2:] = 0
        return loss * keep
    return masked


def _altered(fit):
    """The entry with its answer altered where it is produced: the fan's
    quantile levels in reverse order."""
    def wrapped(*args, **kwargs):
        out, aux = fit(*args, **kwargs)
        return out.flip(-2), aux
    return wrapped


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload):
    assert tiny(workload)["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged(tiny, workload, monkeypatch):
    monkeypatch.setattr(Adam, "step", lambda self: None)
    assert tiny(workload)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_assets_left_out(tiny, workload, monkeypatch):
    loop = train.adam_loop
    monkeypatch.setattr(train, "adam_loop", lambda module, loss_fn, *a:
                        loop(module, _half(loss_fn), *a))
    assert tiny(workload, assets=4)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered(tiny, workload, monkeypatch):
    for name in ("fit_forecast_batch", "fit_forecast_multitask"):
        monkeypatch.setattr(parallel, name, _altered(getattr(parallel, name)))
    assert tiny(workload)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_train_mean_altered(tiny, workload, monkeypatch):
    """K1's output, the EWMA train mean, off by a hundredth where it is
    produced: the data fit's loss and parameters move."""
    from volt_tpu_torch.means.means import EWMAMean
    train_values = EWMAMean.train_values
    monkeypatch.setattr(EWMAMean, "train_values",
                        lambda self, y: train_values(self, y) * 1.01)
    assert tiny(workload)["correct"] is False


def _bfloat16(t):
    return t.to(torch.bfloat16).to(t.dtype)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(tiny, workload):
    from conftest import load
    limits = load(workload)["limits"]
    res = tiny(workload, control=_bfloat16)
    assert res["correct"] is True
    numbers = res["control"]["numbers"]
    assert set(limits) <= set(numbers)
    assert any(numbers[k] > limits[k] for k in limits)
    assert res["control"]["correct"] is False

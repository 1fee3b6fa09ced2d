"""The port's public surface against the JAX package's: every module of
``volt_tpu_torch`` that has a counterpart in ``volt_tpu`` exports each
name of that module's ``__all__``, less the names listed here with the
ROADMAP.md item that ports them (or the reason the port has no use for
them), as ``tests/test_api_surface.py`` checks the JAX package's own
surface."""

import importlib
import importlib.util
import pkgutil

import pytest

import volt_tpu_torch

# name -> the ROADMAP.md item that ports it, or why the port leaves it out
NOT_YET = {
    # "Do not port": ``ConfigEq`` keys jax.jit's static-argument cache; the
    # port's modules are nn.Modules and its configs frozen dataclasses
    "ConfigEq": "do not port",
}


def _pairs():
    pairs = []
    for info in pkgutil.walk_packages(volt_tpu_torch.__path__,
                                      "volt_tpu_torch."):
        ref = info.name.replace("volt_tpu_torch", "volt_tpu", 1)
        try:
            found = importlib.util.find_spec(ref) is not None
        except ModuleNotFoundError:  # no counterpart of its package either
            found = False
        if found:
            pairs.append((info.name, ref))
    return [("volt_tpu_torch", "volt_tpu"), *pairs]


@pytest.mark.parametrize("port,ref", _pairs(), ids=lambda s: s)
def test_port_exports_what_jax_exports(port, ref):
    want = getattr(importlib.import_module(ref), "__all__", ())
    mod = importlib.import_module(port)
    missing = [n for n in want if n not in NOT_YET and not hasattr(mod, n)]
    assert not missing, f"{port} lacks {missing}"
    exported = set(getattr(mod, "__all__", ()))
    unlisted = [n for n in want if hasattr(mod, n) and n not in exported
                and n not in NOT_YET]
    assert not unlisted, f"{port} does not list {unlisted} in __all__"


def test_reference_name_aliases():
    """The reference's names (ROADMAP item 5's aliases)."""
    from volt_tpu_torch import models, ops

    assert volt_tpu_torch.VoltronGP is volt_tpu_torch.VoltGP
    assert models.VoltMagpie is models.VoltGP
    assert models.SingleTaskVariationalGP is models.GPCVModel
    for name in ("BMKernel", "VolatilityKernel", "BMGP", "MultitaskBMGP"):
        assert name in volt_tpu_torch.__all__
    for name in ("mvn_kl", "add_jitter", "window_init", "window_append",
                 "window_value"):
        assert name in ops.__all__


def test_not_yet_names_are_absent_or_stubs():
    """A name listed as not ported is not silently exported as working:
    no module of the port has it (the last stub, ``train_basic_model``,
    went when the baselines were ported); the baselines' names are
    exported where the JAX package exports them."""
    for port, _ in _pairs():
        mod = importlib.import_module(port)
        present = [n for n in NOT_YET if hasattr(mod, n)]
        assert not present, f"{port} has {present}"
    from volt_tpu_torch import models, train

    assert volt_tpu_torch.nonvol_rollouts is volt_tpu_torch.rollouts \
        .nonvol_rollouts
    assert train.TrainBasicModel is train.train_basic_model
    assert models.LSTM is models.LSTMModel

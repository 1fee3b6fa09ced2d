"""Checkpoints of fitted states (port of :mod:`volt_tpu.utils.checkpoint`).

A state splits into a nested dict of tensors and the module's
configuration; the file holds the tensors (``torch.save``, read back with
``torch.load(weights_only=True)``, which unpickles tensors and containers
only), and the configuration travels with the caller's code, which builds
the module again.  The JAX package writes orbax checkpoints, which this
package cannot read without JAX: a JAX state reaches the port as arrays,
through :func:`volt_tpu_torch.convert.params_from_jax`.
"""

from __future__ import annotations

import os

import torch

from ..convert import load_jax_params, params_tree

__all__ = ["save_pytree", "restore_pytree", "save_volt_state",
           "restore_volt_state"]


def save_pytree(path: str, tree):
    """Save a nested dict of tensors to the file ``path``."""
    torch.save(tree, os.path.abspath(path))


def _check_like(tree, like, where="tree"):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"{where}: keys {sorted(tree)} are not the "
                             f"template's {sorted(like)}")
        return {k: _check_like(tree[k], like[k], f"{where}.{k}")
                for k in like}
    if tree.shape != like.shape:
        raise ValueError(f"{where}: shape {tuple(tree.shape)} is not the "
                         f"template's {tuple(like.shape)}")
    return tree.to(device=like.device, dtype=like.dtype)


def restore_pytree(path: str, like=None, map_location=None):
    """The tree saved by :func:`save_pytree`.  ``like``: an optional
    template of the same nesting (e.g. a freshly initialised state); the
    restored leaves must have its shapes, and take its dtypes and devices.
    ``map_location`` as ``torch.load`` takes it."""
    tree = torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
    return tree if like is None else _check_like(tree, like)


def save_volt_state(path: str, state):
    """Save a fitted :class:`~volt_tpu_torch.models.volt.VoltState`: the
    Volt module's parameters, its data and vol path, and, if attached, the
    vol GP's parameters and data."""
    arrays = {
        "params": params_tree(state.module),
        "train_x": state.train_x,
        "train_y": state.train_y,
        "log_vol_path": state.log_vol_path,
    }
    if state.vol_state is not None:
        arrays["vol_params"] = params_tree(state.vol_state.module)
        arrays["vol_train_x"] = state.vol_state.train_x
        arrays["vol_train_y"] = state.vol_state.train_y
    save_pytree(path, arrays)


def restore_volt_state(path: str, volt_module, vol_module=None,
                       map_location=None):
    """A :class:`~volt_tpu_torch.models.volt.VoltState` from a checkpoint
    and the modules of the caller's configuration (``VoltGP(mean=...)``,
    ``BMGP()``), whose parameters are set from the file; the vol state is
    attached when ``vol_module`` is given and the file has one."""
    from ..models.volt import VoltState

    saved = restore_pytree(path, map_location=map_location)
    device = saved["train_y"].device
    load_jax_params(volt_module, saved["params"], device)
    vol_state = None
    if vol_module is not None and "vol_params" in saved:
        load_jax_params(vol_module, saved["vol_params"], device)
        vol_state = vol_module.fit_state(saved["vol_train_x"],
                                         saved["vol_train_y"])
    return VoltState(module=volt_module, train_x=saved["train_x"],
                     train_y=saved["train_y"],
                     log_vol_path=saved["log_vol_path"], vol_state=vol_state)

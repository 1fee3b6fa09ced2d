"""Parameters between the JAX package's pytrees and the port's modules.

A JAX parameter pytree is a nested dict (``{"kernel": {"raw_vol": ...},
"variational_mean": ..., ...}``); the port's modules carry the same leaf
names at the same paths (``kernel.raw_vol``, ``variational_mean``).  The
pipeline's ``aux`` and warm starts use the same nested-dict layout.  A
baseline GP's tree (``{"kernel": ..., "mean": ..., "likelihood": ...}``,
a scaled kernel's base under ``base``) loads the same way.  A flax LSTM
tree has its own layout: :func:`lstm_params_from_flax` maps it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "load_jax_params", "params_tree",
           "lstm_params_from_flax"]


def params_from_jax(tree, device=None):
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes, or
    tensors) -> the same nesting of float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def load_jax_params(module: nn.Module, tree, device=None):
    """Set ``module``'s parameters from a nested dict by leaf path: each
    leaf becomes (or replaces) the ``nn.Parameter`` of that name on the
    submodule at its path.  Returns ``module``."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            load_jax_params(getattr(module, name), leaf, device)
        else:
            t = params_from_jax(leaf, device).clone()
            module.register_parameter(name, nn.Parameter(t))
    return module


def params_tree(module: nn.Module):
    """``module``'s parameters as a nested dict of detached tensors, with
    an entry for every submodule (empty for one without parameters)."""
    tree = {name: p.detach() for name, p in
            module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        tree[name] = params_tree(child)
    return tree


def lstm_params_from_flax(tree, device=None):
    """A flax tree of the JAX package's LSTM baseline (``OptimizedLSTMCell_{l}``
    with per-gate kernels ``i{g}`` (input, no bias) and ``h{g}`` (hidden,
    with the bias), gates ``i, f, g, o``; ``Dense_0``, ``Dense_1``) -> the
    ``state_dict`` of :class:`volt_tpu_torch.models.lstm._Net`: each
    ``torch.nn.LSTM`` weight stacks the four gates' transposed kernels in
    the same order, ``bias_hh`` carries flax's bias and ``bias_ih`` is
    zero."""
    t = params_from_jax(tree, device)
    out = {}
    layer = 0
    while f"OptimizedLSTMCell_{layer}" in t:
        cell = t[f"OptimizedLSTMCell_{layer}"]
        for side, name in (("i", "weight_ih"), ("h", "weight_hh")):
            out[f"lstm.{name}_l{layer}"] = torch.cat(
                [cell[f"{side}{g}"]["kernel"].T for g in "ifgo"])
        bias = torch.cat([cell[f"h{g}"]["bias"] for g in "ifgo"])
        out[f"lstm.bias_hh_l{layer}"] = bias
        out[f"lstm.bias_ih_l{layer}"] = torch.zeros_like(bias)
        layer += 1
    for i in (0, 1):
        out[f"dense{i}.weight"] = t[f"Dense_{i}"]["kernel"].T
        out[f"dense{i}.bias"] = t[f"Dense_{i}"]["bias"]
    return out

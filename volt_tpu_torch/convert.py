"""Parameters between the JAX package's pytrees and the port's modules.

A JAX parameter pytree is a nested dict (``{"kernel": {"raw_vol": ...},
"variational_mean": ..., ...}``); the port's modules carry the same leaf
names at the same paths (``kernel.raw_vol``, ``variational_mean``).  The
pipeline's ``aux`` and warm starts use the same nested-dict layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "load_jax_params", "params_tree"]


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

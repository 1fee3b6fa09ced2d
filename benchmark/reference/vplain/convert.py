"""Parameters between nested dicts and modules: the pipeline's ``aux``
and warm starts hold a module's parameters as a nested dict of tensors
(``{"kernel": {"raw_vol": ...}, "variational_mean": ..., ...}``) at the
paths of its submodules."""

from __future__ import annotations

from torch import nn


def load_params(module: nn.Module, tree, device=None):
    """Set ``module``'s parameters from a nested dict of tensors by leaf
    path: each leaf, in its own precision, becomes (or replaces) the
    ``nn.Parameter`` of that name on the submodule at its path.  Returns
    ``module``."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            load_params(getattr(module, name), leaf, device)
        else:
            t = leaf.detach().to(device=device).clone()
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

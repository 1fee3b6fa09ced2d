"""What the tools share: the ``--device`` argument, the forecast grids,
seeded generators, the move of results to numpy, and for the timing tools
the name of the device and the check of their outputs."""

from __future__ import annotations

import argparse

import numpy as np
import torch

DT = 1.0 / 252


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``: without a
    card the tools raise, they do not fall back to the CPU)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap


def grids(ntrain: int, h: int, device):
    """The return grid of ``ntrain - 1`` steps of ``DT`` from 0 and the
    ``h`` steps after it, float32 on ``device``."""
    train_x = torch.arange(ntrain - 1, dtype=torch.float32,
                           device=device) * DT
    test_x = (torch.arange(h, dtype=torch.float32, device=device) * DT
              + train_x[-1] + DT)
    return train_x, test_x


def seeded(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded ``seed`` (the JAX tools' key)."""
    return torch.Generator(device=device).manual_seed(seed)


def f32(a, device) -> torch.Tensor:
    """A numpy array as a float32 tensor on ``device``."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def numpy(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def per_window(items, widx):
    """Window ``widx``'s entry of an optional per-window list."""
    return None if items is None else items[widx]


def backend(device) -> str:
    """The name of the card under ``device``, or ``"cpu"`` (the JAX
    tools' ``backend`` key)."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def check_finite(a, what: str):
    """Raise ``AssertionError`` unless every value of ``a`` is finite."""
    if not np.isfinite(numpy(a)).all():
        raise AssertionError(f"{what}: non-finite values")

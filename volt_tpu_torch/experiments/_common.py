"""What the experiment drivers share: the deterministic means' names, the
default generator and the float32 conversion of their inputs."""

from __future__ import annotations

import torch

# the means whose joint posterior is sampled in one shot; the Magpie means
# go through the autoregressive rollout
DETERMINISTIC_MEANS = ("loglinear", "constant", "linear")


def default_generator(generator, device):
    """``generator``, or a new one on ``device`` seeded 0."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def as_f32(a, device):
    """An array or tensor as a float32 tensor on ``device``."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)

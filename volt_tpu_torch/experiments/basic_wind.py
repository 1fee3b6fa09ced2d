"""Baseline wind forecasters (port of :mod:`volt_tpu.experiments.basic_wind`;
reference ``experiments/weather/BasicWind.py``).

Kernel family {sm, matern, rbf} x mean family {ewma, dewma, tewma,
loglinear, linear, constant}; deterministic means sample the joint
posterior in one shot, Magpie means go through the autoregressive
``nonvol_rollouts``.  ``generator`` replaces the JAX ``key`` (default: one
seeded 0 on ``device``), and every driver runs on ``device`` (default
``"cuda"``; the CPU only when asked).
"""

from __future__ import annotations

import torch

from ..convert import load_jax_params
from ..kernels import (MaternKernel, RBFKernel, ScaleKernel,
                       SpectralMixtureKernel)
from ..means import (ConstantMean, DEWMAMean, EWMAMean, LinearMean,
                     LogLinearMean, TEWMAMean)
from ..models.basic import BasicGP
from ..rollouts import nonvol_rollouts
from ..train import _fit_basic
from ._common import DETERMINISTIC_MEANS, as_f32, default_generator

__all__ = ["basic_wind_rollouts", "make_basic_model"]

_KERNELS = {"sm": SpectralMixtureKernel, "matern": MaternKernel,
            "rbf": RBFKernel}


def _make_mean(mean_name: str, k: int):
    mean_name = mean_name.lower()
    if mean_name == "loglinear":
        return LogLinearMean(1)
    if mean_name == "linear":
        return LinearMean(1)
    if mean_name == "constant":
        return ConstantMean()
    if mean_name == "ewma":
        return EWMAMean(k)
    if mean_name == "dewma":
        return DEWMAMean(k)
    if mean_name == "tewma":
        return TEWMAMean(k)
    raise ValueError(f"unknown mean {mean_name!r}")


def make_basic_model(train_x, log_y, kernel_name: str, mean_name: str = "ewma",
                     k: int = 20, train_iters: int = 600,
                     num_mixtures: int = 20, generator=None,
                     init_params=None):
    """Build and fit the baseline exact GP on the log levels ``log_y``
    (reference ``BasicWind.py:26-69``): Adam(0.1) on its MLL.
    ``generator`` draws the random init (the spectral mixture's and its
    data-driven re-init, a linear mean's weights); ``init_params`` (the
    JAX package's initial tree, e.g. through :mod:`volt_tpu_torch.convert`)
    replaces that init."""
    kname = kernel_name.lower()
    if kname == "sm":
        kernel = SpectralMixtureKernel(num_mixtures=num_mixtures)
    else:
        kernel = ScaleKernel(_KERNELS[kname]())
    module = BasicGP(kernel, _make_mean(mean_name, k))
    generator = default_generator(generator, log_y.device)
    module.init(log_y.dtype, log_y.device, generator)
    if init_params is not None:
        load_jax_params(module, init_params, log_y.device)
    else:
        if kname == "sm":
            kernel.initialize_from_data(train_x, log_y, generator)
        if mean_name.lower() == "loglinear":
            module.mean.initialize_from_data(train_x, log_y)
    _fit_basic(module, train_x, log_y, train_iters, 0.1)
    return module.fit_state(train_x, log_y)


def basic_wind_rollouts(train_x, train_y, test_x, kernel_name: str,
                        mean_name: str = "ewma", k: int = 20,
                        train_iters: int = 600, nsample: int = 1000,
                        generator=None, device="cuda"):
    """Fit and forecast one window (reference ``BasicWindRollouts``): log
    samples ``(nsample, H)``."""
    generator = default_generator(generator, device)
    train_x, test_x = as_f32(train_x, device), as_f32(test_x, device)
    log_y = torch.log(as_f32(train_y, device))
    model = make_basic_model(train_x, log_y, kernel_name, mean_name, k,
                             train_iters, generator=generator)
    if mean_name.lower() in DETERMINISTIC_MEANS:
        return model.sample(generator, test_x, (nsample,))
    return nonvol_rollouts(generator, model, train_x, train_y, test_x,
                           nsample=nsample)

"""volt_tpu_torch — the PyTorch / CUDA port of :mod:`volt_tpu`.

The same two-stage GP (GPCV volatility inference, the vol GP, the Volt
data model, the Markov Monte-Carlo rollout) on an NVIDIA GPU, laid out
module for module like the JAX package, which stays the reference.  It
imports ``torch`` and numpy, never JAX.

The hand-written CUDA kernels live in ``csrc/`` and are built on first use
(:mod:`volt_tpu_torch.native`); every kernel has a plain PyTorch version
in the same module, which CPU tensors take.  This first slice covers the
main path, :func:`volt_tpu_torch.parallel.fit_forecast_batch` with the BM
kernel and the :class:`~volt_tpu_torch.parallel.PipelineConfig` defaults.
"""

__version__ = "0.1.0"

from . import convert, data, gp, kernels, likelihoods, means, models, ops
from . import parallel, rollouts, train
from .parallel import (PipelineConfig, fit_forecast, fit_forecast_batch,
                       warm_start)

__all__ = [
    "convert",
    "data",
    "gp",
    "kernels",
    "likelihoods",
    "means",
    "models",
    "ops",
    "parallel",
    "rollouts",
    "train",
    "PipelineConfig",
    "fit_forecast",
    "fit_forecast_batch",
    "warm_start",
    "__version__",
]

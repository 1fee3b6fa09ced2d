"""volt_tpu_torch — the PyTorch / CUDA port of :mod:`volt_tpu`.

The same two-stage GP (GPCV volatility inference, the vol GP, the Volt
data model, the Markov Monte-Carlo rollout) on an NVIDIA GPU, laid out
module for module like the JAX package, which stays the reference.  It
imports ``torch`` and numpy, never JAX.

The hand-written CUDA kernels live in ``csrc/`` and are built on first use
(:mod:`volt_tpu_torch.native`); every kernel has a plain PyTorch version
in the same module, which CPU tensors take.  Ported so far: the batched
main path, :func:`volt_tpu_torch.parallel.fit_forecast_batch` (BM kernel,
tridiagonal GPCV by Adam or NGVI, spectral or Kalman vol MLL, every mean),
the single-asset reference API: the training entries of
:mod:`volt_tpu_torch.train`, the forecasts of :mod:`volt_tpu_torch.rollouts`
and :class:`~volt_tpu_torch.models.Volt`; the GPCV families (the ``cv``
likelihood, the dense and sparse ``q``, prediction onto test grids); the
option layer: :mod:`volt_tpu_torch.options`,
:mod:`volt_tpu_torch.calibration` and
:func:`volt_tpu_torch.parallel.price_options_batch`; the FBM kernel
family (``PipelineConfig(kernel="fbm")``); and the Kronecker multitask
chain (:mod:`volt_tpu_torch.gp.kronecker`,
:mod:`volt_tpu_torch.models.multitask`,
:func:`volt_tpu_torch.parallel.fit_forecast_multitask`); the baselines
(the stationary kernels, :mod:`volt_tpu_torch.models.basic`,
``train_basic_model``, ``nonvol_rollouts``, the LSTM of
:mod:`volt_tpu_torch.models.lstm`); the data edges of
:mod:`volt_tpu_torch.data` and the backtest drivers and CLIs of
:mod:`volt_tpu_torch.experiments`; the scale-out layer
(:func:`volt_tpu_torch.parallel.make_mesh`, ``multihost_initialize`` and
``mesh=`` on the batched, multitask and pricing entries: run a world of
gloo ranks on the CPU with :func:`volt_tpu_torch.parallel.spawn_world` or
``torchrun --nproc-per-node``), checkpoints and profiling
(:mod:`volt_tpu_torch.utils`), the graft entry
(:mod:`volt_tpu_torch.graft_entry`) and the examples
(``python -m volt_tpu_torch.examples.<name> --device cuda``).  Not ported:
what ROADMAP.md's "Do not port" names.
"""

__version__ = "0.2.0"

from . import calibration, convert, data, gp, kernels, likelihoods, means
from . import models, ops, options, parallel, rollouts, train
from .kernels import BMKernel, VolatilityKernel
from .models import BMGP, MultitaskBMGP, Volt, VoltGP, VoltronGP
from .options import ECDF, Pricer, ecdf, pricer
from .parallel import (MultitaskPipelineConfig, PipelineConfig, fit_forecast,
                       fit_forecast_batch, fit_forecast_multitask, warm_start,
                       warm_start_multitask)
from .rollouts import generate_prediction
from .rollouts import generate_prediction as GeneratePrediction
from .rollouts import mean_prediction, nonvol_rollouts
from .rollouts import rollouts as Rollouts
from .rollouts import (rollouts_multitask, sample_prediction,
                       sample_vol_paths, volt_posterior)
from .train import (LearnGPCV, TrainBasicModel, TrainDataModel,
                    TrainVolModel, TrainVoltMagpieModel, learn_gpcv,
                    learn_gpcv_multitask, learn_gpcv_sparse,
                    train_basic_model, train_data_model, train_vol_model,
                    train_volt_magpie, train_volt_multitask)

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
    "options",
    "calibration",
    "Volt",
    "learn_gpcv",
    "learn_gpcv_sparse",
    "learn_gpcv_multitask",
    "train_vol_model",
    "train_data_model",
    "train_volt_magpie",
    "train_volt_multitask",
    "train_basic_model",
    "LearnGPCV",
    "TrainVolModel",
    "TrainDataModel",
    "TrainVoltMagpieModel",
    "TrainBasicModel",
    "Rollouts",
    "GeneratePrediction",
    "sample_vol_paths",
    "generate_prediction",
    "sample_prediction",
    "mean_prediction",
    "volt_posterior",
    "nonvol_rollouts",
    "rollouts_multitask",
    "PipelineConfig",
    "fit_forecast",
    "fit_forecast_batch",
    "warm_start",
    "MultitaskPipelineConfig",
    "fit_forecast_multitask",
    "warm_start_multitask",
    "ecdf",
    "pricer",
    "ECDF",
    "Pricer",
    # reference-style aliases (voltron/__init__.py:1-12)
    "BMKernel",
    "VolatilityKernel",
    "BMGP",
    "VoltGP",
    "VoltronGP",
    "MultitaskBMGP",
    "__version__",
]

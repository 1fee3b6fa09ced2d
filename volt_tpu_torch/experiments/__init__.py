"""Backtest drivers and CLIs (port of :mod:`volt_tpu.experiments`;
reference ``experiments/``).  Every driver runs on ``device`` (default
``"cuda"``) and takes a ``torch.Generator`` where the JAX package takes a
key; the CLIs take ``--device``."""

from .basic_wind import basic_wind_rollouts
from .generate_preds import (generate_basic_predictions,
                             generate_gpcv_predictions,
                             generate_one_day_predictions,
                             generate_stock_predictions)
from .mt_wind import run_multitask_wind

__all__ = [
    "basic_wind_rollouts",
    "generate_stock_predictions",
    "generate_one_day_predictions",
    "generate_basic_predictions",
    "generate_gpcv_predictions",
    "run_multitask_wind",
]

from .mesh import Mesh, make_mesh, multihost_initialize, spawn_world
from .pipeline import (PipelineConfig, fit_forecast, fit_forecast_batch,
                       shard_batch, warm_start)
from .pipeline_multitask import (MultitaskPipelineConfig,
                                 fit_forecast_multitask, warm_start_multitask)
from .pricing import price_options_batch

__all__ = ["Mesh", "make_mesh", "multihost_initialize", "spawn_world",
           "PipelineConfig", "fit_forecast", "fit_forecast_batch",
           "shard_batch", "warm_start", "price_options_batch",
           "MultitaskPipelineConfig", "fit_forecast_multitask",
           "warm_start_multitask"]

from .pipeline import (PipelineConfig, fit_forecast, fit_forecast_batch,
                       warm_start)

__all__ = ["PipelineConfig", "fit_forecast", "fit_forecast_batch",
           "warm_start"]

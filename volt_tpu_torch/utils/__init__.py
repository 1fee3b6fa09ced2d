"""Utilities: checkpoints of fitted states, profiling and timing."""

from .checkpoint import (restore_pytree, restore_volt_state, save_pytree,
                         save_volt_state)
from .profiling import (annotate, recording, spans, timed, timed_best,
                        timed_cold_best, trace)

__all__ = ["save_pytree", "restore_pytree", "save_volt_state",
           "restore_volt_state", "annotate", "recording", "spans", "trace",
           "timed", "timed_best", "timed_cold_best"]

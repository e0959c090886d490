"""Runtime utilities: logging, the phase timer, the profiler trace and the
debug mode."""

from glaze_tpu_torch.utils.log import get_logger, init as init_logging
from glaze_tpu_torch.utils.runtime import (Timer, profiler_trace,
                                           setup_debug_modes)

__all__ = ["Timer", "get_logger", "init_logging", "profiler_trace",
           "setup_debug_modes"]

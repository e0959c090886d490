"""Runtime utilities: logging, the recorder of spans and counters, the
profiler trace and the debug mode."""

from glaze_tpu_torch.utils.log import get_logger, init as init_logging
from glaze_tpu_torch.utils.runtime import (count, profiler_trace, recording,
                                           setup_debug_modes, span)

__all__ = ["count", "get_logger", "init_logging", "profiler_trace",
           "recording", "setup_debug_modes", "span"]

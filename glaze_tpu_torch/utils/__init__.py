"""Runtime utilities: logging, the phase timer and the profiler trace."""

from glaze_tpu_torch.utils.log import get_logger, init as init_logging
from glaze_tpu_torch.utils.runtime import Timer, profiler_trace

__all__ = ["Timer", "get_logger", "init_logging", "profiler_trace"]

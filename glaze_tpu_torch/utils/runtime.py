"""Runtime helpers: the CLI's phase timer and its profiler trace.

Copies of ``Timer`` and ``profiler_trace`` of ``glaze_tpu/utils/runtime.py``,
the trace on ``torch.profiler`` in place of ``jax.profiler``. The JAX
package's persistent compilation cache (``enable_compilation_cache``) and
its NaN-checking debug mode (``setup_debug_modes``, ``GLAZE_DEBUG``) are
JAX configuration and have no counterpart here: PyTorch runs eagerly and
compiles nothing at run time, and the CUDA kernels are built once into
``build/`` (:mod:`glaze_tpu_torch.cuda_build`).
"""

from __future__ import annotations

import os
import time

TRACE_FILE = "trace.json"


class profiler_trace:
    """Context manager: records a ``torch.profiler`` trace of the block's
    CPU activity, and its CUDA activity where a card is present, and
    writes it as a Chrome trace (``DIR/trace.json``, readable in
    chrome://tracing or Perfetto) when ``enabled``."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.path, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(os.path.join(self.path, TRACE_FILE))
            self._prof = None
        return False


class Timer:
    """Wall-clock phase timer (the CLI's setup/render ms reporting,
    cli/src/main.rs:96-120)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = {}

    def mark(self, name: str):
        now = time.perf_counter()
        self.marks[name] = now - self.t0
        self.t0 = now
        return self.marks[name]

"""Runtime helpers: the CLI's phase timer, its profiler trace and the
``GLAZE_DEBUG`` NaN checks.

Copies of ``Timer`` and ``profiler_trace`` of ``glaze_tpu/utils/runtime.py``,
the trace on ``torch.profiler`` in place of ``jax.profiler``.
``setup_debug_modes`` reads ``GLAZE_DEBUG`` as the JAX package does; where
that turns on ``jax_debug_nans``, here the renderer checks the path
state's float leaves for NaN after every launch (:func:`check_nans`) and
raises ``FloatingPointError`` naming the launch and the leaf. Off, no
check runs: no sync and no extra kernel. The JAX package's persistent
compilation cache (``enable_compilation_cache``) has no counterpart:
PyTorch runs eagerly and compiles nothing at run time, and the CUDA
kernels are built once into ``build/`` (:mod:`glaze_tpu_torch.cuda_build`).
"""

from __future__ import annotations

import os
import time

TRACE_FILE = "trace.json"

_debug_nans = False


def setup_debug_modes(force: bool | None = None) -> bool:
    """The reference's validation layers (debug.rs:83-165): with
    ``GLAZE_DEBUG`` set to anything but "" or "0" (or ``force=True``) the
    renderer checks its state for NaN after every launch. Returns whether
    enabled. Like the JAX package's, it turns the checks on and never
    off."""
    global _debug_nans
    enabled = (os.environ.get("GLAZE_DEBUG", "") not in ("", "0")
               if force is None else force)
    if enabled:
        _debug_nans = True
    return enabled


def debug_nans() -> bool:
    """True once :func:`setup_debug_modes` has turned the NaN checks on."""
    return _debug_nans


def check_nans(leaves, where: str):
    """Raises FloatingPointError at the first named float tensor of
    ``leaves`` ((name, tensor) pairs) that holds a NaN, naming ``where``
    and the leaf. Infinity passes: ray caps and ``t`` hold it in a correct
    render."""
    import torch

    for name, leaf in leaves:
        if leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
            n = int(torch.isnan(leaf).sum())
            raise FloatingPointError(
                f"GLAZE_DEBUG: NaN in {where}, leaf {name!r} "
                f"({n} of {leaf.numel()} values)")


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

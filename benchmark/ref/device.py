# Frozen copy of glaze_tpu_torch/device.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Device selection for the port's entry points.

Entry points (the renderer, the CLI, the scene upload) run on ``cuda``
unless the caller passes ``device="cpu"``. Asking for CUDA on a machine
without it raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises RuntimeError when a CUDA device is
    asked for and torch sees none."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' (CLI: --device cpu) to render on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: expected cuda or cpu")
    return dev

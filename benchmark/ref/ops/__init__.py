# Frozen copy of glaze_tpu_torch/ops/__init__.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Device math on torch tensors: rng, vectors, spectra, shading frames,
Fresnel, GGX microfacets and texture-atlas sampling."""

from __future__ import annotations

import numpy as np
import torch

_CONSTS: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A module-level NumPy table as a tensor on ``device``, copied once
    per (table, device). Only for constant tables that live for the whole
    process (the key is the array's identity)."""
    device = torch.device(device)
    key = (id(arr), device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(arr)).to(device)
        _CONSTS[key] = (arr, t)
        return t
    return t[1]

# Frozen copy of glaze_tpu_torch/ops/fresnel.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Fresnel reflectance (torch port of :mod:`glaze_tpu.ops.fresnel`,
lib/src/shaders/fresnel.glsl), transposed spectral layout."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_IOR = float(np.float32(1.000293))  # constants.glsl:8


def fresnel_conductor_t(cosin, ior, ior2abs2):
    """Spectral conductor Fresnel (fresnel.glsl:7-18): cosin (R,),
    ior / ior2abs2 (16, R) -> (16, R). ``ior2abs2`` is eta^2 + k^2,
    precomputed at upload (scene.rs:1834-1836)."""
    cosin2 = cosin * cosin
    etacosin2 = ior * (cosin * 2.0)
    etacosin2plus = etacosin2 + cosin2
    etacosin2plusplus = etacosin2 + 1.0
    rperpsq = (ior2abs2 - etacosin2plus) / (ior2abs2 + etacosin2plus)
    tmp = ior2abs2 * cosin2
    rparsq = (tmp - etacosin2plusplus) / (tmp + etacosin2plusplus)
    return (rperpsq + rparsq) * 0.5


def fresnel_dielectric(costi, etai, etat):
    """Scalar dielectric Fresnel (fresnel.glsl:20-37), batched. Returns 1.0
    on total internal reflection."""
    sin2ti = torch.clamp(1.0 - costi * costi, min=0.0)
    sin2tt = (etai * etai) / (etat * etat) * sin2ti
    costt = torch.sqrt(torch.clamp(1.0 - sin2tt, min=0.0))
    etatcostt = etat * costt
    etatcosti = etat * costi
    etaicosti = etai * costi
    etaicostt = etai * costt
    rparl = (etatcosti - etaicostt) / (etatcosti + etaicostt)
    rperp = (etaicosti - etatcostt) / (etaicosti + etatcostt)
    f = (rparl * rparl + rperp * rperp) * 0.5
    return torch.where(sin2tt >= 1.0, torch.ones_like(f), f)

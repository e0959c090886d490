# Frozen copy of glaze_tpu_torch/core/material.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Materials (port of lib/src/materials/material.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

from benchmark.ref.core.metal import Metal

# Number of material types dispatched by the shading kernels and the stride
# (value + sample) per type (material.rs:8-11).
SBT_MATERIAL_TYPES = 6
SBT_MATERIAL_STRIDE = 2


class MaterialType(IntEnum):
    """How light interacts with a material (material.rs:19-40)."""

    FLAT = 0
    LAMBERT = 1
    MIRROR = 2
    GLASS = 3
    METAL = 4
    FROSTED = 5
    UBER = 6
    # Internal version for two-sided preview polygons; never serialized.
    INTERNAL_FLAT_2SIDED = 7

    DEFAULT_MAT_TYPE = LAMBERT

    @property
    def display_name(self) -> str:
        return {
            0: "Flat", 1: "Lambert", 2: "Mirror", 3: "Glass",
            4: "Metal", 5: "Frosted", 6: "Generic (GGX)", 7: "Flat",
        }[int(self)]

    @staticmethod
    def from_id(mid: int) -> "MaterialType":
        if 0 <= mid <= 6:
            return MaterialType(mid)
        raise ValueError(f"Unknown material type: {mid}")

    @staticmethod
    def by_name() -> dict:
        """Lowercase user-facing name -> type (the ui.rs combo labels);
        canonical map shared by glaze-app and the viewer."""
        m = {t.display_name.lower(): t for t in MaterialType
             if t != MaterialType.INTERNAL_FLAT_2SIDED}
        m["uber"] = MaterialType.UBER  # alias for "generic (ggx)"
        return m

    @staticmethod
    def from_u8(mid: int) -> "MaterialType":
        try:
            return MaterialType.from_id(mid)
        except ValueError:
            return MaterialType.LAMBERT

    def id(self) -> int:
        if self == MaterialType.INTERNAL_FLAT_2SIDED:
            raise ValueError("Internal material types have no ID assigned")
        return int(self)

    @staticmethod
    def all_values():
        return [
            MaterialType.UBER, MaterialType.FLAT, MaterialType.LAMBERT,
            MaterialType.MIRROR, MaterialType.GLASS, MaterialType.METAL,
            MaterialType.FROSTED,
        ]

    def is_specular(self) -> bool:
        """Perfectly specular in all cases (material.rs:103-114)."""
        return self in (MaterialType.MIRROR, MaterialType.GLASS)

    def has_diffuse(self) -> bool:
        return self in (
            MaterialType.FLAT, MaterialType.LAMBERT, MaterialType.UBER,
            MaterialType.INTERNAL_FLAT_2SIDED,
        )

    def has_roughness(self) -> bool:
        return self in (MaterialType.METAL, MaterialType.FROSTED, MaterialType.UBER)

    def has_metalness(self) -> bool:
        return self == MaterialType.UBER

    def has_anisotropy(self) -> bool:
        return self in (MaterialType.METAL, MaterialType.FROSTED, MaterialType.UBER)

    def has_normal(self) -> bool:
        return True

    def has_opacity(self) -> bool:
        return True

    def is_fresnel_conductor(self) -> bool:
        return self in (MaterialType.MIRROR, MaterialType.METAL, MaterialType.UBER)

    def is_fresnel_dielectric(self) -> bool:
        return self in (MaterialType.GLASS, MaterialType.FROSTED, MaterialType.UBER)

    def has_emission(self) -> bool:
        return self in (MaterialType.FLAT, MaterialType.LAMBERT)

    def two_sided_viewport(self) -> "MaterialType":
        return MaterialType.INTERNAL_FLAT_2SIDED

    def bsdf_index(self) -> int:
        """Index of the BSDF kernel pair used by the integrator.

        Mirrors the reference's SBT callable layout (material.rs:244-258):
        light samplers occupy the first SBT_LIGHT_TYPES slots, followed by
        (value, sample) pairs per material family; FLAT shades as LAMBERT.
        """
        base_index = 4 * 1  # SBT_LIGHT_TYPES * SBT_LIGHT_STRIDE
        shader_index = {
            MaterialType.FLAT: 0, MaterialType.LAMBERT: 0,
            MaterialType.MIRROR: 1, MaterialType.GLASS: 2,
            MaterialType.METAL: 3, MaterialType.FROSTED: 4,
            MaterialType.UBER: 5,
        }.get(self)
        if shader_index is None:
            raise ValueError("This shader should not appear in the dispatch table")
        return base_index + shader_index * SBT_MATERIAL_STRIDE

    def bsdf_family(self) -> int:
        """Dense 0..5 BSDF family id used by the TPU shading kernels."""
        return {
            MaterialType.FLAT: 0, MaterialType.LAMBERT: 0,
            MaterialType.MIRROR: 1, MaterialType.GLASS: 2,
            MaterialType.METAL: 3, MaterialType.FROSTED: 4,
            MaterialType.UBER: 5,
        }[self]


@dataclass
class Material:
    """Surface description of a mesh (material.rs:285-343)."""

    name: str = "default"
    mtype: MaterialType = MaterialType.LAMBERT
    metal: Metal = Metal.SILVER
    ior: float = 1.46
    diffuse: int = 0  # texture id, 0 = none
    diffuse_mul: tuple = (255, 255, 255)
    roughness: int = 0
    roughness_mul: float = 1.0
    metalness: int = 0
    metalness_mul: float = 0.0
    anisotropy: float = 0.0
    opacity: int = 0
    normal: int = 0
    emissive_col: Optional[tuple] = None

    def __post_init__(self):
        import numpy as np

        self.mtype = MaterialType(self.mtype)
        self.metal = Metal(self.metal)
        self.diffuse_mul = tuple(int(v) for v in self.diffuse_mul)
        if self.emissive_col is not None:
            self.emissive_col = tuple(int(v) for v in self.emissive_col)
        # serialized as f32: keep f32 precision so round trips are exact
        self.ior = float(np.float32(self.ior))
        self.roughness_mul = float(np.float32(self.roughness_mul))
        self.metalness_mul = float(np.float32(self.metalness_mul))
        self.anisotropy = float(np.float32(self.anisotropy))

    def __eq__(self, other):
        return isinstance(other, Material) and all(
            getattr(self, f) == getattr(other, f)
            for f in (
                "name", "mtype", "metal", "ior", "diffuse", "diffuse_mul",
                "roughness", "roughness_mul", "metalness", "metalness_mul",
                "anisotropy", "opacity", "normal", "emissive_col",
            )
        )

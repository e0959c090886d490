# Frozen copy of glaze_tpu_torch/core/light.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Light sources (port of lib/src/geometry/light.rs)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from benchmark.ref.core.spectrum import Spectrum

# Number of light types dispatched by the shading kernels and the stride in
# the dispatch table (light.rs:6-9). The TPU build uses these as branch ids in
# lax.switch rather than SBT callable offsets, preserving the numbering.
SBT_LIGHT_TYPES = 4
SBT_LIGHT_STRIDE = 1


class LightType(IntEnum):
    """All the available light types (light.rs:13-22)."""

    OMNI = 0
    SUN = 1
    AREA = 2
    SKY = 3

    @staticmethod
    def all():
        return [LightType.OMNI, LightType.SUN, LightType.AREA, LightType.SKY]

    @property
    def display_name(self) -> str:
        return {0: "Omni", 1: "Sun", 2: "Area", 3: "Sky"}[int(self)]

    @staticmethod
    def by_name() -> dict:
        """Lowercase name -> type; shared by glaze-app and the viewer."""
        return {t.display_name.lower(): t for t in LightType.all()}

    def name_str(self) -> str:
        return self.display_name

    def has_position(self) -> bool:
        return self == LightType.OMNI

    def has_direction(self) -> bool:
        return self == LightType.SUN

    def has_intensity(self) -> bool:
        return True

    def has_spectrum(self) -> bool:
        return self in (LightType.OMNI, LightType.SUN)

    def has_resources(self) -> bool:
        return self in (LightType.AREA, LightType.SKY)

    def is_delta(self) -> bool:
        """Delta lights are infinitely small and cannot be hit by rays."""
        return self in (LightType.OMNI, LightType.SUN)

    def sampler_index(self) -> int:
        """Index of the light sampling routine (light.rs:111-119)."""
        return int(self) * SBT_LIGHT_STRIDE


@dataclass
class Light:
    """A light source (light.rs:152-174)."""

    ltype: LightType = LightType.OMNI
    name: str = ""
    color: Spectrum = field(default_factory=Spectrum.white)
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], np.float32)
    )
    intensity: float = 1.0
    # material id (AREA) or texture id (SKY)
    resource_id: int = 0
    yaw_deg: float = 0.0
    pitch_deg: float = 0.0
    roll_deg: float = 0.0

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float32).reshape(3)
        self.direction = np.asarray(self.direction, np.float32).reshape(3)
        self.ltype = LightType(self.ltype)
        # serialized as f32: keep f32 precision so round trips are exact
        self.intensity = float(np.float32(self.intensity))
        self.yaw_deg = float(np.float32(self.yaw_deg))
        self.pitch_deg = float(np.float32(self.pitch_deg))
        self.roll_deg = float(np.float32(self.roll_deg))

    def rotation_matrix(self) -> np.ndarray:
        """Skydome rotation: yaw(Y) * pitch(Z) * roll(X) in degrees
        (light.rs:195-199)."""

        def rot(axis: str, deg: float) -> np.ndarray:
            a = math.radians(deg)
            c, s = math.cos(a), math.sin(a)
            m = np.identity(4, dtype=np.float32)
            if axis == "x":
                m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
            elif axis == "y":
                m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
            else:
                m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
            return m

        return rot("y", self.yaw_deg) @ rot("z", self.pitch_deg) @ rot("x", self.roll_deg)

    def __eq__(self, other):
        return (
            isinstance(other, Light)
            and self.ltype == other.ltype
            and self.name == other.name
            and self.color == other.color
            and np.array_equal(self.position, other.position)
            and np.array_equal(self.direction, other.direction)
            and self.intensity == other.intensity
            and self.resource_id == other.resource_id
            and self.yaw_deg == other.yaw_deg
            and self.pitch_deg == other.pitch_deg
            and self.roll_deg == other.roll_deg
        )

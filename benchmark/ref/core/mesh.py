# Frozen copy of glaze_tpu_torch/core/mesh.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Mesh, MeshInstance, Transform, Vertex.

Port of ``lib/src/geometry/{mesh,vertex}.rs``. Transforms are
stored as NumPy (4, 4) float32 matrices in mathematical (row, col) layout;
their byte serialization is column-major to match the cgmath layout used by
the ``.glaze`` format (mesh.rs:41-77).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Vertex:
    """Position + normal + texture coordinate (32 bytes serialized)."""

    vv: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    vn: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    vt: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))

    def __post_init__(self):
        self.vv = np.asarray(self.vv, np.float32).reshape(3)
        self.vn = np.asarray(self.vn, np.float32).reshape(3)
        self.vt = np.asarray(self.vt, np.float32).reshape(2)

    def __eq__(self, other):
        return (
            isinstance(other, Vertex)
            and np.array_equal(self.vv, other.vv)
            and np.array_equal(self.vn, other.vn)
            and np.array_equal(self.vt, other.vt)
        )


@dataclass
class Mesh:
    """A collection of triangles sharing one material (mesh.rs:7-16)."""

    id: int = 0
    indices: list = field(default_factory=list)
    material: int = 0

    def __eq__(self, other):
        return (
            isinstance(other, Mesh)
            and self.id == other.id
            and self.material == other.material
            and list(self.indices) == list(other.indices)
        )


@dataclass(frozen=True)
class MeshInstance:
    """Links a mesh with a transformation (mesh.rs:24-27)."""

    mesh_id: int = 0
    transform_id: int = 0


class Transform:
    """A 4x4 transformation matrix (column-major serialized)."""

    __slots__ = ("m",)

    def __init__(self, m=None):
        if m is None:
            self.m = np.identity(4, dtype=np.float32)
        else:
            self.m = np.asarray(m, dtype=np.float32).reshape(4, 4).copy()

    @staticmethod
    def identity() -> "Transform":
        return Transform()

    def to_bytes(self) -> bytes:
        """Column-major little-endian f32, 64 bytes (mesh.rs:41-54)."""
        return self.m.flatten(order="F").astype("<f4").tobytes()

    @staticmethod
    def from_bytes(data: bytes) -> "Transform":
        vals = np.frombuffer(data, dtype="<f4", count=16)
        return Transform(vals.reshape(4, 4, order="F"))

    def inner(self) -> np.ndarray:
        return self.m

    def to_3x4(self) -> np.ndarray:
        """First 3 rows (the Vulkan TransformMatrixKHR layout, mesh.rs:79-85)."""
        return self.m[:3, :].copy()

    def __eq__(self, other):
        return isinstance(other, Transform) and np.array_equal(self.m, other.m)

    def __repr__(self):
        return f"Transform({self.m.tolist()})"

"""Shared helpers for the mesh importers (OBJ/glTF/FBX/DAE/X3D/WRL/3DS).

Every importer needs the same two pieces: byte-keyed vertex
deduplication (the reference's assimp post-process joins identical
vertices, converter/src/main.rs) and area-weighted normal generation
for meshes that ship without normals.
"""

from __future__ import annotations

import numpy as np

from glaze_tpu_torch.core import Vertex
from glaze_tpu_torch.parser.v1 import vertex_to_bytes


def area_weighted_normals(pos: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Per-vertex normals from (N, 3) positions and (T, 3) triangle
    indices, weighted by face area (the unnormalized cross product)."""
    nrm = np.zeros_like(pos)
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]],
                  pos[tris[:, 2]] - pos[tris[:, 0]])
    for k in range(3):
        np.add.at(nrm, tris[:, k], fn)
    return nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                            1e-20)


class VertexDedup:
    """Accumulates unique vertices keyed on their serialized bytes."""

    def __init__(self):
        self.vertices: list[Vertex] = []
        self._index: dict[bytes, int] = {}

    def add(self, position, normal, uv) -> int:
        vert = Vertex(position, normal, uv)
        key = vertex_to_bytes(vert)
        j = self._index.get(key)
        if j is None:
            j = len(self.vertices)
            self._index[key] = j
            self.vertices.append(vert)
        return j

# Frozen copy of glaze_tpu_torch/ops/shading.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Shading-space orthonormal bases, SoA (torch port of the ``_v`` forms of
:mod:`glaze_tpu.ops.shading`).

A frame is an (s, t, n) tuple of (x, y, z) tuples of (R,) tensors: s from
dpdu Gram-Schmidt'd against the shading normal, t = n x s. BSDFs work in
this frame with n = +z.
"""

from __future__ import annotations

from benchmark.ref.ops import vec


def new_shading_space_v(dpdu, normal):
    """(s, t, n) frame (shading_space.glsl:11-16)."""
    s = vec.normalize(vec.sub(dpdu, vec.scale(normal, vec.dot(normal, dpdu))))
    t = vec.cross(normal, s)
    return (s, t, normal)


def to_shading_space_v(w, frame):
    """World -> shading (shading_space.glsl:27-31), normalized."""
    s, t, n = frame
    return vec.normalize((vec.dot(w, s), vec.dot(w, t), vec.dot(w, n)))


def to_world_space_v(v, frame):
    """Shading -> world (shading_space.glsl:18-25), normalized."""
    s, t, n = frame
    out = (
        s[0] * v[0] + t[0] * v[1] + n[0] * v[2],
        s[1] * v[0] + t[1] * v[1] + n[1] * v[2],
        s[2] * v[0] + t[2] * v[1] + n[2] * v[2],
    )
    return vec.normalize(out)

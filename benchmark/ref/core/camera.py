# Frozen copy of glaze_tpu_torch/core/camera.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Perspective / orthographic cameras.

Port of ``lib/src/geometry/camera.rs``. Matrices follow the
reference's cgmath (OpenGL-style) conventions so the ray-generation math in
the renderer matches the Vulkan implementation bit-for-behavior. Matrices are
returned as NumPy (4, 4) arrays in mathematical (row, col) layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _v3(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(3)


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix (cgmath::Matrix4::look_at_rh)."""
    eye, center, up = _v3(eye), _v3(center), _v3(up)
    f = normalize(center - eye)
    s = normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.identity(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -float(np.dot(s, eye))
    m[1, 3] = -float(np.dot(u, eye))
    m[2, 3] = float(np.dot(f, eye))
    return m


def perspective_gl(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """OpenGL-style perspective projection (cgmath::perspective)."""
    f = 1.0 / math.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def ortho_gl(l, r, b, t, n, f) -> np.ndarray:
    """OpenGL-style orthographic projection (cgmath::ortho)."""
    m = np.identity(4, dtype=np.float32)
    m[0, 0] = 2.0 / (r - l)
    m[1, 1] = 2.0 / (t - b)
    m[2, 2] = -2.0 / (f - n)
    m[0, 3] = -(r + l) / (r - l)
    m[1, 3] = -(t + b) / (t - b)
    m[2, 3] = -(f + n) / (f - n)
    return m


def rotation_about_axis(axis, angle: float) -> np.ndarray:
    """3x3 rotation by ``angle`` radians about ``axis`` (Rodrigues)."""
    a = normalize(_v3(axis))
    c, s = math.cos(angle), math.sin(angle)
    x, y, z = (float(v) for v in a)
    return np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ],
        dtype=np.float32,
    )


@dataclass
class PerspectiveCam:
    """Perspective camera; ``fovx`` is the horizontal FOV in radians."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    target: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 100.0], np.float32)
    )
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    fovx: float = math.radians(90.0)
    near: float = 1e-3
    far: float = 1e3

    def __post_init__(self):
        self.position = _v3(self.position)
        self.target = _v3(self.target)
        self.up = _v3(self.up)
        self.fovx = float(np.float32(self.fovx))
        self.near = float(np.float32(self.near))
        self.far = float(np.float32(self.far))

    def fovy(self, aspect_ratio: float) -> float:
        """Vertical FOV in radians (camera.rs:25-27)."""
        return 2.0 * math.atan(math.tan(self.fovx * 0.5) / aspect_ratio)


@dataclass
class OrthographicCam:
    """Orthographic camera; ``scale`` is the half-extent of the clip box."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    target: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 100.0], np.float32)
    )
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    scale: float = 1.0
    near: float = 1e-3
    far: float = 1e3

    def __post_init__(self):
        self.position = _v3(self.position)
        self.target = _v3(self.target)
        self.up = _v3(self.up)
        self.scale = float(np.float32(self.scale))
        self.near = float(np.float32(self.near))
        self.far = float(np.float32(self.far))


class Camera:
    """A projective camera: either perspective or orthographic.

    Mirrors the reference's ``Camera`` enum (camera.rs:75-281) with the same
    interactive control semantics.
    """

    def __init__(self, cam):
        if not isinstance(cam, (PerspectiveCam, OrthographicCam)):
            raise TypeError("Camera wraps PerspectiveCam or OrthographicCam")
        self.inner = cam

    # -- constructors -------------------------------------------------------
    @staticmethod
    def Perspective(cam: PerspectiveCam) -> "Camera":
        return Camera(cam)

    @staticmethod
    def Orthographic(cam: OrthographicCam) -> "Camera":
        return Camera(cam)

    @staticmethod
    def default() -> "Camera":
        return Camera(PerspectiveCam())

    @property
    def is_perspective(self) -> bool:
        return isinstance(self.inner, PerspectiveCam)

    def position(self) -> np.ndarray:
        return self.inner.position

    def target(self) -> np.ndarray:
        return self.inner.target

    def up(self) -> np.ndarray:
        return self.inner.up

    def near_plane(self) -> float:
        return self.inner.near

    def far_plane(self) -> float:
        return self.inner.far

    # -- matrices ------------------------------------------------------------
    def look_at_rh(self) -> np.ndarray:
        return look_at_rh(self.inner.position, self.inner.target, self.inner.up)

    def projection(self, width: int, height: int) -> np.ndarray:
        if self.is_perspective:
            ar = width / height
            return perspective_gl(
                self.inner.fovy(ar), ar, self.inner.near, self.inner.far
            )
        s, far = self.inner.scale, self.inner.far
        return ortho_gl(-s, s, -s, s, -far, far)

    # -- interactive controls (camera.rs:182-281) ----------------------------
    def strafe(self, magnitude: float):
        cam = self.inner
        direction = normalize(cam.target - cam.position)
        right = normalize(np.cross(direction, cam.up))
        mov = right * np.float32(magnitude)
        cam.position = cam.position + mov
        cam.target = cam.target + mov

    def advance(self, magnitude: float):
        cam = self.inner
        if np.array_equal(cam.target, cam.position):
            cam.target = cam.target + np.array(
                [0, 0, np.finfo(np.float32).eps], np.float32
            )
        mov = normalize(cam.target - cam.position) * np.float32(magnitude)
        cam.position = cam.position + mov
        cam.target = cam.target + mov

    def elevate(self, magnitude: float):
        cam = self.inner
        mov = np.float32(magnitude) * cam.up
        cam.position = cam.position + mov
        cam.target = cam.target + mov

    def look_around(self, theta: float, phi: float):
        cam = self.inner
        direction = cam.target - cam.position
        radius = float(np.linalg.norm(direction))
        direction = normalize(direction)
        right = normalize(np.cross(direction, cam.up))
        h_rot = rotation_about_axis(cam.up, theta)
        v_rot = rotation_about_axis(right, phi)
        rotation = h_rot @ v_rot
        cam.target = cam.position + np.float32(radius) * (rotation @ direction)

    def __eq__(self, other):
        if not isinstance(other, Camera) or type(self.inner) is not type(other.inner):
            return False
        a, b = self.inner, other.inner
        same = (
            np.array_equal(a.position, b.position)
            and np.array_equal(a.target, b.target)
            and np.array_equal(a.up, b.up)
            and a.near == b.near
            and a.far == b.far
        )
        if isinstance(a, PerspectiveCam):
            return same and a.fovx == b.fovx
        return same and a.scale == b.scale

    def __repr__(self):
        kind = "Perspective" if self.is_perspective else "Orthographic"
        return f"Camera.{kind}({self.inner})"

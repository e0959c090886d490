# Frozen copy of glaze_tpu_torch/native/__init__.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Native (C++) host components: binned-SAH BVH builder, octant layouts,
xxHash64 and Walker/Vose alias tables.

The source is the same ``glaze_native.cpp`` the JAX package compiles, so
both packages build identical trees. It is compiled with ``g++`` at FIRST
USE (not at import) into the ``build/`` directory at the repository root.
A missing compiler or a failed build raises: the port has no NumPy
fallback builder, because a different tree would change every triangle id.

``lib`` is resolved lazily (module ``__getattr__``), so
``from benchmark.ref.native import lib`` triggers the build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "glaze_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_SO = os.path.join(BUILD_DIR, "libglaze_native_ref.so")


class _NativeLib:
    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        self._lib.glaze_xxh64.restype = ctypes.c_uint64
        self._lib.glaze_xxh64.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        self._lib.glaze_bvh_build.restype = ctypes.c_void_p
        self._lib.glaze_bvh_build.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
        ]
        self._lib.glaze_bvh_free.restype = None
        self._lib.glaze_bvh_free.argtypes = [ctypes.c_void_p]
        self._lib.glaze_alias_build.restype = None
        self._lib.glaze_alias_build.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        self._lib.glaze_bvh_octants.restype = ctypes.c_void_p
        self._lib.glaze_bvh_octants.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        self._lib.glaze_oct8_node_count.restype = ctypes.c_int32
        self._lib.glaze_oct8_node_count.argtypes = [ctypes.c_void_p]
        self._lib.glaze_oct8_padded_tris.restype = ctypes.c_uint64
        self._lib.glaze_oct8_padded_tris.argtypes = [ctypes.c_void_p]
        self._lib.glaze_oct8_export.restype = None
        self._lib.glaze_oct8_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        self._lib.glaze_oct8_free.restype = None
        self._lib.glaze_oct8_free.argtypes = [ctypes.c_void_p]

    def xxh64(self, data: bytes, seed: int = 0) -> int:
        return self._lib.glaze_xxh64(data, len(data), seed)

    def alias_build(self, weights: np.ndarray):
        """Walker/Vose alias tables for (rows, n) weights.

        Returns (prob (rows, n) f32, alias (rows, n) i32).
        """
        w = np.ascontiguousarray(weights, np.float32)
        rows, n = w.shape
        prob = np.empty((rows, n), np.float32)
        alias = np.empty((rows, n), np.int32)
        self._lib.glaze_alias_build(
            w.ctypes.data_as(ctypes.c_void_p), rows, n,
            prob.ctypes.data_as(ctypes.c_void_p),
            alias.ctypes.data_as(ctypes.c_void_p),
        )
        return prob, alias

    def bvh_build_octants(self, tri_verts: np.ndarray, leaf_size: int):
        """Builds the BVH and re-emits it in 8 octant-ordered DFS layouts
        with leaf-aligned padded triangle order (sentinel 0xFFFFFFFF).

        Returns dict: bmin/bmax (8, M, 3), first/count/skip (8, M),
        tri_order (N_pad,) uint32.
        """
        tri = np.ascontiguousarray(tri_verts, dtype=np.float32)
        n = tri.shape[0]
        handle = self._lib.glaze_bvh_build(
            tri.ctypes.data_as(ctypes.c_void_p), n, leaf_size
        )
        try:
            oct8 = self._lib.glaze_bvh_octants(handle, leaf_size)
            try:
                m = self._lib.glaze_oct8_node_count(oct8)
                n_pad = self._lib.glaze_oct8_padded_tris(oct8)
                bmin = np.empty((8, m, 3), np.float32)
                bmax = np.empty((8, m, 3), np.float32)
                first = np.empty((8, m), np.int32)
                count = np.empty((8, m), np.int32)
                skip = np.empty((8, m), np.int32)
                order = np.empty(n_pad, np.uint32)
                self._lib.glaze_oct8_export(
                    oct8,
                    bmin.ctypes.data_as(ctypes.c_void_p),
                    bmax.ctypes.data_as(ctypes.c_void_p),
                    first.ctypes.data_as(ctypes.c_void_p),
                    count.ctypes.data_as(ctypes.c_void_p),
                    skip.ctypes.data_as(ctypes.c_void_p),
                    order.ctypes.data_as(ctypes.c_void_p),
                )
            finally:
                self._lib.glaze_oct8_free(oct8)
        finally:
            self._lib.glaze_bvh_free(handle)
        return {
            "bmin": bmin,
            "bmax": bmax,
            "first": first,
            "count": count,
            "skip": skip,
            "tri_order": order,
        }


def _build() -> str:
    """Compiles the library into BUILD_DIR unless an up-to-date copy is
    there. Concurrent builders (test workers) each write a private temp
    file and rename it into place atomically."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
               "-o", tmp_path]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {_SRC} failed:\n{res.stderr[-4000:]}")
        os.replace(tmp_path, _SO)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return _SO


_lib: _NativeLib | None = None


def get_lib() -> _NativeLib:
    """The loaded native library, compiled on first call. Raises when the
    compiler is missing or the build fails."""
    global _lib
    if _lib is None:
        _lib = _NativeLib(ctypes.CDLL(_build()))
    return _lib


def __getattr__(name):
    if name == "lib":
        return get_lib()
    raise AttributeError(name)

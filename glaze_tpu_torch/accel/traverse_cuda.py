"""CUDA traversal kernels (the counterpart of ``glaze_tpu/accel/traverse_pallas.py``).

``csrc/traverse.cu`` holds the hand-written sm_90a walks, one thread per
ray over the octant-ordered ``nodes16`` slabs: closest hit and any hit on
the classic tree's ``tri8`` rows, each also in a masked form that honours
the baked 8x8 opacity cells of a tree with a payload, and closest hit and
any hit on a fat-leaf tree's coefficient table (its header note says
which Pallas kernels they replace and what bounds them). They are
compiled with ``nvcc`` at first use into ``build/`` at the repository
root, as a shared library with a plain C interface loaded through
ctypes, and rebuilt when a source under ``csrc/`` is newer than the
library. A missing ``nvcc``, a failed build or a failed launch raises;
nothing here falls back to the plain version.

Each wrapper counts its launches in a plain int attribute
(``closest_hit_soa.launches``, ``any_hit_soa.launches``,
``closest_hit_soa_masked.launches``, ``any_hit_soa_masked.launches``,
``closest_hit_fat_soa.launches``, ``any_hit_fat_soa.launches``),
incremented only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCE = os.path.join(CSRC, "traverse.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
_SO = os.path.join(BUILD_DIR, "libglaze_traverse.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_lib = None
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA traversal kernels "
                           "cannot be built")
    return path


def _newest_source() -> float:
    return max(os.path.getmtime(os.path.join(CSRC, n))
               for n in os.listdir(CSRC))


def build() -> str:
    """Compiles ``traverse.cu`` (if the library is missing or older than
    any source under ``csrc/``) and returns the library path.
    ``build_log`` keeps nvcc's output, including ``-Xptxas -v``'s register
    and spill report."""
    global build_log
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= _newest_source():
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log[-6000:]}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.glaze_closest_hit.argtypes = [p] * 9 + [i, i, ctypes.c_longlong] + [p] * 5
        lib.glaze_closest_hit.restype = i
        lib.glaze_any_hit.argtypes = ([p] * 10 + [i, i, ctypes.c_longlong,
                                                  ctypes.c_float, p, p])
        lib.glaze_any_hit.restype = i
        lib.glaze_closest_hit_masked.argtypes = ([p] * 9 + [i, i, ctypes.c_longlong]
                                                 + [p] * 6)
        lib.glaze_closest_hit_masked.restype = i
        lib.glaze_any_hit_masked.argtypes = ([p] * 10 + [i, i, ctypes.c_longlong,
                                                         ctypes.c_float, p, p, p])
        lib.glaze_any_hit_masked.restype = i
        lib.glaze_closest_hit_fat.argtypes = ([p] * 9 + [i, i, ctypes.c_longlong, i]
                                              + [p] * 5)
        lib.glaze_closest_hit_fat.restype = i
        lib.glaze_any_hit_fat.argtypes = ([p] * 10 + [i, i, ctypes.c_longlong, i,
                                                      ctypes.c_float, p, p])
        lib.glaze_any_hit_fat.restype = i
        lib.glaze_error_string.argtypes = [i]
        lib.glaze_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(code: int, what: str):
    if code != 0:
        msg = _load().glaze_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _ray_comps(bvh, origin3, direction3, extra, tables=("nodes16", "tri8")):
    """Validates the SoA ray components and the tree's ``tables`` for a
    launch."""
    comps = list(origin3) + list(direction3) + list(extra)
    r = comps[0].shape[0]
    for c in comps:
        if not c.is_cuda or c.dim() != 1 or c.shape[0] != r:
            raise ValueError("ray components must be 1-D CUDA tensors of one "
                             "length")
    for name in tables:
        tab = getattr(bvh, name)
        if not tab.is_cuda or tab.dtype != torch.float32 or not tab.is_contiguous():
            raise ValueError(f"bvh.{name} must be a contiguous float32 CUDA "
                             "tensor")
    if r >= 2 ** 31:
        raise ValueError("too many rays for one launch")
    return [c.contiguous() for c in comps], r


def _require_payload(bvh):
    from glaze_tpu_torch.accel.bvh import has_payload

    if not has_payload(bvh):
        raise ValueError("the masked kernels need a tree with the opacity "
                         "payload (bvh.attach_tri_payload)")


def _oct_floats(bvh) -> int:
    """Floats per octant slab of nodes16 (M16 rows of 128)."""
    return (bvh.nodes16.shape[0] // 8) * 128


def _closest(bvh, origin3, direction3, t_max, masked: bool):
    """Launches the closest-hit kernel (masked or not); returns the dict of
    outputs, ``mixed`` included when masked."""
    dev = origin3[0].device
    r = origin3[0].shape[0]
    if t_max is None:
        cap = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    else:
        cap = torch.broadcast_to(
            torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,))
    comps, r = _ray_comps(bvh, origin3, direction3, [cap])
    comps = [c.to(torch.float32) for c in comps]
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    out = {"t": t, "tri": tri, "u": u, "v": v}
    if masked:
        out["mixed"] = torch.empty((r,), dtype=torch.bool, device=dev)
    if r:
        lib = _load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [bvh.nodes16.data_ptr(), bvh.tri8.data_ptr(),
                *[c.data_ptr() for c in comps], r, bvh.n_nodes,
                _oct_floats(bvh), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                v.data_ptr()]
        if masked:
            code = lib.glaze_closest_hit_masked(
                *args, out["mixed"].data_ptr(), stream)
            _check(code, "masked closest-hit")
            closest_hit_soa_masked.launches += 1
        else:
            code = lib.glaze_closest_hit(*args, stream)
            _check(code, "closest-hit")
            closest_hit_soa.launches += 1
    if bvh.n_tris == 0:  # empty scenes keep a placeholder leaf: all misses
        t.fill_(float("inf"))
        tri.fill_(-1)
        if masked:
            out["mixed"].fill_(False)
    return out


def closest_hit_soa(bvh, origin3, direction3, t_max=None):
    """Closest hit of SoA rays ((x, y, z) tuples of (R,) CUDA tensors) on
    the kernel. Returns a dict of (R,) tensors ``t`` (inf on a miss),
    ``tri`` (int32, -1 on a miss), ``u``, ``v``."""
    return _closest(bvh, origin3, direction3, t_max, masked=False)


closest_hit_soa.launches = 0


def closest_hit_soa_masked(bvh, origin3, direction3, t_max=None):
    """:func:`closest_hit_soa` honouring the tree's baked opacity cells
    (the tree must carry the payload): TRANSPARENT-cell hits are skipped,
    and the extra (R,) bool ``mixed`` marks accepted MIXED-cell hits."""
    _require_payload(bvh)
    return _closest(bvh, origin3, direction3, t_max, masked=True)


closest_hit_soa_masked.launches = 0


def _any(bvh, origin3, direction3, t_max, t_min, active, masked: bool):
    """Launches the any-hit kernel (masked or not); returns ``hit``, or
    ``(blocked, pending)`` when masked."""
    dev = origin3[0].device
    r = origin3[0].shape[0]
    cap = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,))
    act = (torch.ones((r,), dtype=torch.bool, device=dev) if active is None
           else active.to(torch.bool))
    comps, r = _ray_comps(bvh, origin3, direction3, [cap, act])
    floats = [c.to(torch.float32) for c in comps[:7]]
    act = comps[7].contiguous()
    hit = torch.empty((r,), dtype=torch.bool, device=dev)
    pending = torch.empty((r,), dtype=torch.bool, device=dev) if masked else None
    if r:
        lib = _load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [bvh.nodes16.data_ptr(), bvh.tri8.data_ptr(),
                *[c.data_ptr() for c in floats], act.data_ptr(), r,
                bvh.n_nodes, _oct_floats(bvh), float(t_min), hit.data_ptr()]
        if masked:
            code = lib.glaze_any_hit_masked(*args, pending.data_ptr(), stream)
            _check(code, "masked any-hit")
            any_hit_soa_masked.launches += 1
        else:
            code = lib.glaze_any_hit(*args, stream)
            _check(code, "any-hit")
            any_hit_soa.launches += 1
    if bvh.n_tris == 0:
        hit.fill_(False)
        if masked:
            pending.fill_(False)
    return (hit, pending) if masked else hit


def any_hit_soa(bvh, origin3, direction3, t_max, t_min=1e-3, active=None):
    """Any hit of SoA CUDA rays with t in (t_min, t_max); lanes with
    ``active`` False report False. Returns an (R,) bool tensor."""
    return _any(bvh, origin3, direction3, t_max, t_min, active, masked=False)


any_hit_soa.launches = 0


def any_hit_soa_masked(bvh, origin3, direction3, t_max, t_min=1e-3,
                       active=None):
    """3-state any hit of SoA CUDA rays on a tree with the opacity payload:
    returns ``(blocked, pending)`` (R,) bool tensors: blocked = an
    OPAQUE-cell hit in (t_min, t_max); pending = a MIXED-cell hit and not
    blocked; TRANSPARENT cells are ignored; inactive lanes False/False."""
    _require_payload(bvh)
    return _any(bvh, origin3, direction3, t_max, t_min, active, masked=True)


any_hit_soa_masked.launches = 0

_FAT_TABLES = ("nodes16", "coef")


def closest_hit_fat_soa(bvh, origin3, direction3, t_max=None):
    """Closest hit of SoA CUDA rays on a fat-leaf tree
    (:class:`~glaze_tpu_torch.accel.fat.FatBVH`), the contract of
    :func:`closest_hit_soa` (``tri`` is the leaf slot; an empty scene's
    placeholder leaf has only zero columns, so it reports misses)."""
    dev = origin3[0].device
    r = origin3[0].shape[0]
    if t_max is None:
        cap = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    else:
        cap = torch.broadcast_to(
            torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,))
    comps, r = _ray_comps(bvh, origin3, direction3, [cap], _FAT_TABLES)
    comps = [c.to(torch.float32) for c in comps]
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    if r:
        lib = _load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.glaze_closest_hit_fat(
            bvh.nodes16.data_ptr(), bvh.coef.data_ptr(),
            *[c.data_ptr() for c in comps], r, bvh.n_nodes, _oct_floats(bvh),
            bvh.leaf_size, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream)
        _check(code, "fat closest-hit")
        closest_hit_fat_soa.launches += 1
    return {"t": t, "tri": tri, "u": u, "v": v}


closest_hit_fat_soa.launches = 0


def any_hit_fat_soa(bvh, origin3, direction3, t_max, t_min=1e-3,
                    active=None):
    """Any hit of SoA CUDA rays on a fat-leaf tree with t in (t_min,
    t_max); lanes with ``active`` False report False."""
    dev = origin3[0].device
    r = origin3[0].shape[0]
    cap = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,))
    act = (torch.ones((r,), dtype=torch.bool, device=dev) if active is None
           else active.to(torch.bool))
    comps, r = _ray_comps(bvh, origin3, direction3, [cap, act], _FAT_TABLES)
    floats = [c.to(torch.float32) for c in comps[:7]]
    act = comps[7].contiguous()
    hit = torch.empty((r,), dtype=torch.bool, device=dev)
    if r:
        lib = _load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.glaze_any_hit_fat(
            bvh.nodes16.data_ptr(), bvh.coef.data_ptr(),
            *[c.data_ptr() for c in floats], act.data_ptr(), r, bvh.n_nodes,
            _oct_floats(bvh), bvh.leaf_size, float(t_min), hit.data_ptr(),
            stream)
        _check(code, "fat any-hit")
        any_hit_fat_soa.launches += 1
    return hit


any_hit_fat_soa.launches = 0

KERNEL_WRAPPERS = (closest_hit_soa, any_hit_soa, closest_hit_soa_masked,
                   any_hit_soa_masked, closest_hit_fat_soa, any_hit_fat_soa)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0

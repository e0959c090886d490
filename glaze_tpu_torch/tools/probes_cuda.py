"""ctypes wrappers of the probe kernels in ``csrc/probes.cu``.

``build/libglaze_probes.so`` is compiled with ``nvcc`` at first use
(:mod:`glaze_tpu_torch.cuda_build`). Each wrapper checks the device,
dtype, shape and contiguity of its tensors, allocates its outputs,
launches on the current stream, raises on a nonzero return, and counts
its launches in a plain int attribute (``fat_drain.launches``,
``resolve_chain.launches``, ``dot_chain.launches``,
``walk_overhead.launches``, ``slab_rate.launches``), incremented only
where the kernel is launched. A CPU tensor is an error here: the tool
modules choose the plain version by device before they get this far.
"""

from __future__ import annotations

import ctypes

import torch

from glaze_tpu_torch import cuda_build

SOURCE = "probes.cu"
LIBRARY = "libglaze_probes.so"
F = 16          # feature rows, the K of every product
RAYS = 128      # rays of one drain block
TS = (16, 32, 64, 128)
PRECISIONS = {"highest": 0, "default": 1, "split3": 2}
VARIANTS = ("A", "B", "C", "D")
PACKETS = (2048, 32)

_lib = None
build_log = ""


def build() -> str:
    """Compiles ``probes.cu`` if the library is missing or older than it
    and returns the library path; ``build_log`` keeps nvcc's output."""
    global build_log
    so, log = cuda_build.build(SOURCE, LIBRARY)
    if log:
        build_log = log
    return so


def use_library(path=None):
    """Loads the probe kernels from ``path``, a library built from another
    ``probes.cu`` with the same C interface (an earlier commit's, to hold
    a redesign against it), or with None from this package's build."""
    global _lib
    _lib = None if path is None else _bind(ctypes.CDLL(path))


def _load():
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(build()))
    return _lib


def _bind(lib):
    """Sets the argument and result types of the library's entries; an
    earlier build may lack the attribute query."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.glaze_probe_drain.argtypes = ([i, i, p, i, i, i, p, p, i] + [p] * 7
                                      + [i, f] + [p] * 5)
    lib.glaze_probe_dot_chain.argtypes = [i, p, i, p, i, p, p, p]
    lib.glaze_probe_walk.argtypes = [i, i, p, p, i] + [p] * 6 + [i, f, p, p, p]
    lib.glaze_probe_slab_rate.argtypes = [i, p, p, p, i, i, f, p, p]
    for fn in (lib.glaze_probe_drain, lib.glaze_probe_dot_chain,
               lib.glaze_probe_walk, lib.glaze_probe_slab_rate):
        fn.restype = i
    if hasattr(lib, "glaze_probe_kernel_attrs"):
        lib.glaze_probe_kernel_count.restype = i
        lib.glaze_probe_kernel_attrs.argtypes = [i, i] + [p] * 5
        lib.glaze_probe_kernel_attrs.restype = i
    lib.glaze_probe_error_string.argtypes = [i]
    lib.glaze_probe_error_string.restype = ctypes.c_char_p
    return lib


def _check(code: int, what: str):
    if code != 0:
        msg = _load().glaze_probe_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


# the kernels of glaze_probe_kernel_attrs, in its order: drain_kernel (T1
# at highest and default, T3b), dot_chain_kernel (T3a at each precision,
# and the 3xTF32 instance that splits its fragments per step above W =
# 1024), walk_overhead_kernel (T2, each variant at packet 2048, then 32)
ATTR_KERNELS = (("drain_highest", "drain_default", "drain_carry",
                 "chain_highest", "chain_default", "chain_split3",
                 "chain_highest_w2048")
                + tuple(f"walk_{v}_{n}" for n in PACKETS for v in VARIANTS))


def kernel_attrs() -> dict:
    """For each kernel of :data:`ATTR_KERNELS`: registers and local
    (spill) bytes per thread, threads per block, resident blocks per SM
    with the shared memory it is launched with at the tools' sizes (leaf
    size 128 for the drains, W = 512 for the chains, 2048 for
    ``chain_highest_w2048``), and the occupancy they give (resident threads
    over the most an SM holds), as the CUDA runtime reports them for the
    built library on the current card."""
    lib = _load()
    if lib.glaze_probe_kernel_count() != len(ATTR_KERNELS):
        raise RuntimeError(f"the library reports on "
                           f"{lib.glaze_probe_kernel_count()} kernels, not "
                           f"the {len(ATTR_KERNELS)} of ATTR_KERNELS")
    out = {}
    for which, name in enumerate(ATTR_KERNELS):
        regs, local, threads, blocks, most = (ctypes.c_int() for _ in range(5))
        _check(lib.glaze_probe_kernel_attrs(
            which, 128, ctypes.byref(regs), ctypes.byref(local),
            ctypes.byref(threads), ctypes.byref(blocks), ctypes.byref(most)),
            f"{name} attribute query")
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "threads_per_block": threads.value,
                     "blocks_per_sm": blocks.value,
                     "occupancy": blocks.value * threads.value / most.value}
    return out


def _need(name, t, dtype, shape=None):
    """Raises unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` (and ``shape``, where given)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, aligned {dtype} "
                         "tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _slabs(mats, T):
    if T not in TS:
        raise ValueError(f"leaf size {T} not in {TS}")
    _need("mats", mats, torch.float32)
    if mats.dim() != 2 or mats.shape[0] % F or mats.shape[1] % 4 \
            or mats.shape[1] < 4 * T:
        raise ValueError(f"mats must be (L*16, W >= 4T), W a multiple of 4; "
                         f"got {tuple(mats.shape)}")
    return mats.shape[0] // F, mats.shape[1]


def _drain_outputs(r, device):
    return {"t": torch.empty((r,), dtype=torch.float32, device=device),
            "tri": torch.empty((r,), dtype=torch.int32, device=device),
            "u": torch.empty((r,), dtype=torch.float32, device=device),
            "v": torch.empty((r,), dtype=torch.float32, device=device)}


def _order(order):
    _need("order", order, torch.int32)
    if order.dim() != 1:
        raise ValueError("order must be a 1-D int32 tensor")
    return order.shape[0]


def fat_drain(mats, centres, order, o3, d3, T, precision="highest"):
    """T1: each block of 128 rays drains the leaves of ``order`` (a leaf
    index out of range traps the kernel). ``mats`` (L*16, W) slabs,
    ``centres`` (L, 3), ``o3``/``d3`` (x, y, z) tuples of (R,) float32
    rays, R a multiple of 128. Returns (R,) ``t`` (inf: no hit), ``tri``
    (int32, -1), ``u``, ``v``."""
    n_leaves, w = _slabs(mats, T)
    _need("centres", centres, torch.float32, (n_leaves, 3))
    reps = _order(order)
    comps = list(o3) + list(d3)
    r = comps[0].shape[0]
    for c in comps:
        _need("ray component", c, torch.float32, (r,))
    if r == 0 or r % RAYS:
        raise ValueError(f"{r} rays: a positive multiple of {RAYS} is needed")
    if precision not in ("highest", "default"):
        raise ValueError(f"precision {precision!r}: highest or default")
    out = _drain_outputs(r, mats.device)
    code = _load().glaze_probe_drain(
        PRECISIONS[precision], 0, mats.data_ptr(), w, T, n_leaves,
        centres.data_ptr(), order.data_ptr(), reps,
        *[c.data_ptr() for c in comps], None, r, float("inf"),
        out["t"].data_ptr(), out["tri"].data_ptr(), out["u"].data_ptr(),
        out["v"].data_ptr(), _stream(mats))
    _check(code, "fat drain")
    fat_drain.launches += 1
    return out


fat_drain.launches = 0


def resolve_chain(mat, feat, T, reps, t_init=1e30):
    """T3b: ``reps`` steps of the 3xTF32 product of ``mat`` (16, W >= 4T)
    with ``feat`` (16, 128) + carry and the closest-hit resolve, one
    block. Returns (128,) ``t`` (``t_init``: no hit), ``tri``, ``u``,
    ``v``."""
    n_leaves, w = _slabs(mat, T)
    if n_leaves != 1:
        raise ValueError("resolve_chain takes one (16, W) matrix")
    _need("feat", feat, torch.float32, (F, RAYS))
    order = torch.zeros((reps,), dtype=torch.int32, device=mat.device)
    out = _drain_outputs(RAYS, mat.device)
    code = _load().glaze_probe_drain(
        PRECISIONS["highest"], 1, mat.data_ptr(), w, T, 1, None,
        order.data_ptr(), reps, *[None] * 6, feat.data_ptr(), RAYS,
        float(t_init), out["t"].data_ptr(), out["tri"].data_ptr(),
        out["u"].data_ptr(), out["v"].data_ptr(), _stream(mat))
    _check(code, "resolve chain")
    resolve_chain.launches += 1
    return out


resolve_chain.launches = 0


def dot_chain(mat, feat, precision, reps, trace=False):
    """T3a: ``reps`` dependent products of ``mat`` (16, W), W a multiple
    of 16, with the sign-fed-back ``feat`` (16, 128), folded into an (8,
    128) sum, one block. Returns ``(acc, trace)``: ``trace`` (reps,) holds
    acc[0, 0] after each step when asked for, else None."""
    _need("mat", mat, torch.float32)
    if mat.dim() != 2 or mat.shape[0] != F or mat.shape[1] % 16 \
            or mat.shape[1] == 0:
        raise ValueError(f"mat must be (16, W), W a multiple of 16; got "
                         f"{tuple(mat.shape)}")
    _need("feat", feat, torch.float32, (F, RAYS))
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {tuple(PRECISIONS)}")
    out = torch.empty((8, RAYS), dtype=torch.float32, device=mat.device)
    tr = (torch.empty((reps,), dtype=torch.float32, device=mat.device)
          if trace else None)
    code = _load().glaze_probe_dot_chain(
        PRECISIONS[precision], mat.data_ptr(), mat.shape[1], feat.data_ptr(),
        reps, out.data_ptr(), None if tr is None else tr.data_ptr(),
        _stream(mat))
    _check(code, "dot chain")
    dot_chain.launches += 1
    return out, tr


dot_chain.launches = 0


def walk_overhead(nodes16, tri8, n_nodes, o3, d3, variant, packet):
    """T2: packets of ``packet`` rays walk octant 0 of ``nodes16`` (the
    tree's tri8 rows for variant A). Returns ``(t, iters)``: (R,) float32
    and the (R / packet,) int32 iteration count of each packet."""
    _need("nodes16", nodes16, torch.float32)
    _need("tri8", tri8, torch.float32)
    if variant not in VARIANTS or packet not in PACKETS:
        raise ValueError(f"variant {variant!r} / packet {packet}: expected "
                         f"one of {VARIANTS} / {PACKETS}")
    comps = list(o3) + list(d3)
    r = comps[0].shape[0]
    for c in comps:
        _need("ray component", c, torch.float32, (r,))
    if r == 0 or r % packet:
        raise ValueError(f"{r} rays: a positive multiple of {packet} is needed")
    t = torch.empty((r,), dtype=torch.float32, device=nodes16.device)
    iters = torch.empty((r // packet,), dtype=torch.int32, device=nodes16.device)
    code = _load().glaze_probe_walk(
        VARIANTS.index(variant), packet, nodes16.data_ptr(), tri8.data_ptr(),
        int(n_nodes), *[c.data_ptr() for c in comps], r, 0.0, t.data_ptr(),
        iters.data_ptr(), _stream(nodes16))
    _check(code, "walk overhead")
    walk_overhead.launches += 1
    return t, iters


walk_overhead.launches = 0


def slab_rate(o, i, nodes, iters):
    """T4: the slab-test op mix ``iters`` times per element of ``o``/``i``
    ((rows, 128), float32 or bfloat16) against ``nodes`` (64, 128)
    float32. Returns the (rows, 128) ``acc + t_cap`` in the input dtype."""
    if o.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("o must be float32 or bfloat16")
    _need("o", o, o.dtype)
    if o.dim() != 2 or o.shape[1] != RAYS:
        raise ValueError(f"o must be (rows, 128); got {tuple(o.shape)}")
    _need("i", i, o.dtype, tuple(o.shape))
    _need("nodes", nodes, torch.float32, (64, RAYS))
    out = torch.empty_like(o)
    code = _load().glaze_probe_slab_rate(
        int(o.dtype == torch.bfloat16), o.data_ptr(), i.data_ptr(),
        nodes.data_ptr(), o.numel(), int(iters), 1.0, out.data_ptr(),
        _stream(o))
    _check(code, "slab rate")
    slab_rate.launches += 1
    return out


slab_rate.launches = 0

KERNEL_WRAPPERS = (fat_drain, resolve_chain, dot_chain, walk_overhead,
                   slab_rate)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0

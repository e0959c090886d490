"""BVH host packing + the plain (pure torch) stackless skip-link walkers.

torch port of :mod:`glaze_tpu.accel.bvh`. The tree is built on the host
by the native binned-SAH builder (:mod:`glaze_tpu_torch.native`, the same
C++ source the JAX package compiles) and re-emitted in EIGHT depth-first
orders, one per ray-direction octant, children near-first along that
octant. Leaves are padded to exactly LEAF_SIZE aligned triangles (padding
rows are degenerate and never hit).

Tables (same layout and bits as the JAX package):
  nodes   (M, 8) f32, octant 0: [bmin.xyz, bmax.xyz, meta, skip] where
          meta/skip are int32 bits in the float slots; meta = leaf ?
          first*8 + (count-1) : -1; skip = next node on a miss (M ends)
  tri     (N_pad, 9) f32 rows (v0, e1, e2) in leaf-aligned order; (N_pad,
          13) when the tree carries a per-triangle payload (below)
  nodes16 (8*M16, 128) f32: all 8 octants, node i of octant o at flat
          float offset (o*M16*16 + i)*8
  tri8    (N_pad/8, 128) f32: triangle k at flat float offset k*16; floats
          9..12 of the 16 hold the payload words (zeros without one)

Scenes beyond CHUNK_MAX_TRIS triangles build a :class:`ChunkedBVH`: a
forest of such trees over a spatial partition, walked chunk by chunk
(:func:`build_bvh_chunked_np`). Large builds are cached on disk
(``GLAZE_CACHE_DIR``, see :func:`build_bvh_np`).

The payload is the baked 8x8 barycentric opacity mask of each triangle
(:func:`pack_alpha_masks`, attached by :func:`attach_tri_payload`): int32
words carried as float32 bits. They move only as int32 views and take no
float arithmetic (ROADMAP F7).

:func:`closest_hit` / :func:`any_hit` and the masked
:func:`closest_hit_masked` / :func:`any_hit_masked` are the PLAIN versions
of the CUDA kernels in :mod:`glaze_tpu_torch.accel.traverse_cuda`: the XLA
walkers of ``glaze_tpu/accel/bvh.py`` as vectorised torch loops, except
that each ray walks its own octant's order in ``nodes16``, as the kernels
(and the Pallas kernels) do, where the XLA walker walks octant 0's. The
results differ from the XLA walker's only where two triangles tie on t
(ROADMAP F3, F9); against the kernels they are bit-identical, and their
node visits (:class:`WalkStats`) are the kernels'. They run on any
device; the CPU tests use them, and the chip smoke holds the kernels
against them on the card.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import tempfile
import zipfile
import zlib

import numpy as np
import torch

from glaze_tpu_torch.utils.runtime import count, traced

LEAF_SIZE = 8

# Matches the reference's ray t bounds (path_trace.rgen:169, raytracer.rs)
T_MIN = 1e-4
SENTINEL = np.uint32(0xFFFFFFFF)

# Scenes beyond this many triangles build a ChunkedBVH forest
# (:func:`build_bvh_chunked_np`). The JAX package chose it for the TPU's
# VMEM; the port keeps it for parity, so one scene builds the same forest
# in both packages. Read at call time (tests lower it).
CHUNK_MAX_TRIS = 1_000_000


class BVH:
    """Device BVH: ``nodes``/``tri`` (octant-0 plain layout; the plain
    walkers read triangles from ``tri``), ``nodes16``/``tri8`` (the
    128-float-row packing; the kernels and the plain walkers walk the
    octant slabs of ``nodes16``), and
    the host ints ``n_nodes`` (M) and ``n_tris`` (real triangle count;
    0 for an empty scene, whose placeholder rows are never reported)."""

    def __init__(self, nodes, tri, nodes16, tri8, n_nodes: int, n_tris: int):
        self.nodes = nodes
        self.tri = tri
        self.nodes16 = nodes16
        self.tri8 = tri8
        self.n_nodes = int(n_nodes)
        self.n_tris = int(n_tris)

    def to(self, device) -> "BVH":
        return BVH(self.nodes.to(device), self.tri.to(device),
                   self.nodes16.to(device), self.tri8.to(device),
                   self.n_nodes, self.n_tris)


def _pack_lane_dense(rows: np.ndarray, per_row: int, stride: int) -> np.ndarray:
    """(K, F) -> (ceil(K/per_row), 128), item k at [k//per_row,
    (k%per_row)*stride : +F]."""
    k, f = rows.shape
    if per_row * stride != 128 or f > stride:
        raise ValueError("bad lane packing")
    nrows = -(-k // per_row)
    padded = np.zeros((nrows * per_row, stride), np.float32)
    padded[:k, :f] = rows
    return padded.reshape(nrows, 128)


def _pad_rows8(p: np.ndarray) -> np.ndarray:
    rows8 = -(-p.shape[0] // 8) * 8
    if rows8 == p.shape[0]:
        return p
    return np.concatenate([p, np.zeros((rows8 - p.shape[0], 128), np.float32)])


def _pack_octant_nodes(oct_tables: dict, m: int):
    """All 8 octant node layouts, each packed 16 nodes per 128-float row and
    padded to a multiple of 8 rows, stacked to (8*M16, 128); plus the
    octant-0 (M, 8) plain table."""
    packed = []
    nodes0 = None
    for o in range(8):
        nodes = np.zeros((m, 8), np.float32)
        nodes[:, 0:3] = oct_tables["bmin"][o]
        nodes[:, 3:6] = oct_tables["bmax"][o]
        is_leaf = oct_tables["first"][o] >= 0
        # count-1 in the low 3 bits (count can be LEAF_SIZE=8)
        meta = np.where(
            is_leaf,
            oct_tables["first"][o] * 8 + (oct_tables["count"][o] - 1),
            -1,
        ).astype(np.int32)
        skip = np.where(
            oct_tables["skip"][o] < 0, m, oct_tables["skip"][o]
        ).astype(np.int32)
        nodes[:, 6] = meta.view(np.float32)
        nodes[:, 7] = skip.view(np.float32)
        packed.append(_pad_rows8(_pack_lane_dense(nodes, 16, 8)))
        if o == 0:
            nodes0 = nodes
    return np.concatenate(packed, axis=0), nodes0


def sorted_tri_rows(tri_verts: np.ndarray, order: np.ndarray) -> np.ndarray:
    """(N_pad, 9) f32 (v0, e1, e2) rows of ``tri_verts`` in the tree's padded
    leaf ``order``; SENTINEL (padding) rows are zero, degenerate, never hit."""
    sent = order == SENTINEL
    safe = np.where(sent, 0, order).astype(np.int64)
    tri_sorted = tri_verts[safe]
    tri_sorted[sent] = 0.0
    v0 = tri_sorted[:, 0]
    e1 = tri_sorted[:, 1] - v0
    e2 = tri_sorted[:, 2] - v0
    return np.concatenate([v0, e1, e2], axis=1).astype(np.float32)


# --- the build's disk cache ------------------------------------------------
# The octant node slab and the leaf permutation are a deterministic function
# of the triangle soup, and a large scene's build takes seconds of host time
# on every start; they are cached under GLAZE_CACHE_DIR (default
# ~/.cache/glaze_tpu_torch; "0" turns the cache off), keyed by a hash of the
# triangle bytes. The port's files are named apart from the JAX package's
# (which are "<hash>_<n>_<leaf>_v<k>.npz" under ~/.cache/glaze_tpu/bvh), so
# neither package reads the other's. Bump _CACHE_VERSION whenever the node
# packing or the native BVH build's output changes.
_CACHE_VERSION = 1
CACHE_MIN_TRIS = 4096  # below this a direct build beats the file IO
_CACHE_PREFIX = "glaze_torch_bvh_"


def _cache_dir():
    d = os.environ.get("GLAZE_CACHE_DIR")
    if d == "0":
        return None
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache", "glaze_tpu_torch")
    p = os.path.join(d, "bvh")
    try:
        os.makedirs(p, exist_ok=True)
    except OSError:
        return None
    return p


def _cache_path(tri_verts: np.ndarray, leaf_size: int):
    """The cache file of ``tri_verts`` (None with the cache off): the key is
    the port's xxh64 of the triangle bytes (native), else blake2b (the pure
    Python xxh64 is too slow for megabytes)."""
    d = _cache_dir()
    if d is None:
        return None
    from glaze_tpu_torch.core.xxh64 import _get_native

    data = tri_verts.tobytes()
    native = _get_native()
    if native is not None:
        h = f"{native.xxh64(data, _CACHE_VERSION):016x}"
    else:
        h = hashlib.blake2b(data + bytes([_CACHE_VERSION]),
                            digest_size=8).hexdigest()
    return os.path.join(d, f"{_CACHE_PREFIX}{h}_{tri_verts.shape[0]}_"
                           f"{leaf_size}_v{_CACHE_VERSION}.npz")


def _cache_load(path):
    """(nodes16, m, order) from ``path``, or None: a missing or unreadable
    file means no cache, never an error."""
    try:
        with np.load(path) as z:
            return z["nodes16"], int(z["m"]), z["order"]
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile,
            zlib.error):
        return None


def _cache_store(path, nodes16, m, order):
    """Writes the build's node slab and permutation to ``path`` atomically
    (a temporary file in the same directory, then ``os.replace``), so
    concurrent processes race safely; a failed write leaves no file."""
    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz")
    except OSError:
        return
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, nodes16=nodes16, m=np.int64(m), order=order)
        os.replace(tmp, path)
    except OSError:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


@traced("setup.bvh")
def build_bvh_np(tri_verts: np.ndarray, leaf_size: int = LEAF_SIZE):
    """Host build over (N, 3, 3) world-space triangles. Returns
    ``(fields, tri_order)``: ``fields`` holds the NumPy tables
    (``nodes``, ``tri``, ``nodes16``, ``tri8``, ``n_nodes``, ``n_tris``)
    and ``tri_order`` is the PADDED leaf-aligned permutation (uint32,
    SENTINEL entries are leaf padding). From CACHE_MIN_TRIS triangles on,
    the octant slab and the permutation come from the disk cache when it
    holds them, and ``nodes``, ``tri`` and ``tri8`` are derived from them
    (the counters ``bvh.cache_hit`` and ``bvh.cache_miss``)."""
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    n = tri_verts.shape[0]
    if n == 0:
        nodes = np.zeros((1, 8), np.float32)
        meta = np.zeros((1, 2), np.int32)
        meta[0] = [0, 1]  # empty leaf encodes count-1 = 0, skip = 1
        nodes[:, 6:8] = meta.view(np.float32)
        tri0 = np.zeros((leaf_size, 9), np.float32)
        n16 = _pad_rows8(_pack_lane_dense(nodes, 16, 8))
        fields = dict(nodes=nodes, tri=tri0, nodes16=np.tile(n16, (8, 1)),
                      tri8=_pack_lane_dense(tri0, 8, 16), n_nodes=1, n_tris=0)
        return fields, np.zeros(0, np.uint32)
    path = _cache_path(tri_verts, leaf_size) if n >= CACHE_MIN_TRIS else None
    cached = _cache_load(path) if path is not None else None
    if path is not None:
        count("bvh.cache_miss" if cached is None else "bvh.cache_hit")
    if cached is not None:
        nodes16, m, order = cached
        # octant 0 fills the slab's first ceil(m/16) rows, node k at
        # flat float offset k*8
        nodes0 = nodes16[:-(-m // 16)].reshape(-1, 8)[:m]
    else:
        from glaze_tpu_torch import native

        oct_tables = native.get_lib().bvh_build_octants(tri_verts, leaf_size)
        m = oct_tables["bmin"].shape[1]
        order = oct_tables["tri_order"]
        nodes16, nodes0 = _pack_octant_nodes(oct_tables, m)
        if path is not None:
            _cache_store(path, nodes16, m, order)
    tri = sorted_tri_rows(tri_verts, order)
    fields = dict(nodes=nodes0, tri=tri, nodes16=nodes16,
                  tri8=_pack_lane_dense(tri, 8, 16), n_nodes=int(m),
                  n_tris=int(n))
    return fields, order


def float_table_to(a: np.ndarray, device) -> torch.Tensor:
    """float32 table -> tensor on ``device``, moved as int32 bits so the
    meta/skip carrier slots cross bitwise."""
    a = np.array(a, dtype=np.float32, order="C")  # copies; keeps 0-d shapes
    return torch.from_numpy(a.view(np.int32)).to(device).view(torch.float32)


class ChunkedBVH:
    """A forest of :class:`BVH` chunks over a spatial partition of the
    triangles, for scenes beyond CHUNK_MAX_TRIS (the JAX package's
    ``ChunkedBVH``). The dispatchers of :mod:`glaze_tpu_torch.accel` walk
    the chunks in turn through the same kernels: a closest walk caps each
    chunk at the best t so far, an any-hit walk passes only the rays not
    yet blocked on. ``offsets[i]`` is chunk i's first row in the forest's
    concatenated leaf order, so a hit's triangle id is chunk-local plus
    the offset. ``n_tris``: the real triangle count."""

    def __init__(self, chunks, offsets, n_tris: int):
        self.chunks = tuple(chunks)
        self.offsets = tuple(int(o) for o in offsets)
        self.n_tris = int(n_tris)

    def to(self, device) -> "ChunkedBVH":
        return ChunkedBVH([c.to(device) for c in self.chunks], self.offsets,
                          self.n_tris)


def bvh_from_np(fields: dict, device):
    """The device tree of host tables: a :class:`BVH`, or a
    :class:`ChunkedBVH` for the chunked form of
    :func:`build_bvh_chunked_np` (``chunks``, ``offsets``, ``n_tris``)."""
    if "chunks" in fields:
        return ChunkedBVH([bvh_from_np(c, device) for c in fields["chunks"]],
                          fields["offsets"], fields["n_tris"])
    return BVH(float_table_to(fields["nodes"], device),
               float_table_to(fields["tri"], device),
               float_table_to(fields["nodes16"], device),
               float_table_to(fields["tri8"], device),
               int(fields["n_nodes"]), int(fields["n_tris"]))


def build_bvh(tri_verts: np.ndarray, device, leaf_size: int = LEAF_SIZE):
    """Builds a BVH on ``device``; returns ``(bvh, tri_order)`` (see
    :func:`build_bvh_np`)."""
    fields, order = build_bvh_np(tri_verts, leaf_size)
    return bvh_from_np(fields, device), order


@traced("setup.bvh")
def build_bvh_chunked_np(tri_verts: np.ndarray, leaf_size: int = LEAF_SIZE,
                         max_tris: int | None = None):
    """The host tables of one tree when the scene has at most ``max_tris``
    triangles (default CHUNK_MAX_TRIS, read at call time), else of a
    forest: ``({"chunks": [tables, ...], "offsets": [...], "n_tris": N},
    tri_order)``. The triangles are split recursively at the median of
    their centroids along the centroids' longest axis (a stable sort)
    until each part fits; each part gets its own tree (cached as
    :func:`build_bvh_np` caches). ``tri_order`` is the global padded leaf
    order over all chunks (SENTINEL for padding), chunk after chunk."""
    if max_tris is None:
        max_tris = CHUNK_MAX_TRIS
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    n = tri_verts.shape[0]
    if n <= max_tris:
        return build_bvh_np(tri_verts, leaf_size)
    centroid = tri_verts.mean(axis=1)
    parts = []

    def split(idx):
        if idx.shape[0] <= max_tris:
            parts.append(idx)
            return
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        mid = idx.shape[0] // 2
        split(idx[order[:mid]])
        split(idx[order[mid:]])

    split(np.arange(n, dtype=np.int64))
    chunks, offsets, orders = [], [], []
    base = 0
    for idx in parts:
        fields_c, order_c = build_bvh_np(tri_verts[idx], leaf_size)
        sent = order_c == SENTINEL
        orders.append(np.where(
            sent, SENTINEL,
            idx[np.where(sent, 0, order_c.astype(np.int64))]).astype(np.uint32))
        chunks.append(fields_c)
        offsets.append(base)
        base += fields_c["tri"].shape[0]
    return ({"chunks": chunks, "offsets": offsets, "n_tris": n},
            np.concatenate(orders))


def build_bvh_chunked(tri_verts: np.ndarray, device,
                      leaf_size: int = LEAF_SIZE, max_tris: int | None = None):
    """:func:`build_bvh_chunked_np` on ``device``: ``(tree, tri_order)``,
    the tree a :class:`BVH` or a :class:`ChunkedBVH`."""
    fields, order = build_bvh_chunked_np(tri_verts, leaf_size, max_tris)
    return bvh_from_np(fields, device), order


# ---------------------------------------------------------------------------
# Per-triangle payloads (baked opacity cell masks)
# ---------------------------------------------------------------------------

# Payload slots inside a 16-slot triangle row: [0:9] v0/e1/e2, [9:9+K]
# payload words (int32 bits viewed as float32, like the nodes' meta/skip).
TRI_PAYLOAD_BASE = 9
TRI_PAYLOAD_MAX = 16 - TRI_PAYLOAD_BASE

# 8x8 barycentric opacity mask: 64 cells x 2 bits packed little-endian into
# 4 int32 words at payload slots 0..3. Cell (cu, cv) with
# cu = min(floor(u*8), 7), cv = min(floor(v*8), 7), index c = cv*8 + cu,
# word c >> 4, shift (c & 15)*2. Codes (scene.flatten._classify_alpha_cells):
#   0 = MIXED (needs the exact texture test; the all-zero default is safe)
#   1 = OPAQUE (alpha >= 0.5 everywhere in the cell)
#   2 = TRANSPARENT (alpha < 0.5 everywhere: the walk skips the hit)
ALPHA_MASK_GRID = 8
ALPHA_MASK_WORDS = (ALPHA_MASK_GRID * ALPHA_MASK_GRID * 2 + 31) // 32


def attach_tri_payload(fields: dict, payload: np.ndarray) -> dict:
    """Host tables of :func:`build_bvh_np` with ``payload`` ((N_pad, K<=7)
    int32 words, in the tree's padded leaf order) packed into slots
    9..9+K of every triangle row: ``tri`` becomes (N_pad, 9+K) and
    ``tri8`` carries the words at floats 9.. of each 16-float row. A
    forest's tables take each chunk's rows of ``payload`` in turn."""
    payload = np.ascontiguousarray(payload, np.int32)
    if "chunks" in fields:
        out, base = [], 0
        for c in fields["chunks"]:
            rows = c["tri"].shape[0]
            out.append(attach_tri_payload(c, payload[base:base + rows]))
            base += rows
        if base != payload.shape[0]:
            raise ValueError(f"payload rows {payload.shape[0]} != forest "
                             f"rows {base}")
        return dict(fields, chunks=out)
    k = payload.shape[1]
    if k > TRI_PAYLOAD_MAX:
        raise ValueError(f"payload of {k} words exceeds {TRI_PAYLOAD_MAX}")
    tri = np.asarray(fields["tri"], np.float32)[:, :TRI_PAYLOAD_BASE]
    if payload.shape[0] != tri.shape[0]:
        raise ValueError(f"payload rows {payload.shape} != tri rows "
                         f"{tri.shape}")
    full = np.concatenate([tri, payload.view(np.float32)], axis=1)
    return dict(fields, tri=full, tri8=_pack_lane_dense(full, 8, 16))


def has_payload(bvh) -> bool:
    """True when the tree carries the opacity-mask payload words (a forest
    when every chunk does)."""
    if isinstance(bvh, ChunkedBVH):
        return all(has_payload(c) for c in bvh.chunks)
    tri = bvh.tri
    return tri.dim() == 2 and tri.shape[1] >= TRI_PAYLOAD_BASE + ALPHA_MASK_WORDS


def pack_alpha_masks(codes: np.ndarray) -> np.ndarray:
    """(N, 64) cell codes {0,1,2} -> (N, ALPHA_MASK_WORDS) int32 payload."""
    n = codes.shape[0]
    out = np.zeros((n, ALPHA_MASK_WORDS), np.uint32)
    c = codes.astype(np.uint32)
    for cell in range(codes.shape[1]):
        out[:, cell >> 4] |= c[:, cell] << ((cell & 15) * 2)
    return out.view(np.int32)


def _mask_cell(u, v, hit):
    """Cell index cv*8 + cu at barycentric (u, v). Only lanes with ``hit``
    read a real cell: a miss's u/v may be huge or NaN, so they take cell 0
    instead of an undefined float->int cast."""
    g = ALPHA_MASK_GRID
    zero = torch.zeros_like(u)
    cu = torch.clamp((torch.where(hit, u, zero) * g).to(torch.int32), 0, g - 1)
    cv = torch.clamp((torch.where(hit, v, zero) * g).to(torch.int32), 0, g - 1)
    return cv * g + cu


def _mask_bits(words, u, v, hit):
    """Cell code at barycentric (u, v) from (..., 4) int32 payload words
    (cell 0 where not ``hit``, see :func:`_mask_cell`)."""
    cell = _mask_cell(u, v, hit)
    w = torch.gather(words, -1, (cell >> 4).long().unsqueeze(-1)).squeeze(-1)
    return (w >> ((cell & 15) * 2)) & 3


# ---------------------------------------------------------------------------
# Plain walkers
# ---------------------------------------------------------------------------


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal direction, the XLA walker's rule
    (glaze_tpu/accel/bvh.py:654-658):
    |d| < 1e-20 maps to 1e20*sign(d), and an exact 0 to +1e20. The CUDA
    kernels use the same rule."""
    tiny = torch.abs(d) < 1e-20
    big = 1e20 * torch.sign(d) + 1e20 * (d == 0.0).to(torch.float32)
    return torch.where(tiny, big, 1.0 / d)


def _slab_test(row, o, inv, t_max):
    """Ray/AABB slab test of node rows (K, 8) against rays (K, 3)."""
    t0 = (row[:, 0:3] - o) * inv
    t1 = (row[:, 3:6] - o) * inv
    tsmall = torch.minimum(t0, t1)
    tbig = torch.maximum(t0, t1)
    tenter = torch.amax(tsmall, dim=1)
    texit = torch.amin(tbig, dim=1)
    return (tenter <= texit) & (texit >= T_MIN) & (tenter <= t_max)


def _tri_intersect(trow, o, d):
    """Moller-Trumbore of rays (K, 1, 3) against rows (K, L, 9); sums in
    x + y + z order like the kernels. Returns (t, u, v, hit), each (K, L)."""
    v0x, v0y, v0z = trow[..., 0], trow[..., 1], trow[..., 2]
    e1x, e1y, e1z = trow[..., 3], trow[..., 4], trow[..., 5]
    e2x, e2y, e2z = trow[..., 6], trow[..., 7], trow[..., 8]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) >= 1e-12
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return t, u, v, hit


def _leaf_rows(bvh: BVH, first, count):
    """(K, LEAF_SIZE) triangle ids and validity of the leaves at ``first``."""
    k = torch.arange(LEAF_SIZE, device=first.device)
    ids = first[:, None] + k[None, :]
    valid = k[None, :] < count[:, None]
    ids = torch.clamp(ids, max=bvh.tri.shape[0] - 1)
    return ids, valid


class WalkStats:
    """Work counters of one plain walk, for the chip smoke's bound: node
    visits, triangle tests, in the masked walks the cell lookups of hits
    closer than the best, and in the fat-leaf walks the leaf columns
    tested (``*_visits``/``*_tests``, with repeats), and the DISTINCT
    table rows the walk read (:meth:`distinct`: node rows, triangle rows,
    payload words ``row*4 + word``, fat-leaf coefficient rows).

    It also keeps, for each ray, its node steps (``lane_steps``) and the
    leaves it entered (``lane_leaves``), (R,) int64 tensors, from which
    :meth:`warp_counters` reads how a warp of a one-thread-per-ray kernel
    spends its steps."""

    def __init__(self):
        self.node_visits = 0
        self.tri_tests = 0
        self.mask_tests = 0
        self.col_tests = 0
        self._seen = {}
        self.lane_steps = None
        self.lane_leaves = None

    def count_lanes(self, lanes, entered, n_rays: int):
        """One node step for each ray of ``lanes`` (ray indices, distinct)
        and one leaf for those where ``entered``."""
        if self.lane_steps is None:
            self.lane_steps = torch.zeros(n_rays, dtype=torch.int64,
                                          device=lanes.device)
            self.lane_leaves = torch.zeros_like(self.lane_steps)
        self.lane_steps[lanes] += 1
        self.lane_leaves[lanes[entered]] += 1

    def warp_counters(self, warp: int = 32) -> dict:
        """Over warps of ``warp`` consecutive rays (thread i = ray i; the
        last warp padded with idle lanes): ``simd_efficiency`` of the node
        walk, sum of steps / (warp x the warp's most steps) summed over
        warps; ``mean_leaves_per_lane``; ``mean_warp_max_leaves``, the
        mean over warps of the most leaves one lane entered (the drain
        rounds of a warp that postpones its leaves)."""
        steps, leaves = self.lane_steps, self.lane_leaves
        if steps is None:
            raise ValueError("WalkStats recorded no walk")
        pad = -steps.numel() % warp
        s = torch.nn.functional.pad(steps, (0, pad)).view(-1, warp)
        lv = torch.nn.functional.pad(leaves, (0, pad)).view(-1, warp)
        return {"simd_efficiency": float(s.sum()) / max(
                    float(s.amax(1).sum()) * warp, 1.0),
                "mean_leaves_per_lane": float(leaves.double().mean()),
                "mean_warp_max_leaves": float(lv.amax(1).double().mean())}

    def touch(self, what: str, rows, size: int):
        """Marks ``rows`` (int tensor) of a ``size``-row table read."""
        seen = self._seen.get(what)
        if seen is None:
            seen = self._seen[what] = torch.zeros(size, dtype=torch.bool,
                                                  device=rows.device)
        seen[rows] = True

    def distinct(self, what: str) -> int:
        """Distinct rows of ``what`` ("nodes", "tris", "mask_words",
        "coef") read."""
        seen = self._seen.get(what)
        return 0 if seen is None else int(seen.sum())


def _payload_words(bvh: BVH, ids):
    """(K, L, 4) int32 payload words of triangle rows ``ids``, gathered
    from an int32 view of ``tri`` (no float op touches the bits)."""
    words = bvh.tri.view(torch.int32)[:, TRI_PAYLOAD_BASE:
                                      TRI_PAYLOAD_BASE + ALPHA_MASK_WORDS]
    return words[ids]


def _node_table(bvh: BVH, direction):
    """The node rows a walk reads and each ray's first row in them:
    nodes16 as (8*M16*16, 8) rows and the slab of each ray's direction
    octant, the order the CUDA kernels walk."""
    octant = ((direction[:, 0] >= 0.0).long()
              + 2 * (direction[:, 1] >= 0.0).long()
              + 4 * (direction[:, 2] >= 0.0).long())
    return (bvh.nodes16.view(-1, 8),
            octant * ((bvh.nodes16.shape[0] // 8) * 16))


def _touch_leaf(stats, bvh, ids, valid, looked=None, u=None, v=None):
    """Records a leaf step's distinct triangle rows (and the payload words
    of the cell lookups ``looked``) in ``stats``."""
    stats.tri_tests += int(valid.sum())
    stats.touch("tris", ids[valid], bvh.tri.shape[0])
    if looked is not None:
        stats.mask_tests += int(looked.sum())
        word = (_mask_cell(u, v, looked) >> 4).long()
        stats.touch("mask_words", (ids * ALPHA_MASK_WORDS + word)[looked],
                    bvh.tri.shape[0] * ALPHA_MASK_WORDS)


def _closest_walk(bvh: BVH, origin, direction, t_max, stats, masked: bool):
    """The closest-hit walk, unmasked or honouring the payload's cells (the
    plain form of the kernel template ``closest_kernel<kMasked>``)."""
    dev = origin.device
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    table, base = _node_table(bvh, direction)
    r = origin.shape[0]
    m = bvh.n_nodes
    inv_dir = safe_inv(direction)
    if t_max is None:
        best_t = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    else:
        best_t = torch.broadcast_to(
            torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,)).clone()
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_mix = torch.zeros((r,), dtype=torch.bool, device=dev)

    lane = torch.arange(r, device=dev)
    ptr = torch.zeros((r,), dtype=torch.int64, device=dev)
    o, d, inv = origin, direction, inv_dir
    bt, btri, bu, bv, bmix = best_t, best_tri, best_u, best_v, best_mix
    while lane.numel():
        row = table[base + ptr]
        meta = row[:, 6].contiguous().view(torch.int32)
        skip = row[:, 7].contiguous().view(torch.int32).long()
        box_hit = _slab_test(row, o, inv, bt)
        is_leaf = meta >= 0
        leaf = box_hit & is_leaf
        if stats is not None:
            stats.node_visits += lane.numel()
            stats.touch("nodes", base + ptr, table.shape[0])
            stats.count_lanes(lane, leaf, r)
        li = torch.nonzero(leaf).squeeze(1)
        if li.numel():
            lm = meta[li]
            ids, valid = _leaf_rows(bvh, (lm >> 3).long(), (lm & 7).long() + 1)
            t, u, v, hit = _tri_intersect(bvh.tri[ids], o[li, None, :],
                                          d[li, None, :])
            keep = valid & hit & (t < bt[li, None])
            if stats is not None:
                # only hits closer than the best read their cell
                _touch_leaf(stats, bvh, ids, valid, keep if masked else None,
                            u, v)
            if masked:
                bits = _mask_bits(_payload_words(bvh, ids), u, v, keep)
                keep = keep & (bits != 2)  # TRANSPARENT: skip the hit
            t = torch.where(keep, t, torch.full_like(t, float("inf")))
            tmin, kmin = torch.min(t, dim=1)
            better = tmin < bt[li]
            bi = li[better]
            kb = kmin[better][:, None]
            bt[bi] = tmin[better]
            btri[bi] = torch.gather(ids[better], 1, kb)[:, 0].to(torch.int32)
            bu[bi] = torch.gather(u[better], 1, kb)[:, 0]
            bv[bi] = torch.gather(v[better], 1, kb)[:, 0]
            if masked:
                bmix[bi] = torch.gather(bits[better], 1, kb)[:, 0] == 0
        ptr = torch.where(box_hit & ~is_leaf, ptr + 1, skip)
        alive = ptr < m
        done = lane[~alive]
        if done.numel():
            best_t[done] = bt[~alive]
            best_tri[done] = btri[~alive]
            best_u[done] = bu[~alive]
            best_v[done] = bv[~alive]
            best_mix[done] = bmix[~alive]
            lane, ptr, base = lane[alive], ptr[alive], base[alive]
            o, d, inv = o[alive], d[alive], inv[alive]
            bt, btri, bu, bv = bt[alive], btri[alive], bu[alive], bv[alive]
            bmix = bmix[alive]
    found = best_tri >= 0
    t = torch.where(found, best_t, torch.full_like(best_t, float("inf")))
    out = {"t": t, "tri": best_tri, "u": best_u, "v": best_v}
    if masked:
        out["mixed"] = best_mix & found
    return out


def _any_walk(bvh: BVH, origin, direction, t_max, t_min, active, stats,
              masked: bool):
    """The any-hit walk, unmasked (returns hit) or 3-state over the
    payload's cells (returns blocked, pending): the plain form of the
    kernel template ``anyhit_kernel<kMasked>``. It tests a whole leaf
    where the kernel stops at the leaf's first blocking triangle, so its
    ``tri_tests`` may exceed the kernel's in a ray's last leaf."""
    dev = origin.device
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    table, base = _node_table(bvh, direction)
    r = origin.shape[0]
    m = bvh.n_nodes
    inv_dir = safe_inv(direction)
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,))
    blocked = torch.zeros((r,), dtype=torch.bool, device=dev)
    pending = torch.zeros((r,), dtype=torch.bool, device=dev)
    lane = torch.arange(r, device=dev)
    if active is not None:
        lane = lane[active]
    o, d, inv, tm = origin[lane], direction[lane], inv_dir[lane], t_max[lane]
    base = base[lane]
    ptr = torch.zeros(lane.shape, dtype=torch.int64, device=dev)
    while lane.numel():
        row = table[base + ptr]
        meta = row[:, 6].contiguous().view(torch.int32)
        skip = row[:, 7].contiguous().view(torch.int32).long()
        box_hit = _slab_test(row, o, inv, tm)
        is_leaf = meta >= 0
        leaf = box_hit & is_leaf
        if stats is not None:
            stats.node_visits += lane.numel()
            stats.touch("nodes", base + ptr, table.shape[0])
            stats.count_lanes(lane, leaf, r)
        blk_now = torch.zeros_like(leaf)
        li = torch.nonzero(leaf).squeeze(1)
        if li.numel():
            lm = meta[li]
            ids, valid = _leaf_rows(bvh, (lm >> 3).long(), (lm & 7).long() + 1)
            t, u, v, hit = _tri_intersect(bvh.tri[ids], o[li, None, :],
                                          d[li, None, :])
            new = valid & hit & (t > t_min) & (t < tm[li, None])
            if stats is not None:
                _touch_leaf(stats, bvh, ids, valid, new if masked else None,
                            u, v)
            if masked:
                bits = _mask_bits(_payload_words(bvh, ids), u, v, new)
                pend_now = (new & (bits == 0)).any(dim=1)
                pending[lane[li[pend_now]]] = True
                new = new & (bits == 1)  # only an OPAQUE cell blocks
            blk_now[li] = new.any(dim=1)
        blocked[lane[blk_now]] = True
        ptr = torch.where(box_hit & ~is_leaf, ptr + 1, skip)
        alive = (ptr < m) & ~blk_now
        if not bool(alive.all()):
            lane, ptr, base = lane[alive], ptr[alive], base[alive]
            o, d, inv, tm = o[alive], d[alive], inv[alive], tm[alive]
    if masked:
        return blocked, pending & ~blocked
    return blocked


def closest_hit(bvh: BVH, origin, direction, t_max=None, stats=None):
    """Closest-hit trace of (R, 3) rays, each in its own octant's order.

    Returns a dict of (R,) tensors: ``t`` (inf on a miss), ``tri`` (int32,
    -1 on a miss) and barycentrics ``u``/``v``. Hits in (T_MIN, t_max);
    a hit replaces the best only when strictly closer. Finished lanes are
    compacted out, so each step works only on rays still walking."""
    return _closest_walk(bvh, origin, direction, t_max, stats, masked=False)


def any_hit(bvh: BVH, origin, direction, t_max, t_min=1e-3, active=None,
            stats=None):
    """Shadow-ray trace: True where ANY triangle lies in (t_min, t_max).

    Each lane stops at its first hit (TerminateOnFirstHit semantics,
    path_trace.rgen:108-110). Lanes where ``active`` is False never walk
    and report False."""
    return _any_walk(bvh, origin, direction, t_max, t_min, active, stats,
                     masked=False)


def closest_hit_masked(bvh: BVH, origin, direction, t_max=None, stats=None):
    """Closest hit honouring the baked 8x8 opacity masks: hits whose cell
    is TRANSPARENT are skipped during the walk and never shrink the best
    t; ``mixed`` marks accepted hits whose cell is MIXED (they still need
    the exact texture test). Trees without a payload give
    :func:`closest_hit` with every hit mixed. Returns a dict of (R,)
    tensors ``t``, ``tri``, ``u``, ``v``, ``mixed`` (bool)."""
    if not has_payload(bvh):
        out = closest_hit(bvh, origin, direction, t_max, stats=stats)
        return dict(out, mixed=out["tri"] >= 0)
    return _closest_walk(bvh, origin, direction, t_max, stats, masked=True)


def any_hit_masked(bvh: BVH, origin, direction, t_max, t_min=1e-3,
                   active=None, stats=None):
    """Shadow-ray trace honouring the baked opacity cells. Returns
    ``(blocked, pending)``: ``blocked`` lanes hit an OPAQUE cell in
    (t_min, t_max); ``pending`` lanes saw only MIXED-cell hits (the
    caller resolves them with the exact texture test); TRANSPARENT cells
    never block. A lane stops at its first OPAQUE-cell hit; inactive lanes
    report False/False. Trees without a payload report every potential
    blocker as pending: ``(zeros, any_hit(...))``."""
    if not has_payload(bvh):
        blocked = any_hit(bvh, origin, direction, t_max, t_min=t_min,
                          active=active, stats=stats)
        return torch.zeros_like(blocked), blocked
    return _any_walk(bvh, origin, direction, t_max, t_min, active, stats,
                     masked=True)

"""Acceleration structures: SAH BVH builds, plain torch walkers and the
CUDA traversal kernels.

The ``*_soa_auto`` dispatchers choose by the DEVICE OF THE RAY TENSORS,
never by what the machine has: rays on the CPU take the plain walkers of
:mod:`glaze_tpu_torch.accel.bvh` (:mod:`~glaze_tpu_torch.accel.fat` for a
fat tree); rays on a CUDA device launch the kernels of
:mod:`glaze_tpu_torch.accel.traverse_cuda`, which raise if they cannot
build or launch.

Tree selection (the JAX package's, ``glaze_tpu/accel/__init__.py``):
``GLAZE_TREE=classic|fat|hybrid`` (legacy ``GLAZE_FATLEAF=0|1`` maps to
classic|fat; classic by default), read when a scene is uploaded
(:func:`build_bvh_auto`). ``fat`` builds the fat-leaf tree
(:class:`~glaze_tpu_torch.accel.fat.FatBVH`) for every trace; ``hybrid``
builds it for closest hits and a classic tree (``bvh_any``) for shadow
rays. A fat tree carries no opacity payload: the masked dispatchers give
its unmasked walk with every hit MIXED / every blocker pending.

Mapping of the JAX package's kernel knobs: ``GLAZE_WINDOWED_CLOSEST=0`` /
``GLAZE_WINDOWED_ANYHIT=0`` (while-while kernels), the streamed kernels
used beyond the VMEM budget and the sub-packet/dual-walk variants are
TPU schedules of the same two functions, so they all map onto the same
two CUDA kernels here and the port reads none of those variables. The fat
kernels' knobs are TPU schedules or timing probes too, and the port reads
none of them: ``GLAZE_FAT_QUEUE_MAX`` / ``GLAZE_FAT_QUEUE_MAX_ANY`` (leaf
queue depth), ``GLAZE_FAT_BATCHED`` (one wide dot per row),
``GLAZE_FAT_DOT2`` and ``GLAZE_FAT_DEFER_UV`` (measurement modes) and
``GLAZE_FAT_PRECISION``: the port computes the leaf test in f32, which is
the JAX package's default "highest".

The ``*_masked_auto`` dispatchers honour the baked 8x8 opacity cell masks
of a tree that carries them (``bvh.attach_tri_payload``), on the masked
kernels; a tree without a payload takes the unmasked walk, with every hit
MIXED (closest) or every blocker pending (any hit), as in the JAX package.
The JAX package's TPU residency rule (``masked_anyhit_ok``'s VMEM check and
the masked kernels' unmasked fallback beyond VMEM) has no counterpart: a
tree with a payload always takes the masked kernels.
"""

import os

from glaze_tpu_torch.accel.bvh import (
    BVH,
    any_hit,
    any_hit_masked,
    build_bvh,
    build_bvh_chunked,
    build_bvh_np,
    bvh_from_np,
    check_tri_count,
    closest_hit,
    closest_hit_masked,
    has_payload,
)
from glaze_tpu_torch.accel.fat import (
    FatBVH,
    any_hit_fat,
    build_bvh_fat,
    build_bvh_fat_np,
    closest_hit_fat,
    fat_from_np,
)

# The fat tree is built only while its node slab (one octant of nodes16)
# fits this budget, else the classic tree. 12 MB is the JAX package's
# VMEM rule (the Pallas kernels keep the slab resident); the port keeps it
# for parity, so one scene builds the same tree in both packages.
_FAT_NODES_BUDGET = 12 * 1024 * 1024


def tree_mode() -> str:
    """``classic``, ``fat`` or ``hybrid`` from ``GLAZE_TREE`` (legacy
    ``GLAZE_FATLEAF=1``/``0`` means fat/classic); classic by default."""
    v = os.environ.get("GLAZE_TREE", "")
    if v in ("classic", "fat", "hybrid"):
        return v
    return "fat" if os.environ.get("GLAZE_FATLEAF", "") == "1" else "classic"


def build_bvh_auto_np(tri_verts, leaf_size=None):
    """Host tables of the tree(s) :func:`tree_mode` asks for. Returns
    ``(fields, tri_order, any_fields)``: ``fields`` serves closest hits
    and defines the triangle order (a fat tree's carry ``leafmat``);
    ``any_fields`` is the classic any-hit tree in hybrid mode, else None.
    A fat node slab beyond the budget builds the classic tree alone.
    ``leaf_size`` sets the fat tree's leaves."""
    mode = tree_mode()
    n = int(tri_verts.shape[0])
    if mode in ("fat", "hybrid"):
        fields, order = build_bvh_fat_np(tri_verts, leaf_size)
        slab = (fields["nodes16"].shape[0] // 8) * 128 * 4
        if slab <= _FAT_NODES_BUDGET:
            if mode == "hybrid":
                check_tri_count(n)
                return fields, order, build_bvh_np(tri_verts)[0]
            return fields, order, None
    check_tri_count(n)
    fields, order = build_bvh_np(tri_verts)
    return fields, order, None


def tree_from_np(fields: dict, device):
    """A :class:`FatBVH` (when ``fields`` hold ``leafmat``) or a
    :class:`BVH` on ``device`` from host tables."""
    if "leafmat" in fields:
        return fat_from_np(fields, device)
    return bvh_from_np(fields, device)


def build_bvh_auto(tri_verts, device, leaf_size=None):
    """:func:`build_bvh_auto_np` on ``device``: ``(bvh, tri_order,
    bvh_any)``."""
    fields, order, any_fields = build_bvh_auto_np(tri_verts, leaf_size)
    any_tree = None if any_fields is None else bvh_from_np(any_fields, device)
    return tree_from_np(fields, device), order, any_tree


def closest_hit_soa_auto(bvh, origin3, direction3, t_max=None):
    """Closest hit of SoA rays: the CUDA kernel for CUDA tensors, the plain
    walker for CPU tensors."""
    fat = isinstance(bvh, FatBVH)
    if origin3[0].is_cuda:
        from glaze_tpu_torch.accel import traverse_cuda

        if fat:
            return traverse_cuda.closest_hit_fat_soa(bvh, origin3, direction3,
                                                     t_max)
        return traverse_cuda.closest_hit_soa(bvh, origin3, direction3, t_max)
    import torch

    walk = closest_hit_fat if fat else closest_hit
    return walk(bvh, torch.stack(origin3, -1), torch.stack(direction3, -1),
                t_max)


def any_hit_soa_auto(bvh, origin3, direction3, t_max, t_min=1e-3, active=None):
    """Any hit of SoA rays: the CUDA kernel for CUDA tensors, the plain
    walker for CPU tensors."""
    fat = isinstance(bvh, FatBVH)
    if origin3[0].is_cuda:
        from glaze_tpu_torch.accel import traverse_cuda

        launch = traverse_cuda.any_hit_fat_soa if fat else traverse_cuda.any_hit_soa
        return launch(bvh, origin3, direction3, t_max, t_min=t_min,
                      active=active)
    import torch

    walk = any_hit_fat if fat else any_hit
    return walk(bvh, torch.stack(origin3, -1), torch.stack(direction3, -1),
                t_max, t_min=t_min, active=active)


def closest_hit_soa_masked_auto(bvh, origin3, direction3, t_max=None):
    """:func:`closest_hit_soa_auto` honouring the baked opacity masks:
    TRANSPARENT-cell hits are skipped in the walk, and ``mixed`` marks the
    accepted hits that still need the exact texture test. A tree without
    a payload (a fat tree among them) gives the unmasked closest hit with
    ``mixed = tri >= 0``."""
    if not has_payload(bvh):
        out = closest_hit_soa_auto(bvh, origin3, direction3, t_max)
        return dict(out, mixed=out["tri"] >= 0)
    if origin3[0].is_cuda:
        from glaze_tpu_torch.accel import traverse_cuda

        return traverse_cuda.closest_hit_soa_masked(bvh, origin3, direction3,
                                                    t_max)
    import torch

    return closest_hit_masked(bvh, torch.stack(origin3, -1),
                              torch.stack(direction3, -1), t_max)


def masked_anyhit_ok(bvh) -> bool:
    """True when :func:`any_hit_soa_masked_auto` runs the 3-state masked
    walk for this tree, i.e. exactly when the tree carries a payload (a
    fat tree never does). Callers that resolve ``pending`` against the
    alpha subset tree alone must check it: the payload-free form reports
    every blocker pending."""
    return has_payload(bvh)


def any_hit_soa_masked_auto(bvh, origin3, direction3, t_max, t_min=1e-3,
                            active=None):
    """:func:`any_hit_soa_auto` honouring the baked opacity cells: returns
    ``(blocked, pending)`` (see :func:`bvh.any_hit_masked`). A tree
    without a payload (a fat tree among them) gives ``(zeros, any hit)``:
    every blocker pending."""
    if not has_payload(bvh):
        blocked = any_hit_soa_auto(bvh, origin3, direction3, t_max,
                                   t_min=t_min, active=active)
        import torch

        return torch.zeros_like(blocked), blocked
    if origin3[0].is_cuda:
        from glaze_tpu_torch.accel import traverse_cuda

        return traverse_cuda.any_hit_soa_masked(bvh, origin3, direction3,
                                                t_max, t_min=t_min,
                                                active=active)
    import torch

    return any_hit_masked(bvh, torch.stack(origin3, -1),
                          torch.stack(direction3, -1), t_max, t_min=t_min,
                          active=active)


__all__ = [
    "BVH", "FatBVH", "build_bvh", "build_bvh_chunked", "build_bvh_fat",
    "build_bvh_auto", "build_bvh_auto_np", "tree_from_np", "tree_mode",
    "closest_hit", "any_hit", "closest_hit_masked", "any_hit_masked",
    "closest_hit_fat", "any_hit_fat",
    "closest_hit_soa_auto", "any_hit_soa_auto",
    "closest_hit_soa_masked_auto", "any_hit_soa_masked_auto",
    "masked_anyhit_ok",
]

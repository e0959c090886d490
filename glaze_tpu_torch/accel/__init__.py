"""Acceleration structures: SAH BVH build, plain torch walkers and the
CUDA traversal kernels.

The ``*_soa_auto`` dispatchers choose by the DEVICE OF THE RAY TENSORS,
never by what the machine has: rays on the CPU take the plain walkers of
:mod:`glaze_tpu_torch.accel.bvh`; rays on a CUDA device launch the
kernels of :mod:`glaze_tpu_torch.accel.traverse_cuda`, which raise if they
cannot build or launch.

Mapping of the JAX package's kernel knobs: ``GLAZE_WINDOWED_CLOSEST=0`` /
``GLAZE_WINDOWED_ANYHIT=0`` (while-while kernels), the streamed kernels
used beyond the VMEM budget and the sub-packet/dual-walk variants are
TPU schedules of the same two functions, so they all map onto the same
two CUDA kernels here and the port reads none of those variables.

The ``*_masked_auto`` dispatchers honour the baked 8x8 opacity cell masks
of a tree that carries them (``bvh.attach_tri_payload``), on the masked
kernels; a tree without a payload takes the unmasked walk, with every hit
MIXED (closest) or every blocker pending (any hit), as in the JAX package.
The JAX package's TPU residency rule (``masked_anyhit_ok``'s VMEM check and
the masked kernels' unmasked fallback beyond VMEM) has no counterpart: a
tree with a payload always takes the masked kernels. The fat tree
(``GLAZE_TREE=fat|hybrid``) is not ported yet.
"""

from glaze_tpu_torch.accel.bvh import (
    BVH,
    any_hit,
    any_hit_masked,
    build_bvh,
    build_bvh_chunked,
    closest_hit,
    closest_hit_masked,
    has_payload,
)


def closest_hit_soa_auto(bvh, origin3, direction3, t_max=None):
    """Closest hit of SoA rays: the CUDA kernel for CUDA tensors, the plain
    walker for CPU tensors."""
    if origin3[0].is_cuda:
        from glaze_tpu_torch.accel import traverse_cuda

        return traverse_cuda.closest_hit_soa(bvh, origin3, direction3, t_max)
    import torch

    return closest_hit(bvh, torch.stack(origin3, -1),
                       torch.stack(direction3, -1), t_max)


def any_hit_soa_auto(bvh, origin3, direction3, t_max, t_min=1e-3, active=None):
    """Any hit of SoA rays: the CUDA kernel for CUDA tensors, the plain
    walker for CPU tensors."""
    if origin3[0].is_cuda:
        from glaze_tpu_torch.accel import traverse_cuda

        return traverse_cuda.any_hit_soa(bvh, origin3, direction3, t_max,
                                         t_min=t_min, active=active)
    import torch

    return any_hit(bvh, torch.stack(origin3, -1), torch.stack(direction3, -1),
                   t_max, t_min=t_min, active=active)


def closest_hit_soa_masked_auto(bvh, origin3, direction3, t_max=None):
    """:func:`closest_hit_soa_auto` honouring the baked opacity masks:
    TRANSPARENT-cell hits are skipped in the walk, and ``mixed`` marks the
    accepted hits that still need the exact texture test. A tree without
    a payload gives the unmasked closest hit with ``mixed = tri >= 0``."""
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
    walk for this tree, i.e. exactly when the tree carries a payload.
    Callers that resolve ``pending`` against the alpha subset tree alone
    must check it: the payload-free form reports every blocker pending."""
    return has_payload(bvh)


def any_hit_soa_masked_auto(bvh, origin3, direction3, t_max, t_min=1e-3,
                            active=None):
    """:func:`any_hit_soa_auto` honouring the baked opacity cells: returns
    ``(blocked, pending)`` (see :func:`bvh.any_hit_masked`). A tree
    without a payload gives ``(zeros, any hit)``: every blocker pending."""
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
    "BVH", "build_bvh", "build_bvh_chunked", "closest_hit", "any_hit",
    "closest_hit_masked", "any_hit_masked",
    "closest_hit_soa_auto", "any_hit_soa_auto",
    "closest_hit_soa_masked_auto", "any_hit_soa_masked_auto",
    "masked_anyhit_ok",
]

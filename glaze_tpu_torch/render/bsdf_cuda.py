"""The BSDF stage of a launch: the accumulation, Russian roulette, the
BSDF sample and the path-state update of every lane.

:func:`bsdf` is what :func:`glaze_tpu_torch.render.integrator.launch_step`
calls. On CPU tensors it runs :func:`bsdf_plain`, the plain PyTorch
version (:func:`glaze_tpu_torch.render.bsdf.bsdf_sample` samples every
BSDF family present over every lane and selects). On CUDA tensors it
launches :func:`bsdf_kernel`, one hand-written kernel (``csrc/shade.cu``,
whose header note says what it replaces and what bounds it; the lane's
arithmetic is ``csrc/shade_lane.cuh`` ``bsdf_lane``), in the library that
holds the NEE kernel (:func:`glaze_tpu_torch.render.nee_cuda._load`
builds and loads it once a process and declares both kernels' entry
points). A missing ``nvcc``, a failed build,
an input the kernel does not take or a failed launch raises; nothing falls
back to the plain version.

Both return the new state's leaves but ``count`` and ``path_no``, by their
:class:`~glaze_tpu_torch.render.integrator.PathState` names:
``importance``, ``origin``, ``direction``, ``bounce``, ``last_specular``,
``accum`` and ``sq``. With ``direct_only`` (the DIRECT integrator) only
the accumulation runs: ``bounce`` is 0 and ``importance``, ``origin`` and
``direction`` are the state's own. The kernel reads the scene's tables in
place at every call (:func:`nee_cuda._table_pointers`), and the texels
that the NEE stage filed in ``mat``'s memo for these lanes (it fetches
them itself where there are none); it adds nothing to set-up.
:func:`bsdf_kernel` counts its launches in ``bsdf_kernel.launches`` and,
inside a recording, in the counter ``integrator.bsdf_kernels``.
"""

from __future__ import annotations

import ctypes

import torch

from glaze_tpu_torch.ops import shading, spectra, vec
from glaze_tpu_torch.render import bsdf as bsdf_mod
from glaze_tpu_torch.render import nee_cuda
from glaze_tpu_torch.scene import flatten as fl
from glaze_tpu_torch.utils import runtime

PT_STEPS = 6  # raytrace_structures.rs:87
RUSSIAN_ROULETTE = PT_STEPS // 2  # path_trace.rgen:11


def bsdf_plain(scene, state, hit, missed, wo_w, frame, mat, importance,
               miss_rgb, nee_rgb, draws, expand, direct_only=False):
    """The plain version (path_trace.rgen:119-133 and :186-239).
    ``state``: the PathState before the launch; ``hit``: the hit's
    ``point``, ``uv`` and ``shading_normal``; ``missed``: the lanes whose
    ray left the scene; ``frame``: the shading frame; ``importance``: the
    launch's (1 where the path regenerated); ``miss_rgb`` and ``nee_rgb``:
    the sky's and the NEE stage's RGB contributions, 3 x (P,) each;
    ``draws``: the roulette's draw and the BSDF sample's three at chain
    width C, which ``expand`` takes to lane width (None under
    ``direct_only``). Returns the dict of the module docstring."""
    enabled = scene.lights_no > 0  # path_trace.rgen:137-141
    mat_specular = mat["scalars"][fl.MS_IS_SPECULAR] > 0.5
    new_specular = torch.where(missed, state.last_specular,
                               mat_specular.to(torch.float32))

    en = enabled.to(torch.float32)
    accum = tuple(state.accum[i] + en * (miss_rgb[i] + nee_rgb[i])
                  for i in range(3))
    c_lum = en * (0.2126 * (miss_rgb[0] + nee_rgb[0])
                  + 0.7152 * (miss_rgb[1] + nee_rgb[1])
                  + 0.0722 * (miss_rgb[2] + nee_rgb[2]))
    sq = state.sq + c_lum * c_lum
    last_specular = torch.where(enabled, new_specular, state.last_specular)
    if direct_only:
        return {"importance": state.importance, "origin": state.origin,
                "direction": state.direction,
                "bounce": torch.zeros_like(state.bounce),
                "last_specular": last_specular, "accum": accum, "sq": sq}

    # ---- Russian roulette (path_trace.rgen:196-211)
    rr_roll, sa, sb_, sc = draws
    rr_active = state.bounce > RUSSIAN_ROULETTE
    kill_prob = torch.clamp(1.0 - spectra.luminance_t(importance), min=0.05)
    rr_kill = rr_active & (expand(rr_roll) < kill_prob)
    rr_scale = torch.where(rr_active, 1.0 / (1.0 - kill_prob),
                           torch.ones_like(kill_prob))
    importance = importance * rr_scale

    # ---- BSDF sampling (path_trace.rgen:212-228)
    wo = shading.to_shading_space_v(wo_w, frame)
    wi, value, pdf = bsdf_mod.bsdf_sample(scene, mat, wo, hit["uv"],
                                          (expand(sa), expand(sb_),
                                           expand(sc)))
    wi_w = shading.to_world_space_v(wi, frame)
    sample_dead = pdf <= 0.0
    weight = (torch.abs(vec.dot(wi_w, hit["shading_normal"]))
              / torch.clamp(pdf, min=1e-20))
    next_importance = importance * value * weight

    path_dead = missed | rr_kill | sample_dead
    # "if bounce < PT_STEPS inc else reset"
    at_max = state.bounce >= PT_STEPS
    new_bounce = torch.where(path_dead | at_max,
                             torch.zeros_like(state.bounce),
                             state.bounce + 1.0)

    upd = enabled & ~path_dead
    return {"importance": torch.where(upd, next_importance, state.importance),
            "origin": vec.where(upd, hit["point"], state.origin),
            "direction": vec.where(upd, wi_w, state.direction),
            "bounce": torch.where(enabled, new_bounce, state.bounce),
            "last_specular": last_specular, "accum": accum, "sq": sq}


# csrc/shade_lane.cuh BsdfArgs, field by field
_LANE_FLOATS = ("px", "py", "pz", "sx", "sy", "sz", "tx", "ty", "tz",
                "nx", "ny", "nz", "wox", "woy", "woz", "u", "v")
_STATE = ("state_importance", "ox", "oy", "oz", "dx", "dy", "dz", "bounce",
          "last_specular", "accum_r", "accum_g", "accum_b", "sq")
_TEXELS = ("diffuse_r", "diffuse_g", "diffuse_b", "roughness", "metalness")
_DRAWS = ("r_rr", "r_a", "r_b", "r_c")
_TABLES = ("lights_no", "mat_scalars", "mat_tex", "metal_ior",
           "metal_fresnel", "texels", "tex_offset", "tex_width", "tex_height",
           "tex_srgb")
# the outputs, as rows of one (K, P) buffer: (field, first row, rows)
_OUTPUTS = (("out_importance", 0, 16), ("out_ox", 16, 1), ("out_oy", 17, 1),
            ("out_oz", 18, 1), ("out_dx", 19, 1), ("out_dy", 20, 1),
            ("out_dz", 21, 1), ("out_bounce", 22, 1),
            ("out_last_specular", 23, 1), ("out_accum_r", 24, 1),
            ("out_accum_g", 25, 1), ("out_accum_b", 26, 1), ("out_sq", 27, 1))
_ROWS = 28
# under direct_only: bounce, last_specular, accum and sq only
_DIRECT_FIRST = 22
_SIZES = ("n_lanes", "lanes_per_chain", "tex_flags", "families",
          "first_family", "direct_only")


class BsdfArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        *_LANE_FLOATS, "mat_id", "missed", "importance", "miss_r", "miss_g",
        "miss_b", "nee_r", "nee_g", "nee_b", *_STATE, *_TEXELS, *_DRAWS,
        *_TABLES, "consts", *(o[0] for o in _OUTPUTS))]
        + [(n, ctypes.c_int) for n in _SIZES])


# the fields that take the texels of mat's memo, by key
_MEMO = {"diffuse": ("diffuse_r", "diffuse_g", "diffuse_b"),
         "rough": ("roughness",), "metal": ("metalness",)}


def kernel_attrs() -> dict:
    """bsdf_kernel's registers and local (spill) bytes per thread, threads
    per block, resident blocks per SM and the occupancy they give."""
    regs, local, threads, blocks, most = (ctypes.c_int() for _ in range(5))
    nee_cuda._check(nee_cuda._load().glaze_bsdf_attrs(*(
        ctypes.byref(x) for x in (regs, local, threads, blocks, most))),
        "the bsdf_kernel attribute query")
    return {"registers": regs.value, "local_bytes": local.value,
            "threads_per_block": threads.value, "blocks_per_sm": blocks.value,
            "occupancy": blocks.value * threads.value / most.value}


def prepare(scene, state, hit, missed, wo_w, frame, mat, importance,
            miss_rgb, nee_rgb, draws, direct_only=False, device_type="cuda"):
    """The kernel's arguments: checks the dtype, shape and contiguity of
    every input, that the lanes split into the draws' chains, then that
    each lies on a ``device_type`` device, and the same of the scene's
    tables, raising at the first that fails, and allocates the outputs.
    Returns ``(BsdfArgs, out)``, ``out`` the (K, P) buffer whose rows the
    kernel writes (:data:`_OUTPUTS`)."""
    check = nee_cuda._check_form
    check(importance, "importance", torch.float32, (16, None), "bsdf")
    p = importance.shape[1]
    s, t, n = frame
    ins = {"px": hit["point"][0], "py": hit["point"][1],
           "pz": hit["point"][2], "sx": s[0], "sy": s[1], "sz": s[2],
           "tx": t[0], "ty": t[1], "tz": t[2], "nx": n[0], "ny": n[1],
           "nz": n[2], "wox": wo_w[0], "woy": wo_w[1], "woz": wo_w[2],
           "u": hit["uv"][0], "v": hit["uv"][1],
           "miss_r": miss_rgb[0], "miss_g": miss_rgb[1],
           "miss_b": miss_rgb[2], "bounce": state.bounce,
           "last_specular": state.last_specular, "accum_r": state.accum[0],
           "accum_g": state.accum[1], "accum_b": state.accum[2],
           "sq": state.sq}
    if not direct_only:
        ins.update(ox=state.origin[0], oy=state.origin[1],
                   oz=state.origin[2], dx=state.direction[0],
                   dy=state.direction[1], dz=state.direction[2])
    # the texels of textured slots filed for these lanes (an untextured
    # slot's are the material's scalars, which the kernel reads itself)
    memo = mat.get("_texmemo", {})
    for slot, _, key, _ in nee_cuda._TEX_SLOTS:
        filed = memo.get(key)
        if (slot in scene.tex_slots and filed is not None
                and filed[0] is hit["uv"]):
            vals = filed[1] if isinstance(filed[1], tuple) else (filed[1],)
            ins.update(zip(_MEMO[key], vals))
    forms = {name: (torch.float32, (p,)) for name in ins}
    ins.update(mat_id=hit["material_id"], missed=missed,
               importance=importance, nee_rgb=nee_rgb)
    forms.update(mat_id=(torch.int32, (p,)), missed=(torch.bool, (p,)),
                 importance=(torch.float32, (16, p)),
                 nee_rgb=(torch.float32, (3, p)))
    c = 1
    if not direct_only:
        ins["state_importance"] = state.importance
        forms["state_importance"] = (torch.float32, (16, p))
        c = draws[0].shape[0] if draws[0].dim() == 1 else -1
        for name, x in zip(_DRAWS, draws):
            ins[name] = x
            forms[name] = (torch.float32, (c,))
    for name, x in ins.items():
        check(x, name, *forms[name], "bsdf")
    if c < 1 or p % c:
        raise ValueError(f"bsdf: {p} lanes do not split into chains of "
                         f"{c} draws")
    for name, x in ins.items():
        if x.device.type != device_type:
            raise ValueError(f"bsdf: {name} lies on {x.device}, not on a "
                             f"{device_type} device")
    dev = importance.device
    args = BsdfArgs()
    rgb = ins.pop("nee_rgb").data_ptr()
    for k, name in enumerate(("nee_r", "nee_g", "nee_b")):
        setattr(args, name, rgb + 4 * k * p)
    for name, x in ins.items():
        setattr(args, name, x.data_ptr())
    for field, ptr in nee_cuda._table_pointers(scene, device_type):
        if field in _TABLES:
            setattr(args, field, ptr)
    args.consts = nee_cuda.const(nee_cuda.CONSTS, dev).data_ptr()

    first = _DIRECT_FIRST if direct_only else 0
    out = torch.empty((_ROWS - first, p), dtype=torch.float32, device=dev)
    base = out.data_ptr()
    for field, row, _ in _OUTPUTS:
        if row >= first:
            setattr(args, field, base + 4 * (row - first) * p)
    flags = 0
    for slot, bit, _, _ in nee_cuda._TEX_SLOTS:
        if slot in scene.tex_slots:
            flags |= bit
    present = list(scene.mat_families) or [bsdf_mod.FAMILY_LAMBERT]
    args.n_lanes = p
    args.lanes_per_chain = p // c
    args.tex_flags = flags
    args.families = sum(1 << f for f in present[1:])
    args.first_family = present[0]
    args.direct_only = int(direct_only)
    return args, out


def _result(out, state, direct_only):
    """The dict of the module docstring from ``prepare``'s buffer."""
    rows = out.unbind(0)
    first = _DIRECT_FIRST if direct_only else 0
    new = {"bounce": rows[22 - first], "last_specular": rows[23 - first],
           "accum": rows[24 - first:27 - first], "sq": rows[27 - first]}
    if direct_only:
        new.update(importance=state.importance, origin=state.origin,
                   direction=state.direction)
    else:
        new.update(importance=out[:16], origin=rows[16:19],
                   direction=rows[19:22])
    return new


def bsdf_kernel(scene, state, hit, missed, wo_w, frame, mat, importance,
                miss_rgb, nee_rgb, draws, direct_only=False):
    """:func:`bsdf_plain`'s results from one launch of ``bsdf_kernel`` on
    CUDA tensors; raises on an input it does not take. The draws keep their
    chain width C (1, the tile count or the lane count): lane i reads draw
    i // (P // C)."""
    args, out = prepare(scene, state, hit, missed, wo_w, frame, mat,
                        importance, miss_rgb, nee_rgb, draws, direct_only)
    if args.n_lanes:
        stream = torch.cuda.current_stream(importance.device).cuda_stream
        nee_cuda._check(
            nee_cuda._load().glaze_bsdf_launch(ctypes.byref(args), stream),
            "the bsdf_kernel launch")
        bsdf_kernel.launches += 1
        runtime.count("integrator.bsdf_kernels")
    return _result(out, state, direct_only)


bsdf_kernel.launches = 0


def reset_launch_counts():
    bsdf_kernel.launches = 0


def bsdf(scene, state, hit, missed, wo_w, frame, mat, importance, miss_rgb,
         nee_rgb, draws, expand, direct_only=False):
    """The BSDF stage: :func:`bsdf_kernel` on CUDA tensors,
    :func:`bsdf_plain` on CPU ones."""
    if importance.is_cuda:
        return bsdf_kernel(scene, state, hit, missed, wo_w, frame, mat,
                           importance, miss_rgb, nee_rgb, draws, direct_only)
    return bsdf_plain(scene, state, hit, missed, wo_w, frame, mat, importance,
                      miss_rgb, nee_rgb, draws, expand, direct_only)

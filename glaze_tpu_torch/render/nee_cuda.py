"""The NEE stage before its shadow ray: the light sample, the BSDF value,
the weight and the unshadowed RGB contribution of every lane.

:func:`nee` is what :func:`glaze_tpu_torch.render.integrator.launch_step`
calls. On CPU tensors it runs :func:`nee_plain`, the plain PyTorch
version (:func:`glaze_tpu_torch.render.lights.sample_light` and
:func:`glaze_tpu_torch.render.bsdf.bsdf_value`, which evaluate every
light type and BSDF family present over every lane and select). On CUDA
tensors it launches :func:`nee_kernel`, one hand-written kernel
(``csrc/shade.cu``, whose header note says what it replaces and what
bounds it; the lane's arithmetic is ``csrc/shade_lane.cuh``), compiled
with ``nvcc`` at first use into ``build/libglaze_shade.so`` at the
repository root (:mod:`glaze_tpu_torch.cuda_build`) and loaded through
ctypes. A missing ``nvcc``, a failed build, an input the kernel does not
take or a failed launch raises; nothing falls back to the plain version.

Both return the same dict: ``wiw`` (the shadow rays' directions, an
(x, y, z) tuple), ``cap`` (their caps, the light's distance - 1e-3),
``active`` (the shadow rays' active lanes: ``nee_active`` and a usable
sample), ``rgb`` ((3, R), the contribution before the shadow test) and
``key`` (the shadow rays' coherence sort key, or None where the caller
computes it). The kernel reads the scene's tables in place at every call,
so material, light and texture edits are seen at once, and files the
texels it fetched in ``mat``'s memo, as ``bsdf_value`` does, for the BSDF
stage. :func:`nee_kernel` counts its launches in ``nee_kernel.launches``
and, inside a recording, in the counter ``integrator.nee_kernels``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from glaze_tpu_torch import cuda_build
from glaze_tpu_torch.ops import const, shading, spectra, vec
from glaze_tpu_torch.render import bsdf as bsdf_mod
from glaze_tpu_torch.render import lights as lights_mod
from glaze_tpu_torch.scene import flatten as fl
from glaze_tpu_torch.utils import runtime
from glaze_tpu_torch.utils.runtime import span

SOURCE = "shade.cu"
LIBRARY = "libglaze_shade.so"

# csrc/shade_lane.cuh's constants table: Smits bases (surface, then
# illuminant), CIE x, y, z, the XYZ -> RGB matrix, the basis scales and
# 1 / sum(CIE y)
CONSTS = np.concatenate([
    spectra.SURFACE_BASIS.reshape(-1), spectra.ILLUMINANT_BASIS.reshape(-1),
    spectra.CIE_X, spectra.CIE_Y, spectra.CIE_Z,
    spectra.XYZ_TO_RGB.reshape(-1),
    np.asarray([spectra.SURFACE_SCALE, spectra.ILLUMINANT_SCALE,
                spectra.INVY_SUM])]).astype(np.float32)

# csrc/shade_lane.cuh NeeArgs, field by field
_LANE_FLOATS = ("px", "py", "pz", "sx", "sy", "sz", "tx", "ty", "tz",
                "nx", "ny", "nz", "wox", "woy", "woz", "u", "v")
_DRAWS = ("r_pick", "r_a", "r_b", "r_c", "r_bsdf")
# (field, scene attribute, dtype, shape: None = any rows, the rest fixed)
_TABLES = (
    ("light_scalars", "light_scalars", torch.float32, (None, 8)),
    ("light_pos", "light_pos", torch.float32, (None, 3)),
    ("light_dir", "light_dir", torch.float32, (None, 3)),
    ("light_color", "light_color", torch.float32, (None, 16)),
    ("lights_no", "lights_no", torch.int32, ()),
    ("tri_pos", "tri_pos_orig", torch.float32, (None, 9)),
    ("mat_scalars", "mat_scalars", torch.float32, (None, fl.MS_ROWS)),
    ("mat_tex", "mat_tex", torch.int32, (None, 5)),
    ("metal_ior", "mat_metal_ior", torch.float32, (None, 16)),
    ("metal_fresnel", "mat_metal_fresnel", torch.float32, (None, 16)),
    ("texels", "atlas.texels", torch.int32, (None, 4)),
    ("tex_offset", "atlas.offset", torch.int32, (None,)),
    ("tex_width", "atlas.width", torch.int32, (None,)),
    ("tex_height", "atlas.height", torch.int32, (None,)),
    ("tex_srgb", "atlas.srgb", torch.float32, (None,)),
    ("sky_marg_rows", "sky_marg_rows", torch.float32, (None, 4)),
    ("sky_cond_rows", "sky_cond_rows", torch.float32, (None, 4)),
    ("sky_cond_n", "sky_cond_n", torch.int32, ()),
    ("sky_marginal_integral", "sky_marginal_integral", torch.float32, ()),
    ("sky_obj2world", "sky_obj2world", torch.float32, (3, 3)),
    ("sky_tex", "sky_tex", torch.int32, ()),
    ("sky_intensity", "sky_intensity", torch.float32, ()),
    ("scene_radius", "scene_radius", torch.float32, ()),
    ("scene_centre", "scene_centre", torch.float32, (3,)),
)
_OUTPUTS = ("wix", "wiy", "wiz", "cap", "shadow_active", "rgb_r", "rgb_g",
            "rgb_b", "key", "diffuse_r", "diffuse_g", "diffuse_b",
            "roughness", "metalness")
_SIZES = ("n_lanes", "lanes_per_chain", "n_tris", "sky_rows", "tex_flags")


class NeeArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        *_LANE_FLOATS, "mat_id", "importance", "nee_active", *_DRAWS,
        *(t[0] for t in _TABLES), "consts", *_OUTPUTS)]
        + [(n, ctypes.c_int) for n in _SIZES])


# tex_flags bits (shade_lane.cuh kTex*) and the BSDF families that read
# each texel: the texels bsdf_value memoizes in a scene of those families
_TEX_SLOTS = ((fl.MT_DIFFUSE, 1, "diffuse",
               (bsdf_mod.FAMILY_LAMBERT, bsdf_mod.FAMILY_UBER)),
              (fl.MT_ROUGHNESS, 2, "rough",
               (bsdf_mod.FAMILY_METAL, bsdf_mod.FAMILY_FROSTED,
                bsdf_mod.FAMILY_UBER)),
              (fl.MT_METALNESS, 4, "metal", (bsdf_mod.FAMILY_UBER,)))


def nee_plain(scene, hit, wo_w, frame, mat, importance, nee_active, draws,
              expand):
    """The plain version (path_trace.rgen direct_light, :87-117, up to the
    shadow test). ``hit``: the hit's ``point``, ``shading_normal`` and
    ``uv``; ``frame``: the shading frame; ``draws``: the five uniforms
    (light pick, three light draws, BSDF draw) at chain width C, which
    ``expand`` takes to lane width. Returns the dict of the module
    docstring, ``key`` None."""
    r_pick, ra, rb, rc, r_bsdf = draws
    lights_no = scene.lights_no
    lights_no_f = lights_no.to(torch.float32)
    light_idx = torch.minimum((r_pick * lights_no_f).to(torch.int32),
                              lights_no - 1)
    light_idx = torch.clamp(light_idx, min=0)
    wiw, dist, emission, light_pdf = lights_mod.sample_light(
        scene, light_idx, hit["point"], (ra, rb, rc), expand=expand)
    wo = shading.to_shading_space_v(wo_w, frame)
    wi = shading.to_shading_space_v(wiw, frame)
    value, bsdf_pdf = bsdf_mod.bsdf_value(scene, mat, wo, wi, hit["uv"],
                                          expand(r_bsdf))
    usable = (light_pdf > 0.0) & (bsdf_pdf > 0.0)
    cos_term = torch.abs(vec.dot(wiw, hit["shading_normal"]))
    weight = (usable.to(torch.float32) * cos_term
              / torch.clamp(light_pdf, min=1e-20))
    radiance = value * emission * (weight * lights_no_f) * importance
    return {"wiw": wiw, "cap": dist - 1e-3, "active": nee_active & usable,
            "rgb": torch.stack(spectra.to_rgb_t(radiance)), "key": None}


_lib = None
build_log = ""


def build() -> str:
    """Compiles ``shade.cu`` if the library is missing or older than it or
    ``shade_lane.cuh`` and returns the library path. ``build_log`` keeps
    nvcc's output of the last build (``-Xptxas -v``'s registers and
    spills)."""
    global build_log
    so, log = cuda_build.build(SOURCE, LIBRARY)
    if log:
        build_log = log
    return so


def _load():
    """The shading library, built if need be and loaded once a process,
    with the entry points of both its kernels declared (the BSDF kernel's
    take a ``bsdf_cuda.BsdfArgs`` by reference)."""
    global _lib
    if _lib is None:
        # the span ``setup.kernels``: the build (or the check that the
        # library is current) and the load, once a process
        with span("setup.kernels"):
            lib = ctypes.CDLL(build())
        i = ctypes.c_int
        lib.glaze_nee_launch.argtypes = [ctypes.POINTER(NeeArgs),
                                         ctypes.c_void_p]
        lib.glaze_nee_launch.restype = i
        lib.glaze_nee_attrs.argtypes = [ctypes.POINTER(i)] * 5
        lib.glaze_nee_attrs.restype = i
        lib.glaze_bsdf_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.glaze_bsdf_launch.restype = i
        lib.glaze_bsdf_attrs.argtypes = [ctypes.POINTER(i)] * 5
        lib.glaze_bsdf_attrs.restype = i
        lib.glaze_nee_error_string.argtypes = [i]
        lib.glaze_nee_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(code: int, what: str):
    if code != 0:
        msg = _load().glaze_nee_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def kernel_attrs() -> dict:
    """nee_kernel's registers and local (spill) bytes per thread, threads
    per block, resident blocks per SM and the occupancy they give, as the
    CUDA runtime reports them for the built library on the current card."""
    regs, local, threads, blocks, most = (ctypes.c_int() for _ in range(5))
    _check(_load().glaze_nee_attrs(*(ctypes.byref(x) for x in (
        regs, local, threads, blocks, most))),
        "the nee_kernel attribute query")
    return {"registers": regs.value, "local_bytes": local.value,
            "threads_per_block": threads.value, "blocks_per_sm": blocks.value,
            "occupancy": blocks.value * threads.value / most.value}


def _check_form(t, name, dtype, shape, who="nee"):
    """Raises unless ``t`` has ``dtype`` and ``shape`` (None matches any
    length) and is contiguous; ``who`` heads the message."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise ValueError(f"{who}: {name} must be a {dtype} tensor, not "
                         f"{getattr(t, 'dtype', type(t).__name__)}")
    got = t.shape
    if (got != shape if None not in shape else len(got) != len(shape) or any(
            w is not None and g != w for g, w in zip(got, shape))):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, not "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _scene_table(scene, attr):
    obj = scene
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _table_pointers(scene, device_type):
    """The (field, pointer) pairs of the scene's tables, each checked for
    its dtype, shape, contiguity and device first."""
    tables = tuple(_scene_table(scene, attr) for _, attr, _, _ in _TABLES)
    for (_, attr, dtype, shape), x in zip(_TABLES, tables):
        _check_form(x, attr, dtype, shape)
    for (_, attr, _, _), x in zip(_TABLES, tables):
        if x.device.type != device_type:
            raise ValueError(f"nee: {attr} lies on {x.device}, not on a "
                             f"{device_type} device")
    return tuple((t[0], x.data_ptr()) for t, x in zip(_TABLES, tables))


def prepare(scene, hit, wo_w, frame, importance, nee_active, draws,
            device_type="cuda"):
    """The kernel's arguments: checks the dtype, shape and contiguity of
    every input, that the lanes split into the draws' chains, then that
    each lies on a ``device_type`` device, and the same of the scene's
    tables at every call, raising at the first that fails, and allocates
    the outputs. Returns ``(NeeArgs, outputs)``, ``outputs`` holding the
    (P,) or (3, P) tensors by the names of the module docstring and the
    wanted texels under the memo's keys (``diffuse`` (3, P), ``rough``,
    ``metal``)."""
    _check_form(importance, "importance", torch.float32, (16, None))
    p = importance.shape[1]
    c = draws[0].shape[0] if draws[0].dim() == 1 else -1
    s, t, n = frame
    ins = {"px": hit["point"][0], "py": hit["point"][1],
           "pz": hit["point"][2], "sx": s[0], "sy": s[1], "sz": s[2],
           "tx": t[0], "ty": t[1], "tz": t[2], "nx": n[0], "ny": n[1],
           "nz": n[2], "wox": wo_w[0], "woy": wo_w[1], "woz": wo_w[2],
           "u": hit["uv"][0], "v": hit["uv"][1]}
    forms = {name: (torch.float32, (p,)) for name in ins}
    ins.update(mat_id=hit["material_id"], importance=importance,
               nee_active=nee_active)
    forms.update(mat_id=(torch.int32, (p,)),
                 importance=(torch.float32, (16, p)),
                 nee_active=(torch.bool, (p,)))
    for name, x in zip(_DRAWS, draws):
        ins[name] = x
        forms[name] = (torch.float32, (c,))
    for name, x in ins.items():
        _check_form(x, name, *forms[name])
    if c < 1 or p % c:
        raise ValueError(f"nee: {p} lanes do not split into chains of "
                         f"{c} draws")
    for name, x in ins.items():
        if x.device.type != device_type:
            raise ValueError(f"nee: {name} lies on {x.device}, not on a "
                             f"{device_type} device")
    dev = importance.device
    args = NeeArgs()
    for name, x in ins.items():
        setattr(args, name, x.data_ptr())
    for field, ptr in _table_pointers(scene, device_type):
        setattr(args, field, ptr)
    args.consts = const(CONSTS, dev).data_ptr()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def rows(t, *names):  # the (P,) rows of a (k, P) float32 output
        base = t.data_ptr()
        for k, name in enumerate(names):
            setattr(args, name, base + 4 * k * p)
        return t

    out = {"wiw": rows(empty(3, p), "wix", "wiy", "wiz"),
           "cap": rows(empty(p), "cap"),
           "active": empty(p, dtype=torch.bool),
           "rgb": rows(empty(3, p), "rgb_r", "rgb_g", "rgb_b"),
           "key": empty(p, dtype=torch.int32)}
    args.shadow_active = out["active"].data_ptr()
    args.key = out["key"].data_ptr()
    flags = 0
    fams = set(scene.mat_families)
    for slot, bit, memo, readers in _TEX_SLOTS:
        if slot not in scene.tex_slots:
            continue
        flags |= bit
        if fams.isdisjoint(readers):
            continue
        if memo == "diffuse":
            out[memo] = rows(empty(3, p), "diffuse_r", "diffuse_g",
                             "diffuse_b")
        else:
            out[memo] = rows(empty(p),
                             "roughness" if memo == "rough" else "metalness")
    args.n_lanes = p
    args.lanes_per_chain = p // c
    args.n_tris = scene.tri_pos_orig.shape[0]
    args.sky_rows = scene.sky_marg_rows.shape[0]
    args.tex_flags = flags
    return args, out


def _result(out, hit, mat):
    """The wrapper's dict from ``prepare``'s outputs; the texels go to
    ``mat``'s memo, keyed on ``hit["uv"]`` as bsdf_value keys them."""
    bsdf_mod.memo_texels(mat, hit["uv"], **{
        k: tuple(out[k].unbind(0)) if k == "diffuse" else out[k]
        for k in ("diffuse", "rough", "metal") if k in out})
    return {"wiw": tuple(out["wiw"].unbind(0)), "cap": out["cap"],
            "active": out["active"], "rgb": out["rgb"], "key": out["key"]}


def nee_kernel(scene, hit, wo_w, frame, mat, importance, nee_active, draws):
    """:func:`nee_plain`'s results from one launch of ``nee_kernel`` on
    CUDA tensors, ``key`` included; raises on an input it does not take.
    The draws keep their chain width C (1, the tile count or the lane
    count): lane i reads draw i // (P // C)."""
    args, out = prepare(scene, hit, wo_w, frame, importance, nee_active,
                        draws)
    if args.n_lanes:
        stream = torch.cuda.current_stream(importance.device).cuda_stream
        _check(_load().glaze_nee_launch(ctypes.byref(args), stream),
               "the nee_kernel launch")
        nee_kernel.launches += 1
        runtime.count("integrator.nee_kernels")
    return _result(out, hit, mat)


nee_kernel.launches = 0


def reset_launch_counts():
    nee_kernel.launches = 0


def nee(scene, hit, wo_w, frame, mat, importance, nee_active, draws, expand):
    """The NEE stage before its shadow ray: :func:`nee_kernel` on CUDA
    tensors, :func:`nee_plain` on CPU ones."""
    if importance.is_cuda:
        return nee_kernel(scene, hit, wo_w, frame, mat, importance,
                          nee_active, draws)
    return nee_plain(scene, hit, wo_w, frame, mat, importance, nee_active,
                     draws, expand)

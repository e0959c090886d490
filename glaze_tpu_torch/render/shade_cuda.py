"""The integrator's three shading stages, and the library of their
kernels: :func:`surface` (the shade stage: the hit's attributes, the
shading frame, wo, the material's specular flag and the sky on missed
lanes), :func:`nee` (the NEE stage before its shadow ray: the light
sample, the BSDF value, the weight and the unshadowed RGB contribution)
and :func:`bsdf` (the accumulation, Russian roulette, the BSDF sample and
the path-state update), all called by
:func:`glaze_tpu_torch.render.integrator.launch_step`.

On CPU tensors each runs its plain PyTorch version, :func:`surface_plain`,
:func:`nee_plain` or :func:`bsdf_plain`, which evaluate the sky, every
light type and every BSDF family present over every lane and select. On
CUDA tensors each launches one hand-written kernel,
:func:`surface_kernel`, :func:`nee_kernel` or :func:`bsdf_kernel`
(``csrc/shade.cu``, whose header note says what they replace and what
bounds them; the lane's arithmetic is ``csrc/shade_lane.cuh``), compiled
with ``nvcc`` at first use into ``build/libglaze_shade.so``
(:mod:`glaze_tpu_torch.cuda_build`) and loaded through ctypes once a
process. A missing ``nvcc``, a failed build, an input a kernel does not
take or a failed launch raises; nothing falls back to the plain version.
The kernels read the scene's tables in place at every call, so edits are
seen at once. The shade kernel writes the lane floats the other two take
as the rows of one buffer; the NEE kernel returns the texels it fetched,
which the BSDF kernel takes as its ``texels`` argument. The plain versions
share the material record of :func:`surface_plain` (``mat``) and their
texels through its memo (:mod:`glaze_tpu_torch.render.bsdf`); the kernels
take no ``mat``. Each kernel counts its launches in its wrapper's
``.launches`` and, inside a recording, in the counter
``integrator.surface_kernels``, ``integrator.nee_kernels`` or
``integrator.bsdf_kernels``.
"""

from __future__ import annotations

import ctypes
import operator

import numpy as np
import torch

from glaze_tpu_torch import cuda_build
from glaze_tpu_torch.ops import const, shading, spectra, vec
from glaze_tpu_torch.ops import texture as tx
from glaze_tpu_torch.render import bsdf as bsdf_mod
from glaze_tpu_torch.render import lights as lights_mod
from glaze_tpu_torch.scene import flatten as fl
from glaze_tpu_torch.utils import runtime
from glaze_tpu_torch.utils.runtime import span

SOURCE = "shade.cu"
LIBRARY = "libglaze_shade.so"

PT_STEPS = 6  # raytrace_structures.rs:87
RUSSIAN_ROULETTE = PT_STEPS // 2  # path_trace.rgen:11
INV_2PI = float(np.float32(0.1591549))
INV_PI = float(np.float32(0.3183099))

# csrc/shade_lane.cuh's constants table: Smits bases (surface, then
# illuminant), CIE x, y, z, the XYZ -> RGB matrix, the basis scales and
# 1 / sum(CIE y)
CONSTS = np.concatenate([
    spectra.SURFACE_BASIS.reshape(-1), spectra.ILLUMINANT_BASIS.reshape(-1),
    spectra.CIE_X, spectra.CIE_Y, spectra.CIE_Z,
    spectra.XYZ_TO_RGB.reshape(-1),
    np.asarray([spectra.SURFACE_SCALE, spectra.ILLUMINANT_SCALE,
                spectra.INVY_SUM])]).astype(np.float32)

# the lane floats the NEE and BSDF stages take first, in the order of both
# structures, and the first rows of the shade kernel's output: the hit
# point, the shading frame (s, t, n), wo in world space, uv
_LANE_FLOATS = ("px", "py", "pz", "sx", "sy", "sz", "tx", "ty", "tz",
                "nx", "ny", "nz", "wox", "woy", "woz", "u", "v")
# the scene's tables: (field, scene attribute, dtype, shape: None = any
# rows, the rest fixed); NeeArgs takes them all, BsdfArgs those it names
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
_TABLE_GETTERS = tuple(operator.attrgetter(t[1]) for t in _TABLES)
# tex_flags bits (shade_lane.cuh kTex*), the texels' key and the fields
# that hold them, and the BSDF families that read each; the normal map's
# bit, which only the shade kernel reads, is _TEX_NORMAL
_TEX_SLOTS = (
    (fl.MT_DIFFUSE, 1, "diffuse", ("diffuse_r", "diffuse_g", "diffuse_b"),
     (bsdf_mod.FAMILY_LAMBERT, bsdf_mod.FAMILY_UBER)),
    (fl.MT_ROUGHNESS, 2, "rough", ("roughness",),
     (bsdf_mod.FAMILY_METAL, bsdf_mod.FAMILY_FROSTED, bsdf_mod.FAMILY_UBER)),
    (fl.MT_METALNESS, 4, "metal", ("metalness",), (bsdf_mod.FAMILY_UBER,)))
_TEXELS = tuple(f for slot in _TEX_SLOTS for f in slot[3])
_TEX_NORMAL = 8

# csrc/shade_lane.cuh SurfaceArgs, field by field: the lane inputs, the
# tables (as _TABLES has them, and the two only it reads), the outputs
_SURFACE_INPUTS = ("tri", "hit_u", "hit_v", "dx", "dy", "dz", "bounce",
                   "last_specular", "parked", "importance")
_TABLE_BY_FIELD = {t[0]: t for t in _TABLES}
_SURFACE_TABLES = (
    ("tri_attr", "tri_attr", torch.float32, (None, fl.ATTR_ROWS)),
    *(_TABLE_BY_FIELD[f] for f in (
        "mat_scalars", "mat_tex", "texels", "tex_offset", "tex_width",
        "tex_height", "tex_srgb")),
    ("sky_world2obj", "sky_world2obj", torch.float32, (3, 3)),
    _TABLE_BY_FIELD["sky_tex"])
_SURFACE_GETTERS = tuple(operator.attrgetter(t[1]) for t in _SURFACE_TABLES)
# the output buffer's rows: _LANE_FLOATS, then the sky's RGB
_SURFACE_ROWS = len(_LANE_FLOATS) + 3


class SurfaceArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        *_SURFACE_INPUTS, *(t[0] for t in _SURFACE_TABLES), "consts", "out",
        "mat_id", "missed", "nee_active")]
        + [(n, ctypes.c_int) for n in ("n_lanes", "tex_flags")])

# csrc/shade_lane.cuh NeeArgs, field by field
_NEE_DRAWS = ("r_pick", "r_a", "r_b", "r_c", "r_bsdf")
_NEE_OUTPUTS = ("wix", "wiy", "wiz", "cap", "shadow_active", "rgb_r",
                "rgb_g", "rgb_b", "key", *_TEXELS)


class NeeArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        *_LANE_FLOATS, "mat_id", "importance", "nee_active", *_NEE_DRAWS,
        *(t[0] for t in _TABLES), "consts", *_NEE_OUTPUTS)]
        + [(n, ctypes.c_int) for n in (
            "n_lanes", "lanes_per_chain", "n_tris", "sky_rows", "tex_flags")])


# csrc/shade_lane.cuh BsdfArgs, field by field
_STATE = ("state_importance", "ox", "oy", "oz", "dx", "dy", "dz", "bounce",
          "last_specular", "accum_r", "accum_g", "accum_b", "sq")
_BSDF_DRAWS = ("r_rr", "r_a", "r_b", "r_c")
_BSDF_TABLES = ("lights_no", "mat_scalars", "mat_tex", "metal_ior",
                "metal_fresnel", "texels", "tex_offset", "tex_width",
                "tex_height", "tex_srgb")
# the outputs, as rows of one (28, P) buffer: out_importance's 16, then one
# each; under direct_only the buffer holds only the last six
_BSDF_ROWS = ("out_ox", "out_oy", "out_oz", "out_dx", "out_dy", "out_dz",
              "out_bounce", "out_last_specular", "out_accum_r",
              "out_accum_g", "out_accum_b", "out_sq")
_DIRECT_FIRST = 22


class BsdfArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        *_LANE_FLOATS, "mat_id", "missed", "importance", "miss_r", "miss_g",
        "miss_b", "nee_r", "nee_g", "nee_b", *_STATE, *_TEXELS, *_BSDF_DRAWS,
        *_BSDF_TABLES, "consts", "out_importance", *_BSDF_ROWS)]
        + [(n, ctypes.c_int) for n in (
            "n_lanes", "lanes_per_chain", "tex_flags", "families",
            "first_family", "direct_only")])


# ---- the library ------------------------------------------------------------

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
    """The library, built if need be and loaded once a process, with every
    entry point declared."""
    global _lib
    if _lib is None:
        # the span ``setup.kernels``: the build (or the check that the
        # library is current) and the load, once a process
        with span("setup.kernels"):
            lib = ctypes.CDLL(build())
        i = ctypes.c_int
        for kernel, args in (("surface", SurfaceArgs), ("nee", NeeArgs),
                             ("bsdf", BsdfArgs)):
            launch_fn = getattr(lib, f"glaze_{kernel}_launch")
            launch_fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
            launch_fn.restype = i
            attrs_fn = getattr(lib, f"glaze_{kernel}_attrs")
            attrs_fn.argtypes = [ctypes.POINTER(i)] * 5
            attrs_fn.restype = i
        lib.glaze_shade_error_string.argtypes = [i]
        lib.glaze_shade_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(code: int, what: str):
    if code != 0:
        msg = _load().glaze_shade_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def kernel_attrs(kernel: str) -> dict:
    """``kernel``'s (``"surface"``, ``"nee"`` or ``"bsdf"``) registers and
    local (spill) bytes per thread, threads per block, resident blocks per
    SM and the occupancy they give, as the CUDA runtime reports them on
    this card."""
    regs, local, threads, blocks, most = (ctypes.c_int() for _ in range(5))
    _check(getattr(_load(), f"glaze_{kernel}_attrs")(*(
        ctypes.byref(x) for x in (regs, local, threads, blocks, most))),
        f"the {kernel}_kernel attribute query")
    return {"registers": regs.value, "local_bytes": local.value,
            "threads_per_block": threads.value, "blocks_per_sm": blocks.value,
            "occupancy": blocks.value * threads.value / most.value}


def launch(kernel: str, args, device):
    """Launches ``kernel`` (``"surface"``, ``"nee"`` or ``"bsdf"``) on
    ``args``' lanes, if any, on the current stream of ``device``; raises if
    the launch failed, and counts it in the kernel's ``.launches`` and
    recording counter."""
    if not args.n_lanes:
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = getattr(_load(), f"glaze_{kernel}_launch")
    _check(fn(ctypes.byref(args), stream), f"the {kernel}_kernel launch")
    _WRAPPERS[kernel].launches += 1
    runtime.count(f"integrator.{kernel}_kernels")


def reset_launch_counts():
    for wrapper in _WRAPPERS.values():
        wrapper.launches = 0


# ---- the arguments the kernels share ----------------------------------------


def _check_form(t, name, dtype, shape, who):
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


def _lane_inputs(who, hit, wo_w, frame, importance, draws, draw_fields):
    """``(P, C, ins, forms)``: the inputs both stages take by field name
    (hit point, frame, wo, uv, mat_id, importance, the draws at chain
    width C) and the dtype and shape each must have."""
    _check_form(importance, "importance", torch.float32, (16, None), who)
    p = importance.shape[1]
    c = 1 if draws is None else (draws[0].shape[0] if draws[0].dim() == 1
                                 else -1)
    s, t, n = frame
    ins = dict(zip(_LANE_FLOATS, (*hit["point"], *s, *t, *n, *wo_w,
                                  *hit["uv"])))
    forms = dict.fromkeys(ins, (torch.float32, (p,)))
    ins.update(mat_id=hit["material_id"], importance=importance)
    forms.update(mat_id=(torch.int32, (p,)),
                 importance=(torch.float32, (16, p)))
    for name, x in zip(draw_fields, draws or ()):
        ins[name] = x
        forms[name] = (torch.float32, (c,))
    return p, c, ins, forms


def _check_inputs(who, ins, forms, p, c, device_type):
    """Raises at the first input without its form, if the P lanes do not
    split into chains of C draws, or at the first not on ``device_type``."""
    for name, x in ins.items():
        _check_form(x, name, *forms[name], who)
    if c < 1 or p % c:
        raise ValueError(f"{who}: {p} lanes do not split into chains of "
                         f"{c} draws")
    for name, x in ins.items():
        if x.device.type != device_type:
            raise ValueError(f"{who}: {name} lies on {x.device}, not on a "
                             f"{device_type} device")


def _bind(args, who, scene, ins, p, device_type, tables=_TABLES,
          getters=_TABLE_GETTERS):
    """Points ``args`` at the checked inputs and at the scene's ``tables``
    (``getters`` reads each), each checked for its form and device at every
    call, and sets the rest the kernels share."""
    for name, x in ins.items():
        setattr(args, name, x.data_ptr())
    values = tuple(get(scene) for get in getters)
    for (_, attr, dtype, shape), x in zip(tables, values):
        _check_form(x, attr, dtype, shape, who)
    for (_, attr, _, _), x in zip(tables, values):
        if x.device.type != device_type:
            raise ValueError(f"{who}: {attr} lies on {x.device}, not on a "
                             f"{device_type} device")
    for (field, _, _, _), x in zip(tables, values):
        if hasattr(args, field):
            setattr(args, field, x.data_ptr())
    args.consts = const(CONSTS, ins["importance"].device).data_ptr()
    args.n_lanes = p
    # a bit for each texel slot the scene textures somewhere
    args.tex_flags = sum(bit for slot, bit, _, _, _ in _TEX_SLOTS
                         if slot in scene.tex_slots) + (
        _TEX_NORMAL if fl.MT_NORMAL in scene.tex_slots else 0)


def _rows(args, t, p, *fields):
    """Points ``fields`` at the (P,) rows of the (k, P) float32 ``t``, in
    order; returns ``t``."""
    base = t.data_ptr()
    for k, field in enumerate(fields):
        setattr(args, field, base + 4 * k * p)
    return t


# ---- the shade stage --------------------------------------------------------


def sky_radiance(scene, direction):
    """Environment lookup on a miss (path_trace.rgen:76-84) -> (r, g, b)."""
    m = scene.sky_world2obj
    w = vec.normalize((
        m[0, 0] * direction[0] + m[0, 1] * direction[1] + m[0, 2] * direction[2],
        m[1, 0] * direction[0] + m[1, 1] * direction[1] + m[1, 2] * direction[2],
        m[2, 0] * direction[0] + m[2, 1] * direction[1] + m[2, 2] * direction[2],
    ))
    phi = torch.atan2(w[1], w[0])
    theta = torch.acos(torch.clamp(w[2], -1.0, 1.0))
    u = phi * INV_2PI
    v = theta * INV_PI
    tex = torch.broadcast_to(scene.sky_tex, phi.shape)
    return tx.sample_rgb_v(scene.atlas, tex, u, v)


def interpolate_hit(scene, hit):
    """The closest-hit shader (raytrace_hit.rchit): barycentric attribute
    interpolation + normal mapping, from one fused row gather."""
    tri = torch.clamp(hit["tri"], min=0).long()
    bu = hit["u"]
    bv = hit["v"]
    bw = 1.0 - bu - bv
    a = scene.tri_attr[tri]  # (R, 34)

    def v3_at(col):
        return (a[:, col], a[:, col + 1], a[:, col + 2])

    v0 = v3_at(fl.ATTR_V0)
    e1 = v3_at(fl.ATTR_E1)
    e2 = v3_at(fl.ATTR_E2)
    point = vec.add(v0, vec.add(vec.scale(e1, bu), vec.scale(e2, bv)))

    n0 = v3_at(fl.ATTR_N0)
    n1 = v3_at(fl.ATTR_N1)
    n2 = v3_at(fl.ATTR_N2)
    shading_n = vec.normalize(vec.add(
        vec.scale(n0, bw), vec.add(vec.scale(n1, bu), vec.scale(n2, bv))))
    u = bw * a[:, fl.ATTR_UV0] + bu * a[:, fl.ATTR_UV1] + bv * a[:, fl.ATTR_UV2]
    v = (bw * a[:, fl.ATTR_UV0 + 1] + bu * a[:, fl.ATTR_UV1 + 1]
         + bv * a[:, fl.ATTR_UV2 + 1])

    geom_n = v3_at(fl.ATTR_GN)
    dpdu = v3_at(fl.ATTR_DPDU)
    mat_id = a[:, fl.ATTR_MAT].to(torch.int32)

    # normal mapping (rchit:55-64), only when some material has a map
    if fl.MT_NORMAL in scene.tex_slots:
        normal_tex = scene.mat_tex[mat_id.long()][:, fl.MT_NORMAL]
        has_nm = normal_tex != 0
        tr, tg, tb = tx.sample_rgb_v(scene.atlas, normal_tex, u, v)
        s_old = vec.normalize(dpdu)
        t_old = vec.normalize(vec.cross(shading_n, s_old))
        nx, ny, nz = tr * 2.0 - 1.0, tg * 2.0 - 1.0, tb * 2.0 - 1.0
        mapped = vec.normalize((
            s_old[0] * nx + t_old[0] * ny + shading_n[0] * nz,
            s_old[1] * nx + t_old[1] * ny + shading_n[1] * nz,
            s_old[2] * nx + t_old[2] * ny + shading_n[2] * nz,
        ))
        mapped = vec.scale(mapped, torch.sign(vec.dot(geom_n, mapped)))
        shading_n = vec.where(has_nm, mapped, shading_n)

    return {
        "point": point,
        "shading_normal": shading_n,
        "geom_normal": geom_n,
        "dpdu": dpdu,
        "uv": (u, v),
        "material_id": mat_id,
    }


def surface_plain(scene, hit, direction, state, importance, parked=None):
    """The plain version (path_trace.rgen:76-84 and the closest-hit
    shader). ``hit``: the closest hit (``tri``, -1 on a miss, ``u``,
    ``v``); ``direction``: the rays' (x, y, z); ``state``: the PathState
    before the launch (its ``bounce`` and ``last_specular``);
    ``importance``: the launch's (16, P); ``parked``: the lanes adaptive
    stopping parked, or None. Returns a dict: ``surf``
    (:func:`interpolate_hit`'s), ``wo_w``, ``frame`` (the shading frame),
    ``mat`` (:func:`glaze_tpu_torch.render.bsdf.gather_material`'s record,
    which the plain NEE and BSDF stages read), ``missed``, ``nee_active``
    (the hits off specular materials, parked lanes out) and ``miss_rgb``
    (the sky's RGB on the missed lanes of camera rays and specular
    bounces, 0 elsewhere)."""
    missed = hit["tri"] < 0

    # ---- miss: sky radiance only on camera rays / after specular bounces
    sky_visible = (state.bounce == 0.0) | (state.last_specular == 1.0)
    add_sky = missed & sky_visible & (scene.sky_tex > 0)
    if parked is not None:
        add_sky = add_sky & ~parked
    sr, sg, sb = sky_radiance(scene, direction)
    sky_spec = importance * spectra.from_illuminant_color_t(sr, sg, sb)
    mr, mg, mb = spectra.to_rgb_t(sky_spec)
    zero = torch.zeros_like(mr)
    miss_rgb = (torch.where(add_sky, mr, zero),
                torch.where(add_sky, mg, zero),
                torch.where(add_sky, mb, zero))

    # ---- hit shading
    surf = interpolate_hit(scene, hit)
    wo_w = vec.neg(direction)
    frame = shading.new_shading_space_v(surf["dpdu"], surf["shading_normal"])
    mat = bsdf_mod.gather_material(scene, surf["material_id"])
    mat_specular = mat["scalars"][fl.MS_IS_SPECULAR] > 0.5

    nee_active = ~missed & ~mat_specular
    if parked is not None:
        nee_active = nee_active & ~parked
    return {"surf": surf, "wo_w": wo_w, "frame": frame, "mat": mat,
            "missed": missed, "nee_active": nee_active, "miss_rgb": miss_rgb}


def surface_prepare(scene, hit, direction, state, importance, parked=None,
                    device_type="cuda"):
    """The shade kernel's arguments, every input and table checked, and
    its outputs: ``(SurfaceArgs, out)``, ``out`` the (20, P) float buffer
    (the rows of _LANE_FLOATS, then the sky's RGB), the (P,) int32
    material rows and the (2, P) bool buffer of ``missed`` and
    ``nee_active``."""
    _check_form(importance, "importance", torch.float32, (16, None),
                "surface")
    p = importance.shape[1]
    ins = {"tri": hit["tri"], "hit_u": hit["u"], "hit_v": hit["v"],
           "dx": direction[0], "dy": direction[1], "dz": direction[2],
           "bounce": state.bounce, "last_specular": state.last_specular,
           "importance": importance}
    forms = dict.fromkeys(ins, (torch.float32, (p,)))
    forms.update(tri=(torch.int32, (p,)), importance=(torch.float32, (16, p)))
    if parked is not None:
        ins["parked"] = parked
        forms["parked"] = (torch.bool, (p,))
    _check_inputs("surface", ins, forms, p, 1, device_type)
    args = SurfaceArgs()
    _bind(args, "surface", scene, ins, p, device_type, _SURFACE_TABLES,
          _SURFACE_GETTERS)
    dev = importance.device
    out = (torch.empty((_SURFACE_ROWS, p), dtype=torch.float32, device=dev),
           torch.empty((p,), dtype=torch.int32, device=dev),
           torch.empty((2, p), dtype=torch.bool, device=dev))
    args.out, args.mat_id, args.missed = (t.data_ptr() for t in out)
    args.nee_active = args.missed + p
    return args, out


def _surface_result(out):
    """:func:`surface_plain`'s dict from :func:`surface_prepare`'s
    outputs: every lane float a row of the one buffer; ``surf`` holds the
    ``point``, ``shading_normal``, ``uv`` and ``material_id`` the NEE and
    BSDF stages and the first-hit G-buffer read, and ``mat`` is None."""
    f, mat_id, flags = out
    rows = f.unbind(0)
    frame = (rows[3:6], rows[6:9], rows[9:12])
    return {"surf": {"point": rows[0:3], "shading_normal": frame[2],
                     "uv": rows[15:17], "material_id": mat_id},
            "wo_w": rows[12:15], "frame": frame, "mat": None,
            "missed": flags[0], "nee_active": flags[1],
            "miss_rgb": rows[17:20]}


def surface_kernel(scene, hit, direction, state, importance, parked=None):
    """:func:`surface_plain`'s results from one launch of
    ``surface_kernel`` on CUDA tensors, with no material record (the NEE
    and BSDF kernels read the material rows themselves); raises on an
    input it does not take. A mesh slot's ``bounce`` and ``last_specular``
    are lane slices of the whole state's, contiguous as (P,) slices are."""
    args, out = surface_prepare(scene, hit, direction, state, importance,
                                parked)
    launch("surface", args, importance.device)
    return _surface_result(out)


def surface(scene, hit, direction, state, importance, parked=None):
    """The shade stage: :func:`surface_kernel` on CUDA tensors,
    :func:`surface_plain` on CPU ones."""
    if importance.is_cuda:
        return surface_kernel(scene, hit, direction, state, importance,
                              parked)
    return surface_plain(scene, hit, direction, state, importance, parked)


# ---- the NEE stage ----------------------------------------------------------


def nee_plain(scene, hit, wo_w, frame, mat, importance, nee_active, draws,
              expand):
    """The plain version (path_trace.rgen direct_light, :87-117, up to the
    shadow test). ``hit``: the hit's ``point``, ``shading_normal``, ``uv``
    and ``material_id``; ``frame``: the shading frame; ``draws``: the five
    uniforms (light pick, three light draws, BSDF draw) at chain width C,
    which ``expand`` takes to lane width. Returns a dict: ``wiw`` (the
    shadow rays' directions, an (x, y, z) tuple), ``cap`` (their caps, the
    light's distance - 1e-3), ``active`` (``nee_active`` and a usable
    sample), ``rgb`` ((3, P), the contribution before the shadow test),
    ``key`` (the shadow rays' coherence sort key; None, the caller
    computes it) and ``texels`` (None: the texels stay in ``mat``'s
    memo)."""
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
            "rgb": torch.stack(spectra.to_rgb_t(radiance)), "key": None,
            "texels": None}


def nee_prepare(scene, hit, wo_w, frame, importance, nee_active, draws,
                device_type="cuda"):
    """The NEE kernel's arguments, every input and table checked, and its
    outputs: ``(NeeArgs, out)``, ``out`` by :func:`nee_plain`'s names,
    ``texels`` those the BSDF stage reads in a scene that textures them
    (``diffuse`` (3, P), ``rough``, ``metal``)."""
    p, c, ins, forms = _lane_inputs("nee", hit, wo_w, frame, importance,
                                    draws, _NEE_DRAWS)
    ins["nee_active"] = nee_active
    forms["nee_active"] = (torch.bool, (p,))
    _check_inputs("nee", ins, forms, p, c, device_type)
    args = NeeArgs()
    _bind(args, "nee", scene, ins, p, device_type)
    args.lanes_per_chain = p // c
    args.n_tris = scene.tri_pos_orig.shape[0]
    args.sky_rows = scene.sky_marg_rows.shape[0]
    dev = importance.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"wiw": _rows(args, empty(3, p), p, "wix", "wiy", "wiz"),
           "cap": _rows(args, empty(p), p, "cap"),
           "active": empty(p, dtype=torch.bool),
           "rgb": _rows(args, empty(3, p), p, "rgb_r", "rgb_g", "rgb_b"),
           "key": empty(p, dtype=torch.int32), "texels": {}}
    args.shadow_active = out["active"].data_ptr()
    args.key = out["key"].data_ptr()
    fams = set(scene.mat_families)
    for slot, _, key, fields, readers in _TEX_SLOTS:
        if slot in scene.tex_slots and not fams.isdisjoint(readers):
            out["texels"][key] = _rows(
                args, empty(3, p) if key == "diffuse" else empty(p), p,
                *fields)
    return args, out


def _nee_result(out):
    """:func:`nee_plain`'s dict from :func:`nee_prepare`'s outputs, the
    texels under ``texels`` (``diffuse`` an (r, g, b) tuple)."""
    texels = {k: tuple(v.unbind(0)) if k == "diffuse" else v
              for k, v in out["texels"].items()}
    return {"wiw": tuple(out["wiw"].unbind(0)), "cap": out["cap"],
            "active": out["active"], "rgb": out["rgb"], "key": out["key"],
            "texels": texels}


def nee_kernel(scene, hit, wo_w, frame, mat, importance, nee_active, draws):
    """:func:`nee_plain`'s results from one launch of ``nee_kernel`` on
    CUDA tensors, ``key`` and ``texels`` included (``mat`` is unused: the
    kernel reads the material rows itself); raises on an input it does not
    take. The draws keep their chain width C (1, the tile count or the
    lane count): lane i reads draw i // (P // C)."""
    args, out = nee_prepare(scene, hit, wo_w, frame, importance, nee_active,
                            draws)
    launch("nee", args, importance.device)
    return _nee_result(out)


def nee(scene, hit, wo_w, frame, mat, importance, nee_active, draws, expand):
    """The NEE stage before its shadow ray: :func:`nee_kernel` on CUDA
    tensors, :func:`nee_plain` on CPU ones."""
    if importance.is_cuda:
        return nee_kernel(scene, hit, wo_w, frame, mat, importance,
                          nee_active, draws)
    return nee_plain(scene, hit, wo_w, frame, mat, importance, nee_active,
                     draws, expand)


# ---- the BSDF stage ---------------------------------------------------------


def bsdf_plain(scene, state, hit, missed, wo_w, frame, mat, importance,
               miss_rgb, nee_rgb, draws, expand, direct_only=False):
    """The plain version (path_trace.rgen:119-133 and :186-239).
    ``state``: the PathState before the launch; ``hit``: as
    :func:`nee_plain`'s; ``missed``: the lanes whose ray left the scene;
    ``importance``: the launch's (1 where the path regenerated);
    ``miss_rgb`` and ``nee_rgb``: the sky's and the NEE stage's RGB, 3 x
    (P,); ``draws``: the roulette's and the BSDF sample's three at chain
    width C (None under ``direct_only``). Returns the new state's leaves
    but ``count`` and ``path_no`` by their PathState names. With
    ``direct_only`` (the DIRECT integrator) only the accumulation runs:
    ``bounce`` is 0 and ``importance``, ``origin`` and ``direction`` are
    the state's own."""
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


def bsdf_prepare(scene, state, hit, missed, wo_w, frame, importance,
                 miss_rgb, nee_rgb, draws, direct_only=False, texels=None,
                 device_type="cuda"):
    """The BSDF kernel's arguments, every input and table checked, and its
    outputs: ``(BsdfArgs, out)``, ``out`` the (K, P) buffer of the new
    state's rows. ``texels``: the NEE kernel's, or None; the kernel
    fetches the textured slots' texels it is not given."""
    p, c, ins, forms = _lane_inputs("bsdf", hit, wo_w, frame, importance,
                                    None if direct_only else draws,
                                    _BSDF_DRAWS)
    ins.update(miss_r=miss_rgb[0], miss_g=miss_rgb[1], miss_b=miss_rgb[2],
               bounce=state.bounce, last_specular=state.last_specular,
               accum_r=state.accum[0], accum_g=state.accum[1],
               accum_b=state.accum[2], sq=state.sq)
    if not direct_only:
        ins.update(ox=state.origin[0], oy=state.origin[1],
                   oz=state.origin[2], dx=state.direction[0],
                   dy=state.direction[1], dz=state.direction[2])
    # an untextured slot's texels are the material's scalars, which the
    # kernel reads itself
    for slot, _, key, fields, _ in _TEX_SLOTS:
        if texels and key in texels and slot in scene.tex_slots:
            given = texels[key]
            ins.update(zip(fields, given if isinstance(given, tuple)
                           else (given,)))
    forms.update((name, (torch.float32, (p,))) for name in ins
                 if name not in forms)
    ins.update(missed=missed, nee_rgb=nee_rgb)
    forms.update(missed=(torch.bool, (p,)),
                 nee_rgb=(torch.float32, (3, p)))
    if not direct_only:
        ins["state_importance"] = state.importance
        forms["state_importance"] = (torch.float32, (16, p))
    _check_inputs("bsdf", ins, forms, p, c, device_type)
    args = BsdfArgs()
    _rows(args, ins.pop("nee_rgb"), p, "nee_r", "nee_g", "nee_b")
    _bind(args, "bsdf", scene, ins, p, device_type)
    args.lanes_per_chain = p // c
    present = list(scene.mat_families) or [bsdf_mod.FAMILY_LAMBERT]
    args.families = sum(1 << f for f in present[1:])
    args.first_family = present[0]
    args.direct_only = int(direct_only)
    first = _DIRECT_FIRST if direct_only else 0
    out = importance.new_empty((28 - first, p))
    base = out.data_ptr() - 4 * first * p  # where row 0 would be
    if not direct_only:
        args.out_importance = base
    for row, field in enumerate(_BSDF_ROWS, 16):
        if row >= first:
            setattr(args, field, base + 4 * row * p)
    return args, out


def _bsdf_result(out, state, direct_only):
    """:func:`bsdf_plain`'s dict from :func:`bsdf_prepare`'s buffer."""
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
                miss_rgb, nee_rgb, draws, direct_only=False, texels=None):
    """:func:`bsdf_plain`'s results from one launch of ``bsdf_kernel`` on
    CUDA tensors (``mat`` is unused: the kernel reads the material rows
    itself); raises on an input it does not take. ``texels``: the NEE
    kernel's ``texels`` for these lanes, or None, and the kernel fetches
    them. The draws keep their chain width C (1, the tile count or the
    lane count): lane i reads draw i // (P // C)."""
    args, out = bsdf_prepare(scene, state, hit, missed, wo_w, frame,
                             importance, miss_rgb, nee_rgb, draws,
                             direct_only, texels)
    launch("bsdf", args, importance.device)
    return _bsdf_result(out, state, direct_only)


def bsdf(scene, state, hit, missed, wo_w, frame, mat, importance, miss_rgb,
         nee_rgb, draws, expand, direct_only=False, texels=None):
    """The BSDF stage: :func:`bsdf_kernel` on CUDA tensors (with the NEE
    kernel's ``texels``), :func:`bsdf_plain` on CPU ones (which takes its
    texels from ``mat``'s memo)."""
    if importance.is_cuda:
        return bsdf_kernel(scene, state, hit, missed, wo_w, frame, mat,
                           importance, miss_rgb, nee_rgb, draws, direct_only,
                           texels)
    return bsdf_plain(scene, state, hit, missed, wo_w, frame, mat, importance,
                      miss_rgb, nee_rgb, draws, expand, direct_only)


surface_kernel.launches = 0
nee_kernel.launches = 0
bsdf_kernel.launches = 0
_WRAPPERS = {"surface": surface_kernel, "nee": nee_kernel,
             "bsdf": bsdf_kernel}

"""The shade stage of a launch (glaze_tpu_torch/render/shade_cuda.py
``surface``): the hit's attributes, normal mapping, the shading frame, wo,
the NEE lanes and the sky on missed lanes.

On the CPU: the plain path of the new stage against the stage as it was
before the kernel (a frozen copy below), bit for bit, on random lanes and
inside real launches; the kernel's lane arithmetic (csrc/shade_lane.cuh
surface_lane, built for the host with the system C++ compiler) against
the plain version; the wrapper's refusals; and the kernel's entry points
in the one library of the shading kernels. On a card (``cuda``-marked,
skipped without one; this file imports no JAX): the kernel against the
plain version on the card, bit for bit, and one shade kernel a launch
with no material gather.

The scene is test_torch_nee's (all six BSDF families, the mirror and
glass ones specular, four light types, an sRGB sky) with a normal map on
the floor and on the uber sphere. The random lanes hold missed lanes
(row -1), bounces 0 to 6, ``last_specular`` on and off, every triangle
row and parked lanes; the cases with no sky (``sky_tex`` 0) and with no
normal map in the scene run too.
"""

import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_nee import _NeeScene, _unit  # noqa: E402

from glaze_tpu_torch.core import Texture, TextureFormat, TextureInfo  # noqa: E402
from glaze_tpu_torch.ops import shading, spectra, vec  # noqa: E402
from glaze_tpu_torch.ops import texture as tx  # noqa: E402
from glaze_tpu_torch.render import bsdf as bsdf_mod  # noqa: E402
from glaze_tpu_torch.render import integrator as ti  # noqa: E402
from glaze_tpu_torch.render import shade_cuda  # noqa: E402
from glaze_tpu_torch.scene import flatten as fl  # noqa: E402

R = 4096  # two 2048-lane tiles
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "glaze_tpu_torch", "csrc")


class _ShadeScene(_NeeScene):
    """test_torch_nee's scene with a linear normal map (tilted around +z)
    on the floor and on the uber sphere."""

    def textures(self):
        rng = np.random.default_rng(9)
        nm = np.zeros((16, 16, 4), np.uint8)
        nm[..., :2] = rng.integers(60, 196, (16, 16, 2))
        nm[..., 2] = rng.integers(180, 256, (16, 16))
        nm[..., 3] = 255
        return super().textures() + [
            Texture(TextureInfo("bumps", 16, 16, TextureFormat.RgbaNorm),
                    [nm])]

    def materials(self):
        mats = super().materials()
        slot = len(self.textures()) - 1
        for m in mats:
            if m.name in ("floor", "uber"):
                m.normal = slot
        return mats


@pytest.fixture(scope="module")
def scene():
    s, _, _ = fl.flatten_scene(_ShadeScene(), "cpu")
    assert fl.MT_NORMAL in s.tex_slots and int(s.sky_tex) > 0
    assert s.mat_families == (0, 1, 2, 3, 4, 5)
    return s


def _variant(scene, case):
    """The scene of a case: as it is, without its sky, or without any
    normal map."""
    if case == "no_sky":
        return scene._replace(sky_tex=torch.zeros_like(scene.sky_tex))
    if case == "no_normal_map":
        mt = scene.mat_tex.clone()
        mt[:, fl.MT_NORMAL] = 0
        return scene._replace(mat_tex=mt)
    return scene


CASES = ("sky", "no_sky", "no_normal_map")


def _lanes(scene, seed, parked=False, device="cpu"):
    """Random inputs of the stage on ``device``: (hit, direction, state,
    importance, parked)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tri = rng.integers(0, scene.tri_attr.shape[0], R).astype(np.int32)
    tri[rng.random(R) < 0.25] = -1
    u = rng.random(R).astype(np.float32)
    v = (rng.random(R) * (1.0 - u)).astype(np.float32)
    hit = {"t": t(rng.uniform(0.1, 9.0, R).astype(np.float32)),
           "tri": t(tri), "u": t(u), "v": t(v)}
    direction = tuple(t(c) for c in _unit(rng, R))
    state = ti.init_state(64, 64, device)._replace(
        bounce=t(rng.integers(0, 7, R).astype(np.float32)),
        last_specular=t((rng.random(R) < 0.4).astype(np.float32)))
    importance = t(rng.uniform(0.0, 1.5, (16, R)).astype(np.float32))
    mask = t(rng.random(R) < 0.25) if parked else None
    return hit, direction, state, importance, mask


def _stage_before(scene, hit, direction, state, importance, parked):
    """The shade stage as integrator.launch_step computed it before the
    kernel (frozen, with integrator._sky_radiance and _interpolate_hit
    inlined): (miss_contrib, surf, wo_w, frame, mat, missed,
    nee_active)."""
    missed = hit["tri"] < 0

    sky_visible = (state.bounce == 0.0) | (state.last_specular == 1.0)
    add_sky = missed & sky_visible & (scene.sky_tex > 0)
    if parked is not None:
        add_sky = add_sky & ~parked
    m = scene.sky_world2obj
    w = vec.normalize((
        m[0, 0] * direction[0] + m[0, 1] * direction[1] + m[0, 2] * direction[2],
        m[1, 0] * direction[0] + m[1, 1] * direction[1] + m[1, 2] * direction[2],
        m[2, 0] * direction[0] + m[2, 1] * direction[1] + m[2, 2] * direction[2],
    ))
    phi = torch.atan2(w[1], w[0])
    theta = torch.acos(torch.clamp(w[2], -1.0, 1.0))
    su = phi * float(np.float32(0.1591549))
    sv = theta * float(np.float32(0.3183099))
    tex = torch.broadcast_to(scene.sky_tex, phi.shape)
    sr, sg, sb = tx.sample_rgb_v(scene.atlas, tex, su, sv)
    sky_spec = importance * spectra.from_illuminant_color_t(sr, sg, sb)
    mr, mg, mb = spectra.to_rgb_t(sky_spec)
    zero = torch.zeros_like(mr)
    miss_contrib = (torch.where(add_sky, mr, zero),
                    torch.where(add_sky, mg, zero),
                    torch.where(add_sky, mb, zero))

    tri = torch.clamp(hit["tri"], min=0).long()
    bu = hit["u"]
    bv = hit["v"]
    bw = 1.0 - bu - bv
    a = scene.tri_attr[tri]

    def v3_at(col):
        return (a[:, col], a[:, col + 1], a[:, col + 2])

    point = vec.add(v3_at(fl.ATTR_V0), vec.add(
        vec.scale(v3_at(fl.ATTR_E1), bu), vec.scale(v3_at(fl.ATTR_E2), bv)))
    shading_n = vec.normalize(vec.add(
        vec.scale(v3_at(fl.ATTR_N0), bw),
        vec.add(vec.scale(v3_at(fl.ATTR_N1), bu),
                vec.scale(v3_at(fl.ATTR_N2), bv))))
    u = bw * a[:, fl.ATTR_UV0] + bu * a[:, fl.ATTR_UV1] + bv * a[:, fl.ATTR_UV2]
    v = (bw * a[:, fl.ATTR_UV0 + 1] + bu * a[:, fl.ATTR_UV1 + 1]
         + bv * a[:, fl.ATTR_UV2 + 1])
    geom_n = v3_at(fl.ATTR_GN)
    dpdu = v3_at(fl.ATTR_DPDU)
    mat_id = a[:, fl.ATTR_MAT].to(torch.int32)
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
    surf = {"point": point, "shading_normal": shading_n,
            "geom_normal": geom_n, "dpdu": dpdu, "uv": (u, v),
            "material_id": mat_id}

    wo_w = vec.neg(direction)
    frame = shading.new_shading_space_v(surf["dpdu"], surf["shading_normal"])
    mat = bsdf_mod.gather_material(scene, surf["material_id"])
    mat_specular = mat["scalars"][fl.MS_IS_SPECULAR] > 0.5
    nee_active = ~missed & ~mat_specular
    if parked is not None:
        nee_active = nee_active & ~parked
    return miss_contrib, surf, wo_w, frame, mat, missed, nee_active


def _as_new(before):
    """The frozen stage's results under the new stage's names."""
    miss, surf, wo_w, frame, mat, missed, nee_active = before
    return {"surf": surf, "wo_w": wo_w, "frame": frame, "mat": mat,
            "missed": missed, "nee_active": nee_active, "miss_rgb": miss}


def _floats(res):
    """The (20, P) lane floats of a result, in the kernel's row order."""
    s, t, n = res["frame"]
    surf = res["surf"]
    return torch.stack([*surf["point"], *s, *t, *n, *res["wo_w"],
                        *surf["uv"], *res["miss_rgb"]])


def _same(a, b):
    """Elementwise equality, NaN equal to NaN."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _equal(got, want):
    """Every lane float, the shading normal, the material rows and both
    flags bit for bit."""
    torch.testing.assert_close(_floats(got), _floats(want), rtol=0, atol=0,
                               equal_nan=True)
    for a, b in zip(got["surf"]["shading_normal"],
                    want["surf"]["shading_normal"]):
        assert bool(_same(a, b).all())
    for k in ("missed", "nee_active"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["surf"]["material_id"],
                       want["surf"]["material_id"])


def _coverage(scene, lanes, res):
    """The cases the lanes must hold: sky lanes, lanes the sky skips,
    specular hits, normal-mapped hits."""
    hit, _, state, _, parked = lanes
    missed = res["missed"]
    sky = (res["miss_rgb"][0] != 0) | (res["miss_rgb"][1] != 0)
    mid = res["surf"]["material_id"].long()
    spec = scene.mat_scalars[mid, fl.MS_IS_SPECULAR] > 0.5
    mapped = scene.mat_tex[mid, fl.MT_NORMAL] != 0
    return {"missed": int(missed.sum()), "sky": int(sky.sum()),
            "missed_dark": int((missed & ~sky).sum()),
            "specular_hits": int((~missed & spec).sum()),
            "mapped_hits": int((~missed & mapped).sum()),
            "parked": 0 if parked is None else int(parked.sum())}


@pytest.mark.parametrize("parked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_path_matches_before(scene, case, parked):
    """CPU: surface_plain gives the frozen stage's results bit for bit,
    the material record included."""
    s = _variant(scene, case)
    lanes = _lanes(s, 11, parked)
    want = _as_new(_stage_before(s, *lanes))
    got = shade_cuda.surface_plain(s, *lanes)
    _equal(got, want)
    for k in ("point", "geom_normal", "dpdu", "uv"):
        assert all(torch.equal(a, b) for a, b in zip(got["surf"][k],
                                                     want["surf"][k])), k
    for k in ("scalars", "tex", "metal_ior", "metal_fresnel", "bsdf"):
        assert torch.equal(got["mat"][k], want["mat"][k]), k
    cov = _coverage(s, lanes, got)
    assert cov["missed"] > R // 8 and cov["specular_hits"] > 0
    assert cov["missed_dark"] > 0
    assert (cov["sky"] > R // 20) == (case != "no_sky")
    assert (cov["mapped_hits"] > 0) == (case != "no_normal_map")
    assert (cov["parked"] > 0) == parked


# the launches of a render, each stage checked against the frozen copy
LAUNCH_CASES = [
    dict(coherent=1, sampler="pcg", sif=1, alpha_rounds=1),
    dict(coherent=2, sampler="pcg", sif=2),
    dict(coherent=0, sampler="ld", sif=1, adaptive=True),
    dict(coherent=0, sampler="pcg", sif=1, direct=True),
]


@pytest.mark.parametrize("case", LAUNCH_CASES,
                         ids=["frame_alpha", "tile_sif2", "ld_parked",
                              "direct"])
def test_stage_inside_launches_matches_before(scene, case, monkeypatch):
    """CPU: inside eight launches of a 64x32 render, every call of the
    stage gives what the frozen copy gives on the same inputs, bit for
    bit: camera rays and bounces, one and two samples in flight, both
    samplers, opacity rounds, parked lanes (adaptive stopping) and
    DIRECT."""
    orig = shade_cuda.surface
    calls = []

    def spy(scene, hit, direction, state, importance, parked=None):
        got = orig(scene, hit, direction, state, importance, parked)
        _equal(got, _as_new(_stage_before(scene, hit, direction, state,
                                          importance, parked)))
        calls.append(int(got["missed"].sum()))
        return got

    monkeypatch.setattr(shade_cuda, "surface", spy)
    w, h, sif = 64, 32, case["sif"]
    cam = _ShadeScene().cameras()[0]
    c2w, s2c = ti.camera_matrices(cam, w, h)
    steps = 8
    seeds = np.arange(steps, dtype=np.uint32) * 7919 + 13
    offsets = np.full((steps, sif, 2) if sif > 1 else (steps, 2), 0.5,
                      np.float32)
    lane_active = None
    if case.get("adaptive"):
        lane_active = torch.arange(ti.pixel_count(w, h)) < 2048
    st = ti.render_steps(
        scene, ti.init_state(w, h, "cpu", sif=sif), seeds, offsets, c2w, s2c,
        width=w, height=h, is_persp=True,
        direct_only=bool(case.get("direct")), steps=steps, sif=sif,
        alpha_rounds=case.get("alpha_rounds", 0), coherent=case["coherent"],
        sampler=case["sampler"], sampler_seed=7, lane_active=lane_active)
    assert len(calls) == steps and max(calls) > 0
    assert (torch.stack(st.accum) != 0).any()


def test_first_hit_attributes_come_from_the_stage(scene, monkeypatch):
    """launch_step's ``want_first_hit`` G-buffer input is the stage's own
    output: the shading normal, the material rows, uv and the miss
    flag."""
    seen = []
    orig = shade_cuda.surface

    def spy(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(shade_cuda, "surface", spy)
    w, h = 64, 32
    c2w, s2c = ti.camera_matrices(_ShadeScene().cameras()[0], w, h)
    px, py = ti.pixel_coords(w, h, "cpu")
    _, fh = ti.launch_step(scene, ti.init_state(w, h, "cpu"), 5, (0.5, 0.5),
                           c2w, s2c, px, py, (float(w), float(h)),
                           is_persp=True, want_first_hit=True)
    res = seen[0]
    assert fh["missed"] is res["missed"]
    assert fh["material_id"] is res["surf"]["material_id"]
    assert fh["shading_normal"] is res["surf"]["shading_normal"]
    assert fh["uv"] is res["surf"]["uv"]


# ---- the kernel's lane arithmetic, built for the host -----------------------


@pytest.fixture(scope="module")
def host_lane(tmp_path_factory):
    """csrc/shade_lane.cuh's surface_lane in a loop over lanes, compiled
    with the host's C++ compiler (no contraction of products and sums into
    fused multiply-adds)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("surface_host")
    src = d / "surface_host.cpp"
    src.write_text(
        '#include "shade_lane.cuh"\n'
        'extern "C" void surface_host(const glaze_shade::SurfaceArgs* a) {\n'
        '  for (int i = 0; i < a->n_lanes; ++i)\n'
        '    glaze_shade::surface_lane(*a, a->consts, i);\n'
        '}\n')
    so = d / "libsurface_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.surface_host.argtypes = [ctypes.POINTER(shade_cuda.SurfaceArgs)]
    lib.surface_host.restype = None
    return lib


def _host(scene, host_lane, lanes):
    args, out = shade_cuda.surface_prepare(scene, *lanes, device_type="cpu")
    host_lane.surface_host(ctypes.byref(args))
    return shade_cuda._surface_result(out)


@pytest.mark.parametrize("parked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_lane_code_matches_plain_on_cpu(scene, host_lane, case, parked):
    """The kernel's arithmetic, run on the host, against the plain version
    on the same lanes: the flags and material rows exactly, the lane
    floats within test_torch_nee's tolerances. The host's atan2f, acosf
    and powf and its 16-bin sums round apart from torch's CPU kernels by an
    ulp here and there (and the sRGB decode divides on the CPU where the
    card's torch multiplies by the reciprocal); the card test holds the
    kernel exactly."""
    s = _variant(scene, case)
    lanes = _lanes(s, 23, parked)
    want = shade_cuda.surface_plain(s, *lanes)
    got = _host(s, host_lane, lanes)
    for k in ("missed", "nee_active"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["surf"]["material_id"],
                       want["surf"]["material_id"])
    assert got["mat"] is None
    a, b = _floats(got), _floats(want)
    geo, sky = slice(0, 17), slice(17, 20)
    assert _same(a[geo], b[geo]).float().mean().item() > 0.9
    assert torch.allclose(a[geo], b[geo], rtol=1e-5, atol=1e-6,
                          equal_nan=True)
    scale = b[sky].abs().amax(dim=0)
    off = (a[sky] - b[sky]).abs()
    assert ((off <= 1e-4 * scale + 1e-30).all(dim=0)).float().mean() > 0.999
    assert bool((off <= 1e-2 * scale + 1e-30).all())
    assert bool((a[sky] == 0).all(dim=0).eq(b[sky].eq(0).all(dim=0)).all())


# ---- the wrapper's refusals -------------------------------------------------


def _bad(case, lanes):
    hit, direction, state, importance, parked = lanes
    hit = dict(hit)
    if case == "dtype":
        importance = importance.double()
    elif case == "tri":
        hit["tri"] = hit["tri"].long()
    elif case == "shape":
        hit["u"] = hit["u"][1:]
    elif case == "contiguity":
        direction = (torch.stack(direction, 1)[:, 0],) + direction[1:]
    elif case == "parked":
        parked = parked.to(torch.uint8)
    return hit, direction, state, importance, parked


@pytest.mark.parametrize("case,match", [
    ("device", "not on a cuda device"), ("dtype", "must be a torch.float32"),
    ("tri", "tri must be a torch.int32"), ("shape", "has shape"),
    ("contiguity", "must be contiguous"),
    ("parked", "parked must be a torch.bool")])
def test_kernel_wrapper_refuses(scene, case, match):
    lanes = _bad(case, _lanes(scene, 3, parked=True))
    before = shade_cuda.surface_kernel.launches
    with pytest.raises(ValueError, match=f"^surface: .*{match}"):
        shade_cuda.surface_kernel(scene, *lanes)
    assert shade_cuda.surface_kernel.launches == before


def test_cpu_tensors_take_the_plain_path(scene):
    """``surface`` on CPU tensors runs the plain version and no kernel,
    and hands the plain stages their material record."""
    lanes = _lanes(scene, 5, parked=True)
    before = shade_cuda.surface_kernel.launches
    got = shade_cuda.surface(scene, *lanes)
    assert shade_cuda.surface_kernel.launches == before
    _equal(got, shade_cuda.surface_plain(scene, *lanes))
    assert set(got["mat"]) >= {"scalars", "tex", "metal_ior"}


def test_kernel_shares_the_shading_library(monkeypatch):
    """The shade kernel lives in the one source and library of the NEE and
    BSDF kernels, declared with its own argument structure when the
    module loads the library (here a stand-in records the declarations);
    its launches count beside theirs and reset with them."""
    src = open(os.path.join(CSRC, shade_cuda.SOURCE)).read()
    assert "surface_kernel" in src and "glaze_surface_launch" in src

    class StandIn:
        def __getattr__(self, name):
            entry = types.SimpleNamespace()
            setattr(self, name, entry)
            return entry

    monkeypatch.setattr(shade_cuda, "_lib", None)
    monkeypatch.setattr(shade_cuda, "build", lambda: "stand-in.so")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: StandIn())
    lib = shade_cuda._load()
    assert lib.glaze_surface_launch.argtypes == [
        ctypes.POINTER(shade_cuda.SurfaceArgs), ctypes.c_void_p]
    assert lib.glaze_surface_attrs.restype is ctypes.c_int
    monkeypatch.setattr(shade_cuda.surface_kernel, "launches", 3)
    shade_cuda.reset_launch_counts()
    assert shade_cuda.surface_kernel.launches == 0


# ---- on a card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("parked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_cuda(scene, card, case, parked):
    """The kernel against the plain version, both on the card: every lane
    float, the material rows and both flags bit for bit."""
    cs = _variant(scene, case).to(card)
    lanes = _lanes(cs, 37, parked, card)
    want = shade_cuda.surface_plain(cs, *lanes)
    before = shade_cuda.surface_kernel.launches
    got = shade_cuda.surface(cs, *lanes)
    torch.cuda.synchronize()
    assert shade_cuda.surface_kernel.launches == before + 1
    assert got["mat"] is None
    _equal(got, want)
    cov = _coverage(cs, lanes, got)
    assert (cov["sky"] > 0) == (case != "no_sky")
    assert (cov["mapped_hits"] > 0) == (case != "no_normal_map")


@pytest.mark.cuda
@pytest.mark.parametrize("coherent,sampler,sif,direct", [
    (0, "pcg", 1, False), (1, "pcg", 2, False), (2, "pcg", 1, False),
    (0, "ld", 1, False), (1, "pcg", 1, True)])
def test_launch_step_on_cuda_matches_cpu(scene, card, coherent, sampler, sif,
                                         direct, monkeypatch):
    """Six launches on the card (the three kernels) against the CPU (the
    plain versions) from the same state: at most 1% of lanes apart by more
    than 1e-4 relative plus 1e-4 (the benchmark's lanes_apart_pct rule),
    every count equal, one shade kernel a launch and no material gather on
    the card."""
    w, h = 128, 32
    c2w, s2c = ti.camera_matrices(_ShadeScene().cameras()[0], w, h)
    seeds = np.arange(6, dtype=np.uint32) * 7919 + 13
    offsets = np.full((6, sif, 2) if sif > 1 else (6, 2), 0.5, np.float32)
    gathers = []
    orig = bsdf_mod.gather_material

    def counted(scene, mat_id):
        gathers.append(mat_id.device.type)
        return orig(scene, mat_id)

    monkeypatch.setattr(bsdf_mod, "gather_material", counted)
    states = {}
    for dev, s in (("cpu", scene), ("cuda", scene.to(card))):
        before = shade_cuda.surface_kernel.launches
        st = ti.render_steps(
            s, ti.init_state(w, h, dev, sif=sif), seeds, offsets, c2w, s2c,
            width=w, height=h, is_persp=True, direct_only=direct, steps=6,
            alpha_rounds=1, sif=sif, coherent=coherent, sampler=sampler,
            sampler_seed=7)
        launched = shade_cuda.surface_kernel.launches - before
        assert launched == (6 if dev == "cuda" else 0)
        states[dev] = st
    assert "cuda" not in gathers and "cpu" in gathers
    cpu, gpu = states["cpu"], states["cuda"]
    assert torch.equal(cpu.count, gpu.count.cpu())
    a = torch.stack(gpu.accum).cpu()
    b = torch.stack(cpu.accum)
    apart = ((a - b).abs() > 1e-4 * b.abs() + 1e-4).any(dim=0)
    assert apart.float().mean().item() <= 0.01
    assert (b != 0).any(dim=0).float().mean().item() > 0.3

"""The NEE stage before its shadow ray
(glaze_tpu_torch/render/shade_cuda.py ``nee``).

On the CPU: the plain path of the new NEE stage against the stage as it
was before the kernel (a frozen copy below), bit for bit, the texel memo
included; the kernel's lane arithmetic (csrc/shade_lane.cuh, built for
the host with the system C++ compiler) against the plain version; and the
wrapper's refusals. On a card (``cuda``-marked, skipped without one;
this file imports no JAX): the kernel against the plain version on the
card, and a launch on the card against the CPU's.

The scene holds all six BSDF families and all four light types, a
textured diffuse slot (sRGB), roughness (linear RGBA) and metalness
(gray) maps beside untextured materials, and an opacity map, so the
shadow rays take the alpha-aware occlusion with ``alpha_rounds`` > 0.
The lanes are random hits: every material, both hemispheres, NEE
inactive on a fifth of them, and the mirror and glass lanes that the
BSDF value leaves at pdf 0.

Draw widths: one chain for the frame (coherent 1), one a 2048-lane tile
(coherent 2), one a lane (coherent 0), and the ``ld`` sampler's
lane-width points.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from glaze_tpu_torch import scenes as sc  # noqa: E402
from glaze_tpu_torch.core import (  # noqa: E402
    Light,
    LightType,
    Spectrum,
    Texture,
    TextureFormat,
    TextureInfo,
)
from glaze_tpu_torch.ops import rng as rng_mod  # noqa: E402
from glaze_tpu_torch.ops import shading, spectra, vec  # noqa: E402
from glaze_tpu_torch.render import bsdf as bsdf_mod  # noqa: E402
from glaze_tpu_torch.render import integrator as ti  # noqa: E402
from glaze_tpu_torch.render import lights as lights_mod  # noqa: E402
from glaze_tpu_torch.render import shade_cuda  # noqa: E402
from glaze_tpu_torch.scene import flatten as fl  # noqa: E402

R = 4096  # two 2048-lane tiles
WIDTHS = ("frame", "tile", "lane", "ld")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "glaze_tpu_torch", "csrc")


class _NeeScene(sc.MatRowScene):
    """The golden scene with a SUN light, roughness maps on the metal,
    frosted and uber spheres, a metalness map and the floor's diffuse map
    on the uber sphere, and an opacity map on the lambert sphere."""

    def textures(self):
        rng = np.random.default_rng(5)
        rough = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
        metal = rng.integers(0, 256, (8, 8)).astype(np.uint8)
        return super().textures() + [
            Texture(TextureInfo("rough", 16, 16, TextureFormat.RgbaNorm),
                    [rough]),
            Texture(TextureInfo("metal", 8, 8, TextureFormat.Gray), [metal]),
            Texture(TextureInfo("cutout", 128, 128, TextureFormat.Gray),
                    [sc._cutout_tex(128)]),
        ]

    def materials(self):
        mats = super().materials()
        for m in mats:
            if m.name in ("metal", "frosted", "uber"):
                m.roughness = 3
            if m.name == "metal":
                m.anisotropy = 0.3
            if m.name == "uber":
                m.metalness, m.metalness_mul, m.diffuse = 4, 0.8, 1
            if m.name == "lambert":
                m.opacity = 5
        return mats

    def lights(self):
        return super().lights() + [Light(
            ltype=LightType.SUN, name="sun", color=Spectrum.white(),
            direction=np.asarray([0.35, -0.8, 0.25], np.float32),
            intensity=3.0)]


@pytest.fixture(scope="module")
def scene():
    s, _, _ = fl.flatten_scene(_NeeScene(), "cpu")
    assert s.mat_families == (0, 1, 2, 3, 4, 5)
    assert s.light_kinds == (0, 1, 2, 3)
    assert {fl.MT_DIFFUSE, fl.MT_ROUGHNESS, fl.MT_METALNESS,
            fl.MT_OPACITY} <= set(s.tex_slots)
    return s


def _unit(rng, n):
    v = rng.normal(size=(3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _lanes(scene, seed, width, device="cpu"):
    """Random hits on ``device``: (hit, wo_w, frame, importance,
    nee_active, rng chain, ld draws or None)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lo, hi = np.asarray([-6, 0, -3]), np.asarray([6, 5, 3])
    point = (lo[:, None] + (hi - lo)[:, None] * rng.random((3, R))).astype(
        np.float32)
    normal = tuple(t(c) for c in _unit(rng, R))
    dpdu = tuple(t(c) for c in rng.normal(size=(3, R)).astype(np.float32))
    frame = shading.new_shading_space_v(dpdu, normal)
    n_mat = scene.mat_scalars.shape[0]
    hit = {"point": tuple(t(c) for c in point), "shading_normal": frame[2],
           "uv": tuple(t(c) for c in rng.uniform(-1, 2, (2, R)).astype(
               np.float32)),
           "material_id": t(rng.integers(0, n_mat, R).astype(np.int32))}
    wo_w = tuple(t(c) for c in _unit(rng, R))
    importance = t(rng.uniform(0.2, 1.5, (16, R)).astype(np.float32))
    nee_active = t(rng.random(R) < 0.8)
    c = {"frame": 1, "tile": R // 2048, "lane": R, "ld": R}[width]
    chain = rng_mod.srand_f32x3(
        t(np.full(c, float(seed), np.float32)),
        t(np.arange(c, dtype=np.float32)), t(np.zeros(c, np.float32)))
    ld = None
    if width == "ld":
        ld = tuple(t(d) for d in rng.random((5, R)).astype(np.float32))
    return hit, wo_w, frame, importance, nee_active, chain, ld


def _expand(a):
    return ti._expand_block(a, R)


def _direct_light_before(scene, state_rng, wo_w, frame, hit, mat, active,
                         alpha_rounds=0, expand=None, draws=None):
    """The NEE stage as integrator._direct_light computed it before the
    kernel (frozen): returns (rng, radiance (16, R))."""
    ex = expand if expand is not None else (lambda a: a)
    rng = state_rng
    rng, r_pick = rng_mod.next_f32(rng)
    if draws is not None:
        r_pick = draws[0]
    lights_no = scene.lights_no
    lights_no_f = lights_no.to(torch.float32)
    light_idx = torch.minimum((r_pick * lights_no_f).to(torch.int32),
                              lights_no - 1)
    light_idx = torch.clamp(light_idx, min=0)
    rng, ra = rng_mod.next_f32(rng)
    rng, rb = rng_mod.next_f32(rng)
    rng, rc = rng_mod.next_f32(rng)
    if draws is not None:
        ra, rb, rc = draws[1], draws[2], draws[3]
    wiw, dist, emission, light_pdf = lights_mod.sample_light(
        scene, light_idx, hit["point"], (ra, rb, rc), expand=expand)
    rng, r_bsdf = rng_mod.next_f32(rng)
    if draws is not None:
        r_bsdf = draws[4]
    wo = shading.to_shading_space_v(wo_w, frame)
    wi = shading.to_shading_space_v(wiw, frame)
    value, bsdf_pdf = bsdf_mod.bsdf_value(scene, mat, wo, wi, hit["uv"],
                                          ex(r_bsdf))
    usable = (light_pdf > 0.0) & (bsdf_pdf > 0.0)
    if alpha_rounds > 0:
        shadow_hit = ti._occlusion_sorted(scene, hit["point"], wiw,
                                          dist - 1e-3, active & usable,
                                          alpha_rounds)
    else:
        shadow_hit = ti._any_hit_sorted(scene, hit["point"], wiw, dist - 1e-3,
                                        active & usable)
    cos_term = torch.abs(vec.dot(wiw, hit["shading_normal"]))
    weight = (usable.to(torch.float32) * (~shadow_hit).to(torch.float32)
              * cos_term / torch.clamp(light_pdf, min=1e-20))
    radiance = value * emission * (weight * lights_no_f)
    return rng, radiance


def _memo(mat):
    return {k: v[1] for k, v in mat.get("_texmemo", {}).items()}


@pytest.mark.parametrize("alpha_rounds", [0, 1])
@pytest.mark.parametrize("width", WIDTHS)
def test_plain_path_matches_before(scene, width, alpha_rounds):
    """CPU: the new stage (the plain version, the shadow test, one where)
    gives the old stage's contribution and rng bit for bit, and the same
    texel memo."""
    hit, wo_w, frame, importance, nee_active, chain, ld = _lanes(
        scene, 11, width)
    mat_a = bsdf_mod.gather_material(scene, hit["material_id"])
    rng_a, rad = _direct_light_before(scene, chain, wo_w, frame, hit, mat_a,
                                      nee_active, alpha_rounds, _expand, ld)
    rad = rad * importance
    zero = torch.zeros(R)
    want = torch.stack([torch.where(nee_active, c, zero)
                        for c in spectra.to_rgb_t(rad)])
    mat_b = bsdf_mod.gather_material(scene, hit["material_id"])
    rng_b, got, texels = ti._direct_light(scene, chain, wo_w, frame, hit,
                                          mat_b, importance, nee_active,
                                          alpha_rounds, _expand, ld)
    assert texels is None  # the plain version keeps them in the memo
    assert torch.equal(rng_a, rng_b)
    assert torch.equal(got, want)
    assert (want != 0).any(dim=0).sum() > R // 10
    a, b = _memo(mat_a), _memo(mat_b)
    assert a.keys() == b.keys() == {"diffuse", "rough", "metal"}
    for k in a:
        for x, y in zip(*((v,) if torch.is_tensor(v) else v
                          for v in (a[k], b[k]))):
            assert torch.equal(x, y), k


# ---- the kernel's lane arithmetic, built for the host -----------------------


@pytest.fixture(scope="module")
def host_lanes(tmp_path_factory):
    """csrc/shade_lane.cuh's nee_lane in a loop over lanes, compiled with
    the host's C++ compiler (no contraction of products and sums into
    fused multiply-adds)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("nee_host")
    src = d / "nee_host.cpp"
    src.write_text(
        '#include "shade_lane.cuh"\n'
        'extern "C" void nee_host(const glaze_shade::NeeArgs* a) {\n'
        '  for (int i = 0; i < a->n_lanes; ++i)\n'
        '    glaze_shade::nee_lane(*a, a->consts, i);\n'
        '}\n')
    so = d / "libnee_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.nee_host.argtypes = [ctypes.POINTER(shade_cuda.NeeArgs)]
    lib.nee_host.restype = None
    return lib


def _draws(chain, ld):
    if ld is not None:
        return ld
    out = []
    for _ in range(5):
        chain, r = rng_mod.next_f32(chain)
        out.append(r)
    return tuple(out)


def _rgb_close(got, want, rtol):
    """Lanes whose RGB agree within ``rtol`` of the lane's largest
    channel (the XYZ -> RGB rows cancel, so a channel near 0 is judged
    on the lane's scale)."""
    scale = want.abs().amax(dim=0)
    return ((got - want).abs() <= rtol * scale + 1e-30).all(dim=0)


@pytest.mark.parametrize("width", WIDTHS)
def test_lane_code_matches_plain_on_cpu(scene, host_lanes, width):
    """The kernel's arithmetic, run on the host, against the plain version
    on the same lanes. The host's sinf/cosf/powf and its sums round apart
    from torch's CPU kernels by an ulp here and there, and the sRGB decode
    divides on the CPU where the card's torch multiplies by the
    reciprocal; the card test holds the kernel exactly."""
    hit, wo_w, frame, importance, nee_active, chain, ld = _lanes(
        scene, 23, width)
    draws = _draws(chain, ld)
    mat = bsdf_mod.gather_material(scene, hit["material_id"])
    want = shade_cuda.nee_plain(scene, hit, wo_w, frame, mat, importance,
                                nee_active, draws, _expand)
    args, out = shade_cuda.nee_prepare(scene, hit, wo_w, frame, importance,
                                       nee_active, draws, device_type="cpu")
    host_lanes.nee_host(ctypes.byref(args))
    got = shade_cuda._nee_result(out)

    def share(ok):
        return ok.float().mean().item()

    for g, w in zip(got["wiw"] + (got["cap"],), want["wiw"] + (want["cap"],)):
        assert share(g == w) > 0.9
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-6)
    assert share(got["active"] == want["active"]) > 0.999
    key = ti._trace_key(scene, hit["point"], want["wiw"], want["active"])
    assert share(got["key"] == key) > 0.999
    assert share(_rgb_close(got["rgb"], want["rgb"], 1e-4)) > 0.999
    assert share(_rgb_close(got["rgb"], want["rgb"], 1e-2)) == 1.0
    memo = _memo(mat)
    assert got["texels"].keys() == memo.keys()
    for k, w in memo.items():
        g = got["texels"][k]
        g, w = (torch.stack(x) if isinstance(x, tuple) else x for x in (g, w))
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-7), k
    assert (want["rgb"] != 0).any(dim=0).sum() > R // 10


# ---- the wrapper's refusals -------------------------------------------------


def _bad(case, lanes):
    hit, wo_w, frame, importance, nee_active, chain, ld = lanes
    hit = dict(hit)
    if case == "dtype":
        importance = importance.double()
    elif case == "shape":
        hit["uv"] = (hit["uv"][0][1:], hit["uv"][1])
    elif case == "contiguity":
        hit["point"] = (torch.stack(hit["point"], 1)[:, 0],) + hit["point"][1:]
    elif case == "chains":
        ld = tuple(d[:3] for d in ld)
    return hit, wo_w, frame, importance, nee_active, ld


@pytest.mark.parametrize("case,match", [
    ("device", "not on a cuda device"), ("dtype", "must be a torch.float32"),
    ("shape", "has shape"), ("contiguity", "must be contiguous"),
    ("chains", "do not split into chains")])
def test_kernel_wrapper_refuses(scene, case, match):
    lanes = _lanes(scene, 3, "ld")
    hit, wo_w, frame, importance, nee_active, ld = _bad(case, lanes)
    mat = bsdf_mod.gather_material(scene, hit["material_id"])
    before = shade_cuda.nee_kernel.launches
    with pytest.raises(ValueError, match=match):
        shade_cuda.nee_kernel(scene, hit, wo_w, frame, mat, importance,
                              nee_active, ld)
    assert shade_cuda.nee_kernel.launches == before
    assert "_texmemo" not in mat


def test_cpu_tensors_take_the_plain_path(scene):
    """``nee`` on CPU tensors runs the plain version and no kernel."""
    hit, wo_w, frame, importance, nee_active, chain, ld = _lanes(
        scene, 5, "tile")
    draws = _draws(chain, None)
    before = shade_cuda.nee_kernel.launches
    mat = bsdf_mod.gather_material(scene, hit["material_id"])
    got = shade_cuda.nee(scene, hit, wo_w, frame, mat, importance, nee_active,
                         draws, _expand)
    want = shade_cuda.nee_plain(scene, hit, wo_w, frame, {**mat}, importance,
                                nee_active, draws, _expand)
    assert shade_cuda.nee_kernel.launches == before
    assert got["key"] is None and got["texels"] is None
    assert torch.equal(got["rgb"], want["rgb"])


def test_library_builds_from_its_sources(monkeypatch):
    """shade.cu is rebuilt when it or shade_lane.cuh changes, and a failed
    build raises (here nvcc is missing): the wrapper never falls back."""
    from glaze_tpu_torch import cuda_build

    assert cuda_build.local_headers(shade_cuda.SOURCE) == ["shade_lane.cuh"]
    monkeypatch.setattr(shade_cuda, "_lib", None)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(shade_cuda, "LIBRARY", "absent.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        shade_cuda._load()


# ---- on a card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_matches_plain_on_cuda(scene, card, width):
    """The kernel against the plain version, both on the card: wiw, cap,
    the shadow rays' active lanes and key, and the texels it returns
    against the plain memo's, bit for bit; RGB within 1e-5 of the lane's
    scale (the 16-bin sums run in another order)."""
    cs = scene.to(card)
    hit, wo_w, frame, importance, nee_active, chain, ld = _lanes(
        cs, 37, width, card)
    draws = _draws(chain, ld)
    mat_p = bsdf_mod.gather_material(cs, hit["material_id"])
    want = shade_cuda.nee_plain(cs, hit, wo_w, frame, mat_p, importance,
                                nee_active, draws, _expand)
    mat_k = bsdf_mod.gather_material(cs, hit["material_id"])
    before = shade_cuda.nee_kernel.launches
    got = shade_cuda.nee(cs, hit, wo_w, frame, mat_k, importance, nee_active,
                         draws, _expand)
    torch.cuda.synchronize()
    assert shade_cuda.nee_kernel.launches == before + 1
    for g, w in zip(got["wiw"] + (got["cap"],), want["wiw"] + (want["cap"],)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got["active"], want["active"])
    key = ti._trace_key(cs, hit["point"], want["wiw"], want["active"])
    assert torch.equal(got["key"], key)
    assert bool(_rgb_close(got["rgb"], want["rgb"], 1e-5).all())
    a, b = _memo(mat_p), got["texels"]
    assert a.keys() == b.keys() == {"diffuse", "rough", "metal"}
    assert "_texmemo" not in mat_k
    for k in a:
        w = torch.stack(a[k]) if isinstance(a[k], tuple) else a[k]
        g = torch.stack(b[k]) if isinstance(b[k], tuple) else b[k]
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    # the lanes the BSDF value leaves at pdf 0 and the inactive ones
    fam = mat_p["bsdf"]
    delta = (fam == bsdf_mod.FAMILY_MIRROR) | (fam == bsdf_mod.FAMILY_GLASS)
    assert delta.any() and not got["active"][delta].any()
    assert not got["active"][~nee_active].any()


@pytest.mark.cuda
@pytest.mark.parametrize("coherent,sampler,alpha_rounds", [
    (0, "pcg", 1), (1, "pcg", 1), (2, "pcg", 0), (0, "ld", 1)])
def test_launch_step_on_cuda_matches_cpu(scene, card, coherent, sampler,
                                         alpha_rounds):
    """Six launches on the card (the kernel) against the CPU (the plain
    version) from the same state: at most 1% of lanes apart by more than
    1e-4 relative plus 1e-4 (the benchmark's lanes_apart_pct rule), and
    every count equal."""
    w, h = 128, 32
    cam = _NeeScene().cameras()[0]
    c2w, s2c = ti.camera_matrices(cam, w, h)
    seeds = np.arange(6, dtype=np.uint32) * 7919 + 13
    offsets = np.full((6, 2), 0.5, np.float32)
    states = {}
    for dev, s in (("cpu", scene), ("cuda", scene.to(card))):
        before = shade_cuda.nee_kernel.launches
        st = ti.render_steps(
            s, ti.init_state(w, h, dev), seeds, offsets, c2w, s2c, width=w,
            height=h, is_persp=True, direct_only=False, steps=6,
            alpha_rounds=alpha_rounds, coherent=coherent, sampler=sampler,
            sampler_seed=7)
        launched = shade_cuda.nee_kernel.launches - before
        assert launched == (6 if dev == "cuda" else 0)
        states[dev] = st
    cpu, gpu = states["cpu"], states["cuda"]
    assert torch.equal(cpu.count, gpu.count.cpu())
    a = torch.stack(gpu.accum).cpu()
    b = torch.stack(cpu.accum)
    apart = ((a - b).abs() > 1e-4 * b.abs() + 1e-4).any(dim=0)
    assert apart.float().mean().item() <= 0.01
    assert (b != 0).any(dim=0).float().mean().item() > 0.3

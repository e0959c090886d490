"""The BSDF stage of a launch (glaze_tpu_torch/render/shade_cuda.py
``bsdf``).

On the CPU: the plain path of the new stage against the stage as it was
before the kernel (a frozen copy below), bit for bit, on random lanes and
inside real launches; the kernel's lane arithmetic (csrc/shade_lane.cuh
bsdf_lane, built for the host with the system C++ compiler) against the
plain version, with the texels fetched, given, and given by the NEE
lane code; the wrapper's refusals; and the one library of both kernels.
On a card (``cuda``-marked, skipped without one; this file imports no
JAX): the kernel against the plain version on the card, and launches on
the card against the CPU's.

The scene is test_torch_nee's: all six BSDF families, textured diffuse,
roughness and metalness slots beside untextured materials. The random
lanes hold every material, both hemispheres, missed lanes, bounces 0 to 6
(so Russian roulette is on for some and off for the others), importance
planes that kill some paths and keep others, and the metal and frosted
lanes whose sample lands at pdf 0.

Draw widths: one chain for the frame (coherent 1), one a 2048-lane tile
(coherent 2), one a lane (coherent 0), and the ``ld`` sampler's
lane-width points.
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

from glaze_tpu_torch.ops import rng as rng_mod  # noqa: E402
from glaze_tpu_torch.ops import shading, spectra, vec  # noqa: E402
from glaze_tpu_torch.render import bsdf as bsdf_mod  # noqa: E402
from glaze_tpu_torch.render import integrator as ti  # noqa: E402
from glaze_tpu_torch.render import shade_cuda  # noqa: E402
from glaze_tpu_torch.scene import flatten as fl  # noqa: E402

R = 4096  # two 2048-lane tiles
WIDTHS = ("frame", "tile", "lane", "ld")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "glaze_tpu_torch", "csrc")
FIELDS = ("importance", "origin", "direction", "bounce", "last_specular",
          "accum", "sq")


@pytest.fixture(scope="module")
def scene():
    s, _, _ = fl.flatten_scene(_NeeScene(), "cpu")
    assert s.mat_families == (0, 1, 2, 3, 4, 5)
    return s


def _lanes(scene, seed, width, device="cpu"):
    """Random inputs of the stage on ``device``: (state, hit, missed,
    wo_w, frame, importance, miss_rgb, nee_rgb, draws)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def f32(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    lo, hi = np.asarray([-6, 0, -3]), np.asarray([6, 5, 3])
    point = (lo[:, None] + (hi - lo)[:, None] * rng.random((3, R))).astype(
        np.float32)
    normal = tuple(t(c) for c in _unit(rng, R))
    dpdu = tuple(t(c) for c in rng.normal(size=(3, R)).astype(np.float32))
    frame = shading.new_shading_space_v(dpdu, normal)
    n_mat = scene.mat_scalars.shape[0]
    hit = {"point": tuple(t(c) for c in point), "shading_normal": frame[2],
           "uv": tuple(t(c) for c in f32(2, R, lo=-1, hi=2)),
           "material_id": t(rng.integers(0, n_mat, R).astype(np.int32))}
    wo_w = tuple(t(c) for c in _unit(rng, R))
    bounce = rng.integers(0, 7, R).astype(np.float32)
    # importance from dim (roulette kills often) to bright (never)
    old_imp = f32(16, R, lo=0.0, hi=1.6) * f32(1, R, lo=0.0, hi=1.0)
    state = ti.PathState(
        importance=t(old_imp), origin=tuple(t(c) for c in f32(3, R, lo=-4)),
        direction=tuple(t(c) for c in _unit(rng, R)), bounce=t(bounce),
        last_specular=t((rng.random(R) < 0.3).astype(np.float32)),
        accum=tuple(t(c) for c in f32(3, R, hi=5)),
        count=t(rng.integers(1, 9, R).astype(np.float32)),
        path_no=t(rng.integers(0, 9, R)), sq=t(f32(R, hi=3)))
    importance = torch.where(state.bounce == 0.0, spectra.one_t(R, device),
                             state.importance)
    missed = t(rng.random(R) < 0.15)
    sky = t(f32(3, R, hi=2))
    miss_rgb = tuple(torch.where(missed, c, 0.0) for c in sky)
    nee_rgb = torch.where(~missed, t(f32(3, R, hi=0.5)), 0.0)
    c = {"frame": 1, "tile": R // 2048, "lane": R, "ld": R}[width]
    if width == "ld":
        draws = tuple(t(d) for d in f32(4, R))
    else:
        chain = rng_mod.srand_f32x3(
            t(np.full(c, float(seed), np.float32)),
            t(np.arange(c, dtype=np.float32)), t(np.zeros(c, np.float32)))
        draws = []
        for _ in range(4):
            chain, r = rng_mod.next_f32(chain)
            draws.append(r)
        draws = tuple(draws)
    return state, hit, missed, wo_w, frame, importance, miss_rgb, nee_rgb, \
        draws


def _ex(p):
    return lambda a: ti._expand_block(a, p)


def _stage_before(scene, state, surf, missed, wo_w, frame, mat, importance,
                  miss_contrib, nee_contrib, draws, ex, direct_only=False):
    """The BSDF stage as integrator.launch_step computed it before the
    kernel (frozen; the four draws, which it took from the chain or the
    ``ld`` points there, come in as ``draws``): the new state's leaves but
    count and path_no."""
    enabled = scene.lights_no > 0
    mat_specular = mat["scalars"][fl.MS_IS_SPECULAR] > 0.5
    new_specular = torch.where(missed, state.last_specular,
                               mat_specular.to(torch.float32))

    en = enabled.to(torch.float32)
    accum = tuple(state.accum[i] + en * (miss_contrib[i] + nee_contrib[i])
                  for i in range(3))
    c_lum = en * (0.2126 * (miss_contrib[0] + nee_contrib[0])
                  + 0.7152 * (miss_contrib[1] + nee_contrib[1])
                  + 0.0722 * (miss_contrib[2] + nee_contrib[2]))
    sq = state.sq + c_lum * c_lum

    if direct_only:
        return dict(
            importance=state.importance,
            origin=state.origin,
            direction=state.direction,
            bounce=torch.zeros_like(state.bounce),
            last_specular=torch.where(enabled, new_specular,
                                      state.last_specular),
            accum=accum, sq=sq)

    rr_roll, sa, sb_, sc = draws
    rr_active = state.bounce > 3
    kill_prob = torch.clamp(1.0 - spectra.luminance_t(importance),
                            min=0.05)
    rr_kill = rr_active & (ex(rr_roll) < kill_prob)
    rr_scale = torch.where(rr_active, 1.0 / (1.0 - kill_prob),
                           torch.ones_like(kill_prob))
    importance = importance * rr_scale

    wo = shading.to_shading_space_v(wo_w, frame)
    wi, value, pdf = bsdf_mod.bsdf_sample(scene, mat, wo, surf["uv"],
                                          (ex(sa), ex(sb_), ex(sc)))
    wi_w = shading.to_world_space_v(wi, frame)
    sample_dead = pdf <= 0.0
    weight = (torch.abs(vec.dot(wi_w, surf["shading_normal"]))
              / torch.clamp(pdf, min=1e-20))
    next_importance = importance * value * weight

    path_dead = missed | rr_kill | sample_dead
    at_max = state.bounce >= 6
    new_bounce = torch.where(path_dead | at_max,
                             torch.zeros_like(state.bounce),
                             state.bounce + 1.0)

    upd = enabled & ~path_dead
    return dict(
        importance=torch.where(upd, next_importance, state.importance),
        origin=vec.where(upd, surf["point"], state.origin),
        direction=vec.where(upd, wi_w, state.direction),
        bounce=torch.where(enabled, new_bounce, state.bounce),
        last_specular=torch.where(enabled, new_specular,
                                  state.last_specular),
        accum=accum, sq=sq)


def _flat(new):
    """The leaves as one (K, P) tensor, in FIELDS order."""
    rows = []
    for k in FIELDS:
        v = new[k]
        if isinstance(v, tuple):
            rows.extend(v)
        elif v.dim() == 2:
            rows.extend(v.unbind(0))
        else:
            rows.append(v)
    return torch.stack(rows)


def _equal(a, b):
    torch.testing.assert_close(_flat(a), _flat(b), rtol=0, atol=0,
                               equal_nan=True)


def _mat(scene, hit):
    return bsdf_mod.gather_material(scene, hit["material_id"])


def _stage_args(lanes):
    state, hit, missed, wo_w, frame, importance, miss_rgb, nee_rgb, draws = \
        lanes
    return (state, hit, missed, wo_w, frame), (importance, miss_rgb, nee_rgb,
                                                draws)


def _run(fn, scene, lanes, mat, **kw):
    (state, hit, missed, wo_w, frame), (imp, miss, nee, draws) = \
        _stage_args(lanes)
    return fn(scene, state, hit, missed, wo_w, frame, mat, imp, miss, nee,
              draws, _ex(R), **kw)


def _dead_lanes(scene, lanes, new):
    """(roulette-active lanes, killed or sampled-dead lanes among the live
    hits, lanes whose sample had pdf 0): the cases the lanes must hold."""
    state, hit, missed = lanes[0], lanes[1], lanes[2]
    rr_active = state.bounce > 3
    alive = ~missed & (new["bounce"] > 0)
    ended = ~missed & (new["bounce"] == 0) & (state.bounce < 6)
    fam = scene.mat_scalars[hit["material_id"].long(), fl.MS_BSDF]
    glossy = (fam == bsdf_mod.FAMILY_METAL) | (fam == bsdf_mod.FAMILY_FROSTED)
    return rr_active, alive, ended & ~rr_active & glossy


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_plain_path_matches_before(scene, width, enabled):
    """CPU: bsdf_plain gives the frozen stage's new state bit for bit, on
    lanes that hold every family, roulette on and off, missed lanes and
    pdf-0 samples; with the lights off (``enabled`` False) too."""
    s = scene if enabled else scene._replace(
        lights_no=torch.zeros((), dtype=torch.int32))
    lanes = _lanes(s, 11, width)
    hit = lanes[1]
    want = _run(_stage_before, s, lanes, _mat(s, hit))
    got = _run(shade_cuda.bsdf_plain, s, lanes, _mat(s, hit))
    _equal(got, want)
    if enabled:
        rr_active, alive, pdf0 = _dead_lanes(s, lanes, got)
        assert 0 < int(rr_active.sum()) < R
        assert int(alive.sum()) > R // 4
        assert int(pdf0.sum()) > 0
    else:
        assert torch.equal(got["bounce"], lanes[0].bounce)


def test_direct_only_matches_before(scene):
    """CPU: the DIRECT integrator's stage (the accumulation only)."""
    lanes = _lanes(scene, 13, "frame")
    hit = lanes[1]
    want = _run(_stage_before, scene, lanes, _mat(scene, hit),
                direct_only=True)
    got = _run(shade_cuda.bsdf_plain, scene, lanes, _mat(scene, hit),
               direct_only=True)
    _equal(got, want)
    assert got["importance"] is lanes[0].importance


# the launches of a render, each stage checked against the frozen copy
LAUNCH_CASES = [
    dict(coherent=1, sampler="pcg", sif=1),
    dict(coherent=2, sampler="pcg", sif=2),
    dict(coherent=0, sampler="ld", sif=1, adaptive=True),
    dict(coherent=0, sampler="pcg", sif=1, direct=True),
]


@pytest.mark.parametrize("case", LAUNCH_CASES,
                         ids=["frame", "tile_sif2", "ld_parked", "direct"])
def test_stage_inside_launches_matches_before(scene, case, monkeypatch):
    """CPU: inside eight launches of a 64x32 render, every call of the
    stage gives what the frozen copy gives on the same inputs, bit for
    bit: one and two samples in flight, both samplers, parked lanes
    (adaptive stopping) and DIRECT."""
    orig = shade_cuda.bsdf
    calls = []

    def spy(scene, state, hit, missed, wo_w, frame, mat, importance,
            miss_rgb, nee_rgb, draws, expand, direct_only=False,
            texels=None):
        assert texels is None  # the plain NEE stage keeps its memo
        memo = {k: v for k, v in mat.get("_texmemo", {}).items()}
        got = orig(scene, state, hit, missed, wo_w, frame, mat, importance,
                   miss_rgb, nee_rgb, draws, expand, direct_only, texels)
        want = _stage_before(scene, state, hit, missed, wo_w, frame,
                             {**mat, "_texmemo": memo}, importance, miss_rgb,
                             nee_rgb, draws, expand, direct_only)
        _equal(got, want)
        calls.append(int(missed.sum()))
        return got

    monkeypatch.setattr(shade_cuda, "bsdf", spy)
    w, h, sif = 64, 32, case["sif"]
    cam = _NeeScene().cameras()[0]
    c2w, s2c = ti.camera_matrices(cam, w, h)
    steps = 8
    seeds = np.arange(steps, dtype=np.uint32) * 7919 + 13
    offsets = np.full((steps, sif, 2) if sif > 1 else (steps, 2), 0.5,
                      np.float32)
    lane_active = None
    if case.get("adaptive"):
        # the first 2048-lane tile runs, the second is parked throughout
        lane_active = torch.arange(ti.pixel_count(w, h)) < 2048
    st = ti.render_steps(
        scene, ti.init_state(w, h, "cpu", sif=sif), seeds, offsets, c2w, s2c,
        width=w, height=h, is_persp=True,
        direct_only=bool(case.get("direct")), steps=steps, sif=sif,
        coherent=case["coherent"], sampler=case["sampler"], sampler_seed=7,
        lane_active=lane_active)
    assert len(calls) == steps
    assert (torch.stack(st.accum) != 0).any()
    if lane_active is not None:
        # parked lanes never count and so never accumulate
        assert not bool((st.count[~lane_active] != 0).any())


# ---- the kernel's lane arithmetic, built for the host -----------------------


@pytest.fixture(scope="module")
def host_lanes(tmp_path_factory):
    """csrc/shade_lane.cuh's bsdf_lane and nee_lane, each in a loop over
    lanes, compiled with the host's C++ compiler (no contraction of
    products and sums into fused multiply-adds)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("bsdf_host")
    src = d / "bsdf_host.cpp"
    src.write_text(
        '#include "shade_lane.cuh"\n'
        'extern "C" void bsdf_host(const glaze_shade::BsdfArgs* a) {\n'
        '  for (int i = 0; i < a->n_lanes; ++i)\n'
        '    glaze_shade::bsdf_lane(*a, a->consts, i);\n'
        '}\n'
        'extern "C" void nee_host(const glaze_shade::NeeArgs* a) {\n'
        '  for (int i = 0; i < a->n_lanes; ++i)\n'
        '    glaze_shade::nee_lane(*a, a->consts, i);\n'
        '}\n')
    so = d / "libbsdf_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.bsdf_host.argtypes = [ctypes.POINTER(shade_cuda.BsdfArgs)]
    lib.bsdf_host.restype = None
    lib.nee_host.argtypes = [ctypes.POINTER(shade_cuda.NeeArgs)]
    lib.nee_host.restype = None
    return lib


def _host(scene, host_lanes, lanes, direct_only=False, texels=None):
    (state, hit, missed, wo_w, frame), (imp, miss, nee, draws) = \
        _stage_args(lanes)
    args, out = shade_cuda.bsdf_prepare(scene, state, hit, missed, wo_w,
                                        frame, imp, miss, nee, draws,
                                        direct_only, texels,
                                        device_type="cpu")
    host_lanes.bsdf_host(ctypes.byref(args))
    return shade_cuda._bsdf_result(out, state, direct_only)


def _memo(mat):
    """The texels in the plain version's memo, by key."""
    return {k: v[1] for k, v in mat["_texmemo"].items()}


def _exact_share(got, want):
    """The share of lanes whose every leaf equals the plain version's."""
    a, b = _flat(got), _flat(want)
    exact = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return exact.all(dim=0).float().mean().item()


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_lane_code_matches_plain_on_cpu(scene, host_lanes, width, given):
    """The kernel's arithmetic, run on the host, against the plain version
    on the same lanes, with the texels fetched by the lane code or given
    (the plain version's memo). torch's CPU sqrt, sin, cos and pow round
    apart from the host's sqrtf/sinf/cosf/powf by an ulp here and there
    (and the sRGB decode divides on the CPU where the card's torch
    multiplies by the reciprocal), which a sample carries on; the card test
    holds the kernel exactly."""
    lanes = _lanes(scene, 23, width)
    hit = lanes[1]
    mat_p = _mat(scene, hit)
    want = _run(shade_cuda.bsdf_plain, scene, lanes, mat_p)
    got = _host(scene, host_lanes, lanes,
                texels=_memo(mat_p) if given else None)
    a, b = _flat(got), _flat(want)
    # without texels the lambert and uber lanes decode their own here
    assert _exact_share(got, want) > (0.95 if given else 0.6)
    # the roulette, the pdf-0 test and the bounce agree on every lane
    assert torch.equal(got["bounce"], want["bounce"])
    assert torch.equal(torch.stack(got["accum"]), torch.stack(want["accum"]))
    assert torch.equal(got["sq"], want["sq"])
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-6, equal_nan=True)
    assert close.all(dim=0).float().mean().item() > 0.999
    rr_active, alive, pdf0 = _dead_lanes(scene, lanes, want)
    assert int(alive.sum()) > R // 4 and int(pdf0.sum()) > 0


def test_lane_code_direct_only(scene, host_lanes):
    lanes = _lanes(scene, 29, "frame")
    hit = lanes[1]
    want = _run(shade_cuda.bsdf_plain, scene, lanes, _mat(scene, hit),
                direct_only=True)
    got = _host(scene, host_lanes, lanes, direct_only=True)
    _equal(got, want)


def test_nee_texels_into_bsdf_lane_code(scene, host_lanes):
    """The NEE lane code's texels, handed to the BSDF lane code as
    ``texels`` (both built for the host): the BSDF lane code gives what
    it gives when it fetches them itself, bit for bit, and the plain
    version's new state, the same texels in its memo, on the share of
    lanes that the plain memo's own texels give."""
    lanes = _lanes(scene, 31, "frame")
    (state, hit, missed, wo_w, frame), rest = _stage_args(lanes)
    draws = tuple(torch.full((1,), d) for d in (0.3, 0.6, 0.2, 0.7, 0.4))
    args, out = shade_cuda.nee_prepare(scene, hit, wo_w, frame, rest[0],
                                       ~missed, draws, device_type="cpu")
    host_lanes.nee_host(ctypes.byref(args))
    texels = shade_cuda._nee_result(out)["texels"]
    assert texels.keys() == {"diffuse", "rough", "metal"}
    got = _host(scene, host_lanes, lanes, texels=texels)
    _equal(got, _host(scene, host_lanes, lanes))
    # the BSDF lanes read the NEE lanes' outputs in place
    args, _ = shade_cuda.bsdf_prepare(scene, state, hit, missed, wo_w, frame,
                                      *rest, texels=texels, device_type="cpu")
    fields = ("diffuse_r", "diffuse_g", "diffuse_b", "roughness", "metalness")
    given = (*texels["diffuse"], texels["rough"], texels["metal"])
    assert [getattr(args, f) for f in fields] == [t.data_ptr() for t in given]
    mat = _mat(scene, hit)
    mat["_texmemo"] = {k: (hit["uv"], v) for k, v in texels.items()}
    want = _run(shade_cuda.bsdf_plain, scene, lanes, mat)
    assert _exact_share(got, want) > 0.95
    assert torch.equal(got["bounce"], want["bounce"])


# ---- the wrapper's refusals -------------------------------------------------


def _bad(case, lanes):
    state, hit, missed, wo_w, frame, importance, miss_rgb, nee_rgb, draws = \
        lanes
    hit = dict(hit)
    if case == "dtype":
        importance = importance.double()
    elif case == "shape":
        hit["uv"] = (hit["uv"][0][1:], hit["uv"][1])
    elif case == "contiguity":
        state = state._replace(importance=torch.cat(
            [state.importance, state.importance], 1)[:, ::2])
    elif case == "chains":
        draws = tuple(d[:3] for d in draws)
    elif case == "missed":
        missed = missed.to(torch.uint8)
    return state, hit, missed, wo_w, frame, importance, miss_rgb, nee_rgb, \
        draws


@pytest.mark.parametrize("case,match", [
    ("device", "not on a cuda device"), ("dtype", "must be a torch.float32"),
    ("shape", "has shape"), ("contiguity", "must be contiguous"),
    ("chains", "do not split into chains"),
    ("missed", "must be a torch.bool")])
def test_kernel_wrapper_refuses(scene, case, match):
    lanes = _bad(case, _lanes(scene, 3, "ld"))
    (state, hit, missed, wo_w, frame), (imp, miss, nee, draws) = \
        _stage_args(lanes)
    before = shade_cuda.bsdf_kernel.launches
    with pytest.raises(ValueError, match=f"^bsdf: .*{match}"):
        shade_cuda.bsdf_kernel(scene, state, hit, missed, wo_w, frame,
                               _mat(scene, hit), imp, miss, nee, draws)
    assert shade_cuda.bsdf_kernel.launches == before


def test_cpu_tensors_take_the_plain_path(scene):
    """``bsdf`` on CPU tensors runs the plain version and no kernel."""
    lanes = _lanes(scene, 5, "tile")
    hit = lanes[1]
    before = shade_cuda.bsdf_kernel.launches
    got = _run(shade_cuda.bsdf, scene, lanes, _mat(scene, hit))
    want = _run(shade_cuda.bsdf_plain, scene, lanes, _mat(scene, hit))
    assert shade_cuda.bsdf_kernel.launches == before
    _equal(got, want)


def test_one_library_for_both_kernels(monkeypatch):
    """Both kernels live in one source and one library, which the module
    loads once a process and declares with each kernel's own argument
    structure (here a stand-in records the declarations); without nvcc
    neither kernel's attribute query gets a library."""
    from glaze_tpu_torch import cuda_build

    src = open(os.path.join(CSRC, shade_cuda.SOURCE)).read()
    assert "bsdf_kernel" in src and "nee_kernel" in src
    loads = []

    class StandIn:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            entry = types.SimpleNamespace()
            setattr(self, name, entry)
            return entry

    with monkeypatch.context() as m:
        m.setattr(shade_cuda, "_lib", None)
        m.setattr(shade_cuda, "build", lambda: "stand-in.so")
        m.setattr(ctypes, "CDLL", StandIn)
        lib = shade_cuda._load()
        assert shade_cuda._load() is lib and loads == ["stand-in.so"]
    for kernel, args in (("nee", shade_cuda.NeeArgs),
                         ("bsdf", shade_cuda.BsdfArgs)):
        entry = getattr(lib, f"glaze_{kernel}_launch")
        assert entry.argtypes == [ctypes.POINTER(args), ctypes.c_void_p]
    monkeypatch.setattr(shade_cuda, "_lib", None)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(shade_cuda, "LIBRARY", "absent.so")
    for kernel in ("nee", "bsdf"):
        with pytest.raises(RuntimeError, match="nvcc"):
            shade_cuda.kernel_attrs(kernel)


# ---- on a card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_matches_plain_on_cuda(scene, card, width, given):
    """The kernel against the plain version, both on the card: every leaf
    of the new state bit for bit, with the texels fetched by the kernel or
    given (the plain version's memo)."""
    cs = scene.to(card)
    lanes = _lanes(cs, 37, width, card)
    hit = lanes[1]
    mat_p = _mat(cs, hit)
    want = _run(shade_cuda.bsdf_plain, cs, lanes, mat_p)
    before = shade_cuda.bsdf_kernel.launches
    got = _run(shade_cuda.bsdf, cs, lanes, _mat(cs, hit),
               texels=_memo(mat_p) if given else None)
    torch.cuda.synchronize()
    assert shade_cuda.bsdf_kernel.launches == before + 1
    _equal(got, want)


@pytest.mark.cuda
def test_kernel_direct_only_on_cuda(scene, card):
    cs = scene.to(card)
    lanes = _lanes(cs, 41, "frame", card)
    hit = lanes[1]
    want = _run(shade_cuda.bsdf_plain, cs, lanes, _mat(cs, hit),
                direct_only=True)
    got = _run(shade_cuda.bsdf, cs, lanes, _mat(cs, hit), direct_only=True)
    torch.cuda.synchronize()
    _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("coherent,sampler,sif", [
    (0, "pcg", 1), (1, "pcg", 2), (2, "pcg", 1), (0, "ld", 1)])
def test_launch_step_on_cuda_matches_cpu(scene, card, coherent, sampler,
                                         sif):
    """Six launches on the card (both kernels) against the CPU (the plain
    versions) from the same state: at most 1% of lanes apart by more than
    1e-4 relative plus 1e-4 (the benchmark's lanes_apart_pct rule), every
    count equal, one BSDF kernel a launch."""
    w, h = 128, 32
    cam = _NeeScene().cameras()[0]
    c2w, s2c = ti.camera_matrices(cam, w, h)
    seeds = np.arange(6, dtype=np.uint32) * 7919 + 13
    offsets = np.full((6, sif, 2) if sif > 1 else (6, 2), 0.5, np.float32)
    states = {}
    for dev, s in (("cpu", scene), ("cuda", scene.to(card))):
        before = shade_cuda.bsdf_kernel.launches
        st = ti.render_steps(
            s, ti.init_state(w, h, dev, sif=sif), seeds, offsets, c2w, s2c,
            width=w, height=h, is_persp=True, direct_only=False, steps=6,
            alpha_rounds=1, sif=sif, coherent=coherent, sampler=sampler,
            sampler_seed=7)
        launched = shade_cuda.bsdf_kernel.launches - before
        assert launched == (6 if dev == "cuda" else 0)
        states[dev] = st
    cpu, gpu = states["cpu"], states["cuda"]
    assert torch.equal(cpu.count, gpu.count.cpu())
    a = torch.stack(gpu.accum).cpu()
    b = torch.stack(cpu.accum)
    apart = ((a - b).abs() > 1e-4 * b.abs() + 1e-4).any(dim=0)
    assert apart.float().mean().item() <= 0.01
    assert (b != 0).any(dim=0).float().mean().item() > 0.3

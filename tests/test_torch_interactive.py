"""The interactive path of glaze_tpu_torch against glaze_tpu's, on the CPU.

The same inputs go through both packages, on the 96x48 golden scene
(``tests/golden_scenes.py`` for glaze_tpu, ``glaze_tpu_torch.scenes`` for
the port: the flattened tables are equal, tests/test_torch_scene.py):

* ``launch_step(want_first_hit=True)`` on tile-coherent camera rays:
  ``missed`` and ``material_id`` exact, ``t`` within ROADMAP F8's bound
  (1e-5 relative on 99% of the lanes, 1e-4 on all), the rays and the
  shading normal and uv within 1e-4;
* the first-hit G-buffer (``denoise._guides`` of ``fh``) against
  ``gbuffer_pass`` at jitter (0.5, 0.5), the port alone
  (tests/test_denoise.py's check of glaze_tpu);
* ``_reproject`` and ``denoised_display_temporal`` on the same NumPy
  inputs (a G-buffer of the golden scene, a history, a moved camera):
  ``valid`` exact, the new history within 1e-5 of its largest magnitude,
  the u8 image within one level;
* ``RayTraceRenderer.draw_frame(return_image=True)`` over a sequence of
  still frames, camera moves and still frames again, raw, spatial and
  temporal: raw frames by the F4 rule (u8 lanes equal but for 0.1% of
  the lanes per launch), the denoised ones by the bound stated at
  ``_DENOISED_OFF``, ``count`` exact after each;
* ``flat_pass`` on the golden scene and on an opacity-mapped quad (4
  alpha rounds), and the port's preview against
  ``tests/goldens/preview.npz``;
* ``default_coherent`` under each ``GLAZE_COHERENT`` value.

Then the port alone: a temporal frame after a camera move dispatches the
closest-hit walks of a raw frame (no second primary trace), and every
edit drops the display history.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import golden_scenes as gs  # noqa: E402
import glaze_tpu_torch.scenes as ps  # noqa: E402
from glaze_tpu.render import denoise as jdn  # noqa: E402
from glaze_tpu.render import integrator as ji  # noqa: E402
from glaze_tpu.render import preview as jpv  # noqa: E402
from glaze_tpu.render import renderer as jrd  # noqa: E402
from glaze_tpu_torch.render import denoise as tdn  # noqa: E402
from glaze_tpu_torch.render import integrator as ti  # noqa: E402
from glaze_tpu_torch.render import preview as tpv  # noqa: E402
from glaze_tpu_torch.render import renderer as trd  # noqa: E402
from torch_parity import golden_scenes_pair, port_scene_from_jax  # noqa: E402

W, H = gs.GOLDEN_W, gs.GOLDEN_H
PREVIEW_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "goldens", "preview.npz")


@pytest.fixture(scope="module")
def scenes():
    js, cam = golden_scenes_pair()
    return js, port_scene_from_jax(js), cam


def _close_frac(got, want, rtol):
    return np.isclose(got, want, rtol=rtol, atol=0).mean()


# ---------------------------------------------------------------------------
# the first hit of a launch


def test_first_hit_matches_reference(scenes):
    js, ts, cam = scenes
    c2w, s2c = ji.camera_matrices(cam, W, H)
    seed, offset = 7, np.asarray([0.25, 0.75], np.float32)

    @jax.jit
    def jax_step(scene, state, c2w, s2c):
        px, py, rng_py = ji.sif_lanes(W, H, 1)
        size = jnp.asarray([W, H], jnp.float32)
        return ji.launch_step(scene, state, jnp.uint32(seed),
                              jnp.asarray(offset), c2w, s2c, px, py, size,
                              is_persp=True, rng_py=rng_py, coherent=2,
                              want_first_hit=True)

    st_j, fh_j = jax_step(js, ji.init_state(W, H), jnp.asarray(c2w),
                          jnp.asarray(s2c))
    px, py, _ = ti.sif_lanes(W, H, 1, "cpu")
    st_t, fh_t = ti.launch_step(ts, ti.init_state(W, H, "cpu"), seed,
                                offset, c2w, s2c, px, py, (float(W), float(H)),
                                is_persp=True, coherent=2, want_first_hit=True)
    missed = np.asarray(fh_j["missed"])
    assert np.array_equal(fh_t["missed"].numpy(), missed)
    assert 0.2 < missed.mean() < 0.8
    hit = ~missed
    assert np.array_equal(fh_t["material_id"].numpy()[hit],
                          np.asarray(fh_j["material_id"])[hit])
    t_t, t_j = fh_t["t"].numpy()[hit], np.asarray(fh_j["t"])[hit]
    assert _close_frac(t_t, t_j, 1e-5) >= 0.99
    np.testing.assert_allclose(t_t, t_j, rtol=1e-4, atol=0)
    for key in ("origin", "direction", "shading_normal", "uv"):
        for g, w in zip(fh_t[key], fh_j[key]):
            g, w = g.numpy(), np.asarray(w)
            if key in ("shading_normal", "uv"):
                g, w = g[hit], w[hit]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    # the state the launch returns with fh is the launch's state
    np.testing.assert_array_equal(st_t.count.numpy(), np.asarray(st_j.count))


def test_first_hit_gbuffer_matches_gbuffer_pass(scenes):
    """At jitter (0.5, 0.5) the launch's camera rays are gbuffer_pass's, so
    the G-buffer built from the launch's own trace equals the separate
    pass's to float rounding (the launch traces Morton-sorted rays)."""
    _, ts, cam = scenes
    c2w, s2c = ti.camera_matrices(cam, W, H)
    ref = tdn.gbuffer_pass(ts, c2w, s2c, width=W, height=H, is_persp=True)
    px, py, _ = ti.sif_lanes(W, H, 1, "cpu")
    _, fh = ti.launch_step(ts, ti.init_state(W, H, "cpu"), 3, (0.5, 0.5),
                           c2w, s2c, px, py, (float(W), float(H)),
                           is_persp=True, want_first_hit=True)
    got = tdn._guides(ts, fh["origin"], fh["direction"], fh["missed"],
                      fh["t"], fh["shading_normal"], fh["material_id"],
                      fh["uv"])
    for k in ("normal", "depth", "albedo", "wpos"):
        a, b = ref[k], got[k]
        for ca, cb in zip(a if isinstance(a, tuple) else (a,),
                          b if isinstance(b, tuple) else (b,)):
            np.testing.assert_allclose(cb.numpy(), ca.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the temporal display on the same NumPy inputs


def _temporal_inputs(ts, cam):
    """A G-buffer of the golden scene, a random accumulation, a history,
    and the previous camera a little to the side (so that no reprojected
    coordinate lies on a whole pixel)."""
    c2w, s2c = ti.camera_matrices(cam, W, H)
    gb = tdn.gbuffer_pass(ts, c2w, s2c, width=W, height=H, is_persp=True)
    gb = {k: tuple(c.numpy() for c in v) if isinstance(v, tuple)
          else v.numpy() for k, v in gb.items()}
    inv, pw, ph = tdn.lane_to_image(W, H, "cpu")
    inv = inv.numpy()
    p = inv.shape[0]
    rng = np.random.default_rng(31)
    count = np.full(p, 6.0, np.float32)
    accum = (rng.uniform(0.0, 1.2, (3, p)) * count).astype(np.float32)

    def plane(v):
        return v[inv].reshape(ph, pw)

    # a displayed frame is smooth where the history is valid, and its
    # count is one value (0 where nothing was shown): a bilinear tap moves
    # with the last ulp of its weight times the step to the next texel
    y, x = np.mgrid[0:ph, 0:pw].astype(np.float32)
    h = np.full((ph, pw), 36.0, np.float32)
    h[:, :12] = 0.0
    hist = {"rgb": tuple((0.5 + 0.4 * np.sin(x / (5.0 + c))
                          * np.cos(y / (4.0 + c))).astype(np.float32)
                         for c in range(3)),
            "t": plane(gb["depth"]),
            "n": tuple(plane(c) for c in gb["normal"]),
            "h": h}
    import copy

    prev_cam = copy.deepcopy(cam)
    prev_cam.strafe(0.037)
    prev_cam.look_around(0.0061, -0.0043)
    return accum, count, gb, hist, tdn.world_to_screen(prev_cam, W, H), inv


def _j(x):
    if isinstance(x, dict):
        return {k: _j(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_j(v) for v in x)
    return jnp.asarray(x)


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_t(v) for v in x)
    return torch.from_numpy(np.ascontiguousarray(x))


def test_reproject_and_temporal_display_match_reference(scenes):
    _, ts, cam = scenes
    accum, count, gb, hist, prev, inv = _temporal_inputs(ts, cam)
    pw, ph = ti.padded_dims(W, H)

    def plane(v):
        return v[inv].reshape(ph, pw)

    planes = {"wpos": tuple(plane(c) for c in gb["wpos"]),
              "normal": tuple(plane(c) for c in gb["normal"])}
    kw = dict(width=W, height=H, pw=pw, ph=ph, is_persp=True)
    reproject = jax.jit(lambda h, g, pv: jdn._reproject(h, g, pv, **kw))
    rgb_j, h_j, valid_j = reproject(_j(hist), _j(planes), _j(prev))
    rgb_t, h_t, valid_t = tdn._reproject(_t(hist), _t(planes), prev, **kw)
    valid_j = np.asarray(valid_j)
    assert np.array_equal(valid_t.numpy(), valid_j)
    assert 0.2 < valid_j[:H, :W].mean() < 0.95
    scale = float(np.abs(np.asarray(h_j)).max())
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-5 * scale)
    for g, w in zip(rgb_t, rgb_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)

    img_j, new_j = jdn.denoised_display_temporal(
        _j(tuple(accum)), _j(count), _j(gb), _j(hist), _j(prev), _j(inv),
        jnp.float32(0.9), **kw)
    img_t, new_t = tdn.denoised_display_temporal(
        _t(tuple(accum)), _t(count), _t(gb), _t(hist), prev, _t(inv), 0.9,
        **kw)
    for key in ("rgb", "t", "n", "h"):
        g, w = new_t[key], new_j[key]
        for cg, cw in zip(g if isinstance(g, tuple) else (g,),
                          w if isinstance(w, tuple) else (w,)):
            cw = np.asarray(cw)
            scale = max(float(np.abs(cw).max()), 1e-30)
            np.testing.assert_allclose(cg.numpy(), cw, rtol=0,
                                       atol=1e-5 * scale, err_msg=key)
    diff = np.abs(img_t.numpy().astype(np.int32)
                  - np.asarray(img_j).astype(np.int32))
    assert diff.max() <= 1


def test_init_history_and_world_to_screen_match_reference(scenes):
    _, _, cam = scenes
    for g, w in zip(tdn.world_to_screen(cam, W, H),
                    jdn.world_to_screen(cam, W, H)):
        assert np.array_equal(g, np.asarray(w))
    hist = tdn.init_history(W, H, "cpu")
    ref = jdn.init_history(W, H)
    for key in ("rgb", "t", "n", "h"):
        g, w = hist[key], ref[key]
        for cg, cw in zip(g if isinstance(g, tuple) else (g,),
                          w if isinstance(w, tuple) else (w,)):
            assert np.array_equal(cg.numpy(), np.asarray(cw))


# ---------------------------------------------------------------------------
# draw_frame sequences, the renderer against glaze_tpu's

# the denoised frames: the share of pixels more than one level off, per
# frame. The à-trous filter spreads a lane that rounds apart over its
# 31x31 footprint, and the temporal validity test is a threshold on a
# bilinear mix of depths, while still frames reproject onto whole pixels,
# where floor() turns with the last ulp. Measured on this sequence:
# spatial at most 31 of 4,608 pixels (0.7%), temporal at most 121 (2.6%);
# at least 97% of every frame within one level.
_DENOISED_OFF = {"spatial": 0.02, "temporal": 0.04}
_SEQUENCE = ("still",) * 3 + ("move",) * 3 + ("still",) * 2


def _renderers(mode):
    jr = jrd.RayTraceRenderer(gs.MatRowScene(), width=W, height=H, seed=21,
                              interactive=True)
    tr = trd.RayTraceRenderer(ps.MatRowScene(), width=W, height=H, seed=21,
                              interactive=True, device="cpu")
    for r in (jr, tr):
        r.denoise = mode != "raw"
        r.temporal = mode == "temporal"
    return jr, tr


@pytest.mark.parametrize("mode", ["raw", "spatial", "temporal"])
def test_draw_frame_sequence_matches_reference(mode):
    jr, tr = _renderers(mode)
    assert jr.coherent == tr.coherent == 2
    for k, step in enumerate(_SEQUENCE):
        if step == "move":
            for r in (jr, tr):
                r.camera.look_around(0.03, 0.01)
                r.update_camera(r.camera)
        want = np.asarray(jr.draw_frame(return_image=True)).astype(np.int32)
        got = tr.draw_frame(return_image=True)
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
        diff = np.abs(got.numpy().astype(np.int32) - want)
        np.testing.assert_array_equal(tr._state.count.numpy(),
                                      np.asarray(jr._state.count))
        launches = int(np.asarray(jr._state.count).max())
        if mode == "raw":
            # (P', 3) lanes: the F4 rule
            assert want.shape == (ti.pixel_count(W, H), 3)
            assert (diff > 0).any(-1).mean() <= 0.001 * launches, k
        else:
            pw, ph = ti.padded_dims(W, H)
            assert want.shape == (ph, pw, 3)
            d = diff[:H, :W].max(-1)
            assert (d > 1).mean() <= _DENOISED_OFF[mode], (k, (d > 1).sum())
            assert (d <= 1).mean() >= 0.9
    if mode == "temporal":
        assert tr._dn_hist is not None and jr._dn_hist is not None


# ---------------------------------------------------------------------------
# the flat preview

_PREVIEW_OFF = 0.001  # pixels more than one level off (F3 ties, rounding)


def _flat_both(js, ts, cam, width, height, rounds):
    import math

    c2w, s2c = ji.camera_matrices(cam, width, height)
    cone = 2.0 * math.tan(cam.inner.fovx * 0.5) / width
    want = jpv.flat_pass(js, jnp.asarray(c2w), jnp.asarray(s2c),
                         jnp.float32(1.0), jnp.float32(cone), width=width,
                         height=height, is_persp=True, alpha_rounds=rounds)
    got = tpv.flat_pass(ts, c2w, s2c, 1.0, cone, width=width, height=height,
                        is_persp=True, alpha_rounds=rounds)
    return got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)


def _quad_scene(pkg):
    """A quad with a half-transparent opacity map, in ``pkg``'s core types
    (tests/test_preview.py's)."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    meta_cls = importlib.import_module(f"{pkg}.parser").Meta
    opa = np.zeros((8, 8), np.uint8)
    opa[:, 4:] = 255

    class QuadScene:
        def vertices(self):
            return [core.Vertex([x, y, 0.0], [0, 0, 1], [u, v])
                    for (x, y, u, v) in [(-1, -1, 0, 0), (1, -1, 1, 0),
                                         (1, 1, 1, 1), (-1, 1, 0, 1)]]

        def meshes(self):
            return [core.Mesh(0, [0, 1, 2, 0, 2, 3], 1)]

        def transforms(self):
            return [core.Transform.identity()]

        def instances(self):
            return [core.MeshInstance(0, 0)]

        def cameras(self):
            return [core.Camera.Perspective(core.PerspectiveCam(
                position=[0.0, 0.0, 3.0], target=[0.0, 0.0, 0.0],
                up=[0.0, 1.0, 0.0]))]

        def textures(self):
            return [core.Texture.default(),
                    core.Texture(core.TextureInfo("opa", 8, 8,
                                                  core.TextureFormat.Gray),
                                 [opa])]

        def materials(self):
            return [core.Material(),
                    core.Material(name="two", mtype=core.MaterialType.LAMBERT,
                                  diffuse_mul=(255, 0, 0), opacity=1)]

        def lights(self):
            return []

        def meta(self):
            return meta_cls(scene_centre=[0, 0, 0], scene_radius=4.0,
                            exposure=1.0)

    return QuadScene()


@pytest.mark.parametrize("scene", ["golden", "quad"])
def test_flat_pass_matches_reference(scenes, scene):
    """u8 channels (P', 3) equal but for at most 0.1% of the pixels more
    than one level off; measured: none on either scene."""
    if scene == "golden":
        js, ts, cam = scenes
        width, height, rounds = W, H, 0
    else:
        from glaze_tpu.scene import flatten_scene

        js, cam, _ = flatten_scene(_quad_scene("glaze_tpu"))
        ts = port_scene_from_jax(js)
        width, height, rounds = 32, 32, tpv.PREVIEW_ALPHA_ROUNDS
        assert tpv.FlatPreviewRenderer(ts)._alpha_rounds == rounds
    got, want = _flat_both(js, ts, cam, width, height, rounds)
    diff = np.abs(got - want).max(-1)
    assert (diff > 1).mean() <= _PREVIEW_OFF, int((diff > 1).sum())
    assert (diff == 0).mean() >= 0.99
    if scene == "quad":
        img = ti.lanes_to_image(torch.from_numpy(got.astype(np.uint8)),
                                width, height)
        assert img[13:20, 17:21, 0].mean() > 80  # the opaque half, red
        assert img[13:20, 11:15].mean() < 5  # the discarded half


def test_preview_renderer_matches_stored_golden():
    """FlatPreviewRenderer on the golden scene against the frame glaze_tpu
    stored (tests/goldens/preview.npz): at most 0.1% of the pixels more
    than one level off; measured: none."""
    from glaze_tpu_torch.scene import flatten_scene

    scene, camera, host = flatten_scene(ps.MatRowScene(), "cpu")
    r = tpv.FlatPreviewRenderer(scene, camera=camera, width=W, height=H,
                                host=host)
    img = r.get_image()
    ref = np.load(PREVIEW_GOLDEN)["frame"]
    assert img.shape == ref.shape == (H, W, 3)
    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= _PREVIEW_OFF
    assert r.draw_frame(return_image=True).shape == (ti.pixel_count(W, H), 3)


# ---------------------------------------------------------------------------
# the coherent default


@pytest.mark.parametrize("env", [None, "", "0", "1", "2", "off", "frame",
                                 "tile"])
@pytest.mark.parametrize("interactive", [False, True])
def test_default_coherent_matches_reference(env, interactive, monkeypatch):
    if env is None:
        monkeypatch.delenv("GLAZE_COHERENT", raising=False)
    else:
        monkeypatch.setenv("GLAZE_COHERENT", env)
    want = jrd.default_coherent(interactive)
    assert trd.default_coherent(interactive) == want
    assert want == ({None: 2 if interactive else 1, "": 2 if interactive
                     else 1, "0": 0, "1": 1, "2": 2, "off": 0, "frame": 1,
                     "tile": 2}[env])


def test_coherent_argument_wins_over_interactive(monkeypatch):
    monkeypatch.setenv("GLAZE_COHERENT", "frame")
    r = trd.RayTraceRenderer(ps.MatRowScene(), width=16, height=8,
                             device="cpu", interactive=True, coherent="off")
    assert r.coherent == 0
    monkeypatch.delenv("GLAZE_COHERENT")
    r = trd.RayTraceRenderer(ps.MatRowScene(), width=16, height=8,
                             device="cpu", interactive=True)
    assert r.coherent == 2


# ---------------------------------------------------------------------------
# the port alone: one primary trace a drag frame, history resets


def _count_closest(monkeypatch):
    from glaze_tpu_torch import accel

    calls = []
    for name in ("closest_hit_soa_auto", "closest_hit_soa_masked_auto"):
        real = getattr(accel, name)

        def spy(*a, _real=real, **k):
            calls.append(1)
            return _real(*a, **k)
        monkeypatch.setattr(accel, name, spy)
    return calls


@pytest.mark.parametrize("scene", ["golden", "lace"])
def test_temporal_drag_frame_makes_no_second_primary_trace(scene,
                                                           monkeypatch):
    """A temporal frame after a camera move dispatches exactly the
    closest-hit walks of a raw frame, and so does a still frame with the
    cached G-buffer; a spatial frame after a move adds gbuffer_pass's."""
    if scene == "golden":
        src = ps.MatRowScene()
    else:
        from test_torch_alpha import LaceScene

        src = LaceScene("torch")
    r = trd.RayTraceRenderer(src, width=32, height=16, seed=4, device="cpu",
                             interactive=True)
    calls = _count_closest(monkeypatch)

    def frame():
        r.camera.look_around(0.02, 0.0)
        r.update_camera(r.camera)
        n = len(calls)
        r.draw_frame(return_image=True)
        return len(calls) - n

    raw = frame()
    assert raw > 0
    r.denoise = True
    assert frame() == raw  # temporal, moved: the launch's own trace
    n = len(calls)
    r.draw_frame(return_image=True)
    assert len(calls) - n == raw  # temporal, still: the cached G-buffer
    r.temporal = False
    assert frame() > raw  # spatial, moved: gbuffer_pass traces again


def test_denoise_turned_on_mid_accumulation_traces_the_gbuffer(
        monkeypatch):
    """The first temporal frame after ``denoise`` is turned on continues
    the paths: most lanes trace bounces, so the launch's first hits are no
    G-buffer. The port traces it (gbuffer_pass), where glaze_tpu takes the
    launch's hits (ROADMAP F14: 31% of the lanes' depth off by more than
    5% on this scene); a restart still takes the launch's own."""
    from glaze_tpu_torch.render import denoise as dn

    r = trd.RayTraceRenderer(ps.MatRowScene(), width=W, height=H, seed=3,
                             device="cpu", interactive=True)
    for _ in range(3):
        r.draw_frame(return_image=True)
    passes = []
    real = dn.gbuffer_pass
    monkeypatch.setattr(dn, "gbuffer_pass",
                        lambda *a, **k: passes.append(1) or real(*a, **k))
    r.denoise = True
    r.draw_frame(return_image=True)
    assert len(passes) == 1
    c2w, s2c = ti.camera_matrices(r.camera, W, H)
    ref = real(r.scene, c2w, s2c, width=W, height=H, is_persp=True)
    for k in ("normal", "depth", "albedo", "wpos"):
        for g, w in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (r._gb[k], ref[k]))):
            assert torch.equal(g, w), k
    r.draw_frame(return_image=True)  # still: the cached G-buffer
    r.camera.look_around(0.02, 0.0)
    r.update_camera(r.camera)
    r.draw_frame(return_image=True)  # a restart: the launch's own hits
    assert len(passes) == 1


def _edits(r):
    from glaze_tpu_torch.core import Texture, TextureFormat, TextureInfo

    tex = Texture(TextureInfo("g", 4, 4, TextureFormat.Gray),
                  [np.full((4, 4), 100, np.uint8)])
    return {
        "materials_and_lights": lambda: r.update_materials_and_lights(
            list(r.host.materials), list(r.host.lights)),
        "textures": lambda: r.update_textures(list(r.host.textures) + [tex]),
        "resolution": lambda: r.change_resolution(24, 16),
        "scene": lambda: r.change_scene(ps.MatRowScene()),
    }


@pytest.mark.parametrize("edit", ["materials_and_lights", "textures",
                                  "resolution", "scene"])
def test_every_edit_drops_the_history(edit):
    r = trd.RayTraceRenderer(ps.MatRowScene(), width=32, height=16, seed=2,
                             device="cpu", interactive=True)
    r.denoise = True
    r.draw_frame(return_image=True)
    assert r._dn_hist is not None
    _edits(r)[edit]()
    assert r._dn_hist is None
    img = r.draw_frame(return_image=True)
    pw, ph = ti.padded_dims(r.width, r.height)
    assert tuple(img.shape) == (ph, pw, 3) and r._dn_hist is not None

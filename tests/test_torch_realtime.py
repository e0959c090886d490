"""The port's RealtimeRenderer, app and viewer, on the CPU.

Scenes are written into the test's temporary directory from
``glaze_tpu_torch.scenes`` (the golden scene) or built here, never read
from outside the repository.

* pipelined ``draw_frame`` against blocking: bit for bit after the same
  launches, the presented frame FRAMES_IN_FLIGHT launches late (the port
  of tests/test_app.py's check);
* a short session of each package's RealtimeRenderer on the same seed
  (frames, a material edit, a camera move, a light edit): ``count``
  exact, and each presented frame by the F4 rule (pixels equal but for
  0.1% per launch since the last restart);
* the texture edits: add, the in-use guard, remove with the id remap,
  the format conversions;
* ``save_as`` after the same edits in both packages: the same bytes;
* a scripted ``python -m glaze_tpu_torch.app --device cpu`` run that
  uses every command of its HELP;
* the viewer on port 0 with ``--device cpu``: the cases of
  tests/test_viewer.py on an in-repo scene, the render thread joined.
"""

import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import glaze_tpu_torch.scenes as ps  # noqa: E402
from glaze_tpu_torch.core import (Light, LightType, MaterialType,  # noqa: E402
                                  Texture, TextureFormat, TextureInfo)
from glaze_tpu_torch.parser import parse  # noqa: E402
from glaze_tpu_torch.render.realtime import (FRAMES_IN_FLIGHT,  # noqa: E402
                                             RealtimeRenderer)


@pytest.fixture(scope="module")
def row_glaze(tmp_path_factory):
    path = tmp_path_factory.mktemp("scenes") / "row.glaze"
    ps.write_glaze(ps.MatRowScene(), str(path))
    return str(path)


def _rr(path, **kw):
    return RealtimeRenderer(parse(path), device="cpu", **kw)


def test_pipelined_draw_matches_blocking(row_glaze):
    n = 3 + FRAMES_IN_FLIGHT
    a = _rr(row_glaze, width=16, height=16, seed=9)
    b = _rr(row_glaze, width=16, height=16, seed=9)
    last_pipe = None
    for _ in range(n):
        last_pipe = a.draw_frame(pipelined=True)
        b.draw_frame()
    np.testing.assert_array_equal(a.get_image(), b.get_image())
    b2 = _rr(row_glaze, width=16, height=16, seed=9)
    for _ in range(n - FRAMES_IN_FLIGHT):
        b2.draw_frame()
    np.testing.assert_array_equal(last_pipe, b2.get_image())


def test_pipelined_preview_and_toggle(row_glaze):
    """Frames of the other renderer are dropped on a toggle: the first
    pipelined preview frame is the preview's own."""
    rr = _rr(row_glaze, width=24, height=16, seed=1)
    for _ in range(3):
        rr.draw_frame(pipelined=True)
    rr.use_raytracer = False
    shown = rr.draw_frame(pipelined=True)
    np.testing.assert_array_equal(shown, rr._preview.get_image())
    assert shown.shape == (16, 24, 3)


def _session(rr, light_cls, frames):
    """The session both packages run: its presented frames."""
    shown = [rr.draw_frame() for _ in range(frames)]
    mat = rr.materials()[1]
    mat.diffuse_mul = (200, 120, 60)
    rr.change_material(1, mat)
    shown += [rr.draw_frame() for _ in range(frames)]
    rr.look_around(0.03, 0.01)
    rr.advance(0.2)
    shown += [rr.draw_frame() for _ in range(frames)]
    rr.update_light(len(rr.lights()), light_cls(
        ltype=type(rr.lights()[0].ltype).OMNI, position=[0.0, 3.0, 2.0],
        intensity=6.0))
    shown += [rr.draw_frame() for _ in range(frames)]
    return shown


def test_realtime_session_matches_reference(row_glaze):
    import glaze_tpu.core as jcore
    from glaze_tpu.parser import parse as jparse
    from glaze_tpu.render.realtime import RealtimeRenderer as JR

    frames = 3
    jr = JR(jparse(row_glaze), width=48, height=24, seed=17)
    tr = _rr(row_glaze, width=48, height=24, seed=17)
    assert jr.coherent == tr.coherent == 2
    want = _session(jr, jcore.Light, frames)
    got = _session(tr, Light, frames)
    np.testing.assert_array_equal(tr._rt._state.count.numpy(),
                                  np.asarray(jr._rt._state.count))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (24, 48, 3)
        launches = k % frames + 1
        off = (g != w).any(-1).mean()
        assert off <= 0.001 * launches, (k, off)


def _gray(v=128, n=4):
    return Texture(TextureInfo("g", n, n, TextureFormat.Gray),
                   [np.full((n, n), v, np.uint8)])


def test_texture_add_guard_remove_and_format(row_glaze):
    rr = _rr(row_glaze, width=16, height=8)
    n0 = len(rr.textures())
    tid = rr.add_texture(_gray())
    assert tid == n0 and len(rr.textures()) == n0 + 1
    second = rr.add_texture(_gray(200))
    mat = rr.materials()[1]
    mat.roughness = tid
    rr.change_material(1, mat)
    with pytest.raises(ValueError, match="in use"):
        rr.remove_texture(tid)
    with pytest.raises(ValueError, match="built-in"):
        rr.remove_texture(0)
    mat = rr.materials()[1]
    mat.roughness = 0
    mat.metalness = second
    rr.change_material(1, mat)
    rr.remove_texture(tid)
    # the later texture moved down one id, and its user with it
    assert len(rr.textures()) == n0 + 1
    assert rr.materials()[1].metalness == second - 1
    assert rr.textures()[second - 1].data[0][0, 0] == 200
    rr.set_texture_format(second - 1, TextureFormat.RgbaSrgb)
    t = rr.textures()[second - 1]
    assert t.info.format == TextureFormat.RgbaSrgb
    assert t.data[0].shape == (4, 4, 4) and (t.data[0][..., 3] == 255).all()
    assert (t.data[0][..., :3] == 200).all()
    rr.set_texture_format(second - 1, TextureFormat.Gray)
    t = rr.textures()[second - 1]
    assert t.data[0].ndim == 2 and t.data[0][0, 0] in (199, 200)
    assert rr.draw_frame().shape == (8, 16, 3)


def _edit_and_save(rr, core, path):
    """The same edits in either package, then save_as."""
    mat = rr.materials()[2]
    mat.mtype = core.MaterialType.METAL
    rr.change_material(2, mat)
    rr.update_light(len(rr.lights()), core.Light(
        ltype=core.LightType.SUN, intensity=2.0))
    tid = rr.add_texture(core.Texture(
        core.TextureInfo("g", 4, 4, core.TextureFormat.Gray),
        [np.full((4, 4), 90, np.uint8)]))
    mat = rr.materials()[1]
    mat.diffuse = tid
    rr.change_material(1, mat)
    rr.set_texture_format(tid, core.TextureFormat.RgbaNorm)
    rr.remove_light(0)
    rr.look_around(0.05, -0.02)
    rr.strafe(0.3)
    rr.elevate(0.1)
    rr.save_as(path)


def test_save_as_matches_reference_bytes(row_glaze, tmp_path):
    import glaze_tpu.core as jcore
    import glaze_tpu_torch.core as tcore
    from glaze_tpu.parser import parse as jparse
    from glaze_tpu.render.realtime import RealtimeRenderer as JR

    jr = JR(jparse(row_glaze), width=16, height=8)
    tr = _rr(row_glaze, width=16, height=8)
    _edit_and_save(jr, jcore, str(tmp_path / "jax.glaze"))
    _edit_and_save(tr, tcore, str(tmp_path / "torch.glaze"))
    want = (tmp_path / "jax.glaze").read_bytes()
    assert (tmp_path / "torch.glaze").read_bytes() == want
    p = parse(str(tmp_path / "torch.glaze"))
    assert p.materials()[2].mtype == MaterialType.METAL
    assert p.textures()[-1].info.format == TextureFormat.RgbaNorm


def test_save_in_place(row_glaze, tmp_path):
    path = tmp_path / "inplace.glaze"
    path.write_bytes(open(row_glaze, "rb").read())
    rr = _rr(str(path), width=16, height=8)
    mat = rr.materials()[1]
    mat.mtype = MaterialType.GLASS
    rr.change_material(1, mat)
    rr.save()
    assert parse(str(path)).materials()[1].mtype == MaterialType.GLASS


# ---------------------------------------------------------------------------
# the app


APP_SCRIPT = """help
w 0.5
s 0.2
a 0.2 fast
q 0.1
look 5 2
drag 0.5 0 2
settings
set speed 2
set fastmul 3
set vspeed 0.5
set sensitivity 0.5
set invert_h on
set invert_v off
set invert_move on
set bogus 1
frames 1
mat
mat 1 type mirror
mat 1 ior 1.7
mat 4 metal GOLD
mat 1 diffuse 200 100 50
tex
tex add {png} srgb
mat 1 tex diffuse {tid}
tex format {tid} gray
tex show {tid} {show}
mat 1 tex diffuse 0
tex del {tid}
light
light 0 intensity 3
light 0 color 1 0.5 0.5
light 0 pos 0 3 3
light add omni
light del 0
raytrace off
frames 1
raytrace on
denoise on
denoise off
integrator direct
integrator pt
coherent off
coherent tile
scale 0.5
exposure 1.2
stats
info
save
load {load}
saveas {edited}
shot {shot}
mat 99 type glass
bogus
quit
"""


def _quad_glaze(path):
    """A two-material quad scene written to ``path``."""
    import glaze_tpu_torch.core as core
    from glaze_tpu_torch.parser import Meta

    class Quad:
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
            return [core.Texture.default()]

        def materials(self):
            return [core.Material(),
                    core.Material(name="red", mtype=core.MaterialType.LAMBERT,
                                  diffuse_mul=(255, 0, 0))]

        def lights(self):
            return [core.Light(ltype=core.LightType.OMNI,
                               position=[0.0, 0.0, 2.0], intensity=4.0)]

        def meta(self):
            return Meta(scene_centre=[0, 0, 0], scene_radius=2.0,
                        exposure=1.0)

    ps.write_glaze(Quad(), str(path))
    return str(path)


def test_app_script_runs_every_help_command(row_glaze, tmp_path, capsys):
    from PIL import Image

    from glaze_tpu_torch import app

    scene = tmp_path / "scene.glaze"
    scene.write_bytes(open(row_glaze, "rb").read())
    png = tmp_path / "red.png"
    Image.fromarray(np.full((8, 8, 3), 220, np.uint8)).save(png)
    quad = _quad_glaze(tmp_path / "quad.glaze")
    tid = len(parse(str(scene)).textures())
    script = tmp_path / "script.txt"
    script.write_text(APP_SCRIPT.format(
        png=png, tid=tid, show=tmp_path / "show.png", load=quad,
        edited=tmp_path / "edited.glaze", shot=tmp_path / "shot.png"))
    out = tmp_path / "view.png"
    assert app.main([str(scene), "--out", str(out), "--res", "16x8",
                     "--script", str(script), "--device", "cpu"]) == 0
    text = capsys.readouterr()
    err, stdout = text.err, text.out
    # every command of HELP ran (each is echoed), and none but the two
    # deliberate faults was refused
    commands = {line.split()[0] for line in APP_SCRIPT.splitlines()}
    helped = {line.split()[0].split("/")[0]
              for line in app.HELP.splitlines()[1:] if line.startswith("  ")
              and not line.startswith("   ")}
    assert helped - {"w"} <= commands
    assert {"w", "a", "s", "q"} <= commands
    assert err.count("bad command") == 1  # mat 99
    assert "unknown command 'bogus'" in stdout
    assert "unknown setting 'bogus'" in stdout
    assert "added texture" in err and "loaded" in err
    assert "cpu (cpu, cpu)" in stdout  # info
    assert "fps=" in stdout and "fastmul = 2.5" in stdout
    assert out.exists() and (tmp_path / "show.png").exists()
    shot = np.asarray(Image.open(tmp_path / "shot.png"))
    assert shot.shape == (4, 8, 3)  # scale 0.5 of 16x8
    edited = parse(str(tmp_path / "edited.glaze"))
    assert len(edited.materials()) == 2  # the loaded quad
    assert parse(str(scene)).materials()[1].mtype == MaterialType.MIRROR


def test_app_tex_show_default_path_is_in_the_temporary_directory(
        row_glaze, tmp_path, monkeypatch):
    import tempfile

    from glaze_tpu_torch import app

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    script = tmp_path / "s.txt"
    script.write_text("tex show 1\nquit\n")
    assert app.main([row_glaze, "--out", str(tmp_path / "v.png"), "--res",
                     "8x8", "--script", str(script), "--device", "cpu"]) == 0
    assert (tmp_path / "glaze_tex_1.png").exists()


# ---------------------------------------------------------------------------
# the viewer (tests/test_viewer.py's cases)


@pytest.fixture(scope="module")
def server(row_glaze):
    from glaze_tpu_torch import viewer

    rt = _rr(row_glaze, width=64, height=48, render_scale=1.0)
    srv, state, t = viewer.serve(rt, host="127.0.0.1", port=0)
    st = threading.Thread(target=srv.serve_forever, daemon=True)
    st.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    yield url, state, rt
    with state.cond:
        state.running = False
        state.cond.notify_all()
    srv.shutdown()
    srv.server_close()
    t.join(timeout=120)
    st.join(timeout=30)
    assert not t.is_alive() and not st.is_alive()


def _get(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _post(url, cmd):
    req = urllib.request.Request(url + "/control",
                                 data=json.dumps(cmd).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 204


def _settle(state):
    _, seq = state.wait_frame(-1)
    state.wait_frame(seq, timeout=120)
    state.wait_frame(state.seq, timeout=120)


def test_viewer_frame_is_jpeg(server):
    from PIL import Image

    url, state, rt = server
    status, ctype, body = _get(url + "/frame")
    assert status == 200 and ctype == "image/jpeg"
    assert body[:2] == b"\xff\xd8"
    assert np.asarray(Image.open(io.BytesIO(body))).shape == (48, 64, 3)


def test_viewer_index_page(server):
    url, state, rt = server
    status, ctype, body = _get(url + "/")
    assert status == 200 and "text/html" in ctype
    assert b"/stream" in body and b"advance" in body
    assert b'min="0.01" max="10"' in body  # the shared ranges


def test_viewer_stats_and_progression(server):
    url, state, rt = server
    s0 = json.loads(_get(url + "/stats")[2])
    assert s0["mode"] == "pt" and s0["loading"] is None
    _, seq = state.wait_frame(-1)
    state.wait_frame(seq, timeout=120)
    s1 = json.loads(_get(url + "/stats")[2])
    assert s1["spp"] >= s0["spp"]


def test_viewer_control_moves_camera(server):
    url, state, rt = server
    before = np.asarray(rt.camera().inner.position, float).copy()
    _post(url, {"action": "advance", "value": 1})
    _settle(state)
    assert not np.allclose(before, np.asarray(rt.camera().inner.position,
                                              float))


def test_viewer_scene_listing_and_live_edit(server):
    url, state, rt = server
    sc = json.loads(_get(url + "/scene")[2])
    assert len(sc["materials"]) == len(rt.materials())
    assert len(sc["lights"]) == len(rt.lights())
    n_lights = len(rt.lights())
    _post(url, {"action": "mat",
                "value": {"id": 2, "field": "type", "value": "glass"}})
    _post(url, {"action": "mat", "value": {"id": 2, "field": "ior",
                                           "value": 1.9}})
    _post(url, {"action": "mat", "value": {"id": 4, "field": "metal",
                                           "value": "copper"}})
    _post(url, {"action": "light", "value": {"op": "add", "value": "omni"}})
    _settle(state)
    assert rt.materials()[2].mtype == MaterialType.GLASS
    assert rt.materials()[2].ior == pytest.approx(1.9)
    assert len(rt.lights()) == n_lights + 1
    omni = [i for i, l in enumerate(rt.lights())
            if l.ltype == LightType.OMNI][-1]
    _post(url, {"action": "light", "value": {"id": omni, "field": "intensity",
                                             "value": 3.5}})
    _post(url, {"action": "light", "value": {"id": omni, "field": "color",
                                             "value": [1.0, 0.5, 0.2]}})
    _settle(state)
    assert rt.lights()[omni].intensity == pytest.approx(3.5)
    _post(url, {"action": "light", "value": {"op": "del", "id": omni}})
    _settle(state)
    assert len(rt.lights()) == n_lights
    assert json.loads(_get(url + "/scene")[2])["materials"][2]["type"] == \
        "glass"


def test_viewer_texture_panel_and_material_texture_edit(server):
    url, state, rt = server
    sc = json.loads(_get(url + "/scene")[2])
    assert len(sc["textures"]) == len(rt.textures())
    assert len(sc["metals"]) == 29
    _post(url, {"action": "mat", "value": {"id": 1, "field": "diffuse",
                                           "value": 0}})
    _post(url, {"action": "mat", "value": {"id": 1, "field": "emission",
                                           "value": [255, 128, 0]}})
    old = rt.textures()[1].info.format
    new = "Gray" if old != TextureFormat.Gray else "RgbaSrgb"
    _post(url, {"action": "tex", "value": {"id": 1, "field": "format",
                                           "value": new}})
    _settle(state)
    assert rt.materials()[1].diffuse == 0
    assert rt.materials()[1].emissive_col == (255, 128, 0)
    assert rt.textures()[1].info.format == TextureFormat(new)
    _post(url, {"action": "mat", "value": {"id": 1, "field": "emission",
                                           "value": None}})
    _settle(state)
    assert rt.materials()[1].emissive_col is None


def test_viewer_integrator_coherent_denoise_and_mode(server):
    from glaze_tpu_torch.render.renderer import Integrator

    url, state, rt = server
    _post(url, {"action": "integrator", "value": "direct"})
    _settle(state)
    assert rt._rt.integrator is Integrator.DIRECT
    assert json.loads(_get(url + "/stats")[2])["mode"] == "direct"
    _post(url, {"action": "integrator", "value": "pt"})
    assert rt.coherent == 2
    _post(url, {"action": "coherent", "value": 0})
    _post(url, {"action": "denoise", "value": "toggle"})
    _settle(state)
    assert rt._rt.integrator is Integrator.PATH_TRACE
    assert rt.coherent == 0 and rt.denoise
    _post(url, {"action": "coherent", "value": 2})
    _post(url, {"action": "denoise", "value": False})
    _post(url, {"action": "mode", "value": "toggle"})
    _settle(state)
    assert rt.coherent == 2 and not rt.denoise and not rt.use_raytracer
    assert json.loads(_get(url + "/stats")[2])["mode"] == "preview"
    _post(url, {"action": "mode", "value": True})
    _post(url, {"action": "exposure", "value": 1.1})
    _settle(state)
    assert rt.use_raytracer and rt._rt.exposure == pytest.approx(1.1)


def test_viewer_control_settings(server):
    url, state, rt = server
    _post(url, {"action": "set", "value": ["mov_speed", 2.0]})
    _post(url, {"action": "set", "value": ["sensitivity", 0.5]})
    _post(url, {"action": "set", "value": ["invert_v", True]})
    _post(url, {"action": "set", "value": ["mov_speed_mul", 4.0]})
    _settle(state)
    assert state.mov_speed == 2.0 and state.sensitivity == 0.5
    assert state.invert_v is True and state.mov_speed_mul == 4.0
    _post(url, {"action": "set", "value": ["sensitivity", 1e6]})
    _settle(state)
    assert state.sensitivity == 10.0
    before = np.asarray(rt.camera().inner.position, float).copy()
    _post(url, {"action": "advance", "value": 1, "fast": True})
    _settle(state)
    mid = np.asarray(rt.camera().inner.position, float).copy()
    _post(url, {"action": "advance", "value": -1})
    _settle(state)
    after = np.asarray(rt.camera().inner.position, float)
    assert np.linalg.norm(mid - before) == pytest.approx(
        4.0 * np.linalg.norm(after - mid), rel=1e-4)
    _post(url, {"action": "set", "value": ["mov_speed", 1.0]})
    _post(url, {"action": "set", "value": ["sensitivity", 1.0]})


def test_viewer_save_as(server, tmp_path):
    url, state, rt = server
    out = str(tmp_path / "saved.glaze")
    _post(url, {"action": "save", "value": out})
    _settle(state)
    p = parse(out)
    assert len(p.vertices()) == len(ps.MatRowScene().vertices())
    assert len(p.materials()) == len(rt.materials())


def test_viewer_stream_yields_parts(server):
    url, state, rt = server
    with urllib.request.urlopen(url + "/stream", timeout=120) as r:
        assert "multipart/x-mixed-replace" in r.headers.get("Content-Type")
        data = b""
        while data.count(b"--glazeframe") < 2:
            chunk = r.read(4096)
            assert chunk, "stream ended early"
            data += chunk
    assert b"Content-Type: image/jpeg" in data


def test_viewer_tex_endpoint(server):
    from PIL import Image

    url, state, rt = server
    t1 = rt.textures()[1]
    status, ctype, body = _get(url + "/tex/1")
    assert status == 200 and ctype == "image/png"
    img = np.asarray(Image.open(io.BytesIO(body)))
    assert img.shape[:2] == (t1.info.height, t1.info.width)
    with pytest.raises(Exception):
        _get(url + "/tex/999")
    assert b"/tex/" in _get(url + "/")[2]


def test_viewer_bad_command_keeps_serving(server):
    url, state, rt = server
    _post(url, {"action": "no_such_action"})
    _post(url, {"action": "mat", "value": {"id": 999, "field": "type",
                                           "value": "glass"}})
    _settle(state)
    assert state.running
    req = urllib.request.Request(url + "/control", data=b"{not json",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(req, timeout=30)


def test_viewer_background_scene_load(server, tmp_path):
    """The last viewer case: it swaps the scene."""
    url, state, rt = server
    quad = _quad_glaze(tmp_path / "quad.glaze")
    _post(url, {"action": "load", "value": quad})
    _, seq = state.wait_frame(-1)
    jpeg, _ = state.wait_frame(seq, timeout=120)
    assert jpeg is not None
    for _ in range(600):
        if state.loader is None and len(rt.materials()) == 2:
            break
        time.sleep(0.1)
    assert len(rt.materials()) == 2
    assert state.step == pytest.approx(2.0 * 0.05)
    assert json.loads(_get(url + "/stats")[2])["loading"] is None
    _settle(state)
    assert state.running

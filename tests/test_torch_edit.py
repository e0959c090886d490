"""Scene edits of the port's renderer against glaze_tpu's, on the CPU.

``update_materials_and_lights``, ``update_textures`` and ``change_scene``
replace the device tables in place; an edit that adds or removes an
opacity map rebuilds the opaque/alpha split (the subset trees, their
maps, the alpha-test rows, the cluster boxes and the cell masks baked
into a classic main tree). On the classic and the fat tree the tables
after each edit equal glaze_tpu's after the same edit, and, after a round
trip, those of a fresh renderer, bit for bit (the host builds are the
same NumPy code; floats cross as int32 views, ROADMAP F7). A render after
an edit is held to glaze_tpu's render after the same edit: count exact
and accum within the Monte-Carlo bound of tests/test_goldens.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_alpha import LaceScene  # noqa: E402
from torch_parity import jax_scene_to_numpy  # noqa: E402

W, H = 32, 16


def _tables_equal(a: dict, b: dict):
    """Every field present on both sides or neither, and bit for bit."""
    ka = {k for k, v in a.items() if v is not None}
    kb = {k for k, v in b.items() if v is not None}
    assert ka == kb, sorted(ka ^ kb)
    differ = []
    for k in sorted(ka):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == y.dtype:
            same = x.shape == y.shape and x.tobytes() == y.tobytes()
        else:  # texels: uint32 on one side, their int32 bits on the other
            same = x.shape == y.shape and np.array_equal(
                x.view(np.int32) if x.dtype == np.uint32 else x,
                y.view(np.int32) if y.dtype == np.uint32 else y)
        if not same:
            differ.append(k)
    assert differ == []


def _port(renderer):
    from glaze_tpu_torch.scene.flatten import device_scene_to_numpy

    return device_scene_to_numpy(renderer.scene)


def _pair(jscene, tscene, **kw):
    from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    return (JRenderer(jscene, width=W, height=H, seed=11, coherent=1, **kw),
            RayTraceRenderer(tscene, width=W, height=H, seed=11, coherent=1,
                             device="cpu", **kw))


def _lace_edit(renderer, pkg, opacity, intensity=40.0):
    """The lace scene's materials with the curtain's opacity map on or off,
    and its light at ``intensity``."""
    scene = LaceScene(pkg, opacity=opacity)
    lights = scene.lights()
    lights[0].intensity = intensity
    renderer.update_materials_and_lights(scene.materials(), lights)


@pytest.mark.parametrize("tree", ["classic", "fat"])
def test_opacity_edits_match_glaze_tpu_and_a_fresh_renderer(tree,
                                                            monkeypatch):
    """Add the curtain's map to a scene flattened without it, remove it,
    put it back: after each edit the tables equal glaze_tpu's after the
    same edit, and after adding it (twice) those of a fresh renderer of
    the scene with the map. Removing the map leaves the main tree's old
    masks in place, as glaze_tpu does; with no alpha rounds no walk reads
    them."""
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    monkeypatch.setenv("GLAZE_TREE", tree)
    j, t = _pair(LaceScene("jax", opacity=False),
                 LaceScene("torch", opacity=False))
    assert t._alpha_rounds == j._alpha_rounds == 0
    assert t.scene.bvh_alpha is None
    fresh = _port(RayTraceRenderer(LaceScene("torch"), width=W, height=H,
                                   device="cpu"))
    for step, opacity in enumerate((True, False, True)):
        _lace_edit(j, "jax", opacity, intensity=40.0 + step)
        _lace_edit(t, "torch", opacity, intensity=40.0 + step)
        assert t._alpha_rounds == j._alpha_rounds == (1 if opacity else 0)
        assert t._request_new_frame and t._gb_key is None
        tables = _port(t)
        _tables_equal(tables, jax_scene_to_numpy(j.scene))
        if opacity:
            lights = {k for k in tables if k.startswith("light_")}
            _tables_equal({k: v for k, v in tables.items()
                           if k not in lights},
                          {k: v for k, v in fresh.items()
                           if k not in lights})
            assert t.scene.bvh_alpha is not None
            # a classic main tree carries the baked masks: the masked walks
            assert ti._full_tree_masked(t.scene, 1) is (tree == "classic")
        else:
            assert t.scene.bvh_alpha is None and t.scene.alpha_attr is None
            assert not ti._full_tree_masked(t.scene, t._alpha_rounds)


def test_material_edit_without_opacity_change_keeps_the_split(monkeypatch):
    """An edit that moves no triangle between the sets rebuilds nothing:
    the split's tensors are the same objects, and the material tables and
    specialization sets follow the edit as in glaze_tpu."""
    from glaze_tpu.core import MaterialType as JType
    from glaze_tpu_torch.core import MaterialType

    j, t = _pair(LaceScene("jax"), LaceScene("torch"))
    before = t.scene.bvh_alpha
    for r, pkg, mtype in ((j, "jax", JType), (t, "torch", MaterialType)):
        mats = LaceScene(pkg).materials()
        mats[2].mtype = mtype.METAL
        r.update_materials_and_lights(mats, LaceScene(pkg).lights())
    assert t.scene.bvh_alpha is before
    assert t.scene.mat_families == j.scene.mat_families != (0,)
    assert t.scene.light_kinds == j.scene.light_kinds
    assert t.scene.tex_slots == j.scene.tex_slots
    _tables_equal(_port(t), jax_scene_to_numpy(j.scene))


class _Relaced(LaceScene):
    """The port's lace scene with the texture list ``textures`` and the
    curtain's opacity map in slot ``slot``."""

    def __init__(self, textures, slot):
        super().__init__("torch")
        self._texs, self._slot = list(textures), slot

    def textures(self):
        return list(self._texs)

    def materials(self):
        mats = super().materials()
        mats[1].opacity = self._slot
        return mats


def _rolled(tex):
    """``tex`` rolled by half its height: the solid band, the holes and
    the cut hem fall on other curtain triangles."""
    import glaze_tpu_torch.core as tcore

    data = np.roll(np.asarray(tex.data[0]), tex.data[0].shape[0] // 2, 0)
    return tcore.Texture(tex.info, [np.ascontiguousarray(data)])


@pytest.mark.parametrize("edit", ["texels", "retarget"])
@pytest.mark.parametrize("tree", ["classic", "fat"])
def test_opacity_texture_edits_rebuild_the_split(tree, edit, monkeypatch):
    """Edits that keep which triangles have an opacity map but change what
    the split classifies: new texels for the curtain's map
    (``update_textures``), or the curtain pointed at another opacity
    texture (``update_materials_and_lights``). Each rebuilds the split:
    the tables equal, bit for bit, those of a fresh renderer of the edited
    scene, and differ from the tables before the edit. (glaze_tpu keeps
    the stale split here: ROADMAP F13.)"""
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    monkeypatch.setenv("GLAZE_TREE", tree)
    default, lace = LaceScene("torch").textures()
    if edit == "texels":
        start, edited = _Relaced([default, lace], 1), \
            _Relaced([default, _rolled(lace)], 1)
    else:
        start, edited = _Relaced([default, lace, _rolled(lace)], 1), \
            _Relaced([default, lace, _rolled(lace)], 2)

    def renderer(scene):
        return RayTraceRenderer(scene, width=W, height=H, seed=11,
                                device="cpu")

    t = renderer(start)
    before = _port(t)
    if edit == "texels":
        t.update_textures(edited.textures())
    else:
        t.update_materials_and_lights(edited.materials(), edited.lights())
    assert t._alpha_rounds == 1 and t._request_new_frame
    after = _port(t)
    _tables_equal(after, _port(renderer(edited)))
    for k in ("bvh_alpha_map", "alpha_attr"):
        assert after[k].tobytes() != before[k].tobytes(), k


def _golden_pair():
    import glaze_tpu_torch.scenes as ps
    import golden_scenes as gs

    return gs.MatRowScene(), ps.MatRowScene()


def _swap_sky(scene, core):
    """The scene's textures with the sky's rows reversed (a new sky
    importance distribution)."""
    texs = list(scene.textures())
    i = next(k for k, x in enumerate(texs) if x.info.name == "sky")
    data = np.ascontiguousarray(np.asarray(texs[i].data[0])[::-1])
    texs[i] = core.Texture(texs[i].info, [data])
    return texs


def test_update_textures_matches_glaze_tpu():
    """A new sky texture: the atlas and the sky tables match glaze_tpu's
    after the same swap, and differ from the scene's before it."""
    import glaze_tpu.core as jcore
    import glaze_tpu_torch.core as tcore

    js, ts = _golden_pair()
    j, t = _pair(js, ts)
    before = _port(t)
    j.update_textures(_swap_sky(js, jcore))
    t.update_textures(_swap_sky(ts, tcore))
    assert t._request_new_frame and t._gb_key is None
    after = _port(t)
    _tables_equal(after, jax_scene_to_numpy(j.scene))
    assert after["sky_marg_rows"].tobytes() != before["sky_marg_rows"].tobytes()
    assert after["atlas.texels"].tobytes() != before["atlas.texels"].tobytes()


def test_change_scene_matches_glaze_tpu(monkeypatch):
    """Swapping the lace scene for the golden scene (and back) gives the
    tables and camera glaze_tpu's swap gives; a DeviceScene-built renderer
    refuses the edits that need the host tables."""
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    j, t = _pair(LaceScene("jax"), LaceScene("torch"))
    js, ts = _golden_pair()
    j.change_scene(js)
    t.change_scene(ts)
    assert t.scene.device == torch.device("cpu")
    _tables_equal(_port(t), jax_scene_to_numpy(j.scene))
    assert t._alpha_rounds == j._alpha_rounds == 0
    np.testing.assert_array_equal(np.asarray(t.camera.inner.position),
                                  np.asarray(j.camera.inner.position))
    j.change_scene(LaceScene("jax"))
    t.change_scene(LaceScene("torch"))
    _tables_equal(_port(t), jax_scene_to_numpy(j.scene))
    assert t._alpha_rounds == j._alpha_rounds == 1

    bare = RayTraceRenderer(t.scene, width=W, height=H)
    assert bare._alpha_rounds == 1 and bare.host is None
    with pytest.raises(ValueError, match="parsed scene"):
        bare.update_materials_and_lights(LaceScene("torch").materials(), [])
    with pytest.raises(ValueError, match="parsed scene"):
        bare.update_textures([])


def _held_to(j, t):
    """count exact; the clipped mean radiance within the bounds of
    tests/test_goldens.py's coherent modes (per-pixel MAD < 0.06, image
    mean within 3%)."""
    cj, ct = np.asarray(j._state.count), t._state.count.numpy()
    np.testing.assert_array_equal(ct, cj)
    aj = np.stack([np.asarray(c) for c in j._state.accum], -1)
    at = torch.stack(t._state.accum, -1).numpy()
    assert np.isfinite(at).all()
    ca = np.clip(at / np.maximum(ct, 1.0)[:, None], 0.0, 1.0)
    cg = np.clip(aj / np.maximum(cj, 1.0)[:, None], 0.0, 1.0)
    assert cg.mean() > 1e-3
    assert abs(ca.mean() - cg.mean()) < 0.03 * cg.mean()
    assert np.abs(ca - cg).mean() < 0.06


@pytest.mark.parametrize("tree", ["classic", "fat"])
def test_render_after_edit_matches_glaze_tpu(tree, monkeypatch):
    """Render one sample, add the opacity map (classic) or remove it (fat),
    render one more: each package restarts its accumulation at the edit,
    and the render after it is held to glaze_tpu's."""
    monkeypatch.setenv("GLAZE_TREE", tree)
    start = tree == "fat"
    j, t = _pair(LaceScene("jax", opacity=start),
                 LaceScene("torch", opacity=start))
    for r in (j, t):
        r.draw(1, return_image=False)
    _lace_edit(j, "jax", not start)
    _lace_edit(t, "torch", not start)
    for r in (j, t):
        r.draw(1, return_image=False)
    assert float(t._state.count.max()) == 6.0  # the accumulation restarted
    _held_to(j, t)

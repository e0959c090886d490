"""Scene files and the scene upload: glaze_tpu_torch against glaze_tpu.

The parsers read each other's files (and the serializers write the same
bytes); the flattened tables are bit-identical, because both packages
compile the same native BVH builder; and device_scene_from_numpy carries
every field across unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import golden_scenes as gs  # noqa: E402
import glaze_tpu_torch.scenes as ps  # noqa: E402
from torch_parity import jax_scene_to_numpy  # noqa: E402


def _write(pkg_serializer, scene, path):
    (pkg_serializer(str(path))
     .with_vertices(scene.vertices())
     .with_meshes(scene.meshes())
     .with_transforms(scene.transforms())
     .with_instances(scene.instances())
     .with_cameras(scene.cameras())
     .with_textures(scene.textures())
     .with_materials(scene.materials())
     .with_lights(scene.lights())
     .with_metadata(scene.meta())
     .serialize())


def _summary(parsed):
    """Comparable plain data of a parsed scene (either package)."""
    verts = np.stack([np.concatenate([v.vv, v.vn, v.vt])
                      for v in parsed.vertices()])
    meshes = [(m.id, list(np.asarray(m.indices)), m.material)
              for m in parsed.meshes()]
    mats = [(m.name, int(m.mtype), int(m.metal), tuple(m.diffuse_mul),
             m.diffuse, m.opacity, m.normal, float(m.ior),
             float(m.roughness_mul)) for m in parsed.materials()]
    lights = [(int(l.ltype), l.name, float(l.intensity), int(l.resource_id),
               tuple(np.asarray(l.position).tolist()),
               tuple(np.asarray(l.color.wavelength).tolist()))
              for l in parsed.lights()]
    texs = [(t.name(), t.format().value, [a.tobytes() for a in t.data])
            for t in parsed.textures()]
    cams = [(c.is_perspective, c.look_at_rh().tobytes())
            for c in parsed.cameras()]
    meta = parsed.meta()
    return (verts.tobytes(), meshes, mats, lights, texs, cams,
            list(meta.scene_centre), meta.scene_radius, meta.exposure)


def test_serializers_write_identical_bytes(tmp_path):
    from glaze_tpu.parser import Serializer as JSerializer
    from glaze_tpu_torch.parser import Serializer as TSerializer

    _write(JSerializer, gs.MatRowScene(), tmp_path / "j.glaze")
    _write(TSerializer, ps.MatRowScene(), tmp_path / "t.glaze")
    assert (tmp_path / "j.glaze").read_bytes() == (tmp_path / "t.glaze").read_bytes()


def test_parsers_read_each_others_files(tmp_path):
    from glaze_tpu.parser import Serializer as JSerializer
    from glaze_tpu.parser import parse as jparse
    from glaze_tpu_torch.parser import Serializer as TSerializer
    from glaze_tpu_torch.parser import parse as tparse

    _write(JSerializer, gs.MatRowScene(), tmp_path / "j.glaze")
    _write(TSerializer, ps.MatRowScene(), tmp_path / "t.glaze")
    port_reads_jax = _summary(tparse(str(tmp_path / "j.glaze")))
    jax_reads_port = _summary(jparse(str(tmp_path / "t.glaze")))
    assert port_reads_jax == jax_reads_port
    assert port_reads_jax == _summary(jparse(str(tmp_path / "j.glaze")))


def _tiny_parsed():
    """The FakeParsed scene of __graft_entry__._tiny_scene (captured from
    the flatten call it makes)."""
    import __graft_entry__ as ge
    import glaze_tpu.scene.flatten as jfl

    seen = {}
    orig = jfl.flatten_scene

    def spy(parsed):
        seen["parsed"] = parsed
        return orig(parsed)

    jfl.flatten_scene = spy
    try:
        ge._tiny_scene(32, 16)
    finally:
        jfl.flatten_scene = orig
    return seen["parsed"]


def _flat_pair(name, tmp_path):
    """(glaze_tpu fields as NumPy, glaze_tpu_torch fields) for one scene;
    the port side reads the scene from a file glaze_tpu wrote."""
    from glaze_tpu.parser import Serializer as JSerializer
    from glaze_tpu.scene.flatten import flatten_scene
    from glaze_tpu_torch.parser import parse as tparse
    from glaze_tpu_torch.scene.flatten import flatten_scene_np

    src = gs.MatRowScene() if name == "matrow" else _tiny_parsed()
    js, _, _ = flatten_scene(src)
    path = tmp_path / f"{name}.glaze"
    _write(JSerializer, src, path)
    tf, _, _ = flatten_scene_np(tparse(str(path)))
    return jax_scene_to_numpy(js), tf


@pytest.mark.parametrize("name", ["matrow", "tiny"])
def test_flatten_tables_match(name, tmp_path):
    jf, tf = _flat_pair(name, tmp_path)
    assert sorted(jf) == sorted(tf)
    for key in sorted(jf):
        a, b = np.asarray(jf[key]), np.asarray(tf[key])
        assert a.shape == b.shape, key
        if a.dtype.kind == "f":
            # float tables: identical here; the stated bound is 1e-6
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=key)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), key
    for key in ("bvh.nodes", "bvh.nodes16", "bvh.tri8", "bvh.tri"):
        # including the meta/skip int32 bits carried in float slots
        assert np.array_equal(np.asarray(jf[key]).view(np.int32),
                              tf[key].view(np.int32)), key


def test_device_scene_roundtrips_every_field():
    from glaze_tpu.scene.flatten import flatten_scene
    from glaze_tpu_torch.scene.flatten import (
        _SCENE_FIELDS,
        device_scene_from_numpy,
        device_scene_to_numpy,
    )

    js, _, _ = flatten_scene(gs.MatRowScene())
    fields = jax_scene_to_numpy(js)
    scene = device_scene_from_numpy(fields, "cpu")
    back = device_scene_to_numpy(scene)
    assert sorted(back) == sorted(fields)
    for key, want in fields.items():
        got = back[key]
        if isinstance(want, int):
            assert got == want, key
            continue
        want = np.asarray(want)
        assert got.dtype.itemsize == want.dtype.itemsize, key
        assert got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key  # bitwise
    assert scene.mat_families == js.mat_families
    assert scene.light_kinds == js.light_kinds
    assert scene.tex_slots == js.tex_slots
    for name in _SCENE_FIELDS:
        if getattr(js, name) is None:
            assert getattr(scene, name) is None, name


def test_opacity_maps_raise(tmp_path):
    """Opacity maps no longer raise: a scene whose material carries one
    flattens to glaze_tpu's tables bit for bit, the opaque/alpha subset
    trees, the baked cell masks and the alpha-test rows included."""
    from glaze_tpu.parser import Serializer as JSerializer
    from glaze_tpu.scene.flatten import flatten_scene as j_flatten
    from glaze_tpu_torch.parser import parse as tparse
    from glaze_tpu_torch.scene.flatten import flatten_scene, flatten_scene_np

    def cutout(base):
        class Cutout(base):
            def materials(self):
                mats = super().materials()
                mats[-2].opacity = 1  # texture 1: the golden's checker
                return mats
        return Cutout()

    src = cutout(gs.MatRowScene)
    path = tmp_path / "cutout.glaze"
    _write(JSerializer, src, path)
    jf = jax_scene_to_numpy(j_flatten(src)[0])
    tf, _, _ = flatten_scene_np(tparse(str(path)))
    assert sorted(jf) == sorted(tf)
    assert any(k.startswith("bvh_alpha.") for k in tf)
    for key in sorted(jf):
        assert np.asarray(jf[key]).tobytes() == np.asarray(tf[key]).tobytes(), key
    scene, _, _ = flatten_scene(cutout(ps.MatRowScene), "cpu")
    assert scene.bvh.tri.shape[1] == 13 and scene.alpha_attr_full is not None


def test_chunk_limit_raises(monkeypatch):
    """The chunk limit no longer raises: beyond CHUNK_MAX_TRIS (read at
    call time) the build makes a forest whose chunks each fit it."""
    from glaze_tpu_torch.accel import bvh

    rng = np.random.default_rng(5)
    soup = rng.uniform(-1, 1, (300, 3, 3)).astype(np.float32)
    monkeypatch.setattr(bvh, "CHUNK_MAX_TRIS", 100)
    tree, order = bvh.build_bvh_chunked(soup, "cpu")
    assert isinstance(tree, bvh.ChunkedBVH) and len(tree.chunks) == 4
    assert all(c.n_tris <= 100 for c in tree.chunks)
    assert tree.n_tris == 300 and order.shape[0] == sum(
        c.tri.shape[0] for c in tree.chunks)
    real = np.sort(order[order != bvh.SENTINEL])
    assert np.array_equal(real, np.arange(300))

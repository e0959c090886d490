"""The port's converter and importers against glaze_tpu's, on the CPU.

Every input format goes through ``glaze_tpu.converter.convert`` and
``glaze_tpu_torch.converter.convert``, and the two ``.glaze`` files must be
byte-identical (sha256). The inputs are built here or by the existing
importer tests' own input writers (FBX binary and ASCII, 3DS, COLLADA, X3D,
VRML); nothing is read from outside the test's directory. The fuzz cases
of tests/test_importer_fuzz.py raise the same exception type in both
packages or write the same bytes. ``ensure_glaze`` and the background
loader run against glaze_tpu's with ``tempfile.tempdir`` pointed at the
test's directory, and one CLI render of a converted OBJ is held to
glaze_tpu's CLI on the same file.
"""

import base64
import hashlib
import io
import json
import os
import struct
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import glaze_tpu.converter as jconv  # noqa: E402
import glaze_tpu_torch.converter as tconv  # noqa: E402


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _checker(n=16, mode="RGB"):
    i = np.arange(n)
    chk = ((i[:, None] // 4 + i[None, :] // 4) % 2).astype(np.uint8)
    if mode == "L":
        return np.where(chk > 0, 255, 0).astype(np.uint8)
    img = np.zeros((n, n, 3), np.uint8)
    img[..., 0] = np.where(chk > 0, 230, 30)
    img[..., 1] = np.where(chk > 0, 40, 200)
    img[..., 2] = 60 + i[:, None].astype(np.uint8) * 8
    return img


# -- inputs -----------------------------------------------------------------


def _write_obj(d):
    """A textured quad (map_Kd, map_d, a bump map), a second group without
    normals or uvs (generated normals, default uvs) and an emitter (Ke ->
    an AREA light)."""
    (d / "diffuse.png").write_bytes(_png_bytes(_checker(16)))
    (d / "lace.png").write_bytes(_png_bytes(_checker(16, "L")))
    (d / "bump.png").write_bytes(_png_bytes(_checker(8)))
    (d / "scene.mtl").write_text(
        "newmtl cloth\nKd 0.8 0.7 0.6\nNs 10\nNi 1.45\nillum 2\n"
        "map_Kd diffuse.png\nmap_d lace.png\nmap_bump -bm 1 bump.png\n"
        "newmtl lamp\nKd 1 1 0.9\nKe 1 1 0.9\n"
        "newmtl floor\nKd 0.5 0.5 0.5\n")
    (d / "scene.obj").write_text(
        "# textured quad, floor and lamp\nmtllib scene.mtl\n"
        "v 2 -1 3\nv -2 -1 3\nv -2 2 3\nv 2 2 3\n"
        "v -4 -1 0\nv 4 -1 0\nv 4 -1 6\nv -4 -1 6\n"
        "v -1 2 1\nv 1 2 1\nv 1 2 2\nv -1 2 2\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 -1\nvn 0 -1 0\n"
        "usemtl cloth\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "usemtl floor\nf 5 8 7 6\n"
        "usemtl lamp\nf 9//2 10//2 11//2\nf -4//2 -2//2 -1//2\n")
    return d / "scene.obj"


def _gltf_doc(image):
    """A quad with uvs, a textured PBR material with an emissive factor, a
    perspective camera and a punctual light; ``image`` is the image entry
    (a data uri or a bufferView)."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    buf = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2, 3]}],
        "nodes": [
            {"mesh": 0},
            {"mesh": 0, "translation": [2, 0, 0], "scale": [2, 2, 2]},
            {"extensions": {"KHR_lights_punctual": {"light": 0}},
             "translation": [0, 4, 1]},
            {"camera": 0, "translation": [0.5, 0.5, 5]},
        ],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": 0.8, "znear": 0.1, "zfar": 100, "aspectRatio": 1.5}}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "intensity": 7.0, "color": [1, 0.5, 0.25]}]}},
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{
            "name": "quadmat",
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.8, 0.2, 0.1, 1.0],
                "baseColorTexture": {"index": 0}},
            "emissiveFactor": [0.0, 0.5, 0.0]}],
        "textures": [{"source": 0}],
        "images": [image],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 32},
            {"buffer": 0, "byteOffset": 128, "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
    }
    return doc, buf


def _write_gltf(d):
    png = _png_bytes(_checker(16))
    doc, buf = _gltf_doc({"uri": "data:image/png;base64,"
                                 + base64.b64encode(png).decode()})
    doc["buffers"] = [{"byteLength": len(buf),
                       "uri": "data:application/octet-stream;base64,"
                              + base64.b64encode(buf).decode()}]
    (d / "scene.gltf").write_text(json.dumps(doc))
    return d / "scene.gltf"


def _write_glb(d):
    """The glTF scene as a binary container, the image in the BIN chunk."""
    png = _png_bytes(_checker(16))
    doc, buf = _gltf_doc({"bufferView": 4, "mimeType": "image/png"})
    buf += b"\x00" * (-len(buf) % 4)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(buf),
                               "byteLength": len(png)})
    blob = buf + png
    blob += b"\x00" * (-len(blob) % 4)
    doc["buffers"] = [{"byteLength": len(blob)}]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    data = struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body
    (d / "scene.glb").write_bytes(data)
    return d / "scene.glb"


def _write_fbx_file(d):
    from test_fbx_textures import _checker_png_bytes, _quad_fbx_roots, write_fbx

    (d / "check.png").write_bytes(_checker_png_bytes()[0])
    write_fbx(d / "quad.fbx", _quad_fbx_roots(
        [("RelativeFilename", ["check.png"], [])]))
    return d / "quad.fbx"


def _write_fbx_embedded(d):
    from test_fbx_textures import _checker_png_bytes, _quad_fbx_roots, write_fbx

    video = ("Video", [5, "check\x00\x01Video", "Clip"], [
        ("Content", [_checker_png_bytes()[0]], [])])
    write_fbx(d / "embedded.fbx", _quad_fbx_roots(
        [("RelativeFilename", ["missing_on_disk.png"], [])],
        extra_objects=[video], connections=[("C", ["OO", 5, 4], [])]))
    return d / "embedded.fbx"


def _write_fbx_ascii(d):
    from test_fbx_ascii import _ASCII_QUAD

    (d / "ascii.fbx").write_text(_ASCII_QUAD)
    return d / "ascii.fbx"


def _write_dae(d):
    from test_collada import _BASIC

    (d / "scene.dae").write_text(_BASIC)
    return d / "scene.dae"


def _write_x3d(d):
    from test_x3d import _BASIC

    (d / "scene.x3d").write_text(_BASIC)
    return d / "scene.x3d"


def _write_wrl(d):
    from test_vrml import _BASIC

    (d / "scene.wrl").write_text(_BASIC)
    return d / "scene.wrl"


def _write_3ds(d):
    from test_3ds import _quad_3ds

    (d / "wood.png").write_bytes(_png_bytes(np.full((4, 4, 3), 90, np.uint8)))
    (d / "scene.3ds").write_bytes(_quad_3ds(with_texture="wood.png"))
    return d / "scene.3ds"


def _write_ply_ascii(d):
    (d / "quad.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property float s\nproperty float t\n"
        "element face 2\nproperty list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 0 0 1 0 0\n1 0 0 0 0 1 1 0\n1 1 0 0 0 1 1 1\n"
        "0 1 0 0 0 1 0 1\n3 0 1 2\n4 0 2 3 1\n")
    return d / "quad.ply"


def _write_ply_binary(d):
    head = (b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 2\nproperty list uchar int vertex_indices\n"
            b"end_header\n")
    body = b"".join(struct.pack("<3f", *v) for v in
                    [(0, 0, 0), (2, 0, 0), (0, 2, 0), (2, 2, 1)])
    body += struct.pack("<B3i", 3, 0, 1, 2) + struct.pack("<B3i", 3, 1, 3, 2)
    (d / "tri.ply").write_bytes(head + body)
    return d / "tri.ply"


def _write_stl_binary(d):
    facets = [((0, 0, 1), (0, 0, 0, 1, 0, 0, 0, 1, 0)),
              ((0, 0, 1), (1, 0, 0, 1, 1, 0, 0, 1, 0)),
              ((1, 0, 0), (1, 0, 0, 1, 0, 1, 1, 1, 0))]
    data = b"solid exported facet mesh".ljust(80, b" ")
    data += struct.pack("<I", len(facets))
    for n, v in facets:
        data += struct.pack("<3f", *n) + struct.pack("<9f", *v)
        data += struct.pack("<H", 0)
    (d / "mesh.stl").write_bytes(data)
    return d / "mesh.stl"


def _write_stl_ascii(d):
    (d / "tri_ascii.stl").write_text(
        "solid t\nfacet normal 0 0 1\n  outer loop\n    vertex 0 0 0\n"
        "    vertex 1 0 0\n    vertex 0 1 0\n  endloop\nendfacet\n"
        "endsolid t\n")
    return d / "tri_ascii.stl"


INPUTS = {
    "obj": _write_obj,
    "gltf": _write_gltf,
    "glb": _write_glb,
    "fbx": _write_fbx_file,
    "fbx_embedded": _write_fbx_embedded,
    "fbx_ascii": _write_fbx_ascii,
    "dae": _write_dae,
    "x3d": _write_x3d,
    "wrl": _write_wrl,
    "3ds": _write_3ds,
    "ply_ascii": _write_ply_ascii,
    "ply_binary": _write_ply_binary,
    "stl_binary": _write_stl_binary,
    "stl_ascii": _write_stl_ascii,
}


def test_inputs_cover_every_extension():
    """The cases above reach each extension the converter imports."""
    exts = set()
    for name in INPUTS:
        exts.add("." + name.split("_")[0])
    assert exts == set(tconv.MESH_EXTENSIONS) == set(jconv.MESH_EXTENSIONS)


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_convert_byte_identical(case, tmp_path):
    """Both converters write the same bytes for the same input, and the
    port's file parses in both packages to the same vertex count."""
    from glaze_tpu.parser import parse as jparse
    from glaze_tpu_torch.parser import parse as tparse

    src = INPUTS[case](tmp_path)
    a, b = tmp_path / "jax.glaze", tmp_path / "torch.glaze"
    ja = jconv.convert(str(src), str(a))
    tb = tconv.convert(str(src), str(b))
    assert ja == tb
    assert _sha(a) == _sha(b)
    assert len(tparse(str(b)).vertices()) == len(jparse(str(a)).vertices())


@pytest.mark.parametrize("case", ["obj", "fbx", "glb"])
def test_main_gen_mipmaps_byte_identical(case, tmp_path, capsys):
    """``--gen-mipmaps`` through both ``main``s: power-of-two textures
    gain their mip chains and the files stay byte-identical."""
    from glaze_tpu_torch.parser import parse

    src = INPUTS[case](tmp_path)
    a, b = tmp_path / "jax.glaze", tmp_path / "torch.glaze"
    assert jconv.main([str(src), str(a), "--gen-mipmaps"]) == 0
    assert tconv.main([str(src), str(b), "--gen-mipmaps"]) == 0
    assert _sha(a) == _sha(b)
    texs = parse(str(b)).textures()
    assert any(len(t.data) > 1 for t in texs)
    assert "Converted" in capsys.readouterr().err


def test_main_benchmark_and_errors(tmp_path, capsys):
    """``--benchmark`` times the same parse and chunk reads; a missing
    output and an unknown extension fail in both packages alike."""
    src = _write_obj(tmp_path)
    out = tmp_path / "s.glaze"
    tconv.convert(str(src), str(out))
    keys = []
    for mod in (jconv, tconv):
        capsys.readouterr()
        assert mod.main([str(out), "--benchmark"]) == 0
        lines = capsys.readouterr().out.splitlines()
        keys.append([ln.split(":")[0] for ln in lines])
    assert keys[0] == keys[1] and keys[1][0] == "parse" and len(keys[1]) == 10
    for mod in (jconv, tconv):
        with pytest.raises(SystemExit) as e:
            mod.main([str(src)])
        assert e.value.code == 2
    bad = tmp_path / "x.xyz"
    bad.write_text("nope")
    for mod in (jconv, tconv):
        with pytest.raises(SystemExit, match="Unsupported input format"):
            mod.convert(str(bad), str(tmp_path / "x.glaze"))


# -- the fuzz cases of tests/test_importer_fuzz.py, through both packages --


def _fuzz_files(d):
    """(path, ...) of every case of tests/test_importer_fuzz.py."""
    from test_importer_fuzz import _fuzz_cases

    files = []

    def put(name, data):
        p = d / name
        p.write_bytes(data if isinstance(data, bytes) else data.encode())
        files.append(p)

    from glaze_tpu_torch.fbx import MAGIC

    for seed in (0, 1, 2):
        for i, data in enumerate(_fuzz_cases(seed, 8)):
            put(f"f{seed}_{i}.fbx", MAGIC + b"\x1a\x00" + data)
    tokens = ["Objects:", "{", "}", ":", '"x"', "*4", "a:", "1", "-2.5",
              "C:", ";junk\n", "Geometry:", "\n"]
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        for i in range(10):
            put(f"a{seed}_{i}.fbx",
                "FBXHeaderExtension: { FBXVersion: 7400 }\n" + "".join(
                    rng.choice(tokens) + " "
                    for _ in range(int(rng.integers(5, 60)))))
    for i, body in enumerate([
            "<notcollada/>",
            "<COLLADA><library_geometries><geometry id='g'><mesh>"
            "<triangles><p>1 2</p></triangles></mesh></geometry>"
            "</library_geometries></COLLADA>",
            "<COLLADA><scene><instance_visual_scene url='#nope'/></scene>"
            "</COLLADA>", "<COLLADA", ""]):
        put(f"d{i}.dae", body)
    for ext in ("ply", "stl"):
        for i, data in enumerate(_fuzz_cases(11, 6)):
            put(f"m{i}.{ext}", data)
    for i, body in enumerate([
            "<X3D/>",
            "<X3D><Scene><Shape><IndexedFaceSet coordIndex='0 1 2 -1'/>"
            "</Shape></Scene></X3D>",
            "<X3D><Scene><Shape><IndexedFaceSet coordIndex='5 6 7 -1'>"
            "<Coordinate point='0 0 0'/></IndexedFaceSet></Shape></Scene>"
            "</X3D>", "<X3D><Scene", ""]):
        put(f"x{i}.x3d", body)
    for i, body in enumerate([
            "#VRML V2.0 utf8\nShape {",
            "#VRML V2.0 utf8\nShape { geometry IndexedFaceSet { coordIndex "
            "[ 0 1 ] } }",
            "#VRML V2.0 utf8\n{ } } ] [",
            "#VRML V2.0 utf8\nTransform { translation }", "plain text", ""]):
        put(f"w{i}.wrl", body)
    for seed in (21, 22):
        for i, data in enumerate(_fuzz_cases(seed, 6)):
            put(f"t{seed}_{i}.3ds",
                struct.pack("<HI", 0x4D4D, 6 + len(data)) + data)
    return files


def _outcome(mod, src, out):
    try:
        mod.convert(str(src), str(out))
    except BaseException as e:  # noqa: BLE001 - the type is the outcome
        return type(e).__name__
    return _sha(out)


def test_fuzz_cases_agree(tmp_path):
    """Each malformed input raises the same exception type in both
    packages, or both write the same bytes."""
    files = _fuzz_files(tmp_path)
    assert len(files) == 98
    out = tmp_path / "out"
    out.mkdir()
    differ = []
    for src in files:
        j = _outcome(jconv, src, out / (src.name + ".j.glaze"))
        t = _outcome(tconv, src, out / (src.name + ".t.glaze"))
        if j != t:
            differ.append((src.name, j, t))
    assert differ == []


# -- ensure_glaze and the background loader ---------------------------------


@pytest.fixture
def own_tempdir(tmp_path, monkeypatch):
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def test_ensure_glaze_against_glaze_tpu(tmp_path, own_tempdir, capsys):
    """The port converts to its own cache file (its own prefix, so neither
    package reads the other's), with the bytes glaze_tpu writes; a second
    call hits the cache, and .glaze paths pass through."""
    src = str(_write_gltf(tmp_path))
    j = jconv.ensure_glaze(src)
    t = tconv.ensure_glaze(src)
    assert os.path.dirname(t) == str(own_tempdir) == os.path.dirname(j)
    assert os.path.basename(t).startswith("glaze_torch_conv_")
    assert os.path.basename(j).startswith("glaze_conv_")
    assert _sha(t) == _sha(j)
    assert "converting" in capsys.readouterr().err
    assert tconv.ensure_glaze(src) == t
    assert "converting" not in capsys.readouterr().err
    assert tconv.ensure_glaze("/x/y.glaze") == "/x/y.glaze"
    # only the two cache files: no half-written temporary is left behind
    assert sorted(os.listdir(own_tempdir)) == sorted(
        [os.path.basename(j), os.path.basename(t)])


def test_background_loader_against_glaze_tpu(tmp_path, own_tempdir):
    """Both loaders convert, parse and decode the same OBJ to the same
    chunks, with the same progress stages; a bad file ends in "error"."""
    from glaze_tpu.loader import BackgroundSceneLoader as JLoader
    from glaze_tpu_torch.loader import BackgroundSceneLoader, PreloadedScene

    src = str(_write_obj(tmp_path))
    jl, tl = JLoader(src), BackgroundSceneLoader(src)
    assert jl.join(60) and tl.join(60)
    assert jl.error is None and tl.error is None
    assert (tl.stage, tl.fraction) == (jl.stage, jl.fraction) == ("ready", 1.0)
    j, t = jl.result, tl.result
    assert isinstance(t, PreloadedScene)
    for a, b in zip(j.vertices_np(), t.vertices_np()):
        np.testing.assert_array_equal(a, b)
    assert [m.indices for m in j.meshes()] == [m.indices for m in t.meshes()]
    assert [m.name for m in j.materials()] == [m.name for m in t.materials()]
    assert ([(x.info.width, x.info.height) for x in j.textures()]
            == [(x.info.width, x.info.height) for x in t.textures()])
    assert len(t.vertices()) == len(j.vertices())
    assert t.meta().scene_radius == j.meta().scene_radius

    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply")
    bl = BackgroundSceneLoader(str(bad))
    assert bl.join(60)
    assert bl.stage == "error" and bl.error is not None


# -- the CLI on a converted file ----------------------------------------------


def _held_to(acc_t, cnt_t, acc_j, cnt_j):
    """count exact; the clipped mean radiance within the Monte-Carlo
    bounds of tests/test_goldens.py's coherent modes (per-pixel MAD < 0.06,
    image mean within 3%)."""
    np.testing.assert_array_equal(cnt_t, cnt_j)
    assert np.isfinite(acc_t).all()
    ct = np.clip(acc_t / np.maximum(cnt_t, 1.0)[:, None], 0.0, 1.0)
    cj = np.clip(acc_j / np.maximum(cnt_j, 1.0)[:, None], 0.0, 1.0)
    assert abs(ct.mean() - cj.mean()) < 0.03 * max(cj.mean(), 1e-6)
    assert np.abs(ct - cj).mean() < 0.06


def test_cli_renders_obj_like_glaze_tpu(tmp_path, own_tempdir, capsys):
    """``glaze_tpu_torch.cli x.obj out.png --device cpu`` renders the
    converted scene; held to glaze_tpu's CLI on the same file through the
    two checkpoints: count exact, accum within the MC bound, and the same
    scene_id (the sha256 of the byte-identical converted files)."""
    from PIL import Image

    from glaze_tpu import cli as jcli
    from glaze_tpu_torch import cli as tcli

    src = str(_write_obj(tmp_path))
    flags = ["--res", "32x16", "--spp", "2", "--seed", "3", "-i", "direct"]
    jck, tck = tmp_path / "j.npz", tmp_path / "t.npz"
    assert jcli.main([src, str(tmp_path / "j.png"), *flags,
                      "--checkpoint", str(jck)]) == 0
    code = tcli.main([src, str(tmp_path / "t.png"), *flags, "--device", "cpu",
                      "--checkpoint", str(tck)])
    assert code == 0
    err = capsys.readouterr().err
    assert "not yet ported" not in err and "Saved" in err
    img = np.asarray(Image.open(tmp_path / "t.png"))
    assert img.shape == (16, 32, 3) and img.max() > 0
    j, t = np.load(jck), np.load(tck)
    assert str(t["scene_id"]) == str(j["scene_id"]) != ""
    assert str(t["scene_id"]) == _sha(tconv.ensure_glaze(src))
    acc = [np.stack([ck[f"leaf_{i}"] for i in (9, 10, 11)], -1)
           for ck in (t, j)]
    _held_to(acc[0], t["leaf_12"], acc[1], j["leaf_12"])


def test_write_obj_round_trip(tmp_path):
    """glaze_tpu_torch.scenes.write_obj (chip_smoke.py [convert] writes the
    Sponza-class scene) on the lace scene: both converters write the same
    bytes; the converted scene keeps every triangle, every uv bit for bit
    (``1 - v`` written exactly) and so the MIXED set of the opacity map;
    the geometry moves rigidly into the camera's frame (the converter's
    default camera at the origin, looking down +z)."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.scene.flatten import flatten_scene_np
    from test_torch_alpha import LaceScene

    scene = LaceScene("torch")
    obj = ps.write_obj(scene, str(tmp_path / "obj"))
    a, b = tmp_path / "jax.glaze", tmp_path / "torch.glaze"
    jconv.convert(obj, str(a))
    tconv.convert(obj, str(b))
    assert _sha(a) == _sha(b)
    parsed = parse(str(b))
    fc, _, hc = flatten_scene_np(parsed)
    fd, _, hd = flatten_scene_np(scene)
    assert sum(hc.inst_tri_count) == sum(hd.inst_tri_count) == 324
    assert fc["bvh_alpha.n_tris"] == fd["bvh_alpha.n_tris"] > 0
    assert sorted(map(bytes, hc.tri_uv)) == sorted(map(bytes, hd.tri_uv))
    rot, origin = ps._camera_frame(scene.cameras()[0])
    np.testing.assert_allclose(
        fc["tri_pos_orig"].reshape(-1, 3).mean(0),
        rot @ (fd["tri_pos_orig"].reshape(-1, 3).mean(0) - origin),
        atol=1e-5)
    # the converter's default slot, then one material per usemtl group
    assert [m.name for m in parsed.materials()] == ["default", "lace", "room"]

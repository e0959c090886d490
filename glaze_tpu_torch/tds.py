"""Native 3D Studio (.3ds) importer for the converter.

The reference reaches 3DS through assimp (converter/src/main.rs:86-102);
this reads the classic chunk container directly (u16 id + u32 length,
nested): MAIN(0x4D4D) -> EDITOR(0x3D3D) -> OBJECT(0x4000) ->
TRIMESH(0x4100) with VERTICES(0x4110), FACES(0x4120) +
MATERIAL_GROUP(0x4130) + UV(0x4140) + LOCAL_MATRIX(0x4160);
MATERIAL(0xAFFF) with NAME(0xA000), DIFFUSE(0xA020 via color subchunk),
SELF_ILLUM, TEXTURE(0xA200 -> filename 0xA300); LIGHT(0x4600,
point/spot) and CAMERA(0x4700). Faces default to per-object smooth
normals (area-weighted), matching the other importers' fallback.

3DS is Z-up: geometry, lights, and cameras are re-based to Y-up with
the same rotation COLLADA's Z_UP path uses.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from glaze_tpu_torch.importer_util import (
    VertexDedup,
    area_weighted_normals,
)
from glaze_tpu_torch.core import (
    Camera,
    Light,
    LightType,
    Material,
    Mesh,
    MeshInstance,
    PerspectiveCam,
    Spectrum,
    Texture,
    TextureFormat,
    TextureInfo,
    Transform,
)

MAIN = 0x4D4D
EDITOR = 0x3D3D
OBJECT = 0x4000
TRIMESH = 0x4100
VERTICES = 0x4110
FACES = 0x4120
MAT_GROUP = 0x4130
UVS = 0x4140
LOCAL_MATRIX = 0x4160
LIGHT = 0x4600
SPOTLIGHT = 0x4610
CAMERA = 0x4700
MATERIAL = 0xAFFF
MAT_NAME = 0xA000
MAT_DIFFUSE = 0xA020
MAT_SELF_ILLUM = 0xA080
MAT_TEXMAP = 0xA200
MAP_FILENAME = 0xA300
COLOR_F = 0x0010
COLOR_24 = 0x0011


def _cstr(data, pos):
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _chunks(data, start, end):
    """Yields (chunk id, body start, body end) within [start, end)."""
    pos = start
    while pos + 6 <= end:
        cid, clen = struct.unpack_from("<HI", data, pos)
        if clen < 6 or pos + clen > end:
            raise ValueError("corrupt 3DS chunk structure")
        yield cid, pos + 6, pos + clen
        pos += clen


def _read_color(data, start, end):
    for cid, s, e in _chunks(data, start, end):
        if cid == COLOR_24 and e - s >= 3:
            return tuple(data[s + i] / 255.0 for i in range(3))
        if cid == COLOR_F and e - s >= 12:
            return struct.unpack_from("<fff", data, s)
    return None


# Z-up -> Y-up (same basis COLLADA's Z_UP path uses)
_ZUP = np.asarray([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)


def import_3ds(path):
    """3DS -> (vertices, meshes, materials, textures, lights, cameras,
    transforms, instances) — the common importer contract."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 6 or struct.unpack_from("<H", data, 0)[0] != MAIN:
        raise ValueError("not a 3DS file (missing 0x4D4D main chunk)")
    _, main_len = struct.unpack_from("<HI", data, 0)
    end = min(len(data), main_len)

    base = os.path.dirname(os.path.abspath(path))
    textures = [Texture.default()]
    tex_ids = {}

    def load_texture(name):
        p = os.path.join(base, name.replace("\\", "/"))
        if not os.path.exists(p):
            p = os.path.join(base, os.path.basename(name.replace("\\", "/")))
        if not os.path.exists(p):
            return 0
        if p in tex_ids:
            return tex_ids[p]
        from PIL import Image

        arr = np.asarray(Image.open(p).convert("RGBA"), np.uint8)
        tid = len(textures)
        textures.append(Texture(TextureInfo(
            os.path.basename(p), arr.shape[1], arr.shape[0],
            TextureFormat.RgbaSrgb), [arr]))
        tex_ids[p] = tid
        return tid

    materials = [Material()]
    lights = []
    mat_by_name = {}

    objects = []  # (name, verts (N,3), faces (F,3), uvs (N,2)|None,
    #               face materials {name: [face ids]})

    editor_span = None
    for cid, s, e in _chunks(data, 6, end):
        if cid == EDITOR:
            editor_span = (s, e)
    if editor_span is None:
        raise ValueError("3DS file has no editor (0x3D3D) chunk")

    cameras = []
    for cid, s, e in _chunks(data, *editor_span):
        if cid == MATERIAL:
            name = ""
            mat = Material()
            emissive = 0.0
            for mc, ms, me in _chunks(data, s, e):
                if mc == MAT_NAME:
                    name, _ = _cstr(data, ms)
                elif mc == MAT_DIFFUSE:
                    col = _read_color(data, ms, me)
                    if col:
                        mat.diffuse_mul = tuple(
                            int(np.clip(v, 0, 1) * 255) for v in col)
                elif mc == MAT_SELF_ILLUM:
                    for pc, ps, pe in _chunks(data, ms, me):
                        if pc == 0x0030 and pe - ps >= 2:  # int percent
                            emissive = struct.unpack_from(
                                "<h", data, ps)[0] / 100.0
                elif mc == MAT_TEXMAP:
                    for pc, ps, pe in _chunks(data, ms, me):
                        if pc == MAP_FILENAME:
                            fn, _ = _cstr(data, ps)
                            mat.diffuse = load_texture(fn)
            mat.name = name or f"mat{len(materials)}"
            if emissive > 0:
                mat.emissive_col = tuple(
                    int(v * emissive) for v in
                    (mat.diffuse_mul or (255, 255, 255)))
            mid = len(materials)
            materials.append(mat)
            mat_by_name[mat.name] = mid
            if mat.emissive_col is not None:
                lights.append(Light(ltype=LightType.AREA, name=mat.name,
                                    resource_id=mid))
        elif cid == OBJECT:
            name, pos = _cstr(data, s)
            for oc, os_, oe in _chunks(data, pos, e):
                if oc == TRIMESH:
                    verts = faces = uvs = None
                    fmats = {}
                    for tc, ts, te in _chunks(data, os_, oe):
                        if tc == VERTICES:
                            n = struct.unpack_from("<H", data, ts)[0]
                            verts = np.frombuffer(
                                data, "<f4", n * 3, ts + 2).reshape(n, 3)
                        elif tc == FACES:
                            n = struct.unpack_from("<H", data, ts)[0]
                            f4 = np.frombuffer(
                                data, "<u2", n * 4, ts + 2).reshape(n, 4)
                            faces = f4[:, :3].astype(np.int64)
                            # material groups nest AFTER the face array
                            sub = ts + 2 + n * 8
                            for fc, fs, fe in _chunks(data, sub, te):
                                if fc == MAT_GROUP:
                                    mname, p2 = _cstr(data, fs)
                                    cnt = struct.unpack_from(
                                        "<H", data, p2)[0]
                                    ids = np.frombuffer(
                                        data, "<u2", cnt, p2 + 2)
                                    fmats[mname] = ids.astype(np.int64)
                        elif tc == UVS:
                            n = struct.unpack_from("<H", data, ts)[0]
                            uvs = np.frombuffer(
                                data, "<f4", n * 2, ts + 2).reshape(n, 2)
                    if verts is not None and faces is not None:
                        objects.append((name, verts, faces, uvs, fmats))
                elif oc == LIGHT:
                    x, y, z = struct.unpack_from("<fff", data, os_)
                    col = _read_color(data, os_ + 12, oe) or (1, 1, 1)
                    lights.append(Light(
                        ltype=LightType.OMNI, name=name,
                        color=Spectrum.from_rgb(col, True),
                        position=_ZUP @ np.asarray([x, y, z], np.float32)))
                elif oc == CAMERA:
                    vals = struct.unpack_from("<8f", data, os_)
                    p = _ZUP @ np.asarray(vals[0:3], np.float32)
                    t = _ZUP @ np.asarray(vals[3:6], np.float32)
                    lens_mm = vals[7] or 50.0
                    # 3DS stores the lens focal length (mm, 35mm film):
                    # horizontal fov = 2 atan(36/2 / lens)
                    cameras.append(Camera.Perspective(PerspectiveCam(
                        position=p, target=t, up=[0, 1, 0],
                        fovx=float(2.0 * np.arctan(18.0 / lens_mm)))))

    dedup = VertexDedup()
    vertices = dedup.vertices
    meshes = []
    instances = []
    transforms = [Transform.identity()]

    def add_mesh(verts, faces, uvs, mat_id):
        pos = (verts @ _ZUP.T).astype(np.float32)
        nrm = area_weighted_normals(pos, faces)
        indices = []
        for f in faces:
            for pi in f:
                uv = (uvs[pi] if uvs is not None and pi < len(uvs)
                      else np.zeros(2, np.float32))
                indices.append(dedup.add(pos[pi], nrm[pi], uv))
        mid = len(meshes)
        meshes.append(Mesh(mid, indices, mat_id))
        instances.append(MeshInstance(mid, 0))

    for name, verts, faces, uvs, fmats in objects:
        if fmats:
            assigned = np.zeros(len(faces), bool)
            for mname, ids in fmats.items():
                ids = ids[ids < len(faces)]
                if len(ids) == 0:
                    continue
                assigned[ids] = True
                add_mesh(verts, faces[ids], uvs,
                         mat_by_name.get(mname, 0))
            if not assigned.all():
                add_mesh(verts, faces[~assigned], uvs, 0)
        else:
            add_mesh(verts, faces, uvs, 0)

    return (vertices, meshes, materials, textures, lights, cameras,
            transforms, instances)

"""Native X3D (.x3d, XML encoding) importer for the converter.

The reference reaches X3D/VRML through assimp
(converter/src/main.rs:86-102); this reads the converter-relevant
subset of the X3D scene graph with stdlib XML only:

- ``Shape`` / ``IndexedFaceSet`` (coordIndex with -1 face separators,
  fan triangulation, ``Coordinate``/``Normal``/``TextureCoordinate``
  with optional ``normalIndex``/``texCoordIndex``), ``IndexedTriangleSet``
  (``index``), missing normals area-weighted like the other importers.
- ``Transform`` nodes (translation, rotation axis-angle, scale, center)
  composed down the graph; ``DEF``/``USE`` node reuse (instancing).
- ``Appearance``/``Material`` (diffuseColor, emissiveColor -> emissive
  material + AREA light) and ``ImageTexture`` (url -> diffuse texture).
- ``Viewpoint`` (fieldOfView, position, orientation) and
  ``PointLight``/``DirectionalLight`` -> OMNI/SUN.

X3D is Y-up, meters — no re-basing needed.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from glaze_tpu_torch.importer_util import (
    VertexDedup,
    area_weighted_normals as _area_weighted_normals,
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


def _floats(text):
    if not text:
        return np.zeros(0, np.float32)
    return np.asarray(text.replace(",", " ").split(), np.float32)


def _ints(text):
    if not text:
        return np.zeros(0, np.int64)
    return np.asarray(text.replace(",", " ").split(), np.int64)


def _axis_angle(vals):
    m = np.identity(4, np.float32)
    if len(vals) != 4:
        return m
    axis = vals[:3]
    n = np.linalg.norm(axis)
    if n == 0:
        return m
    x, y, z = axis / n
    a = vals[3]
    c, s = np.cos(a), np.sin(a)
    m[:3, :3] = [
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ]
    return m


def _transform_matrix(el):
    """X3D Transform: T * C * R * S * -C (scaleOrientation unsupported)."""
    t = _floats(el.get("translation", ""))
    r = _floats(el.get("rotation", ""))
    s = _floats(el.get("scale", ""))
    c = _floats(el.get("center", ""))
    m = np.identity(4, np.float32)
    tm = np.identity(4, np.float32)
    if len(t) == 3:
        tm[:3, 3] = t
    cm = np.identity(4, np.float32)
    cmi = np.identity(4, np.float32)
    if len(c) == 3:
        cm[:3, 3] = c
        cmi[:3, 3] = -c
    rm = _axis_angle(r) if len(r) == 4 else np.identity(4, np.float32)
    sm = np.identity(4, np.float32)
    if len(s) == 3:
        sm[0, 0], sm[1, 1], sm[2, 2] = s
    return tm @ cm @ rm @ sm @ cmi


def _faces_to_tris(idx):
    """coordIndex stream with -1 separators -> (T, 3) fan triangles."""
    tris = []
    face = []
    for v in idx:
        if v < 0:
            for k in range(1, len(face) - 1):
                tris.append((face[0], face[k], face[k + 1]))
            face = []
        else:
            face.append(int(v))
    for k in range(1, len(face) - 1):
        tris.append((face[0], face[k], face[k + 1]))
    return np.asarray(tris, np.int64).reshape(-1, 3)


def import_x3d(path):
    """X3D -> (vertices, meshes, materials, textures, lights, cameras,
    transforms, instances) — the common importer contract."""
    return import_x3d_tree(ET.parse(path).getroot(),
                           os.path.dirname(os.path.abspath(path)))


def import_x3d_tree(root, base):
    """Same contract over a parsed element tree (the VRML97 importer
    feeds its classic-encoding parse through here — VRML is the same
    scene graph in a different syntax)."""
    scene = root.find("Scene")
    if scene is None:
        scene = root.find(".//Scene")
    if scene is None:
        raise ValueError("X3D file has no <Scene>")

    defs = {}  # DEF name -> element

    def resolve(el):
        use = el.get("USE")
        if use is not None:
            target = defs.get(use)
            if target is None:
                raise ValueError(f"X3D USE references unknown DEF {use!r}")
            return target
        if el.get("DEF"):
            defs[el.get("DEF")] = el
        return el

    textures = [Texture.default()]
    tex_ids = {}

    def load_texture(url):
        for candidate in url.replace('"', " ").split():
            p = candidate
            if p.startswith("file://"):
                p = p[7:]
            if not os.path.isabs(p):
                p = os.path.join(base, p)
            if not os.path.exists(p):
                continue
            if p in tex_ids:
                return tex_ids[p]
            from PIL import Image

            arr = np.asarray(Image.open(p).convert("RGBA"), np.uint8)
            info = TextureInfo(os.path.basename(p), arr.shape[1],
                               arr.shape[0], TextureFormat.RgbaSrgb)
            tid = len(textures)
            textures.append(Texture(info, [arr]))
            tex_ids[p] = tid
            return tid
        return 0

    materials = [Material()]
    lights = []
    mat_cache = {}  # id(appearance element) -> material index

    def material_for(shape_el):
        app = shape_el.find("Appearance")
        if app is None:
            return 0
        app = resolve(app)
        key = id(app)
        if key in mat_cache:
            return mat_cache[key]
        mat = Material(name=app.get("DEF") or f"mat{len(materials)}")
        m = app.find("Material")
        if m is not None:
            m = resolve(m)
            dc = _floats(m.get("diffuseColor", ""))
            if len(dc) == 3:
                mat.diffuse_mul = tuple(
                    int(np.clip(v, 0, 1) * 255) for v in dc)
            ec = _floats(m.get("emissiveColor", ""))
            if len(ec) == 3 and ec.max() > 0:
                mat.emissive_col = tuple(
                    int(np.clip(v, 0, 1) * 255) for v in ec)
        tex = app.find("ImageTexture")
        if tex is not None:
            tex = resolve(tex)
            mat.diffuse = load_texture(tex.get("url", ""))
        mid = len(materials)
        materials.append(mat)
        mat_cache[key] = mid
        if mat.emissive_col is not None:
            lights.append(Light(ltype=LightType.AREA, name=mat.name,
                                resource_id=mid))
        return mid

    dedup = VertexDedup()
    vertices = dedup.vertices
    meshes = []
    geo_cache = {}  # (id(geometry el), material idx) -> mesh id

    def mesh_for(geom_el, mat_id):
        key = (id(geom_el), mat_id)
        if key in geo_cache:
            return geo_cache[key]
        coord = geom_el.find("Coordinate")
        if coord is None:
            return None
        pos = _floats(resolve(coord).get("point", "")).reshape(-1, 3)
        if geom_el.tag == "IndexedTriangleSet":
            tris = _ints(geom_el.get("index", "")).reshape(-1, 3)
            nidx_tris = tidx_tris = None
        else:
            tris_raw = _ints(geom_el.get("coordIndex", ""))
            tris = _faces_to_tris(tris_raw)
            nidx_tris = (_faces_to_tris(_ints(geom_el.get("normalIndex")))
                         if geom_el.get("normalIndex") else None)
            tidx_tris = (_faces_to_tris(_ints(geom_el.get("texCoordIndex")))
                         if geom_el.get("texCoordIndex") else None)
        if len(tris) == 0 or len(pos) == 0:
            return None
        nrm_el = geom_el.find("Normal")
        nrm = (_floats(resolve(nrm_el).get("vector", "")).reshape(-1, 3)
               if nrm_el is not None else None)
        uv_el = geom_el.find("TextureCoordinate")
        uv = (_floats(resolve(uv_el).get("point", "")).reshape(-1, 2)
              if uv_el is not None else None)
        gen = _area_weighted_normals(pos, tris) if nrm is None else None

        indices = []
        for f in range(len(tris)):
            for k in range(3):
                pi = tris[f, k]
                if nrm is None:
                    n = gen[pi]
                else:
                    ni = nidx_tris[f, k] if nidx_tris is not None else pi
                    n = nrm[min(int(ni), len(nrm) - 1)]
                if uv is None:
                    t = np.zeros(2, np.float32)
                else:
                    ti = tidx_tris[f, k] if tidx_tris is not None else pi
                    t = uv[ti] if ti < len(uv) else np.zeros(2, np.float32)
                indices.append(dedup.add(pos[pi], n, t))
        mid = len(meshes)
        meshes.append(Mesh(mid, indices, mat_id))
        geo_cache[key] = mid
        return mid

    transforms = [Transform.identity()]
    tf_dedup = {Transform.identity().to_bytes(): 0}
    instances = []
    cameras = []

    def tf_id(world):
        key = Transform(world).to_bytes()
        tid = tf_dedup.get(key)
        if tid is None:
            tid = len(transforms)
            transforms.append(Transform(world))
            tf_dedup[key] = tid
        return tid

    def walk(el, parent, depth=0):
        if depth > 64:
            return
        el = resolve(el)
        if el.tag == "Transform":
            world = parent @ _transform_matrix(el)
        else:
            world = parent
        if el.tag == "Shape":
            for gtag in ("IndexedFaceSet", "IndexedTriangleSet"):
                geom = el.find(gtag)
                if geom is not None:
                    mid = mesh_for(resolve(geom), material_for(el))
                    if mid is not None:
                        instances.append(MeshInstance(mid, tf_id(world)))
                    break
            return
        if el.tag == "Viewpoint":
            fov = float(el.get("fieldOfView", "0.785398"))
            p = _floats(el.get("position", "0 0 10"))
            o = _floats(el.get("orientation", ""))
            m = world @ _axis_angle(o if len(o) == 4 else np.zeros(4))
            position = (world[:3, :3] @ p[:3] + world[:3, 3]
                        if len(p) == 3 else world[:3, 3])
            fwd = -m[:3, 2]
            cameras.append(Camera.Perspective(PerspectiveCam(
                position=position, target=position + fwd * 100.0,
                up=m[:3, 1], fovx=fov)))
            return
        if el.tag in ("PointLight", "DirectionalLight"):
            col = _floats(el.get("color", "1 1 1"))
            spectrum = Spectrum.from_rgb(col[:3] if len(col) == 3
                                         else [1, 1, 1], True)
            intensity = float(el.get("intensity", "1"))
            if el.tag == "PointLight":
                loc = _floats(el.get("location", "0 0 0"))
                lights.append(Light(
                    ltype=LightType.OMNI, name=el.get("DEF", ""),
                    color=spectrum, intensity=intensity,
                    position=world[:3, :3] @ loc[:3] + world[:3, 3]))
            else:
                d = _floats(el.get("direction", "0 0 -1"))
                lights.append(Light(
                    ltype=LightType.SUN, name=el.get("DEF", ""),
                    color=spectrum, intensity=intensity,
                    direction=world[:3, :3] @ d[:3]))
            return
        for child in el:
            walk(child, world, depth + 1)

    for child in scene:
        walk(child, np.identity(4, np.float32))

    return (vertices, meshes, materials, textures, lights, cameras,
            transforms, instances)

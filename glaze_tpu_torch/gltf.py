"""Native glTF 2.0 importer (.gltf / .glb) for the converter.

Covers the converter-relevant subset the reference gets via assimp
(converter/src/main.rs): triangle meshes (POSITION/NORMAL/TEXCOORD_0 +
indices), the node hierarchy -> deduplicated Transform table + one
MeshInstance per node-mesh (conv_trans_inst_rec, main.rs:223-260), PBR
materials (baseColor -> diffuse, metallicRoughness/normal textures,
emissive -> AREA light, main.rs:411-587), cameras (yfov -> fovx), and
KHR_lights_punctual (point -> OMNI, directional -> SUN).

No external dependencies: glTF is JSON + binary buffers (GLB container,
external .bin, or base64 data URIs).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

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

_COMPONENT = {
    5120: ("b", 1), 5121: ("B", 1), 5122: ("h", 2), 5123: ("H", 2),
    5125: ("I", 4), 5126: ("f", 4),
}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_container(path):
    """Returns (gltf dict, [buffer bytes])."""
    with open(path, "rb") as f:
        data = f.read()
    base = os.path.dirname(os.path.abspath(path))
    if data[:4] == b"glTF":
        # GLB: header (magic, version, length) then chunks
        _, version, _ = struct.unpack_from("<III", data, 0)
        offset = 12
        gltf = None
        bin_chunk = b""
        while offset < len(data):
            clen, ctype = struct.unpack_from("<II", data, offset)
            chunk = data[offset + 8:offset + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = chunk
            offset += 8 + clen + (-clen % 4)
        buffers = []
        for buf in gltf.get("buffers", []):
            buffers.append(_resolve_buffer(buf, base, bin_chunk))
        return gltf, buffers
    gltf = json.loads(data)
    buffers = [_resolve_buffer(b, base, b"") for b in gltf.get("buffers", [])]
    return gltf, buffers


def _resolve_buffer(buf, base, glb_bin):
    uri = buf.get("uri")
    if uri is None:
        return glb_bin
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base, uri), "rb") as f:
        return f.read()


class _Gltf:
    def __init__(self, path):
        self.gltf, self.buffers = _load_container(path)
        self.base = os.path.dirname(os.path.abspath(path))

    def accessor(self, idx):
        """Accessor -> numpy array (count, ncomp)."""
        acc = self.gltf["accessors"][idx]
        fmt, csize = _COMPONENT[acc["componentType"]]
        n = _NCOMP[acc["type"]]
        count = acc["count"]
        if "bufferView" not in acc:
            return np.zeros((count, n), np.float32)
        view = self.gltf["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or csize * n
        out = np.empty((count, n), np.dtype(fmt))
        itemsize = csize * n
        raw = np.frombuffer(buf, np.uint8,
                            count=stride * (count - 1) + itemsize,
                            offset=start)
        if stride == itemsize:
            out = np.frombuffer(raw.tobytes(), np.dtype(fmt),
                                count=count * n).reshape(count, n).copy()
        else:
            strided = np.lib.stride_tricks.as_strided(
                raw, shape=(count, itemsize), strides=(stride, 1))
            out = strided.reshape(-1).view(np.dtype(fmt)).reshape(count, n).copy()
        if acc.get("normalized") and fmt in ("B", "H"):
            out = out.astype(np.float32) / (255.0 if fmt == "B" else 65535.0)
        return out

    def image_array(self, image_idx, gray=False):
        """Decodes an image to numpy RGBA/gray uint8."""
        from io import BytesIO

        from PIL import Image

        img = self.gltf["images"][image_idx]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
                pil = Image.open(BytesIO(data))
            else:
                pil = Image.open(os.path.join(self.base, uri))
        else:
            view = self.gltf["bufferViews"][img["bufferView"]]
            buf = self.buffers[view["buffer"]]
            start = view.get("byteOffset", 0)
            pil = Image.open(BytesIO(buf[start:start + view["byteLength"]]))
        if gray:
            return np.asarray(pil.convert("L"), np.uint8)
        return np.asarray(pil.convert("RGBA"), np.uint8)


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.identity(4, np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1],
        ], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.identity(4, np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def import_gltf(path):
    """glTF -> (vertices, meshes, materials, textures, lights, cameras,
    transforms, instances)."""
    g = _Gltf(path)
    doc = g.gltf

    textures = [Texture.default()]
    tex_cache = {}

    def load_texture(tex_idx, fmt, channel=None):
        """``channel``: extract one RGBA channel as a Gray texture (for the
        packed metallicRoughness map: roughness=G, metalness=B per spec)."""
        key = (tex_idx, fmt, channel)
        if key in tex_cache:
            return tex_cache[key]
        tex = doc["textures"][tex_idx]
        img_idx = tex.get("source")
        if img_idx is None:
            return 0
        if channel is not None:
            arr = g.image_array(img_idx, gray=False)[:, :, channel].copy()
        else:
            arr = g.image_array(img_idx, gray=(fmt == TextureFormat.Gray))
        h, w = arr.shape[0], arr.shape[1]
        info = TextureInfo(f"tex{tex_idx}", w, h, fmt)
        tid = len(textures)
        textures.append(Texture(info, [arr]))
        tex_cache[key] = tid
        return tid

    materials = [Material()]
    lights = []
    for mi, m in enumerate(doc.get("materials", [])):
        mat = Material(name=m.get("name", f"material{mi}"))
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        mat.diffuse_mul = tuple(int(v * 255) for v in base[:3])
        if "baseColorTexture" in pbr:
            mat.diffuse = load_texture(pbr["baseColorTexture"]["index"],
                                       TextureFormat.RgbaSrgb)
        if "metallicRoughnessTexture" in pbr:
            # glTF packs roughness in G and metalness in B of one texture
            idx = pbr["metallicRoughnessTexture"]["index"]
            mat.roughness = load_texture(idx, TextureFormat.Gray, channel=1)
            mat.metalness = load_texture(idx, TextureFormat.Gray, channel=2)
        if "normalTexture" in m:
            mat.normal = load_texture(m["normalTexture"]["index"],
                                      TextureFormat.RgbaNorm)
        em = m.get("emissiveFactor", [0, 0, 0])
        if any(v > 0 for v in em):
            mat.emissive_col = tuple(int(v * 255) for v in em)
        mat_id = len(materials)
        materials.append(mat)
        if mat.emissive_col is not None:
            lights.append(Light(ltype=LightType.AREA, name=mat.name,
                                resource_id=mat_id))

    # meshes: one Mesh per primitive; glTF mesh index -> our mesh id list
    from glaze_tpu_torch.importer_util import VertexDedup, area_weighted_normals

    dedup = VertexDedup()
    vertices = dedup.vertices
    meshes = []
    mesh_ids = []  # per glTF mesh: list of our mesh ids

    for gm in doc.get("meshes", []):
        ids = []
        for prim in gm.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            nrm = (g.accessor(attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else None)
            uv = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else None)
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            if nrm is None:
                nrm = area_weighted_normals(pos, idx.reshape(-1, 3))
            if uv is None:
                uv = np.zeros((len(pos), 2), np.float32)
            indices = [dedup.add(pos[i], nrm[i], uv[i]) for i in idx]
            mid = len(meshes)
            meshes.append(Mesh(mid, indices,
                               prim.get("material", -1) + 1))
            ids.append(mid)
        mesh_ids.append(ids)

    # node tree -> transforms + instances (+ cameras, punctual lights)
    transforms = [Transform.identity()]
    tf_dedup = {Transform.identity().to_bytes(): 0}
    instances = []
    cameras = []
    punctual = doc.get("extensions", {}).get(
        "KHR_lights_punctual", {}).get("lights", [])

    def walk(node_idx, parent):
        node = doc["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            key = Transform(world).to_bytes()
            tid = tf_dedup.get(key)
            if tid is None:
                tid = len(transforms)
                transforms.append(Transform(world))
                tf_dedup[key] = tid
            for mid in mesh_ids[node["mesh"]]:
                instances.append(MeshInstance(mid, tid))
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "orthographic":
                o = cam["orthographic"]
                position = world[:3, 3]
                fwd = -world[:3, 2]
                from glaze_tpu_torch.core import OrthographicCam

                cameras.append(Camera.Orthographic(OrthographicCam(
                    position=position, target=position + fwd * 100.0,
                    up=world[:3, 1], scale=float(o.get("xmag", 1.0)),
                    near=o.get("znear", 1e-3), far=o.get("zfar", 1e3))))
            elif cam.get("type") == "perspective":
                p = cam["perspective"]
                aspect = p.get("aspectRatio", 16 / 9)
                yfov = p["yfov"]
                fovx = 2.0 * np.arctan(np.tan(yfov / 2.0) * aspect)
                position = world[:3, 3]
                fwd = -world[:3, 2]
                up = world[:3, 1]
                cameras.append(Camera.Perspective(PerspectiveCam(
                    position=position, target=position + fwd * 100.0,
                    up=up, fovx=float(fovx),
                    near=p.get("znear", 1e-3), far=p.get("zfar", 1e3))))
        lt = node.get("extensions", {}).get("KHR_lights_punctual", {})
        if "light" in lt:
            l = punctual[lt["light"]]
            color = l.get("color", [1, 1, 1])
            spectrum = Spectrum.from_rgb(color, True)
            if l.get("type") == "point":
                lights.append(Light(
                    ltype=LightType.OMNI, name=l.get("name", ""),
                    color=spectrum, position=world[:3, 3],
                    intensity=l.get("intensity", 1.0)))
            elif l.get("type") == "directional":
                lights.append(Light(
                    ltype=LightType.SUN, name=l.get("name", ""),
                    color=spectrum, direction=-world[:3, 2],
                    intensity=l.get("intensity", 1.0)))
        for child in node.get("children", []):
            walk(child, world)

    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    roots = scenes[scene_idx]["nodes"] if scenes else range(len(doc.get("nodes", [])))
    for r in roots:
        walk(r, np.identity(4, np.float32))

    return vertices, meshes, materials, textures, lights, cameras, transforms, instances

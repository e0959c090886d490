"""FBX importer, binary and ASCII (meshes, transforms, materials, lights).

The reference converter reads FBX through assimp
(converter/src/main.rs:86-102); this is a from-scratch
reader of both 7.x encodings — the binary container (Kaydara node
records, zlib array properties) and the ASCII form (nested
``Name: props {}`` records, ``*N { a: }`` arrays) — covering the subset
a .glaze scene needs: Geometry (Vertices/PolygonVertexIndex/Normals/UV
with per-polygon-vertex or per-vertex mappings, polygon fan
triangulation), Model local transforms (translation/rotation XYZ-euler/
scaling), material diffuse colors + diffuse textures, cameras, and
point/directional lights. Pre-7.0 ASCII (object-name schema) is
rejected with a clear error.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

MAGIC = b"Kaydara FBX Binary  \x00"


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props, children):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_props(data, pos, count):
    props = []
    for _ in range(count):
        code = data[pos:pos + 1]
        pos += 1
        if code == b"Y":
            props.append(struct.unpack_from("<h", data, pos)[0]); pos += 2
        elif code == b"C":
            props.append(bool(data[pos])); pos += 1
        elif code == b"I":
            props.append(struct.unpack_from("<i", data, pos)[0]); pos += 4
        elif code == b"F":
            props.append(struct.unpack_from("<f", data, pos)[0]); pos += 4
        elif code == b"D":
            props.append(struct.unpack_from("<d", data, pos)[0]); pos += 8
        elif code == b"L":
            props.append(struct.unpack_from("<q", data, pos)[0]); pos += 8
        elif code in (b"f", b"d", b"l", b"i", b"b"):
            n, enc, clen = struct.unpack_from("<III", data, pos)
            pos += 12
            raw = data[pos:pos + clen]
            pos += clen
            if enc == 1:
                raw = zlib.decompress(raw)
            dt = {b"f": "<f4", b"d": "<f8", b"l": "<i8", b"i": "<i4",
                  b"b": "<i1"}[code]
            props.append(np.frombuffer(raw, dt, count=n))
        elif code == b"S":
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            props.append(data[pos:pos + n].decode("utf-8", "replace"))
            pos += n
        elif code == b"R":
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            props.append(data[pos:pos + n])
            pos += n
        else:
            raise ValueError(f"unknown FBX property type {code!r}")
    return props, pos


def _read_node(data, pos, big):
    if big:
        end, nprops, plen = struct.unpack_from("<QQQ", data, pos)
        pos += 24
    else:
        end, nprops, plen = struct.unpack_from("<III", data, pos)
        pos += 12
    nlen = data[pos]
    pos += 1
    if end == 0 and nprops == 0 and nlen == 0:
        return None, pos
    name = data[pos:pos + nlen].decode("ascii", "replace")
    pos += nlen
    props, pos = _read_props(data, pos, nprops)
    children = []
    while pos < end:
        child, pos = _read_node(data, pos, big)
        if child is None:  # null record terminates the child list
            break
        children.append(child)
    return FbxNode(name, props, children), max(pos, end)


def _ascii_value(kind, v):
    if kind == "s":
        # ASCII spells object names "Class::Name"; binary stores
        # "Name\x00\x01Class". Normalize so downstream code (which
        # splits on \x00) sees one encoding.
        if "::" in v:
            cls, name = v.split("::", 1)
            return f"{name}\x00\x01{cls}"
        return v
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _ascii_array(vals):
    if any(("." in v) or ("e" in v) or ("E" in v) for v in vals):
        return np.asarray(vals, np.float64)
    return np.asarray(vals, np.int64)


def _parse_ascii(text):
    """ASCII FBX 7.x -> the same FbxNode tree the binary parser builds.

    The grammar is a nested list of ``Name: prop, prop, ... { children }``
    records; ``*N { a: ... }`` blocks are the array form (decoded to one
    numpy prop, matching the binary f/d/i/l property types). The assimp
    path of the reference converter accepts both encodings
    (converter/src/main.rs:86-102).
    """
    toks = []
    pos, n = 0, len(text)
    while pos < n:
        c = text[pos]
        if c in " \t\r\n,":
            pos += 1
        elif c == ";":
            nl = text.find("\n", pos)
            pos = n if nl < 0 else nl + 1
        elif c == '"':
            j = text.find('"', pos + 1)
            if j < 0:
                raise ValueError("unterminated string in ASCII FBX")
            toks.append(("s", text[pos + 1:j]))
            pos = j + 1
        elif c in "{}:":
            toks.append((c, c))
            pos += 1
        else:
            j = pos
            while j < n and text[j] not in ' \t\r\n,{}:;"':
                j += 1
            toks.append(("a", text[pos:j]))
            pos = j

    i = 0

    def parse_nodes():
        nonlocal i
        out = []
        while i < len(toks) and toks[i][0] != "}":
            if toks[i][0] != "a" or i + 1 >= len(toks) or \
                    toks[i + 1][0] != ":":
                raise ValueError(
                    f"ASCII FBX parse error near {toks[i][1]!r}")
            name = toks[i][1]
            i += 2
            props = []
            if i < len(toks) and toks[i][0] == "a" and \
                    toks[i][1].startswith("*"):
                # array form: *N { a: v, v, ... }
                i += 1
                vals = []
                if i < len(toks) and toks[i][0] == "{":
                    i += 1
                    if i + 1 < len(toks) and toks[i] == ("a", "a") and \
                            toks[i + 1][0] == ":":
                        i += 2
                    while i < len(toks) and toks[i][0] != "}":
                        vals.append(toks[i][1])
                        i += 1
                    i += 1  # }
                props.append(_ascii_array(vals))
                out.append(FbxNode(name, props, []))
                continue
            while i < len(toks):
                t, v = toks[i]
                if t in "{}":
                    break
                if t == "a" and i + 1 < len(toks) and \
                        toks[i + 1][0] == ":":
                    break  # start of the next record
                props.append(_ascii_value(t, v))
                i += 1
            children = []
            if i < len(toks) and toks[i][0] == "{":
                i += 1
                children = parse_nodes()
                if i < len(toks) and toks[i][0] == "}":
                    i += 1
            out.append(FbxNode(name, props, children))
        return out

    root = FbxNode("", [], parse_nodes())
    header = root.first("FBXHeaderExtension")
    ver_node = header.first("FBXVersion") if header is not None else None
    version = int(ver_node.props[0]) if ver_node is not None and \
        ver_node.props else 0
    return root, version


def parse_fbx(path):
    """Parses a binary or ASCII FBX file into a root node."""
    data = open(path, "rb").read()
    if not data.startswith(MAGIC):
        head = data[:4096]
        if b"FBX" not in head or b"\x00" in head:
            raise ValueError(
                "not an FBX file (neither the binary magic nor an ASCII "
                "FBX header found; re-export or convert via glTF)")
        root, version = _parse_ascii(data.decode("utf-8", "replace"))
        if version and version < 7000:
            raise ValueError(
                f"ASCII FBX {version} uses the pre-7.0 object-name "
                "schema, which is not supported; re-export as FBX 7.x")
        return root, version
    version = struct.unpack_from("<I", data, 23)[0]
    big = version >= 7500
    pos = 27
    roots = []
    while pos < len(data):
        node, pos = _read_node(data, pos, big)
        if node is None:
            break
        roots.append(node)
    return FbxNode("", [], roots), version


def _prop70(node, name, default=None):
    """Fetches a Properties70 'P' entry's values."""
    p70 = node.first("Properties70")
    if p70 is None:
        return default
    for p in p70.find("P"):
        if p.props and p.props[0] == name:
            return p.props[4:]
    return default


def _euler_xyz(rx, ry, rz):
    """FBX Lcl Rotation (degrees, XYZ order) -> 3x3."""
    rx, ry, rz = (math.radians(v) for v in (rx, ry, rz))

    def rot(axis, a):
        c, s = math.cos(a), math.sin(a)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        m[i, j] = -s if axis != 1 else s
        m[j, i] = s if axis != 1 else -s
        return m

    return rot(2, rz) @ rot(1, ry) @ rot(0, rx)


def _model_matrix(model):
    t = _prop70(model, "Lcl Translation", (0.0, 0.0, 0.0)) or (0, 0, 0)
    r = _prop70(model, "Lcl Rotation", (0.0, 0.0, 0.0)) or (0, 0, 0)
    s = _prop70(model, "Lcl Scaling", (1.0, 1.0, 1.0)) or (1, 1, 1)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (_euler_xyz(*r[:3]) * np.asarray(s[:3], np.float64)).astype(
        np.float32)
    m[:3, 3] = np.asarray(t[:3], np.float32)
    return m


def _layer_values(geom, layer_name, value_name, index_name, n_pv, n_vert,
                  poly_vert_index):
    """Resolves a layer element to per-polygon-vertex values (N_pv, K)."""
    layer = geom.first(layer_name)
    if layer is None:
        return None
    mapping = (layer.first("MappingInformationType").props[0]
               if layer.first("MappingInformationType") else "")
    ref = (layer.first("ReferenceInformationType").props[0]
           if layer.first("ReferenceInformationType") else "Direct")
    vals_node = layer.first(value_name)
    if vals_node is None:
        return None
    vals = np.asarray(vals_node.props[0], np.float64)
    k = 2 if value_name == "UV" else 3
    vals = vals.reshape(-1, k)
    if ref == "IndexToDirect" and layer.first(index_name) is not None:
        idx = np.asarray(layer.first(index_name).props[0], np.int64)
        vals = vals[np.clip(idx, 0, len(vals) - 1)]
    if mapping == "ByPolygonVertex":
        return vals[:n_pv] if len(vals) >= n_pv else None
    if mapping in ("ByVertex", "ByVertice", "ByControlPoint"):
        per_vert = vals[:n_vert] if len(vals) >= n_vert else None
        if per_vert is None:
            return None
        return per_vert[poly_vert_index]
    if mapping == "AllSame":
        return np.broadcast_to(vals[0], (n_pv, k))
    return None


def import_fbx(path):
    """FBX -> (vertices, meshes, materials, textures, lights, cameras,
    transforms, instances), mirroring glaze_tpu_torch.gltf.import_gltf."""
    from glaze_tpu_torch.core import (
        Light,
        LightType,
        Material,
        MaterialType,
        Mesh,
        MeshInstance,
        Spectrum,
        Texture,
        Transform,
    )

    root, _version = parse_fbx(path)
    objects = root.first("Objects")
    conns = root.first("Connections")
    if objects is None:
        raise ValueError("FBX file has no Objects section")

    # connection maps: child id -> parent ids; OP keeps the property slot
    # name (texture -> material attachment point, e.g. "DiffuseColor")
    oo = {}
    op = []
    if conns is not None:
        for c in conns.find("C"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                oo.setdefault(c.props[1], []).append(c.props[2])
            elif len(c.props) >= 4 and c.props[0] == "OP":
                op.append((c.props[1], c.props[2], str(c.props[3])))

    geoms = {}
    models = {}
    fbx_mats = {}
    lights_attr = {}
    fbx_texs = {}
    fbx_videos = {}
    for obj in objects.children:
        if not obj.props:
            continue
        oid = obj.props[0]
        if obj.name == "Geometry":
            geoms[oid] = obj
        elif obj.name == "Model":
            models[oid] = obj
        elif obj.name == "Material":
            fbx_mats[oid] = obj
        elif obj.name == "NodeAttribute":
            lights_attr[oid] = obj
        elif obj.name == "Texture":
            fbx_texs[oid] = obj
        elif obj.name == "Video":
            fbx_videos[oid] = obj

    materials = [Material()]
    mat_id_of = {}
    for oid, m in fbx_mats.items():
        name = (m.props[1].split("\x00")[0] if len(m.props) > 1
                and isinstance(m.props[1], str) else f"mat{oid}")
        dc = _prop70(m, "DiffuseColor", (0.8, 0.8, 0.8)) or (0.8, 0.8, 0.8)
        mat = Material(name=name, mtype=MaterialType.LAMBERT,
                       diffuse_mul=tuple(int(float(v) * 255) for v in dc[:3]))
        ec = _prop70(m, "EmissiveColor")
        ef = _prop70(m, "EmissiveFactor", (1.0,))
        if ec is not None and any(float(v) > 0 for v in ec[:3]) and \
                float(ef[0] if ef else 1.0) > 0:
            mat.emissive_col = tuple(int(float(v) * 255) for v in ec[:3])
        mat_id_of[oid] = len(materials)
        materials.append(mat)

    from glaze_tpu_torch.importer_util import VertexDedup

    dedup = VertexDedup()
    vertices = dedup.vertices
    meshes = []
    transforms = [Transform.identity()]
    tf_cache = {Transform.identity().m.tobytes(): 0}
    instances = []
    lights = []

    def add_vertex(p, n, uv):
        return dedup.add(np.asarray(p, np.float32),
                         np.asarray(n, np.float32),
                         np.asarray(uv, np.float32))

    def add_transform(m4):
        t = Transform(m4.astype(np.float32))
        key = t.m.tobytes()
        if key not in tf_cache:
            tf_cache[key] = len(transforms)
            transforms.append(t)
        return tf_cache[key]

    def model_material(model):
        if model is None or not model.props:
            return 0
        for cid, parents in oo.items():
            if model.props[0] in parents and cid in mat_id_of:
                return mat_id_of[cid]
        return 0

    for gid, geom in geoms.items():
        vnode = geom.first("Vertices")
        inode = geom.first("PolygonVertexIndex")
        if vnode is None or inode is None:
            continue
        pts = np.asarray(vnode.props[0], np.float64).reshape(-1, 3)
        pvi = np.asarray(inode.props[0], np.int64)
        # polygon fan triangulation; negative index = ~last-of-polygon
        polys = []
        cur = []
        for ix in pvi:
            if ix < 0:
                cur.append(~ix)
                polys.append(cur)
                cur = []
            else:
                cur.append(ix)
        poly_vert_index = np.asarray([i for p in polys for i in p], np.int64)
        n_pv = len(poly_vert_index)
        normals = _layer_values(geom, "LayerElementNormal", "Normals",
                                "NormalsIndex", n_pv, len(pts),
                                poly_vert_index)
        uvs = _layer_values(geom, "LayerElementUV", "UV", "UVIndex",
                            n_pv, len(pts), poly_vert_index)

        # instancing: one LOCAL-space mesh per (geometry, material); one
        # transform + instance per connected model (the russimp
        # FindInstances postprocess the reference enables, main.rs:89-98)
        users = [models[pid] for pid in oo.get(gid, []) if pid in models]
        if not users:
            users = [None]

        mesh_by_mat = {}
        for model in users:
            mat_id = model_material(model)
            if mat_id not in mesh_by_mat:
                indices = []
                pv = 0
                for poly in polys:
                    for t in range(1, len(poly) - 1):
                        for local in (0, t, t + 1):
                            gi = pv + local
                            n = (normals[gi] if normals is not None
                                 else np.asarray([0.0, 1.0, 0.0]))
                            n = np.asarray(n, np.float64)
                            ln = np.linalg.norm(n)
                            n = (n / ln if ln > 0
                                 else np.asarray([0.0, 1.0, 0.0]))
                            uv = uvs[gi] if uvs is not None else (0.0, 0.0)
                            indices.append(
                                add_vertex(pts[poly[local]], n, uv))
                    pv += len(poly)
                mesh_id = len(meshes)
                meshes.append(Mesh(mesh_id, indices, mat_id))
                mesh_by_mat[mat_id] = mesh_id
                if materials[mat_id].emissive_col is not None:
                    lights.append(Light(ltype=LightType.AREA,
                                        name=materials[mat_id].name,
                                        resource_id=mat_id))
            m4 = (_model_matrix(model) if model is not None
                  else np.eye(4, dtype=np.float32))
            instances.append(
                MeshInstance(mesh_by_mat[mat_id], add_transform(m4)))

    # FBX lights: NodeAttribute "Light" connected to a Model for position
    for oid, attr in lights_attr.items():
        if len(attr.props) > 2 and attr.props[2] == "Light":
            lt = _prop70(attr, "LightType", (0,))
            color = _prop70(attr, "Color", (1.0, 1.0, 1.0))
            inten = _prop70(attr, "Intensity", (100.0,))
            model = None
            for pid in oo.get(oid, []):
                if pid in models:
                    model = models[pid]
                    break
            pos = (_model_matrix(model)[:3, 3] if model is not None
                   else np.zeros(3, np.float32))
            kind = int(lt[0]) if lt else 0
            ltype = LightType.SUN if kind == 1 else LightType.OMNI
            lights.append(Light(
                ltype=ltype,
                name="fbx_light",
                color=Spectrum.from_rgb([float(v) for v in color[:3]], True),
                position=np.asarray(pos, np.float32),
                direction=np.asarray([0.0, -1.0, 0.0], np.float32),
                intensity=float(inten[0]) / 100.0 if inten else 1.0,
            ))

    # FBX cameras: NodeAttribute "Camera" (Position/InterestPosition/
    # FieldOfView in its Properties70)
    cameras = []
    for oid, attr in lights_attr.items():
        if len(attr.props) > 2 and attr.props[2] == "Camera":
            from glaze_tpu_torch.core import Camera, PerspectiveCam

            pos = _prop70(attr, "Position", (0.0, 0.0, 10.0))
            tgt = _prop70(attr, "InterestPosition", (0.0, 0.0, 0.0))
            up = _prop70(attr, "UpVector", (0.0, 1.0, 0.0))
            fov = _prop70(attr, "FieldOfView", (40.0,))
            cameras.append(Camera.Perspective(PerspectiveCam(
                position=[float(v) for v in pos[:3]],
                target=[float(v) for v in tgt[:3]],
                up=[float(v) for v in up[:3]],
                fovx=math.radians(float(fov[0]) if fov else 40.0),
            )))

    # Textures: Texture objects attached to materials via OP connections
    # (attachment slot names the material channel), image data from a
    # relative/absolute filename or a Video object's embedded Content
    # (the reference's assimp path loads these for FBX too,
    # converter/src/main.rs:411-491).
    textures = [Texture.default()]
    tex_cache = {}

    def _tex_file(node):
        for key in ("RelativeFilename", "FileName", "Filename"):
            fn = node.first(key)
            if fn is not None and fn.props and isinstance(fn.props[0], str):
                v = fn.props[0].split("\x00")[0]
                if v:
                    return v
        return None

    def _load_fbx_texture(tex_oid, fmt):
        from glaze_tpu_torch.core import TextureFormat, TextureInfo
        from glaze_tpu_torch.utils import get_logger

        key = (tex_oid, fmt)
        if key in tex_cache:
            return tex_cache[key]
        node = fbx_texs[tex_oid]
        raw = None
        name = _tex_file(node) or f"tex{tex_oid}"
        # embedded Video content wins (OO connection video -> texture)
        for vid, v in fbx_videos.items():
            if tex_oid in oo.get(vid, ()):
                content = v.first("Content")
                if content is not None and content.props:
                    c = content.props[0]
                    if isinstance(c, (bytes, bytearray)):
                        raw = bytes(c)
                    elif isinstance(c, str) and len(c) > 16:
                        # ASCII FBX embeds Content as base64 text
                        import base64

                        try:
                            raw = base64.b64decode(c, validate=True)
                        except Exception:
                            raw = None
                name = _tex_file(v) or name
        import io
        import os as _os

        from PIL import Image

        try:
            if raw is not None:
                img = Image.open(io.BytesIO(raw))
            else:
                p = name.replace("\\", "/")
                if not _os.path.isabs(p):
                    p = _os.path.join(
                        _os.path.dirname(_os.path.abspath(path)), p)
                if not _os.path.exists(p):
                    # assimp also retries on the basename next to the file
                    p2 = _os.path.join(
                        _os.path.dirname(_os.path.abspath(path)),
                        _os.path.basename(name.replace("\\", "/")))
                    p = p2 if _os.path.exists(p2) else p
                img = Image.open(p)
        except Exception as e:
            get_logger("converter").warning(
                "FBX texture %s not loadable: %s", name, e)
            tex_cache[key] = 0
            return 0
        if fmt == TextureFormat.Gray:
            arr = np.asarray(img.convert("L"), np.uint8)
        else:
            arr = np.asarray(img.convert("RGBA"), np.uint8)
        info = TextureInfo(_os.path.basename(name.replace("\\", "/")),
                           img.width, img.height, fmt)
        tid = len(textures)
        textures.append(Texture(info, [arr]))
        tex_cache[key] = tid
        return tid

    from glaze_tpu_torch.core import TextureFormat

    for child, parent, slot in op:
        if child not in fbx_texs or parent not in mat_id_of:
            continue
        mat = materials[mat_id_of[parent]]
        if "DiffuseColor" in slot:
            tid = _load_fbx_texture(child, TextureFormat.RgbaSrgb)
            if tid:
                mat.diffuse = tid
                # assimp keeps the multiplier white once a map is bound
                mat.diffuse_mul = (255, 255, 255)
        elif "TransparentColor" in slot or "Opacity" in slot:
            tid = _load_fbx_texture(child, TextureFormat.Gray)
            if tid:
                mat.opacity = tid
        elif "NormalMap" in slot or "Bump" in slot:
            tid = _load_fbx_texture(child, TextureFormat.Rgba)
            if tid:
                mat.normal = tid

    return (vertices, meshes, materials, textures, lights, cameras,
            transforms, instances)

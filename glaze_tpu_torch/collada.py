"""Native COLLADA (.dae) importer for the converter.

The reference reaches DAE through assimp (converter/src/main.rs:86-102);
this is a from-scratch reader of the converter-relevant subset of the
COLLADA 1.4/1.5 schema (stdlib XML only, no assimp):

- ``library_geometries``: ``<triangles>`` and ``<polylist>`` (fan
  triangulation) with POSITION/NORMAL/TEXCOORD inputs at per-input
  offsets; missing normals are area-weighted like the other importers.
- ``library_visual_scenes``: node hierarchy with ``matrix``/
  ``translate``/``rotate``/``scale`` composed in document order,
  ``instance_geometry`` + ``bind_material`` symbol resolution, and
  ``instance_node`` into ``library_nodes``.
- ``library_effects``: phong/lambert/blinn/constant ``diffuse`` color or
  texture (sampler2D -> surface -> image chain, or a direct image ref),
  ``emission`` -> emissive material + AREA light (matching the glTF/FBX
  importers' emissive rule, main.rs:411-587).
- ``library_cameras`` perspective (xfov/yfov, degrees) and
  ``library_lights`` point/directional -> OMNI/SUN.
- ``asset``: ``up_axis`` (Z_UP/X_UP re-based to Y-up) and ``unit@meter``
  scaling, applied as a root transform.

Everything else (animation, controllers/skinning, physics) is outside
the .glaze data model and is ignored.
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
    OrthographicCam,
    PerspectiveCam,
    Spectrum,
    Texture,
    TextureFormat,
    TextureInfo,
    Transform,
)


def _strip_ns(root):
    """COLLADA 1.4 and 1.5 differ only in namespace URI; drop it."""
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


def _parse_array(text, dtype):
    if not text or not text.strip():
        return np.zeros(0, dtype)
    return np.asarray(text.split(), dtype=dtype)


class _Dae:
    def __init__(self, path):
        self.base = os.path.dirname(os.path.abspath(path))
        self.root = _strip_ns(ET.parse(path).getroot())
        # id -> element, across all libraries ('#id' URL fragments)
        self.by_id = {el.get("id"): el for el in self.root.iter()
                      if el.get("id") is not None}

    def ref(self, url):
        """Resolve a '#id' URL fragment."""
        return self.by_id.get(url.lstrip("#"))


def _source_array(dae, source_el):
    """<source> -> (N, stride) float array honoring the accessor."""
    arr_el = source_el.find("float_array")
    data = _parse_array(arr_el.text if arr_el is not None else "", np.float32)
    acc = source_el.find("technique_common/accessor")
    stride = int(acc.get("stride", "1")) if acc is not None else 1
    count = int(acc.get("count", str(len(data) // max(stride, 1)))) if acc is not None else len(data) // max(stride, 1)
    return data[: count * stride].reshape(count, stride)


def _mesh_sources(dae, mesh_el):
    """Maps source/vertices ids available inside one <mesh>."""
    srcs = {}
    for s in mesh_el.findall("source"):
        srcs[s.get("id")] = _source_array(dae, s)
    # <vertices> indirects POSITION (and sometimes NORMAL) to sources
    verts = {}
    for v in mesh_el.findall("vertices"):
        sem = {}
        for inp in v.findall("input"):
            src = inp.get("source")
            if src is None:
                raise ValueError(
                    "COLLADA <vertices> input lacks a source attribute")
            sem[inp.get("semantic")] = srcs.get(src.lstrip("#"))
        verts[v.get("id")] = sem
    return srcs, verts


def _gather_inputs(prim_el, srcs, verts):
    """Per-semantic (offset, array) for one triangles/polylist element."""
    inputs = {}
    max_off = 0
    for inp in prim_el.findall("input"):
        off = int(inp.get("offset", "0"))
        max_off = max(max_off, off)
        sem = inp.get("semantic")
        src = inp.get("source")
        if src is None:
            raise ValueError(
                f"COLLADA <input semantic={sem!r}> lacks a source attribute")
        src_id = src.lstrip("#")
        if sem == "VERTEX":
            vsem = verts.get(src_id, {})
            inputs["POSITION"] = (off, vsem.get("POSITION"))
            if "NORMAL" in vsem and "NORMAL" not in inputs:
                inputs["NORMAL"] = (off, vsem["NORMAL"])
        elif sem in ("NORMAL", "TEXCOORD"):
            # first TEXCOORD set only (the .glaze Vertex has one UV)
            if sem == "TEXCOORD" and "TEXCOORD" in inputs:
                continue
            inputs[sem] = (off, srcs.get(src_id))
    return inputs, max_off + 1


def _effect_color(technique, name):
    el = technique.find(f"{name}/color")
    if el is None:
        return None
    vals = _parse_array(el.text, np.float32)
    return vals[:3] if len(vals) >= 3 else None


def _effect_texture(technique, effect_el, name):
    """diffuse <texture texture=SAMP> -> image id via sampler/surface."""
    el = technique.find(f"{name}/texture")
    if el is None:
        return None
    ref = el.get("texture")
    # sampler2D -> surface -> image chain (sids live on newparam)
    params = {p.get("sid"): p for p in effect_el.iter("newparam")}
    seen = set()
    while ref in params and ref not in seen:
        seen.add(ref)
        p = params[ref]
        samp = p.find("sampler2D/source")
        if samp is not None:
            ref = (samp.text or "").strip()
            continue
        surf = p.find("surface/init_from")
        if surf is not None:
            return (surf.text or "").strip()
        break
    return ref  # some exporters point straight at the image id


def _node_local_matrix(node_el):
    """Compose matrix/translate/rotate/scale children in document order."""
    m = np.identity(4, np.float32)
    for el in node_el:
        if el.tag == "matrix":
            v = _parse_array(el.text, np.float32)
            if len(v) == 16:
                m = m @ v.reshape(4, 4)
        elif el.tag == "translate":
            v = _parse_array(el.text, np.float32)
            t = np.identity(4, np.float32)
            t[:3, 3] = v[:3]
            m = m @ t
        elif el.tag == "rotate":
            v = _parse_array(el.text, np.float32)
            if len(v) == 4:
                axis = v[:3]
                n = np.linalg.norm(axis)
                if n > 0:
                    axis = axis / n
                    a = np.deg2rad(v[3])
                    c, s = np.cos(a), np.sin(a)
                    x, y, z = axis
                    r = np.identity(4, np.float32)
                    r[:3, :3] = [
                        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
                    ]
                    m = m @ r
        elif el.tag == "scale":
            v = _parse_array(el.text, np.float32)
            sc = np.identity(4, np.float32)
            sc[0, 0], sc[1, 1], sc[2, 2] = v[0], v[1], v[2]
            m = m @ sc
    return m


_UP_BASIS = {
    # re-base so the document's up axis lands on +Y (right-handed)
    "Y_UP": np.identity(4, np.float32),
    "Z_UP": np.asarray([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                        [0, 0, 0, 1]], np.float32),
    "X_UP": np.asarray([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0],
                        [0, 0, 0, 1]], np.float32),
}


def import_dae(path):
    """COLLADA -> (vertices, meshes, materials, textures, lights, cameras,
    transforms, instances) — the common importer contract."""
    dae = _Dae(path)
    root = dae.root

    # ---- asset: up axis + unit scale, applied as the root transform
    up = root.findtext("asset/up_axis", "Y_UP").strip() or "Y_UP"
    unit_el = root.find("asset/unit")
    meter = float(unit_el.get("meter", "1.0")) if unit_el is not None else 1.0
    root_m = _UP_BASIS.get(up, _UP_BASIS["Y_UP"]).copy()
    if meter != 1.0:
        root_m[:3, :3] *= np.float32(meter)

    # ---- images
    image_files = {}  # image id -> abs path
    for img in root.iter("image"):
        # 1.4: <init_from>path</init_from>; 1.5 wraps it in <ref> (the
        # outer element then holds only whitespace, so strip BEFORE the
        # fallback or 1.5 refs are silently dropped)
        init = ((img.findtext("init_from") or "").strip()
                or (img.findtext("init_from/ref") or "").strip())
        if init.startswith("file://"):
            init = init[7:]
        if init:
            image_files[img.get("id")] = os.path.normpath(
                os.path.join(dae.base, init))

    textures = [Texture.default()]
    tex_ids = {}

    def load_texture(image_id):
        if image_id in tex_ids:
            return tex_ids[image_id]
        p = image_files.get(image_id)
        if p is None or not os.path.exists(p):
            return 0
        from PIL import Image

        arr = np.asarray(Image.open(p).convert("RGBA"), np.uint8)
        info = TextureInfo(image_id, arr.shape[1], arr.shape[0],
                           TextureFormat.RgbaSrgb)
        tid = len(textures)
        textures.append(Texture(info, [arr]))
        tex_ids[image_id] = tid
        return tid

    # ---- effects -> material prototypes, then materials -> effect
    effect_mat = {}  # effect id -> Material
    for eff in root.iter("effect"):
        common = eff.find("profile_COMMON")
        if common is None:
            continue
        shader = None
        for kind in ("phong", "blinn", "lambert", "constant"):
            for tech in common.findall("technique"):
                el = tech.find(kind)
                if el is not None:
                    shader = el
                    break
            if shader is not None:
                break
        mat = Material(name=eff.get("id", "effect"))
        if shader is not None:
            col = _effect_color(shader, "diffuse")
            if col is not None:
                mat.diffuse_mul = tuple(
                    int(np.clip(v, 0, 1) * 255) for v in col)
            img_id = _effect_texture(shader, eff, "diffuse")
            if img_id:
                mat.diffuse = load_texture(img_id)
            em = _effect_color(shader, "emission")
            if em is not None and any(v > 0 for v in em):
                mat.emissive_col = tuple(
                    int(np.clip(v, 0, 1) * 255) for v in em)
        effect_mat[eff.get("id")] = mat

    materials = [Material()]
    lights = []
    mat_index = {}  # material id -> .glaze material index
    for m in root.iter("material"):
        inst = m.find("instance_effect")
        eff_id = inst.get("url").lstrip("#") if inst is not None else None
        proto = effect_mat.get(eff_id, Material())
        mat = Material(**{f: getattr(proto, f) for f in (
            "mtype", "metal", "ior", "diffuse", "diffuse_mul", "roughness",
            "roughness_mul", "metalness", "metalness_mul", "opacity",
            "emissive_col")})
        mat.name = m.get("name") or m.get("id") or "material"
        mid = len(materials)
        materials.append(mat)
        mat_index[m.get("id")] = mid
        if mat.emissive_col is not None:
            lights.append(Light(ltype=LightType.AREA, name=mat.name,
                                resource_id=mid))

    # ---- geometries: one Mesh per triangles/polylist element
    dedup = VertexDedup()
    vertices = dedup.vertices
    meshes = []
    geo_meshes = {}  # geometry id -> [(mesh id, material symbol)]

    def add_prims(pos, nrm, uv, prim_idx, symbol, out):
        """Dedup-append triangle vertices; one Mesh per primitive."""
        indices = []
        for pi, ni, ti in prim_idx:
            indices.append(dedup.add(
                pos[pi],
                nrm[ni] if ni >= 0 else gen_nrm[pi],
                uv[ti] if ti >= 0 else np.zeros(2, np.float32)))
        mid = len(meshes)
        meshes.append(Mesh(mid, indices, 0))  # material patched at bind
        out.append([mid, symbol])

    for geo in root.iter("geometry"):
        mesh_el = geo.find("mesh")
        if mesh_el is None:
            continue
        srcs, verts = _mesh_sources(dae, mesh_el)
        out = []
        for prim in list(mesh_el.findall("triangles")) + list(
                mesh_el.findall("polylist")):
            inputs, stride = _gather_inputs(prim, srcs, verts)
            if "POSITION" not in inputs or inputs["POSITION"][1] is None:
                continue
            pos_off, pos = inputs["POSITION"]
            pos = pos[:, :3].astype(np.float32)
            nrm_off, nrm = inputs.get("NORMAL", (-1, None))
            uv_off, uv = inputs.get("TEXCOORD", (-1, None))
            p_el = prim.find("p")
            idx = _parse_array(p_el.text if p_el is not None else "",
                               np.int64)
            if len(idx) == 0:
                continue
            idx = idx.reshape(-1, stride)
            if prim.tag == "polylist":
                vcount = _parse_array(prim.findtext("vcount", ""), np.int64)
                corners = []
                base = 0
                for vc in vcount:
                    for k in range(1, int(vc) - 1):  # fan triangulation
                        corners.extend((base, base + k, base + k + 1))
                    base += int(vc)
                idx = idx[np.asarray(corners, np.int64)]
            # now idx rows are triangle corners in order
            pidx = idx[:, pos_off]
            nidx = idx[:, nrm_off] if nrm is not None else np.full(len(idx), -1, np.int64)
            tidx = idx[:, uv_off] if uv is not None else np.full(len(idx), -1, np.int64)
            if nrm is None:
                gen_nrm = _area_weighted_normals(pos, pidx.reshape(-1, 3))
            else:
                gen_nrm = None
                nrm = nrm[:, :3].astype(np.float32)
            if uv is not None:
                uv = uv[:, :2].astype(np.float32)
            add_prims(pos, nrm, uv, list(zip(pidx, nidx, tidx)),
                      prim.get("material", ""), out)
        geo_meshes[geo.get("id")] = out

    # ---- visual scene: nodes -> transforms + instances (+ cams/lights)
    transforms = [Transform.identity()]
    tf_dedup = {Transform.identity().to_bytes(): 0}
    instances = []
    cameras = []
    mesh_material = {}  # mesh id -> material index (from bind_material)
    mesh_clones = {}  # (mesh id, material index) -> cloned mesh id

    def bind_materials(inst_el):
        """material symbol -> material index for one instance_geometry."""
        binds = {}
        for im in inst_el.iter("instance_material"):
            binds[im.get("symbol")] = mat_index.get(
                im.get("target", "").lstrip("#"), 0)
        return binds

    def tf_id(world):
        key = Transform(world).to_bytes()
        tid = tf_dedup.get(key)
        if tid is None:
            tid = len(transforms)
            transforms.append(Transform(world))
            tf_dedup[key] = tid
        return tid

    def walk(node_el, parent, depth=0):
        if depth > 64:
            return
        world = parent @ _node_local_matrix(node_el)
        for inst in node_el.findall("instance_geometry"):
            geo_id = inst.get("url", "").lstrip("#")
            binds = bind_materials(inst)
            for mid, symbol in geo_meshes.get(geo_id, []):
                mat_id = binds.get(symbol, 0)
                prev = mesh_material.get(mid)
                if prev is None or prev == mat_id:
                    mesh_material[mid] = mat_id
                    use = mid
                elif (mid, mat_id) in mesh_clones:
                    use = mesh_clones[mid, mat_id]
                else:
                    # same geometry bound to a different material:
                    # clone the Mesh once per binding (ids are per-Mesh
                    # in .glaze); later instances reuse the clone
                    use = len(meshes)
                    meshes.append(Mesh(use, meshes[mid].indices, mat_id))
                    mesh_material[use] = mat_id
                    mesh_clones[mid, mat_id] = use
                instances.append(MeshInstance(use, tf_id(world)))
        for inst in node_el.findall("instance_camera"):
            cam_el = dae.ref(inst.get("url", ""))
            if cam_el is None:
                continue
            ortho = cam_el.find("optics/technique_common/orthographic")
            if ortho is not None:
                xmag = ortho.findtext("xmag")
                ymag = ortho.findtext("ymag")
                mag = float(xmag if xmag is not None else (ymag or 1.0))
                position = world[:3, 3]
                fwd = -world[:3, 2]
                cameras.append(Camera.Orthographic(OrthographicCam(
                    position=position, target=position + fwd * 100.0,
                    up=world[:3, 1], scale=mag,
                    near=float(ortho.findtext("znear", "0.001") or 0.001),
                    far=float(ortho.findtext("zfar", "1000") or 1000.0))))
                continue
            persp = cam_el.find("optics/technique_common/perspective")
            if persp is None:
                continue
            xfov = persp.findtext("xfov")
            yfov = persp.findtext("yfov")
            aspect = float(persp.findtext("aspect_ratio", "1.7778") or 1.7778)
            if xfov is not None:
                fovx = np.deg2rad(float(xfov))
            elif yfov is not None:
                fovx = 2.0 * np.arctan(
                    np.tan(np.deg2rad(float(yfov)) / 2.0) * aspect)
            else:
                fovx = np.deg2rad(90.0)
            position = world[:3, 3]
            fwd = -world[:3, 2]
            upv = world[:3, 1]
            cameras.append(Camera.Perspective(PerspectiveCam(
                position=position, target=position + fwd * 100.0, up=upv,
                fovx=float(fovx),
                near=float(persp.findtext("znear", "0.001") or 0.001),
                far=float(persp.findtext("zfar", "1000") or 1000.0))))
        for inst in node_el.findall("instance_light"):
            light_el = dae.ref(inst.get("url", ""))
            if light_el is None:
                continue
            tc = light_el.find("technique_common")
            if tc is None:
                continue
            for kind, ltype in (("point", LightType.OMNI),
                                ("directional", LightType.SUN)):
                el = tc.find(kind)
                if el is None:
                    continue
                col = _parse_array(el.findtext("color", "1 1 1"), np.float32)
                spectrum = Spectrum.from_rgb(col[:3], True)
                if ltype == LightType.OMNI:
                    lights.append(Light(
                        ltype=ltype, name=light_el.get("id", ""),
                        color=spectrum, position=world[:3, 3]))
                else:
                    lights.append(Light(
                        ltype=ltype, name=light_el.get("id", ""),
                        color=spectrum, direction=-world[:3, 2]))
        for inst in node_el.findall("instance_node"):
            target = dae.ref(inst.get("url", ""))
            if target is not None:
                walk(target, world, depth + 1)
        for child in node_el.findall("node"):
            walk(child, world, depth + 1)

    scene_inst = root.find("scene/instance_visual_scene")
    vs = dae.ref(scene_inst.get("url", "")) if scene_inst is not None else None
    if vs is None:
        vs = root.find("library_visual_scenes/visual_scene")
    if vs is not None:
        for node in vs.findall("node"):
            walk(node, root_m)

    # patch Mesh.material from the bindings (Mesh is frozen per id here,
    # so rebuild the list with resolved material fields)
    meshes = [Mesh(m.id, m.indices, mesh_material.get(m.id, m.material))
              for m in meshes]

    return (vertices, meshes, materials, textures, lights, cameras,
            transforms, instances)

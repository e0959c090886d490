"""glaze-converter: 3D scene -> ``.glaze`` (port of converter/src/main.rs).

A copy of ``glaze_tpu/converter.py`` for the torch package, which imports
nothing of ``glaze_tpu``: for the same input it writes the same bytes.
Pure NumPy, PIL and the standard library; no torch.

The reference uses assimp; this build ships native OBJ/MTL, glTF 2.0
(:mod:`glaze_tpu_torch.gltf`), and binary FBX (:mod:`glaze_tpu_torch.fbx`)
importers with the same postprocess semantics (triangulation,
identical-vertex joining, normal generation, instancing detection,
material slot 0 reserved for the default) and the same scene derivations
(AABB centre/radius, camera fallback, emissive materials -> AREA lights).
The `.glaze` output is byte-compatible with the reference renderer. The
other importers (COLLADA, X3D, VRML97, 3DS, PLY, STL) are modules of their
own, loaded by extension in :func:`convert`.

Usage: ``python -m glaze_tpu_torch.converter input.obj output.glaze
[--gen-mipmaps] [--benchmark]``
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

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
    Vertex,
)
from glaze_tpu_torch.parser import Meta, ParserVersion, Serializer

DEFAULT_TEXCOORD = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0)]


# ---------------------------------------------------------------------------
# OBJ/MTL import
# ---------------------------------------------------------------------------


def _parse_mtl(path):
    """Returns {name: {kd, ke, map_kd, map_bump, map_d, ns, ni, illum}}."""
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = {"name": line.split(None, 1)[1].strip()}
                mats[cur["name"]] = cur
            elif cur is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                cur["kd"] = [float(v) for v in parts[1:4]]
            elif key == "ke" and len(parts) >= 4:
                cur["ke"] = [float(v) for v in parts[1:4]]
            elif key == "ns" and len(parts) >= 2:
                cur["ns"] = float(parts[1])
            elif key == "ni" and len(parts) >= 2:
                cur["ni"] = float(parts[1])
            elif key == "illum" and len(parts) >= 2:
                cur["illum"] = int(parts[1])
            elif key == "d" and len(parts) >= 2:
                cur["d"] = float(parts[1])
            elif key == "map_kd":
                cur["map_kd"] = line.split(None, 1)[1].strip()
            elif key in ("map_bump", "bump", "norm"):
                cur["map_bump"] = line.split(None, 1)[1].strip().split()[-1]
            elif key == "map_d":
                cur["map_d"] = line.split(None, 1)[1].strip()
    return mats


class ObjScene:
    """Parsed OBJ: groups of triangles per material."""

    def __init__(self, path):
        self.positions = []
        self.normals = []
        self.texcoords = []
        self.groups = {}  # material name -> list of faces [(vi, ti, ni) x 3]
        self.mtl = {}
        cur_mat = None
        base = os.path.dirname(os.path.abspath(path))
        with open(path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                key = parts[0]
                if key == "v":
                    self.positions.append([float(v) for v in parts[1:4]])
                elif key == "vn":
                    self.normals.append([float(v) for v in parts[1:4]])
                elif key == "vt":
                    u = float(parts[1])
                    v = float(parts[2]) if len(parts) > 2 else 0.0
                    self.texcoords.append([u, v])
                elif key == "mtllib":
                    name = line.split(None, 1)[1].strip()
                    self.mtl.update(_parse_mtl(os.path.join(base, name)))
                elif key == "usemtl":
                    cur_mat = line.split(None, 1)[1].strip()
                elif key == "f":
                    corners = []
                    for spec in parts[1:]:
                        comps = spec.split("/")
                        vi = int(comps[0])
                        ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                        ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                        corners.append((vi, ti, ni))
                    # triangulate fans (assimp Triangulate)
                    faces = self.groups.setdefault(cur_mat, [])
                    for i in range(1, len(corners) - 1):
                        faces.append((corners[0], corners[i], corners[i + 1]))

    def resolve(self, idx, count):
        """OBJ 1-based / negative indices."""
        if idx > 0:
            return idx - 1
        if idx < 0:
            return count + idx
        return -1


def _generate_normals(positions, faces_resolved):
    """Area-weighted vertex normals (assimp GenerateNormals fallback)."""
    pos = np.asarray(positions, np.float32)
    acc = np.zeros_like(pos)
    for (a, b, c) in faces_resolved:
        n = np.cross(pos[b] - pos[a], pos[c] - pos[a])
        acc[a] += n
        acc[b] += n
        acc[c] += n
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    return acc / np.maximum(norm, 1e-20)


def import_obj(path):
    """OBJ -> (vertices, meshes, materials, textures, lights).

    One Mesh per material group (assimp splits by material the same way);
    material ids are offset by 1 for the default slot
    (converter/src/main.rs:374).
    """
    obj = ObjScene(path)
    n_pos = len(obj.positions)
    n_tex = len(obj.texcoords)
    n_nrm = len(obj.normals)
    base = os.path.dirname(os.path.abspath(path))

    # textures: slot 0 = default (convert_materials, main.rs:423-425)
    textures = [Texture.default()]
    used_textures = {}

    def load_texture(name, fmt):
        key = (name, fmt)
        if key in used_textures:
            return used_textures[key]
        p = name.replace("\\", "/")
        if not os.path.isabs(p):
            p = os.path.join(base, p)
        if not os.path.exists(p):
            from glaze_tpu_torch.utils import get_logger

            get_logger("converter").warning("texture not found: %s", name)
            return 0
        from PIL import Image

        img = Image.open(p)
        if fmt == TextureFormat.Gray:
            arr = np.asarray(img.convert("L"), np.uint8)
        else:
            arr = np.asarray(img.convert("RGBA"), np.uint8)
        info = TextureInfo(name, img.width, img.height, fmt)
        tid = len(textures)
        textures.append(Texture(info, [arr]))
        used_textures[key] = tid
        return tid

    materials = [Material()]  # slot 0 = default
    lights = []
    vertices = []
    used_vert = {}
    meshes = []

    mat_names = sorted(obj.groups.keys(), key=lambda s: (s is None, s or ""))
    for mesh_id, mat_name in enumerate(mat_names):
        props = obj.mtl.get(mat_name, {"name": mat_name or "default"})
        mat = Material(name=props.get("name", mat_name or "default"))
        kd = props.get("kd")
        if kd is not None:
            mat.diffuse_mul = tuple(int(v * 255) for v in kd)
        ke = props.get("ke")
        if ke is not None and any(v > 0 for v in ke):
            mat.emissive_col = tuple(int(v * 255) for v in ke)
        if "ni" in props:
            mat.ior = float(np.float32(props["ni"]))
        if "map_kd" in props:
            mat.diffuse = load_texture(props["map_kd"], TextureFormat.RgbaSrgb)
        if "map_bump" in props:
            mat.normal = load_texture(props["map_bump"], TextureFormat.RgbaNorm)
        if "map_d" in props:
            mat.opacity = load_texture(props["map_d"], TextureFormat.Gray)
        mat_id = len(materials)
        materials.append(mat)
        if mat.emissive_col is not None:
            lights.append(
                Light(ltype=LightType.AREA, name=mat.name, resource_id=mat_id)
            )

        faces = obj.groups[mat_name]
        # pass 1: normals if missing
        need_gen = any(obj.resolve(c[2], n_nrm) < 0 for f in faces for c in f)
        gen_normals = None
        if need_gen:
            resolved = [
                tuple(obj.resolve(c[0], n_pos) for c in f) for f in faces
            ]
            gen_normals = _generate_normals(obj.positions, resolved)

        indices = []
        for face in faces:
            for i, (vi, ti, ni) in enumerate(face):
                pv = obj.resolve(vi, n_pos)
                pt = obj.resolve(ti, n_tex)
                pn = obj.resolve(ni, n_nrm)
                pos = obj.positions[pv]
                if pn >= 0:
                    nrm = obj.normals[pn]
                else:
                    nrm = gen_normals[pv]
                if pt >= 0:
                    u, v = obj.texcoords[pt]
                else:
                    u, v = DEFAULT_TEXCOORD[i]
                vert = Vertex(
                    np.asarray(pos, np.float32),
                    np.asarray(nrm, np.float32),
                    np.asarray([u, 1.0 - v], np.float32),  # vulkan y-flip
                )
                from glaze_tpu_torch.parser.v1 import vertex_to_bytes

                vb = vertex_to_bytes(vert)
                idx = used_vert.get(vb)
                if idx is None:
                    idx = len(vertices)
                    used_vert[vb] = idx
                    vertices.append(vert)
                indices.append(idx)
        meshes.append(Mesh(mesh_id, indices, len(materials) - 1))
    return vertices, meshes, materials, textures, lights


# ---------------------------------------------------------------------------
# Scene derivations (converter/src/main.rs)
# ---------------------------------------------------------------------------


def calc_scene_centre_radius(vertices, meshes, instances, transforms):
    """World AABB centre + half-diagonal (main.rs:188-211)."""
    pmin = np.full(3, np.inf, np.float32)
    pmax = np.full(3, -np.inf, np.float32)
    pos = np.stack([v.vv for v in vertices]) if vertices else np.zeros((0, 3))
    for inst in instances:
        mesh = meshes[inst.mesh_id]
        t = transforms[inst.transform_id].m
        pts = pos[np.asarray(mesh.indices, np.int64)]
        world = pts @ t[:3, :3].T + t[:3, 3]
        pmin = np.minimum(pmin, world.min(axis=0))
        pmax = np.maximum(pmax, world.max(axis=0))
    if not np.isfinite(pmin).all():
        return [0.0, 0.0, 0.0], 100.0
    centre = pmin + (pmax - pmin) * 0.5
    radius = float(np.linalg.norm(pmax - pmin) / 2.0)
    return centre.tolist(), radius


def default_camera(radius):
    """Camera fallback (main.rs:399-407)."""
    return Camera.Perspective(
        PerspectiveCam(
            position=[0.0, 0.0, 0.0],
            target=[0.0, 0.0, 100.0],
            up=[0.0, 1.0, 0.0],
            fovx=math.radians(90.0),
            near=max(1e-3, radius * 2.0 * 1e-5),
            far=max(100.0, radius * 2.0),
        )
    )


MESH_EXTENSIONS = (".obj", ".gltf", ".glb", ".fbx", ".dae", ".x3d",
                   ".wrl", ".3ds", ".ply", ".stl")


def ensure_glaze(path):
    """Returns a .glaze path for ``path``, converting importable mesh
    formats to a cached temp .glaze first (so cli/app/viewer can open
    any supported format directly). .glaze paths pass through.

    The cache file's prefix (``glaze_torch_conv_``) differs from the JAX
    package's, so neither package reads a file that the other wrote."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in MESH_EXTENSIONS:
        return path  # .glaze (or unknown: let the parser error clearly)
    import hashlib
    import tempfile

    st = os.stat(path)
    key = hashlib.blake2b(
        f"{os.path.abspath(path)}:{st.st_mtime_ns}:{st.st_size}".encode(),
        digest_size=8).hexdigest()
    out = os.path.join(tempfile.gettempdir(), f"glaze_torch_conv_{key}.glaze")
    if not os.path.exists(out):
        import sys as _sys

        print(f"converting {path} -> {out}", file=_sys.stderr)
        # convert to a private temp then atomically rename, so two
        # front-ends opening the same model concurrently never read a
        # half-written file
        fd, tmp = tempfile.mkstemp(dir=tempfile.gettempdir(),
                                   suffix=".glaze")
        os.close(fd)
        try:
            convert(path, tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def convert(input_path, output_path, gen_mipmaps=False):
    ext = os.path.splitext(input_path)[1].lower()
    if ext == ".obj":
        vertices, meshes, materials, textures, lights = import_obj(input_path)
        transforms = [Transform.identity()]
        instances = [MeshInstance(m.id, 0) for m in meshes]
        cameras = []
    elif ext in (".gltf", ".glb"):
        from glaze_tpu_torch.gltf import import_gltf

        (vertices, meshes, materials, textures, lights, cameras,
         transforms, instances) = import_gltf(input_path)
    elif ext == ".fbx":
        from glaze_tpu_torch.fbx import import_fbx

        (vertices, meshes, materials, textures, lights, cameras,
         transforms, instances) = import_fbx(input_path)
    elif ext == ".dae":
        from glaze_tpu_torch.collada import import_dae

        (vertices, meshes, materials, textures, lights, cameras,
         transforms, instances) = import_dae(input_path)
    elif ext == ".x3d":
        from glaze_tpu_torch.x3d import import_x3d

        (vertices, meshes, materials, textures, lights, cameras,
         transforms, instances) = import_x3d(input_path)
    elif ext == ".wrl":
        from glaze_tpu_torch.vrml import import_wrl

        (vertices, meshes, materials, textures, lights, cameras,
         transforms, instances) = import_wrl(input_path)
    elif ext == ".3ds":
        from glaze_tpu_torch.tds import import_3ds

        (vertices, meshes, materials, textures, lights, cameras,
         transforms, instances) = import_3ds(input_path)
    elif ext in (".ply", ".stl"):
        from glaze_tpu_torch.mesh_formats import import_ply, import_stl

        importer = import_ply if ext == ".ply" else import_stl
        vertices, meshes, materials, textures, lights = importer(input_path)
        transforms = [Transform.identity()]
        instances = [MeshInstance(m.id, 0) for m in meshes]
        cameras = []
    else:
        raise SystemExit(
            f"Unsupported input format {ext!r}: this build imports OBJ, "
            "glTF/GLB, FBX (binary+ASCII), COLLADA (.dae), X3D, VRML97 "
            "(.wrl), 3DS, PLY, and STL natively (assimp is not "
            "available)."
        )
    centre, radius = calc_scene_centre_radius(vertices, meshes, instances, transforms)
    if not cameras:
        cameras = [default_camera(radius)]
    if gen_mipmaps:
        for t in textures:
            # only power-of-two textures can mip (texture.rs)
            w, h = t.info.width, t.info.height
            if w and h and (w & (w - 1)) == 0 and (h & (h - 1)) == 0:
                t.gen_mipmaps()
    meta = Meta(scene_centre=centre, scene_radius=radius, exposure=1.0)
    (
        Serializer(output_path, ParserVersion.V1)
        .with_vertices(vertices)
        .with_meshes(meshes)
        .with_transforms(transforms)
        .with_instances(instances)
        .with_cameras(cameras)
        .with_textures(textures)
        .with_materials(materials)
        .with_lights(lights)
        .with_metadata(meta)
        .serialize()
    )
    return len(vertices), len(meshes)


def benchmark(input_path):
    """Times parse + per-chunk reads (main.rs:639+)."""
    from glaze_tpu_torch.parser import parse

    t0 = time.perf_counter()
    parsed = parse(input_path)
    t_parse = time.perf_counter() - t0
    print(f"parse: {t_parse * 1000:.1f}ms")
    for chunk in ("vertices", "meshes", "transforms", "instances", "cameras",
                  "textures", "materials", "lights", "meta"):
        t0 = time.perf_counter()
        getattr(parsed, chunk)()
        print(f"read {chunk}: {(time.perf_counter() - t0) * 1000:.1f}ms")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="glaze-converter",
        description="Converts a 3D scene to the .glaze format.",
    )
    p.add_argument("input")
    p.add_argument("output", nargs="?")
    p.add_argument("--gen-mipmaps", action="store_true")
    p.add_argument("--benchmark", action="store_true",
                   help="time parse+reads of an existing .glaze file")
    args = p.parse_args(argv)
    if args.benchmark:
        benchmark(args.input)
        return 0
    if not args.output:
        p.error("output path required")
    t0 = time.perf_counter()
    nv, nm = convert(args.input, args.output, args.gen_mipmaps)
    dt = time.perf_counter() - t0
    print(f"Converted {nv} vertices / {nm} meshes in {dt * 1000:.0f}ms "
          f"-> {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

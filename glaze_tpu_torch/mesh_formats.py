"""Native PLY and STL importers for glaze-converter.

The reference converter reaches these formats through assimp
(converter/src/main.rs:89-98 imports anything russimp reads); this build
implements the two most common interchange mesh formats natively, in the
same shape as :func:`glaze_tpu_torch.converter.import_obj`: each returns
``(vertices, meshes, materials, textures, lights)`` with a single default
lambert material (PLY/STL carry no material system).

PLY: ascii 1.0 and binary_little_endian 1.0; vertex properties x/y/z,
optional nx/ny/nz normals and s/t (or u/v) texcoords; polygon faces are
fan-triangulated. STL: ascii and binary, per-facet normals.
"""

from __future__ import annotations

import struct

import numpy as np

from glaze_tpu_torch.core import Material, Mesh, Vertex

_PLY_SIZES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def _parse_ply_header(data):
    if not data.startswith(b"ply"):
        raise ValueError("not a PLY file")
    # line-by-line until a line that IS "end_header" (a substring search
    # would trip on comments mentioning it)
    fmt = None
    elements = []  # (name, count, [prop])  prop = ("scalar",t,name)|("list",ct,it,name)
    off = 0
    while True:
        nl = data.find(b"\n", off)
        if nl < 0:
            raise ValueError("PLY header has no end_header")
        line = data[off:nl].strip()
        off = nl + 1
        tok = line.decode("ascii", "replace").split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "end_header":
            break
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append(("scalar", tok[1], tok[2]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r} "
                         "(ascii / binary_little_endian)")
    return fmt, elements, off


def _read_ply(data):
    """Returns {element: {prop: list}} (list props -> list of lists)."""
    fmt, elements, off = _parse_ply_header(data)
    out = {}
    if fmt == "ascii":
        lines = data[off:].decode("ascii", "replace").split("\n")
        li = 0
        for name, count, props in elements:
            cols = {p[-1]: [] for p in props}
            for _ in range(count):
                while not lines[li].strip():
                    li += 1
                tok = lines[li].split()
                li += 1
                ti = 0
                for p in props:
                    if p[0] == "list":
                        n = int(float(tok[ti])); ti += 1
                        cols[p[3]].append([int(float(x))
                                           for x in tok[ti:ti + n]])
                        ti += n
                    else:
                        cols[p[2]].append(float(tok[ti])); ti += 1
            out[name] = cols
        return out
    for name, count, props in elements:
        cols = {p[-1]: [] for p in props}
        fixed = all(p[0] == "scalar" for p in props)
        if fixed and count:
            # vectorized scalar rows via a structured dtype
            dt = np.dtype([(p[2], "<" + _PLY_SIZES[p[1]][0]) for p in props])
            arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            for p in props:
                cols[p[2]] = arr[p[2]].tolist()
        else:
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        cf, cs = _PLY_SIZES[p[1]]
                        nf, ns = _PLY_SIZES[p[2]]
                        n = struct.unpack_from("<" + cf, data, off)[0]
                        off += cs
                        cols[p[3]].append(
                            list(struct.unpack_from(f"<{n}{nf}", data, off)))
                        off += ns * n
                    else:
                        f, s = _PLY_SIZES[p[1]]
                        cols[p[2]].append(
                            struct.unpack_from("<" + f, data, off)[0])
                        off += s
        out[name] = cols
    return out


def import_ply(path):
    """PLY -> (vertices, meshes, materials, textures, lights)."""
    from glaze_tpu_torch.converter import _generate_normals
    from glaze_tpu_torch.core import Texture

    with open(path, "rb") as fh:
        data = fh.read()
    ply = _read_ply(data)
    if "vertex" not in ply:
        raise ValueError("PLY has no vertex element")
    vx = ply["vertex"]
    pos = np.stack([np.asarray(vx[c], np.float32)
                    for c in ("x", "y", "z")], axis=1)
    has_n = all(c in vx for c in ("nx", "ny", "nz"))
    uv_names = ("s", "t") if "s" in vx else ("u", "v")
    has_uv = all(c in vx for c in uv_names)
    faces = []
    fcols = ply.get("face", {})
    idx_col = fcols.get("vertex_indices", fcols.get("vertex_index", []))
    for poly in idx_col:
        for k in range(1, len(poly) - 1):  # fan triangulation
            faces.append((poly[0], poly[k], poly[k + 1]))
    if not faces:
        raise ValueError(
            "PLY has no faces (point clouds cannot become render geometry)")
    if has_n:
        nrm = np.stack([np.asarray(vx[c], np.float32)
                        for c in ("nx", "ny", "nz")], axis=1)
    else:
        nrm = _generate_normals(pos.tolist(), faces)
        nrm = np.asarray(nrm, np.float32)
    if has_uv:
        uv = np.stack([np.asarray(vx[uv_names[0]], np.float32),
                       1.0 - np.asarray(vx[uv_names[1]], np.float32)], axis=1)
    else:
        uv = np.zeros((len(pos), 2), np.float32)

    vertices, indices = _dedup_vertices(
        Vertex(pos[vi], nrm[vi], uv[vi]) for tri in faces for vi in tri)
    materials = [Material(name="default")]
    meshes = [Mesh(0, indices, 0)]
    return vertices, meshes, materials, [Texture.default()], []


def _dedup_vertices(vert_iter):
    """Byte-identical vertex dedup shared by the PLY/STL importers."""
    from glaze_tpu_torch.parser.v1 import vertex_to_bytes

    vertices, used, indices = [], {}, []
    for vert in vert_iter:
        vb = vertex_to_bytes(vert)
        j = used.get(vb)
        if j is None:
            j = len(vertices)
            used[vb] = j
            vertices.append(vert)
        indices.append(j)
    return vertices, indices


def _read_stl(data):
    """Returns (normals (F,3), tris (F,3,3)) from ascii or binary STL."""
    # binary detection first, by the size formula (84 + 50*count): a
    # binary file whose 80-byte comment header happens to start with
    # "solid" and mention "facet" (the classic STL ambiguity) must still
    # import as binary, so the text heuristic is only a fallback
    if len(data) >= 84:
        count = struct.unpack_from("<I", data, 80)[0]
        # tolerate trailing bytes (some CAD tools append metadata)
        if count > 0 and 84 + 50 * count <= len(data):
            rec = np.dtype([("n", "<3f4"), ("v", "<(3,3)f4"), ("attr", "<u2")])
            arr = np.frombuffer(data, dtype=rec, count=count, offset=84)
            return arr["n"].copy(), arr["v"].copy()
    text = data.decode("ascii", "replace")
    normals, tris, cur = [], [], []
    cur_n = (0.0, 0.0, 0.0)
    for raw in text.splitlines():
        tok = raw.split()
        if not tok:
            continue
        if tok[0] == "facet" and len(tok) >= 5:
            cur_n = tuple(float(x) for x in tok[2:5])
        elif tok[0] == "vertex":
            cur.append(tuple(float(x) for x in tok[1:4]))
            if len(cur) == 3:
                normals.append(cur_n)
                tris.append(cur)
                cur = []
    return (np.asarray(normals, np.float32),
            np.asarray(tris, np.float32).reshape(-1, 3, 3))


def import_stl(path):
    """STL -> (vertices, meshes, materials, textures, lights)."""
    from glaze_tpu_torch.core import Texture

    with open(path, "rb") as fh:
        data = fh.read()
    normals, tris = _read_stl(data)
    if len(tris) == 0:
        raise ValueError("STL has no facets")
    # zero/degenerate facet normals -> geometric normal
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    geo = np.cross(e1, e2)
    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    lg = np.maximum(np.linalg.norm(geo, axis=1, keepdims=True), 1e-20)
    normals = np.where(ln > 1e-8, normals / np.maximum(ln, 1e-20), geo / lg)
    uv = np.asarray([(0.0, 0.0), (1.0, 0.0), (1.0, 1.0)], np.float32)
    vertices, indices = _dedup_vertices(
        Vertex(tris[f, i], normals[f], uv[i])
        for f in range(len(tris)) for i in range(3))
    materials = [Material(name="default")]
    meshes = [Mesh(0, indices, 0)]
    return vertices, meshes, materials, [Texture.default()], []

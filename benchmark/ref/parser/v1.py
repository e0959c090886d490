# Frozen copy of glaze_tpu_torch/parser/v1.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Version 1 of the ``.glaze`` scene format.

Byte-exact port of ``lib/src/parser/v1.rs``:

- After the 16-byte header there is an 8-byte xxHash64 of the offsets table,
  then 1 byte of chunk count and 17 bytes per chunk (id u8, absolute offset
  u64le, length u64le).
- Each chunk is 8 bytes of xxHash64 followed by its payload. Fixed/dynamic
  record chunks are xz (preset 9) compressed; texture chunks store PNG
  (per mip level) without an outer compression layer.
- The hasher seed is 0x368262AAA1DEB64D (v1.rs:40).
"""

from __future__ import annotations

import io
import lzma
import struct
from typing import Optional

import numpy as np
from PIL import Image

from benchmark.ref.core.camera import Camera, OrthographicCam, PerspectiveCam
from benchmark.ref.core.light import Light, LightType
from benchmark.ref.core.material import Material, MaterialType
from benchmark.ref.core.mesh import Mesh, MeshInstance, Transform, Vertex
from benchmark.ref.core.metal import Metal
from benchmark.ref.core.spectrum import Spectrum
from benchmark.ref.core.texture import Texture, TextureFormat, TextureInfo
from benchmark.ref.core.xxh64 import xxh64

HEADER_LEN = 16
HASHER_SEED = 0x368262AAA1DEB64D
HASH_SIZE = 8

CHUNK_VERTEX = 0
CHUNK_MESH = 1
CHUNK_CAMERA = 2
CHUNK_TEXTURE = 3
CHUNK_MATERIAL = 4
CHUNK_TRANSFORM = 5
CHUNK_INSTANCE = 6
CHUNK_LIGHT = 7
CHUNK_META = 250

_KNOWN_CHUNKS = {
    CHUNK_VERTEX, CHUNK_MESH, CHUNK_CAMERA, CHUNK_TEXTURE, CHUNK_MATERIAL,
    CHUNK_TRANSFORM, CHUNK_INSTANCE, CHUNK_LIGHT, CHUNK_META,
}

_SERIALIZED_CHUNK_LEN = 17


def _hash(data: bytes) -> int:
    return xxh64(data, HASHER_SEED)


def _compress(data: bytes) -> bytes:
    return lzma.compress(data, format=lzma.FORMAT_XZ, preset=9)


def _decompress(data: bytes) -> bytes:
    return lzma.decompress(data)


def _prepend_hash(data: bytes) -> bytes:
    return struct.pack("<Q", _hash(data)) + data


def _verify_hash(data: bytes) -> Optional[bytes]:
    expected = struct.unpack_from("<Q", data, 0)[0]
    remaining = data[HASH_SIZE:]
    if expected == _hash(remaining):
        return remaining
    return None


# ---------------------------------------------------------------------------
# per-type byte codecs (v1.rs:613-1080)
# ---------------------------------------------------------------------------

def vertex_to_bytes(v: Vertex) -> bytes:
    return np.concatenate([v.vv, v.vn, v.vt]).astype("<f4").tobytes()


def bytes_to_vertex(data: bytes) -> Vertex:
    f = np.frombuffer(data, dtype="<f4", count=8)
    return Vertex(f[0:3], f[3:6], f[6:8])


def vertices_to_bytes(vertices: list[Vertex]) -> bytes:
    if not vertices:
        return b""
    arr = np.empty((len(vertices), 8), dtype="<f4")
    for i, v in enumerate(vertices):
        arr[i, 0:3] = v.vv
        arr[i, 3:6] = v.vn
        arr[i, 6:8] = v.vt
    return arr.tobytes()


def bytes_to_vertices(data: bytes) -> list[Vertex]:
    n = len(data) // 32
    arr = np.frombuffer(data, dtype="<f4", count=n * 8).reshape(n, 8)
    return [Vertex(row[0:3], row[3:6], row[6:8]) for row in arr]


def mesh_to_bytes(mesh: Mesh) -> bytes:
    head = struct.pack("<HIH", mesh.id, len(mesh.indices), mesh.material)
    return head + np.asarray(mesh.indices, dtype="<u4").tobytes()


def bytes_to_mesh(data: bytes) -> Mesh:
    mid, faces_no, material = struct.unpack_from("<HIH", data, 0)
    indices = np.frombuffer(data, dtype="<u4", offset=8, count=faces_no)
    return Mesh(mid, indices.tolist(), material)


def camera_to_bytes(camera: Camera) -> bytes:
    cam = camera.inner
    if isinstance(cam, PerspectiveCam):
        ctype, other = 0, cam.fovx
    else:
        ctype, other = 1, cam.scale
    return struct.pack(
        "<B12f",
        ctype,
        *cam.position.tolist(),
        *cam.target.tolist(),
        *cam.up.tolist(),
        other,
        cam.near,
        cam.far,
    )


def bytes_to_camera(data: bytes) -> Camera:
    vals = struct.unpack_from("<B12f", data, 0)
    ctype = vals[0]
    pos, tgt, up = vals[1:4], vals[4:7], vals[7:10]
    other, near, far = vals[10], vals[11], vals[12]
    if ctype == 0:
        return Camera(PerspectiveCam(pos, tgt, up, other, near, far))
    if ctype == 1:
        return Camera(OrthographicCam(pos, tgt, up, other, near, far))
    raise IOError("Unexpected cam type")


def texture_to_bytes(texture: Texture) -> bytes:
    name = texture.name().encode("utf-8")
    assert len(name) < 256
    miplvls = texture.mipmap_levels()
    tex_data = bytearray()
    for level in range(miplvls):
        arr = texture.array(level)
        mode = "L" if texture.format() == TextureFormat.Gray else "RGBA"
        img = Image.fromarray(arr, mode=mode)
        buf = io.BytesIO()
        img.save(buf, format="PNG", compress_level=1)
        png = buf.getvalue()
        tex_data += struct.pack("<I", len(png))
        tex_data += png
    out = bytearray()
    out.append(_format_to_u8(texture.format()))
    out.append(len(name))
    out += name
    out.append(miplvls)
    out += tex_data
    return bytes(out)


def _format_to_u8(fmt: TextureFormat) -> int:
    return {TextureFormat.Gray: 1, TextureFormat.RgbaSrgb: 2, TextureFormat.RgbaNorm: 3}[fmt]


def _u8_to_format(v: int) -> TextureFormat:
    try:
        return {1: TextureFormat.Gray, 2: TextureFormat.RgbaSrgb, 3: TextureFormat.RgbaNorm}[v]
    except KeyError:
        raise IOError("Unexpected texture format")


def bytes_to_texture(data: bytes) -> Texture:
    fmt = _u8_to_format(data[0])
    str_len = data[1]
    index = 2
    name = data[index : index + str_len].decode("utf-8")
    index += str_len
    miplvls = data[index]
    index += 1
    mips = []
    dims = []
    for _ in range(miplvls):
        (miplen,) = struct.unpack_from("<I", data, index)
        index += 4
        img = Image.open(io.BytesIO(data[index : index + miplen]))
        index += miplen
        if fmt == TextureFormat.Gray:
            img = img.convert("L")
        else:
            img = img.convert("RGBA")
        dims.append(img.size)
        mips.append(np.asarray(img))
    info = TextureInfo(name=name, width=dims[0][0], height=dims[0][1], format=fmt)
    if fmt == TextureFormat.Gray:
        return Texture.new_gray_with_mipmaps(info, mips)
    return Texture.new_rgba_with_mipmaps(info, mips)


def material_to_bytes(material: Material) -> bytes:
    out = bytearray()
    out.append(material.mtype.id())
    out.append(int(material.metal))
    out += bytes(material.diffuse_mul)
    out += bytes(material.emissive_col if material.emissive_col is not None else (0, 0, 0))
    out += struct.pack(
        "<ffff",
        material.ior,
        material.roughness_mul,
        material.metalness_mul,
        material.anisotropy,
    )
    out += struct.pack(
        "<HHHHH",
        material.diffuse,
        material.roughness,
        material.metalness,
        material.normal,
        material.opacity,
    )
    out += material.name.encode("utf-8")
    return bytes(out)


def bytes_to_material(data: bytes) -> Material:
    mtype = MaterialType.from_u8(data[0])
    metal = Metal.from_u8(data[1])
    diffuse_mul = tuple(data[2:5])
    maybe_emissive = tuple(data[5:8])
    emissive_col = maybe_emissive if maybe_emissive != (0, 0, 0) else None
    ior, roughness_mul, metalness_mul, anisotropy = struct.unpack_from("<ffff", data, 8)
    diffuse, roughness, metalness, normal, opacity = struct.unpack_from("<HHHHH", data, 24)
    name = data[34:].decode("utf-8")
    return Material(
        name=name,
        mtype=mtype,
        metal=metal,
        ior=ior,
        diffuse=diffuse,
        diffuse_mul=diffuse_mul,
        roughness=roughness,
        roughness_mul=roughness_mul,
        metalness=metalness,
        metalness_mul=metalness_mul,
        anisotropy=anisotropy,
        opacity=opacity,
        normal=normal,
        emissive_col=emissive_col,
    )


def transform_to_bytes(transform: Transform) -> bytes:
    return transform.to_bytes()


def bytes_to_transform(data: bytes) -> Transform:
    return Transform.from_bytes(data)


def instance_to_bytes(instance: MeshInstance) -> bytes:
    return struct.pack("<HH", instance.mesh_id, instance.transform_id)


def bytes_to_instance(data: bytes) -> MeshInstance:
    mesh_id, transform_id = struct.unpack_from("<HH", data, 0)
    return MeshInstance(mesh_id, transform_id)


def light_to_bytes(light: Light) -> bytes:
    out = bytearray()
    out.append(int(light.ltype))
    out += light.position.astype("<f4").tobytes()
    out += light.direction.astype("<f4").tobytes()
    out += struct.pack("<I", light.resource_id)
    out += struct.pack(
        "<ffff", light.intensity, light.yaw_deg, light.pitch_deg, light.roll_deg
    )
    out += light.color.to_le_bytes()
    out += light.name.encode("utf-8")
    return bytes(out)


def bytes_to_light(data: bytes) -> Light:
    ltype = LightType(data[0])
    f = struct.unpack_from("<6f", data, 1)
    position, direction = f[0:3], f[3:6]
    (resource_id,) = struct.unpack_from("<I", data, 25)
    intensity, yaw, pitch, roll = struct.unpack_from("<ffff", data, 29)
    color = Spectrum.from_le_bytes(data[45 : 45 + 64])
    name = data[45 + 64 :].decode("utf-8")
    return Light(
        ltype=ltype,
        name=name,
        color=color,
        position=position,
        direction=direction,
        intensity=intensity,
        resource_id=resource_id,
        yaw_deg=yaw,
        pitch_deg=pitch,
        roll_deg=roll,
    )


def meta_to_bytes(meta) -> bytes:
    return struct.pack(
        "<5f",
        meta.scene_centre[0],
        meta.scene_centre[1],
        meta.scene_centre[2],
        meta.scene_radius,
        meta.exposure,
    )


def bytes_to_meta(data: bytes):
    from benchmark.ref.parser import Meta

    vals = struct.unpack_from("<5f", data, 0)
    return Meta(scene_centre=list(vals[0:3]), scene_radius=vals[3], exposure=vals[4])


# ---------------------------------------------------------------------------
# chunk encode / decode (v1.rs:451-610)
# ---------------------------------------------------------------------------

def encode_fixed(items, func) -> bytes:
    if not items:
        return b""
    uncompressed = b"".join(func(i) for i in items)
    return _prepend_hash(_compress(uncompressed))


def decode_fixed(data: bytes, func, size: int, name: str) -> list:
    if not data:
        return []
    verified = _verify_hash(data)
    if verified is None:
        raise IOError(f"Corrupted {name}")
    decompressed = _decompress(verified)
    n = len(decompressed) // size
    return [func(decompressed[i * size : (i + 1) * size]) for i in range(n)]


def encode_dynamic(items, func) -> bytes:
    if not items:
        return b""
    out = bytearray(struct.pack("<H", len(items)))
    for item in items:
        encoded = func(item)
        out += struct.pack("<I", len(encoded))
        out += encoded
    return _prepend_hash(_compress(bytes(out)))


def decode_dynamic(data: bytes, func, name: str) -> list:
    if not data:
        return []
    verified = _verify_hash(data)
    if verified is None:
        raise IOError(f"Corrupted chunk: {name}")
    decompressed = _decompress(verified)
    retval = []
    index = 2
    while index < len(decompressed):
        (encoded_len,) = struct.unpack_from("<I", decompressed, index)
        index += 4
        retval.append(func(decompressed[index : index + encoded_len]))
        index += encoded_len
    return retval


def encode_textures(items) -> bytes:
    if not items:
        return b""
    out = bytearray(struct.pack("<H", len(items)))
    for texture in items:
        encoded = texture_to_bytes(texture)
        out += struct.pack("<I", len(encoded))
        out += encoded
    # textures are already compressed (PNG per mip), no outer xz layer
    return _prepend_hash(bytes(out))


def decode_textures(data: bytes) -> list:
    if not data:
        return []
    verified = _verify_hash(data)
    if verified is None:
        raise IOError("Corrupted textures")
    retval = []
    index = 2
    while index < len(verified):
        (encoded_len,) = struct.unpack_from("<I", verified, index)
        index += 4
        retval.append(bytes_to_texture(verified[index : index + encoded_len]))
        index += encoded_len
    return retval


# vertices use a fast-path bulk codec (identical bytes to the per-item one)
def encode_vertices(vertices) -> bytes:
    if not vertices:
        return b""
    return _prepend_hash(_compress(vertices_to_bytes(vertices)))


def decode_vertices(data: bytes) -> list:
    if not data:
        return []
    verified = _verify_hash(data)
    if verified is None:
        raise IOError("Corrupted Vertex")
    return bytes_to_vertices(_decompress(verified))


def decode_vertices_np(data: bytes):
    """Bulk vertex decode: ``(vv (N,3), vn (N,3), vt (N,2))`` float32
    arrays, skipping per-vertex object construction (scene flatten only
    needs the arrays; 141k Vertex dataclasses cost ~1.3 s host time)."""
    if not data:
        z = np.zeros((0, 3), np.float32)
        return z, z.copy(), np.zeros((0, 2), np.float32)
    verified = _verify_hash(data)
    if verified is None:
        raise IOError("Corrupted Vertex")
    raw = _decompress(verified)
    n = len(raw) // 32
    arr = np.frombuffer(raw, dtype="<f4", count=n * 8).reshape(n, 8)
    return (np.ascontiguousarray(arr[:, 0:3]),
            np.ascontiguousarray(arr[:, 3:6]),
            np.ascontiguousarray(arr[:, 6:8]))


# ---------------------------------------------------------------------------
# offsets table + file level logic
# ---------------------------------------------------------------------------

class OffsetsTable:
    def __init__(self):
        self.next_chunk = 0
        self.chunks: dict[int, tuple[int, int]] = {}

    @staticmethod
    def seek_and_parse(f) -> "OffsetsTable":
        f.seek(HEADER_LEN)
        expected_hash = struct.unpack("<Q", f.read(HASH_SIZE))[0]
        first = f.read(1)
        if len(first) != 1:
            raise IOError("Corrupted file structure")
        chunks_no = first[0]
        rest = f.read(chunks_no * _SERIALIZED_CHUNK_LEN)
        buffer = first + rest
        if _hash(buffer) != expected_hash:
            raise IOError("Corrupted file structure")
        tab = OffsetsTable()
        for i in range(chunks_no):
            off = 1 + i * _SERIALIZED_CHUNK_LEN
            cid = buffer[off]
            offset, length = struct.unpack_from("<QQ", buffer, off + 1)
            if cid in _KNOWN_CHUNKS:
                tab.next_chunk = offset + length
                tab.chunks[cid] = (offset, length)
        return tab

    def as_bytes(self) -> bytes:
        chunks_no = len(self.chunks)
        mylen = HASH_SIZE + 1 + chunks_no * _SERIALIZED_CHUNK_LEN
        body = bytearray()
        body.append(chunks_no)
        for cid, (offset, length) in self.chunks.items():
            body.append(cid)
            adjusted = HEADER_LEN + mylen + offset
            body += struct.pack("<QQ", adjusted, length)
        return struct.pack("<Q", _hash(bytes(body))) + bytes(body)

    def set_offset(self, cid: int, length: int):
        if length > 0:
            self.chunks[cid] = (self.next_chunk, length)
            self.next_chunk += length


def write_chunks(f, chunks: list[tuple[int, bytes]]):
    tab = OffsetsTable()
    for cid, data in chunks:
        tab.set_offset(cid, len(data))
    f.seek(HEADER_LEN)
    f.write(tab.as_bytes())
    for _, data in chunks:
        f.write(data)


def serialize_v1(
    f, vertices, meshes, transforms, instances, cameras, textures, materials,
    lights, meta,
):
    chunks = [
        (CHUNK_VERTEX, encode_vertices(vertices)),
        (CHUNK_MESH, encode_dynamic(meshes, mesh_to_bytes)),
        (CHUNK_CAMERA, encode_fixed(cameras, camera_to_bytes)),
        (CHUNK_TEXTURE, encode_textures(textures)),
        (CHUNK_MATERIAL, encode_dynamic(materials, material_to_bytes)),
        (CHUNK_TRANSFORM, encode_fixed(transforms, transform_to_bytes)),
        (CHUNK_INSTANCE, encode_fixed(instances, instance_to_bytes)),
        (CHUNK_LIGHT, encode_dynamic(lights, light_to_bytes)),
    ]
    if meta is not None:
        chunks.append((CHUNK_META, encode_fixed([meta], meta_to_bytes)))
    write_chunks(f, chunks)


class ContentV1:
    """Random-access parser for a V1 file (v1.rs:208-313)."""

    def __init__(self, path: str, f):
        self._path = str(path)
        self._file = f
        self._offsets = OffsetsTable.seek_and_parse(f)

    def _read_chunk(self, cid: int) -> bytes:
        entry = self._offsets.chunks.get(cid)
        if entry is None:
            return b""
        offset, length = entry
        self._file.seek(offset)
        return self._file.read(length)

    # -- accessors ----------------------------------------------------------
    def vertices(self):
        return decode_vertices(self._read_chunk(CHUNK_VERTEX))

    def vertices_np(self):
        """(positions, normals, uvs) arrays; see decode_vertices_np."""
        return decode_vertices_np(self._read_chunk(CHUNK_VERTEX))

    def meshes(self):
        return decode_dynamic(self._read_chunk(CHUNK_MESH), bytes_to_mesh, "Mesh")

    def transforms(self):
        return decode_fixed(
            self._read_chunk(CHUNK_TRANSFORM), bytes_to_transform, 64, "Transform"
        )

    def instances(self):
        return decode_fixed(
            self._read_chunk(CHUNK_INSTANCE), bytes_to_instance, 4, "Instance"
        )

    def cameras(self):
        return decode_fixed(
            self._read_chunk(CHUNK_CAMERA), bytes_to_camera, 49, "Camera"
        )

    def textures(self):
        return decode_textures(self._read_chunk(CHUNK_TEXTURE))

    def materials(self):
        return decode_dynamic(
            self._read_chunk(CHUNK_MATERIAL), bytes_to_material, "Material"
        )

    def lights(self):
        return decode_dynamic(self._read_chunk(CHUNK_LIGHT), bytes_to_light, "Light")

    def meta(self):
        metas = decode_fixed(self._read_chunk(CHUNK_META), bytes_to_meta, 20, "Meta")
        if not metas:
            raise IOError("No Meta chunk in file")
        return metas[-1]

    def update(self, cameras=None, materials=None, lights=None, textures=None, meta=None):
        """Rewrites the file, replacing the given chunk types (v1.rs:364-422)."""
        from benchmark.ref.parser import write_header

        vertices = self._read_chunk(CHUNK_VERTEX)
        meshes = self._read_chunk(CHUNK_MESH)
        transforms = self._read_chunk(CHUNK_TRANSFORM)
        instances = self._read_chunk(CHUNK_INSTANCE)
        meta_b = (
            encode_fixed([meta], meta_to_bytes)
            if meta is not None
            else self._read_chunk(CHUNK_META)
        )
        cameras_b = (
            encode_fixed(cameras, camera_to_bytes)
            if cameras is not None
            else self._read_chunk(CHUNK_CAMERA)
        )
        materials_b = (
            encode_dynamic(materials, material_to_bytes)
            if materials is not None
            else self._read_chunk(CHUNK_MATERIAL)
        )
        lights_b = (
            encode_dynamic(lights, light_to_bytes)
            if lights is not None
            else self._read_chunk(CHUNK_LIGHT)
        )
        textures_b = (
            encode_textures(textures)
            if textures is not None
            else self._read_chunk(CHUNK_TEXTURE)
        )
        self._file.close()
        with open(self._path, "wb") as fout:
            write_header(fout)
            chunks = [
                (CHUNK_VERTEX, vertices),
                (CHUNK_MESH, meshes),
                (CHUNK_CAMERA, cameras_b),
                (CHUNK_TEXTURE, textures_b),
                (CHUNK_MATERIAL, materials_b),
                (CHUNK_TRANSFORM, transforms),
                (CHUNK_INSTANCE, instances),
                (CHUNK_LIGHT, lights_b),
                (CHUNK_META, meta_b),
            ]
            write_chunks(fout, chunks)
        self._file = open(self._path, "rb")
        self._offsets = OffsetsTable.seek_and_parse(self._file)

    def close(self):
        try:
            self._file.close()
        except Exception:
            pass

"""Scene file parsing and serialization for the ``.glaze`` format.

Port of ``lib/src/parser/mod.rs``: a 16-byte header (5 magic
bytes + version byte + padding) followed by a version-specific body.
Reference scenes load unmodified; files written here load in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAGIC_NUMBER = bytes([0x67, 0x6C, 0x61, 0x7A, 0x65])  # "glaze"
HEADER_LEN = 16


class ParserVersion:
    """Supported format versions (mod.rs:18-47)."""

    V1 = "V1"

    @staticmethod
    def from_byte(byte: int) -> str:
        if byte == 1:
            return ParserVersion.V1
        raise IOError("Unsupported file version")

    @staticmethod
    def from_str(s: str) -> str:
        if s == "V1":
            return ParserVersion.V1
        raise ValueError("Unrecognized parser version")


@dataclass
class Meta:
    """Additional scene information (mod.rs:273-288)."""

    scene_centre: list = field(default_factory=lambda: [0.0, 0.0, 0.0])
    scene_radius: float = 100.0
    exposure: float = 1.0

    def __post_init__(self):
        import numpy as np

        self.scene_centre = [float(np.float32(v)) for v in self.scene_centre]
        self.scene_radius = float(np.float32(self.scene_radius))
        self.exposure = float(np.float32(self.exposure))

    def __eq__(self, other):
        return (
            isinstance(other, Meta)
            and list(self.scene_centre) == list(other.scene_centre)
            and self.scene_radius == other.scene_radius
            and self.exposure == other.exposure
        )


def write_header(f):
    """Writes magic + version, padded to HEADER_LEN (mod.rs:246-251)."""
    f.write(MAGIC_NUMBER)
    f.write(bytes([1]))
    f.write(bytes(HEADER_LEN - len(MAGIC_NUMBER) - 1))


def parse(path):
    """Parses a ``.glaze`` file and returns a :class:`ParsedScene`-like object.

    Raises ``IOError`` for wrong magic, unsupported versions, or corruption
    (mod.rs:93-116). The span ``setup.parse`` times the header and offsets
    read here; the chunks decode where they are read (the flatten's reads
    carry the same span).
    """
    from glaze_tpu_torch.parser.v1 import ContentV1
    from glaze_tpu_torch.utils.runtime import span

    with span("setup.parse"):
        f = open(path, "rb")
        header = f.read(HEADER_LEN)
        if len(header) < HEADER_LEN or header[:5] != MAGIC_NUMBER:
            f.close()
            raise IOError("Wrong or empty input file")
        version = ParserVersion.from_byte(header[5])
        assert version == ParserVersion.V1
        return ContentV1(path, f)


def converted_file(path) -> bool:
    """True if the file is already in a supported format (mod.rs:259-270)."""
    try:
        with open(path, "rb") as f:
            header = f.read(HEADER_LEN)
            return len(header) == HEADER_LEN and header[:5] == MAGIC_NUMBER
    except OSError:
        return False


class Serializer:
    """Builder-style scene writer (mod.rs:130-243)."""

    def __init__(self, file, version: str = ParserVersion.V1):
        self._file = str(file)
        self._version = version
        self._vertices = []
        self._meshes = []
        self._transforms = []
        self._instances = []
        self._cameras = []
        self._textures = []
        self._materials = []
        self._lights = []
        self._meta = None

    def with_vertices(self, vertices):
        self._vertices = vertices
        return self

    def with_meshes(self, meshes):
        self._meshes = meshes
        return self

    def with_transforms(self, transforms):
        self._transforms = transforms
        return self

    def with_instances(self, instances):
        self._instances = instances
        return self

    def with_cameras(self, cameras):
        self._cameras = cameras
        return self

    def with_textures(self, textures):
        self._textures = textures
        return self

    def with_materials(self, materials):
        self._materials = materials
        return self

    def with_lights(self, lights):
        self._lights = lights
        return self

    def with_metadata(self, meta):
        self._meta = meta
        return self

    def serialize(self):
        from glaze_tpu_torch.parser.v1 import serialize_v1

        with open(self._file, "wb") as f:
            write_header(f)
            serialize_v1(
                f,
                self._vertices,
                self._meshes,
                self._transforms,
                self._instances,
                self._cameras,
                self._textures,
                self._materials,
                self._lights,
                self._meta,
            )


class NoScene:
    """Null-object scene: every accessor raises (mod.rs:325-404)."""

    def _unsupported(self, what):
        raise IOError(f"Empty scene has no {what}")

    def vertices(self):
        self._unsupported("vertices")

    def meshes(self):
        self._unsupported("meshes")

    def transforms(self):
        self._unsupported("transforms")

    def instances(self):
        self._unsupported("instances")

    def cameras(self):
        self._unsupported("cameras")

    def textures(self):
        self._unsupported("textures")

    def materials(self):
        self._unsupported("materials")

    def lights(self):
        self._unsupported("lights")

    def meta(self):
        self._unsupported("metadata")

    def update(self, cameras=None, materials=None, lights=None, textures=None, meta=None):
        raise IOError("Empty scene can't be saved")

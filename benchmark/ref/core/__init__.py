# Frozen copy of glaze_tpu_torch/core/__init__.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Device-independent core types (geometry, materials, spectra, parsing)."""

from benchmark.ref.core.camera import Camera, OrthographicCam, PerspectiveCam
from benchmark.ref.core.color import ColorRGB, ColorXYZ
from benchmark.ref.core.distribution import Distribution1D, Distribution2D
from benchmark.ref.core.light import Light, LightType
from benchmark.ref.core.material import Material, MaterialType
from benchmark.ref.core.mesh import Mesh, MeshInstance, Transform, Vertex
from benchmark.ref.core.metal import Metal
from benchmark.ref.core.spectrum import Spectrum
from benchmark.ref.core.texture import Texture, TextureFormat, TextureInfo

__all__ = [
    "Camera", "OrthographicCam", "PerspectiveCam", "ColorRGB", "ColorXYZ",
    "Distribution1D", "Distribution2D", "Light", "LightType", "Material",
    "MaterialType", "Mesh", "MeshInstance", "Transform", "Vertex", "Metal",
    "Spectrum", "Texture", "TextureFormat", "TextureInfo",
]

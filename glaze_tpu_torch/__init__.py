"""glaze_tpu_torch: the spectral path tracer of ``glaze_tpu``, ported to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``glaze_tpu``'s layout module for module. It imports
torch, never JAX, and nothing of ``glaze_tpu``: the host code it needs
(``core``, ``parser``, ``native``, the importers, the work scheduler) is
its own copy. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.

The public surface is ``glaze_tpu``'s (lib/src/lib.rs:10-24).
``RayTraceRenderer``, ``Integrator`` and ``RealtimeRenderer`` load on
first use; importing the package does not initialise CUDA.
"""

from glaze_tpu_torch.core import (
    Camera,
    ColorRGB,
    ColorXYZ,
    Distribution1D,
    Distribution2D,
    Light,
    LightType,
    Material,
    MaterialType,
    Mesh,
    MeshInstance,
    Metal,
    OrthographicCam,
    PerspectiveCam,
    Spectrum,
    Texture,
    TextureFormat,
    TextureInfo,
    Transform,
    Vertex,
)
from glaze_tpu_torch.instance import DeviceInfo, PresentInstance, RayTraceInstance
from glaze_tpu_torch.parser import (
    Meta,
    NoScene,
    ParserVersion,
    Serializer,
    converted_file,
    parse,
)

__version__ = "0.1.0"

__all__ = [
    "Camera", "OrthographicCam", "PerspectiveCam", "ColorRGB", "ColorXYZ",
    "Distribution1D", "Distribution2D", "Light", "LightType", "Material",
    "MaterialType", "Mesh", "MeshInstance", "Metal", "Spectrum", "Texture",
    "TextureFormat", "TextureInfo", "Transform", "Vertex",
    "Meta", "NoScene", "ParserVersion", "Serializer", "converted_file", "parse",
    "RayTraceRenderer", "Integrator", "RealtimeRenderer",
    "DeviceInfo", "PresentInstance", "RayTraceInstance",
]


def __getattr__(name):
    # the renderers pull in the integrator and the kernels' wrappers: load
    # them on first use
    if name in ("RayTraceRenderer", "Integrator"):
        from glaze_tpu_torch.render.renderer import Integrator, RayTraceRenderer

        return {"RayTraceRenderer": RayTraceRenderer, "Integrator": Integrator}[name]
    if name == "RealtimeRenderer":
        from glaze_tpu_torch.render.realtime import RealtimeRenderer

        return RealtimeRenderer
    raise AttributeError(name)

"""RayTraceRenderer: the offline progressive path tracer (torch).

Port of the main-path surface of :mod:`glaze_tpu.render.renderer`
(``RayTraceRenderer::{new, draw, set_integrator, set_exposure,
update_camera}``, raytracer.rs:153-687). ``draw(spp)`` runs
``spp * steps_per_sample`` launches as a Python loop; launch seeds come
from the host ``np.random.default_rng(seed)`` in the same chunks as the
JAX package, so both packages draw the same seeds for the same ``seed``.

Scenes with opacity maps render with one alpha re-test round
(``alpha_rounds``, the JAX package's default ``GLAZE_ALPHA_ROUNDS=1``),
set at construction from the materials; without opacity maps it is 0.

Not ported in this slice: checkpoints, device meshes, the display
denoiser, material / light edits (``update_materials_and_lights`` and its
opaque/alpha split rebuild), the ``ld`` sampler, adaptive sampling and
more than one sample in flight per pixel (the integrator raises
NotImplementedError for the last three).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import torch

from glaze_tpu_torch.core import Camera
from glaze_tpu_torch.device import resolve_device
from glaze_tpu_torch.render import integrator as integ
from glaze_tpu_torch.render.scheduler import WorkScheduler


class Integrator(enum.Enum):
    """Available integrators (raytracer.rs:36-53)."""

    DIRECT = "direct"
    PATH_TRACE = "pt"

    @property
    def steps_per_sample(self) -> int:
        """Launches per sample (raytracer.rs:80-86)."""
        return 1 if self is Integrator.DIRECT else integ.PT_STEPS

    @property
    def name_str(self) -> str:
        return "Direct light only" if self is Integrator.DIRECT else "Path tracing"


# alpha re-test rounds when some material has an opacity map: one, the
# JAX package's default (a second stacked MIXED-transparent layer along one
# segment is treated opaque)
ALPHA_ROUNDS = 1

# launches per chunk of draw(); seeds are drawn per chunk exactly like the
# JAX package's lax.scan chunks, so the seed streams line up
_CHUNK = 32


def _chunk_sizes(total: int):
    """Equal power-of-two chunks: the largest c <= _CHUNK dividing
    ``total``, repeated."""
    if total <= 0:
        return []
    c = _CHUNK
    while c > 1 and (c > total or total % c):
        c >>= 1
    return [c] * (total // c)


class RayTraceRenderer:
    """Progressive spectral path tracer over a DeviceScene."""

    def __init__(self, scene, camera=None, width: int = 1920, height: int = 1080,
                 integrator: Integrator = Integrator.PATH_TRACE, seed=None,
                 coherent=None, device=None):
        """``scene``: a DeviceScene (used on its own device) or a
        ParsedScene (flattened onto ``device``: ``cuda`` unless the caller
        passes ``"cpu"``; CUDA without a card raises). ``coherent``:
        0/'off', 1/'frame' (the default) or 2/'tile' shared-RNG sampling.
        The sampler is pcg with one sample in flight per pixel."""
        from glaze_tpu_torch.scene import DeviceScene, flatten_scene

        self.host = None
        if isinstance(scene, DeviceScene):
            if device is not None and torch.device(device) != scene.device:
                raise ValueError(f"scene lives on {scene.device}, not {device}")
        else:
            scene, parsed_cam, self.host = flatten_scene(
                scene, resolve_device(device))
            if camera is None:
                camera = parsed_cam
        self.scene = scene
        self.device = scene.device
        self.camera = camera if camera is not None else Camera.default()
        self.width = int(width)
        self.height = int(height)
        self.integrator = integrator
        self.exposure: Optional[float] = None  # None = scene meta exposure
        self.coherent = 1 if coherent is None else integ.resolve_coherent(coherent)
        self._rng = np.random.default_rng(seed)
        self._scheduler = WorkScheduler()
        self._state = integ.init_state(self.width, self.height, self.device)
        self._request_new_frame = True
        # ALPHA_ROUNDS when some material has an opacity map, else 0
        from glaze_tpu_torch.scene.flatten import MT_OPACITY

        has_opacity = bool(self.scene.mat_tex[:, MT_OPACITY].any())
        self._alpha_rounds = ALPHA_ROUNDS if has_opacity else 0

    # -- configuration ------------------------------------------------------
    def set_integrator(self, integrator: Integrator):
        """Swaps the integrator; restarts accumulation if it changed
        (raytracer.rs:196-231)."""
        if integrator is not self.integrator:
            self.integrator = integrator
            self._request_new_frame = True

    def set_exposure(self, exposure: float):
        self.exposure = float(exposure)

    def update_camera(self, camera: Camera):
        """Restarts progressive accumulation (raytracer.rs update_camera)."""
        self.camera = camera
        self._request_new_frame = True

    # -- rendering ------------------------------------------------------------
    def _maybe_restart(self):
        if self._request_new_frame:
            self._request_new_frame = False
            self._scheduler.rewind()
            self._state = integ.init_state(self.width, self.height, self.device)

    def draw(self, spp: int, callback: Optional[Callable[[int], None]] = None,
             return_image: bool = True):
        """Blocking render of ``spp`` samples/pixel; returns (H, W, 3) uint8
        (or None with ``return_image=False``). ``callback(launches_done)``
        fires after each chunk of launches."""
        self._maybe_restart()
        c2w, s2c = integ.camera_matrices(self.camera, self.width, self.height)
        total = spp * self.integrator.steps_per_sample
        done = 0
        for n in _chunk_sizes(total):
            seeds = self._rng.integers(0, 2**32, size=n, dtype=np.uint32)
            offsets = self._scheduler.take(n)
            self._state = integ.render_steps(
                self.scene, self._state, seeds, offsets, c2w, s2c,
                width=self.width, height=self.height,
                is_persp=self.camera.is_perspective,
                direct_only=self.integrator is Integrator.DIRECT,
                steps=n, alpha_rounds=self._alpha_rounds,
                coherent=self.coherent)
            done += n
            if callback is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                callback(done)
        if not return_image:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return None
        return self.get_image()

    def get_image(self) -> np.ndarray:
        """Current progressive result as (H, W, 3) uint8 sRGB."""
        exposure = (self.exposure if self.exposure is not None
                    else self.scene.exposure)
        return integ.render_image(self._state, exposure, self.width,
                                  self.height)

    def save(self, path: str):
        from PIL import Image

        Image.fromarray(self.get_image()).save(path)

    @property
    def completed_spp(self) -> int:
        """Samples/pixel accumulated so far."""
        count = int(self._state.count.max().item())
        return count // self.integrator.steps_per_sample

"""RayTraceRenderer: the offline progressive path tracer (torch).

Port of the main-path surface of :mod:`glaze_tpu.render.renderer`
(``RayTraceRenderer::{new, draw, set_integrator, set_exposure,
update_camera}``, raytracer.rs:153-687). ``draw(spp)`` runs
``spp * steps_per_sample`` launches as a Python loop; launch seeds come
from the host ``np.random.default_rng(seed)`` in the same chunks as the
JAX package, so both packages draw the same seeds for the same ``seed``.

Scenes with opacity maps render with ``GLAZE_ALPHA_ROUNDS`` alpha re-test
rounds (one by default, as in the JAX package), set at construction from
the materials; without opacity maps it is 0. The coherent mode follows
the JAX package's precedence: the ``coherent`` argument, else
``GLAZE_COHERENT``, else 1 (frame).

Not ported in this slice: checkpoints, device meshes, the display
denoiser, material / light edits (``update_materials_and_lights`` and its
opaque/alpha split rebuild), the ``ld`` sampler, adaptive sampling and
more than one sample in flight per pixel. The renderer raises
NotImplementedError for the last three, whether an argument or the JAX
package's ``GLAZE_SAMPLER``, ``GLAZE_ADAPTIVE`` or ``GLAZE_SIF`` asks for
them.
"""

from __future__ import annotations

import enum
import os
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


def alpha_rounds() -> int:
    """Alpha re-test rounds when some material has an opacity map:
    ``GLAZE_ALPHA_ROUNDS``, else one, the JAX package's default (a second
    stacked MIXED-transparent layer along one segment is treated
    opaque)."""
    return int(os.environ.get("GLAZE_ALPHA_ROUNDS", "1"))


def default_coherent() -> int:
    """The offline coherent mode: ``GLAZE_COHERENT`` (0/1/2 or
    off/frame/tile) where it is set, else 1 (frame), as the JAX package's
    ``default_coherent``."""
    env = os.environ.get("GLAZE_COHERENT")
    if env not in (None, ""):
        return integ.resolve_coherent(int(env) if env.isdigit() else env)
    return 1


def check_sampling(samples_in_flight=None, sampler=None, adaptive=None):
    """Refuses the sampling options that are not ported, taken with the
    JAX package's precedence: an argument, else ``GLAZE_SIF`` /
    ``GLAZE_SAMPLER`` / ``GLAZE_ADAPTIVE``, else 1 / pcg / off. Raises
    ValueError where the JAX package does, and NotImplementedError,
    naming the variable when one asked for it, for anything but one
    sample in flight, pcg and no adaptive stopping."""
    source = {}  # option -> the variable setting it was read from
    if samples_in_flight is None:
        samples_in_flight = os.environ.get("GLAZE_SIF", "1")
        source["sif"] = f"GLAZE_SIF={samples_in_flight}"
    if sampler is None:
        sampler = os.environ.get("GLAZE_SAMPLER", "pcg")
        source["sampler"] = f"GLAZE_SAMPLER={sampler}"
    if adaptive is None:
        adaptive = os.environ.get("GLAZE_ADAPTIVE", "0")
        source["adaptive"] = f"GLAZE_ADAPTIVE={adaptive}"
        adaptive = int(adaptive)
    if sampler not in ("pcg", "ld"):
        raise ValueError(f"sampler {sampler!r}: expected pcg or ld")
    if int(samples_in_flight) < 1:
        raise ValueError("samples_in_flight must be >= 1")
    for key, what, ported in (
            ("sif", "samples in flight > 1", int(samples_in_flight) == 1),
            ("sampler", f"sampler {sampler!r}", sampler == "pcg"),
            ("adaptive", "adaptive sampling", not adaptive)):
        if not ported:
            if key in source:
                what = f"{what} (from {source[key]})"
            raise NotImplementedError(f"{what} is not yet ported to "
                                      "glaze_tpu_torch")


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
                 coherent=None, device=None, samples_in_flight=None,
                 sampler=None, adaptive=None):
        """``scene``: a DeviceScene (used on its own device) or a
        ParsedScene (flattened onto ``device``: ``cuda`` unless the caller
        passes ``"cpu"``; CUDA without a card raises). ``coherent``:
        0/'off', 1/'frame' or 2/'tile' shared-RNG sampling (default:
        :func:`default_coherent`). ``samples_in_flight``, ``sampler`` and
        ``adaptive`` are the JAX package's options; only one sample in
        flight, pcg and no adaptive stopping are ported, and anything else,
        by argument or by environment, raises NotImplementedError
        (:func:`check_sampling`)."""
        from glaze_tpu_torch.scene import DeviceScene, flatten_scene

        check_sampling(samples_in_flight, sampler, adaptive)
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
        self.coherent = (default_coherent() if coherent is None
                         else integ.resolve_coherent(coherent))
        self._rng = np.random.default_rng(seed)
        self._scheduler = WorkScheduler()
        self._state = integ.init_state(self.width, self.height, self.device)
        self._request_new_frame = True
        # alpha_rounds() when some material has an opacity map, else 0
        from glaze_tpu_torch.scene.flatten import MT_OPACITY

        has_opacity = bool(self.scene.mat_tex[:, MT_OPACITY].any())
        self._alpha_rounds = alpha_rounds() if has_opacity else 0

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

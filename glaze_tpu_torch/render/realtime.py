"""RealtimeRenderer: interactive progressive rendering (torch port of
:mod:`glaze_tpu.render.realtime`).

The reference's ``RealtimeRenderer`` (renderer.rs:90-545) presents to a
swapchain; here it owns a :class:`RayTraceRenderer` (built with
``interactive=True``, so the coherent mode defaults to tile), advances it
by one launch per ``draw_frame`` and hands each frame to a presenter
callback. Material, light and texture edits rebuild the device tables and
restart the accumulation; camera moves restart it; ``save``/``save_as``
rewrite the scene file (scene.rs:477-511). ``use_raytracer = False``
switches ``draw_frame`` to the flat preview
(:mod:`glaze_tpu_torch.render.preview`), the reference's raster forward
pass and skydome (renderer.rs:561-655).

Pipelined frames (``draw_frame(pipelined=True)``) keep
``FRAMES_IN_FLIGHT`` launches in flight and present the oldest. Each
frame is unswizzled and cropped on its device right behind its launch,
and on ``cuda`` copied asynchronously into pinned host memory with an
event after the copy; presenting the oldest frame waits for its event
only, not for the newer launches queued behind it. (Unswizzling on the
host at present time instead gathers every 3-byte lane on the thread
that dispatches the launches; ``chip_smoke.py``'s ``[interactive]``
times that gather.)
"""

from __future__ import annotations

import copy
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from glaze_tpu_torch.core import (Camera, LightType, Texture, TextureFormat,
                                  TextureInfo)
from glaze_tpu_torch.render import integrator as integ
from glaze_tpu_torch.render.preview import FlatPreviewRenderer
from glaze_tpu_torch.render.renderer import Integrator, RayTraceRenderer
from glaze_tpu_torch.utils.runtime import count, span, traced

# launches in flight before a frame is presented (vulkan/mod.rs:38)
FRAMES_IN_FLIGHT = 2
_TEX_SLOTS = ("diffuse", "roughness", "metalness", "opacity", "normal")


class FrameStats:
    """fps over a window of at least one second (renderer.rs:733-775)."""

    def __init__(self):
        self._window_start = time.perf_counter()
        self._frames = 0
        self.fps = 0.0

    def tick(self):
        self._frames += 1
        now = time.perf_counter()
        dt = now - self._window_start
        if dt >= 1.0:
            self.fps = self._frames / dt
            self._frames = 0
            self._window_start = now


def _to_host_async(img):
    """(host tensor, event): on ``cuda`` an asynchronous copy of ``img``
    into pinned memory and the event recorded after it; on the CPU the
    tensor itself and None."""
    if img.device.type != "cuda":
        return img, None
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    host.copy_(img, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _unswizzle(img, width, height):
    """A frame's display as the (H, W, 3) image on its device: denoised
    frames arrive as (ph, pw, 3) images, the others as (P', 3) lanes in
    the swizzled order."""
    if img.dim() == 3:
        return img[:height, :width]
    return integ.unswizzle(img, width, height)


class RealtimeRenderer:
    """Interactive progressive renderer with live scene edits, on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""

    def __init__(self, parsed, width: int = 800, height: int = 600,
                 render_scale: float = 1.0,
                 presenter: Optional[Callable[[np.ndarray], None]] = None,
                 seed=None, coherent=None, device=None):
        self._parsed = parsed
        self.render_scale = float(render_scale)
        self.width = int(width)
        self.height = int(height)
        self.use_raytracer = True
        self.presenter = presenter
        self.stats = FrameStats()
        # frames not yet presented: (host image, event of its copy)
        self._inflight = deque()
        self._inflight_src = None  # the renderer the in-flight frames are of
        self._rt = RayTraceRenderer(
            parsed, width=self._scaled(self.width),
            height=self._scaled(self.height),
            integrator=Integrator.PATH_TRACE, seed=seed, coherent=coherent,
            device=device, interactive=True)
        self._preview = self._new_preview()

    def _new_preview(self):
        return FlatPreviewRenderer(self._rt.scene, camera=self._rt.camera,
                                   width=self._rt.width,
                                   height=self._rt.height, host=self._rt.host)

    def _scaled(self, v: int) -> int:
        return max(1, int(v * self.render_scale))

    @property
    def device(self):
        return self._rt.device

    # -- the reference's API surface (renderer.rs) ---------------------------
    def camera(self) -> Camera:
        return self._rt.camera

    def set_camera(self, camera: Camera):
        self._rt.update_camera(camera)
        self._preview.update_camera(camera)

    def set_render_scale(self, scale: float):
        """Resizes the render targets (renderer.rs:283-315)."""
        self.render_scale = float(scale)
        w, h = self._scaled(self.width), self._scaled(self.height)
        self._rt.change_resolution(w, h)
        self._preview.change_resolution(w, h)

    def update_render_size(self, width: int, height: int):
        self.width, self.height = int(width), int(height)
        self.set_render_scale(self.render_scale)

    def _edited(self):
        """The preview follows the renderer's tables after an edit."""
        self._preview.scene = self._rt.scene
        self._preview.host = self._rt.host
        self._preview._request_new_frame = True

    def change_material(self, mat_id: int, material):
        """Live material edit (renderer.rs:368 -> scene.rs:232-321)."""
        mats = list(self._rt.host.materials)
        mats[mat_id] = material
        self._rt.update_materials_and_lights(mats, self._rt.host.lights)
        self._edited()

    def update_light(self, light_id: int, light):
        """Live light edit; an id past the end appends (ui.rs lights
        editor)."""
        lights = list(self._rt.host.lights)
        if light_id < len(lights):
            lights[light_id] = light
        else:
            lights.append(light)
        self._rt.update_materials_and_lights(self._rt.host.materials, lights)
        self._edited()

    def remove_light(self, light_id: int):
        lights = list(self._rt.host.lights)
        del lights[light_id]
        self._rt.update_materials_and_lights(self._rt.host.materials, lights)
        self._edited()

    def materials(self):
        return self._rt.host.materials

    def lights(self):
        return self._rt.host.lights

    # texture edits (the ui.rs textures window: add, remove, format)
    def textures(self):
        return self._rt.host.textures

    def _texture_users(self, tex_id: int):
        """Materials (by slot) and sky lights that reference ``tex_id``."""
        users = [f"material {i} {slot}"
                 for i, m in enumerate(self._rt.host.materials)
                 for slot in _TEX_SLOTS if getattr(m, slot) == tex_id]
        users += [f"light {i} sky" for i, l in enumerate(self._rt.host.lights)
                  if l.ltype == LightType.SKY and int(l.resource_id) == tex_id]
        return users

    def add_texture(self, texture) -> int:
        """Appends a texture; returns its id."""
        texs = list(self._rt.host.textures) + [texture]
        self._rt.update_textures(texs)
        self._edited()
        return len(texs) - 1

    def remove_texture(self, tex_id: int):
        """Removes a texture. Refuses while one is referenced (the UI
        disables remove for textures in use); later ids shift down and
        every material and sky reference is remapped."""
        if tex_id <= 0:
            raise ValueError("texture 0 is the built-in default")
        users = self._texture_users(tex_id)
        if users:
            raise ValueError(f"texture {tex_id} in use by: {', '.join(users)}")
        texs = list(self._rt.host.textures)
        del texs[tex_id]

        def remap(v):
            return v - 1 if v > tex_id else v

        mats = []
        for m in self._rt.host.materials:
            m2 = copy.copy(m)
            for slot in _TEX_SLOTS:
                setattr(m2, slot, remap(getattr(m, slot)))
            mats.append(m2)
        lights = []
        for l in self._rt.host.lights:
            l2 = copy.copy(l)
            if l2.ltype == LightType.SKY:
                l2.resource_id = remap(int(l2.resource_id))
            lights.append(l2)
        self._rt.update_textures(texs)
        self._rt.update_materials_and_lights(mats, lights)
        self._edited()

    def set_texture_format(self, tex_id: int, fmt):
        """Reinterprets a texture's pixel format (the UI's format
        dropdown): Gray <-> RGBA re-encode the data, sRGB <-> linear keep
        the bytes."""
        texs = list(self._rt.host.textures)
        t = texs[tex_id]
        if fmt == t.info.format:
            return
        data = []
        for mip in t.data:
            if fmt == TextureFormat.Gray and mip.ndim == 3:
                lum = (0.299 * mip[..., 0] + 0.587 * mip[..., 1]
                       + 0.114 * mip[..., 2])
                data.append(lum.astype(np.uint8))
            elif fmt != TextureFormat.Gray and mip.ndim == 2:
                rgba = np.empty(mip.shape + (4,), np.uint8)
                rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = mip
                rgba[..., 3] = 255
                data.append(rgba)
            else:
                data.append(mip)
        texs[tex_id] = Texture(
            TextureInfo(t.info.name, t.info.width, t.info.height, fmt), data)
        self._rt.update_textures(texs)
        self._edited()

    # camera controls forward to Camera (camera.rs:182-281)
    def strafe(self, m: float):
        self._rt.camera.strafe(m)
        self.set_camera(self._rt.camera)

    def advance(self, m: float):
        self._rt.camera.advance(m)
        self.set_camera(self._rt.camera)

    def elevate(self, m: float):
        self._rt.camera.elevate(m)
        self.set_camera(self._rt.camera)

    def look_around(self, theta: float, phi: float):
        self._rt.camera.look_around(theta, phi)
        self.set_camera(self._rt.camera)

    def change_scene(self, parsed, camera=None):
        """Full scene swap (the background load's completion, ui.rs:1101+):
        the upload and the tree build run here, on the caller's thread.
        ``parsed`` is any ParsedScene duck type, e.g. a
        :class:`glaze_tpu_torch.loader.PreloadedScene`."""
        self._parsed = parsed
        self._inflight.clear()
        self._rt.change_scene(parsed, camera=camera)
        self._preview = self._new_preview()

    # -- the frame loop -------------------------------------------------------
    @traced("frame")
    def draw_frame(self, pipelined: bool = False) -> np.ndarray:
        """One progressive launch and its present (renderer.rs:415-545).

        ``pipelined=True`` keeps FRAMES_IN_FLIGHT launches in flight and
        presents the oldest (two frames of display latency); a toggle
        between the path tracer and the preview drops the other one's
        frames. The default presents the launch it just issued.

        The span ``frame`` (the counter ``frame.presented``); pipelined,
        ``frame.copy`` (the unswizzle and the copy to the host, issued) and
        ``frame.present_wait`` (the wait for the presented frame's copy)."""
        active = self._rt if self.use_raytracer else self._preview
        if pipelined:
            if self._inflight_src is not active:
                self._inflight.clear()
                self._inflight_src = active
            img = active.draw_frame(return_image=True)
            with span("frame.copy"):
                self._inflight.append(_to_host_async(
                    _unswizzle(img, active.width, active.height).contiguous()))
            if len(self._inflight) > FRAMES_IN_FLIGHT:
                host, event = self._inflight.popleft()
            else:  # warm-up: present the oldest and keep it in flight
                host, event = self._inflight[0]
            with span("frame.present_wait"):
                if event is not None:
                    event.synchronize()
            frame = host.numpy()
        else:
            self._inflight.clear()
            active.draw_frame()
            frame = active.get_image()
        count("frame.presented")
        self.stats.tick()
        if self.presenter is not None:
            self.presenter(frame)
        return frame

    @property
    def denoise(self) -> bool:
        """The display-only denoiser on the path-traced frames (spatial,
        and temporal in pipelined frames); the accumulation stays raw."""
        return self._rt.denoise

    @denoise.setter
    def denoise(self, on: bool):
        self._rt.denoise = bool(on)

    @property
    def coherent(self) -> int:
        """The path tracer's coherent mode (0 off, 1 frame, 2 tile; tile
        by default); in-flight frames of the old mode are still
        presented."""
        return self._rt.coherent

    @coherent.setter
    def coherent(self, mode):
        self._rt.coherent = integ.resolve_coherent(mode)

    def get_image(self) -> np.ndarray:
        active = self._rt if self.use_raytracer else self._preview
        return active.get_image()

    # -- persistence (scene.rs:477-511) ---------------------------------------
    def save(self):
        """In-place scene update (ParsedScene::update)."""
        host = self._rt.host
        self._parsed.update(cameras=[self._rt.camera],
                            materials=host.materials, lights=host.lights,
                            meta=host.meta)

    def save_as(self, path: str):
        from glaze_tpu_torch.parser import Serializer

        host = self._rt.host
        (Serializer(path)
         .with_vertices(self._parsed.vertices())
         .with_meshes(self._parsed.meshes())
         .with_transforms(self._parsed.transforms())
         .with_instances(self._parsed.instances())
         .with_cameras([self._rt.camera])
         .with_textures(host.textures)
         .with_materials(host.materials)
         .with_lights(host.lights)
         .with_metadata(host.meta)
         .serialize())

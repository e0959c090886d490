"""RayTraceRenderer: the progressive path tracer (torch).

Port of :mod:`glaze_tpu.render.renderer` (``RayTraceRenderer::{new,
draw, draw_frame, set_integrator, set_exposure, update_camera,
update_materials_and_lights, change_resolution, change_scene}``,
raytracer.rs:153-687, ``update_textures`` and the checkpoints).
``draw(spp)`` runs ``ceil(spp * steps_per_sample / sif)`` launches as a
Python loop; launch seeds come from the host
``np.random.default_rng(seed)`` in the same chunks as the JAX package, so
both packages draw the same seeds for the same ``seed``.

Scenes with opacity maps render with ``GLAZE_ALPHA_ROUNDS`` alpha re-test
rounds (one by default, as in the JAX package), set from the materials at
construction and after every edit; without opacity maps it is 0. The
coherent mode follows the JAX package's precedence: the ``coherent``
argument, else ``GLAZE_COHERENT``, else 2 (tile) for an ``interactive``
renderer and 1 (frame) otherwise. The sampling options
follow it too: ``samples_in_flight`` (else ``GLAZE_SIF``, else 1),
``sampler`` (else ``GLAZE_SAMPLER``, else pcg) and ``adaptive`` (else
``GLAZE_ADAPTIVE``, else off, with ``GLAZE_ADAPTIVE_TAU`` and
``GLAZE_ADAPTIVE_MIN``).

``save_checkpoint`` / ``load_checkpoint`` write and read the JAX package's
``.npz`` layout key for key, so a checkpoint crosses between the packages
either way.

``denoise`` sends ``get_image`` (and so ``save``) through the display
denoiser (:mod:`glaze_tpu_torch.render.denoise`), whose G-buffer is cached
until the camera, scene, resolution or alpha rounds change, or an edit;
the accumulation state, and so any checkpoint, stays raw.

Scene edits (``update_materials_and_lights``, ``update_textures``,
``change_scene``) replace the device tables in place and restart the
accumulation. An edit that changes what the opaque/alpha split is built
from rebuilds it on the host and uploads it as ``flatten_scene`` does,
re-baking the cell masks into a classic main tree: a material edit that
adds, removes or retargets an opacity map, and a texture edit in a scene
with opacity maps (the split classifies the opacity texels, and its
alpha-test rows hold atlas offsets).

With ``GLAZE_DEBUG`` on (:func:`glaze_tpu_torch.utils.setup_debug_modes`)
``draw`` checks the state for NaN after every launch and raises
``FloatingPointError`` naming the launch and the leaf.

``draw_frame`` is the interactive path: one launch a call, and with
``return_image`` the frame's display on the device (the raw sRGB lanes,
or with ``denoise`` the spatial or, with ``temporal``, the temporal
denoised image, whose history every edit, resolution change and scene
change drops).

``mesh`` (a :class:`glaze_tpu_torch.parallel.mesh.Mesh`, or ``"auto"``
for every visible CUDA device, the renderer's device on the CPU) makes
``draw`` render with the pixel axis split over the mesh's slots
(:func:`glaze_tpu_torch.parallel.mesh.render_steps_sharded`); the state
is split at the start of each ``draw`` and joined on the renderer's
device after each chunk of launches, so everything else (the adaptive
mask, images, checkpoints, which a mesh render and an unsharded one read
and resume alike) sees the unsharded layout. It needs one sample in
flight and a lane count that divides by the slot count; ``draw_frame``
ignores the mesh, as in the JAX package.

When several processes render one image
(:mod:`glaze_tpu_torch.parallel.distributed`), a renderer over a mesh
holds and renders only its process's lanes
(:func:`~glaze_tpu_torch.parallel.distributed.local_pixel_slice`), and
``"auto"`` is the renderer's own device. ``load_checkpoint`` reads the
whole image and keeps those lanes; the whole state, for an image or a
checkpoint, is :func:`~glaze_tpu_torch.parallel.distributed.gather_state`
of ``_state`` on every rank. Adaptive stopping then needs each process's
lanes to be whole tiles.
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
from glaze_tpu_torch.utils.log import get_logger
from glaze_tpu_torch.utils.runtime import check_nans, count, debug_nans, span

log = get_logger("renderer")

# a checkpoint's PathState leaves are in the order of the JAX package's
# jax.tree.flatten: importance, origin x3, direction x3, bounce,
# last_specular, accum x3, count, path_no (uint32 on disk), sq
PATH_NO_LEAF = 13


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


def default_coherent(interactive: bool = False) -> int:
    """The coherent mode when no argument names one: ``GLAZE_COHERENT``
    (0/1/2 or off/frame/tile) where it is set, else 2 (tile, a noise
    realization per 2048-lane tile) for interactive renders and 1 (frame)
    offline, as the JAX package's ``default_coherent``."""
    env = os.environ.get("GLAZE_COHERENT")
    if env not in (None, ""):
        return integ.resolve_coherent(int(env) if env.isdigit() else env)
    return 2 if interactive else 1


def check_sampling(samples_in_flight=None, sampler=None, adaptive=None):
    """The sampling options with the JAX package's precedence: an
    argument, else ``GLAZE_SIF`` / ``GLAZE_SAMPLER`` / ``GLAZE_ADAPTIVE``,
    else 1 / pcg / off. Returns (samples_in_flight, sampler, adaptive);
    raises ValueError where the JAX package does."""
    if samples_in_flight is None:
        samples_in_flight = os.environ.get("GLAZE_SIF", "1")
    if sampler is None:
        sampler = os.environ.get("GLAZE_SAMPLER", "pcg")
    if adaptive is None:
        adaptive = int(os.environ.get("GLAZE_ADAPTIVE", "0"))
    if sampler not in ("pcg", "ld"):
        raise ValueError(f"sampler {sampler!r}: expected pcg or ld")
    if int(samples_in_flight) < 1:
        raise ValueError("samples_in_flight must be >= 1")
    return int(samples_in_flight), sampler, bool(adaptive)


# launches per chunk of draw(); seeds are drawn per chunk exactly like the
# JAX package's lax.scan chunks, so the seed streams line up
_CHUNK = 32


def _process_lanes(width: int, height: int):
    """This process's share of the lane axis when several processes render
    one image (:func:`~glaze_tpu_torch.parallel.distributed.local_pixel_slice`),
    else None."""
    from glaze_tpu_torch.parallel import distributed

    if distributed.process_count() == 1:
        return None
    return distributed.local_pixel_slice(width, height)


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
                 sampler=None, adaptive=None, interactive: bool = False,
                 mesh=None):
        """``scene``: a DeviceScene (used on its own device) or a
        ParsedScene (flattened onto ``device``: ``cuda`` unless the caller
        passes ``"cpu"``; CUDA without a card raises). ``coherent``:
        0/'off', 1/'frame' or 2/'tile' shared-RNG sampling (default:
        :func:`default_coherent` of ``interactive``).
        ``samples_in_flight``: independent path states per pixel advanced
        per launch; ``sampler``: 'pcg' or 'ld'
        (per-pixel Owen-scrambled Sobol); ``adaptive``: per-tile adaptive
        stopping in ``draw()`` (tiles park once their relative standard
        error is at most ``GLAZE_ADAPTIVE_TAU``, default 0.01, after
        ``GLAZE_ADAPTIVE_MIN`` launches, default 64). Defaults as
        :func:`check_sampling`. ``mesh``: None, ``"auto"`` or a
        :class:`~glaze_tpu_torch.parallel.mesh.Mesh` (see the module
        docstring); with a mesh, samples in flight other than 1 and a
        lane count that does not divide by its size raise."""
        from glaze_tpu_torch.scene import DeviceScene, flatten_scene

        sif, self.sampler, self.adaptive = check_sampling(
            samples_in_flight, sampler, adaptive)
        self.samples_in_flight = sif
        self.adaptive_tau = float(os.environ.get("GLAZE_ADAPTIVE_TAU", "0.01"))
        self.adaptive_min = float(os.environ.get("GLAZE_ADAPTIVE_MIN", "64"))
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
        self.coherent = (default_coherent(interactive) if coherent is None
                         else integ.resolve_coherent(coherent))
        self._mesh = self._check_mesh(mesh)
        self._rng = np.random.default_rng(seed)
        # the ld streams' key, from a generator of its own so the launch
        # seeds stay those of a pcg render
        self._sampler_seed = int(np.random.default_rng(seed).integers(0, 2**32))
        self._scheduler = WorkScheduler()
        self._state = self._zero_state()
        self._request_new_frame = True
        # launches since the accumulation restarted (GLAZE_DEBUG names them)
        self._launch_no = 0
        # the display denoiser: display-only, it never touches the state.
        # ``temporal`` adds the history reprojection to draw_frame's
        # denoised display (it rides the denoise switch)
        self.denoise = False
        self.temporal = True
        self._gb_key = None
        self._gb = None
        self._dn_hist = None
        self._dn_hist_key = None
        self._dn_prev = None
        # the per-triangle opacity texture ids the split was built for
        self._alpha_tex_cache = None
        self._refresh_alpha_rounds()

    def _check_mesh(self, mesh):
        """The renderer's mesh from its ``mesh`` argument (None, "auto" or
        a Mesh), held to one sample in flight and to the lane count."""
        if mesh is None:
            return None
        from glaze_tpu_torch.parallel import mesh as pmesh

        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh {mesh!r}: expected None, 'auto' or "
                                 "a Mesh")
            mesh = (pmesh.make_mesh() if self.device.type == "cuda"
                    and _process_lanes(self.width, self.height) is None
                    else pmesh.make_mesh([self.device]))
        if self.samples_in_flight != 1:
            raise ValueError("mesh rendering requires samples_in_flight == 1")
        lanes = _process_lanes(self.width, self.height)
        n = (integ.pixel_count(self.width, self.height) if lanes is None
             else lanes.stop - lanes.start)
        if n % mesh.size:
            raise ValueError(f"pixel count not divisible by mesh size "
                             f"{mesh.size}")
        return mesh

    def _lanes(self):
        """The lanes this renderer holds: None (all of them), or under a
        mesh with several processes its process's share."""
        if self._mesh is None:
            return None
        return _process_lanes(self.width, self.height)

    def _zero_state(self):
        state = integ.init_state(self.width, self.height, self.device,
                                 self.samples_in_flight)
        return self._own_lanes(state)

    def _own_lanes(self, state):
        """``state`` (the whole image) cut to the lanes this renderer
        holds."""
        lanes = self._lanes()
        if lanes is None:
            return state
        from glaze_tpu_torch.parallel import mesh as pmesh

        return pmesh.state_lanes(state, lanes)

    # -- opacity maps -------------------------------------------------------
    def _alpha_tri_tex(self):
        """Per-ORIGINAL-triangle opacity texture id (0: no opacity map),
        from the host instance tables (None without host data); the JAX
        package's ``_alpha_tri_mask`` is this ``!= 0``."""
        h = self.host
        if h is None or not h.inst_tri_count:
            return None
        opac = np.asarray([m.opacity for m in h.materials], np.int64)
        n = max(f + c for f, c in zip(h.inst_tri_first, h.inst_tri_count))
        tex = np.zeros(n, np.int64)
        for m, f, c in zip(h.inst_material, h.inst_tri_first,
                           h.inst_tri_count):
            if 0 <= m < opac.size:
                tex[f:f + c] = opac[m]
        return tex

    def _refresh_alpha_rounds(self, textures_changed: bool = False):
        """Sets the alpha rounds from the materials (``alpha_rounds()``
        when some material has an opacity map, else 0), and rebuilds the
        opaque/alpha split when its inputs changed since the flatten or
        the last rebuild: a triangle's opacity texture id, or, with
        ``textures_changed``, the textures of a scene with opacity maps.
        The JAX package rebuilds only when the "has an opacity map" mask
        changes (ROADMAP F13)."""
        from glaze_tpu_torch.scene.flatten import MT_OPACITY

        if self.host is not None:
            has = any(m.opacity != 0 for m in self.host.materials)
        else:
            has = bool(self.scene.mat_tex[:, MT_OPACITY].any())
        self._alpha_rounds = alpha_rounds() if has else 0
        tex = self._alpha_tri_tex()
        if tex is None or self.host.tri_order is None:
            return
        cached = self._alpha_tex_cache
        self._alpha_tex_cache = tex
        if cached is None:
            return  # construction or change_scene: the flatten built it
        if not (textures_changed and tex.any()) and \
                cached.shape == tex.shape and (cached == tex).all():
            return
        from glaze_tpu_torch.scene import flatten as fl

        self.scene = self.scene._replace(
            **fl.rebuild_alpha_split(self.scene, self.host))

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

    def _scene_edited(self, textures_changed: bool = False):
        self._refresh_alpha_rounds(textures_changed)
        self._gb_key = None  # albedo follows the materials; ids are reused
        self._dn_hist = None  # the old display history would ghost
        self._request_new_frame = True

    def update_materials_and_lights(self, materials, lights):
        """Re-flattens the material, light and sky tables in place
        (RayTraceScene::update_materials_and_lights, scene.rs:1578-1624)
        and restarts accumulation. Needs a renderer built from a parsed
        scene (so the host instance tables exist). The span ``scene.edit``
        and the counter ``scene.edits``."""
        from glaze_tpu_torch.scene import flatten as fl

        if self.host is None:
            raise ValueError(
                "update_materials_and_lights needs a renderer built from a "
                "parsed scene; use change_scene for DeviceScene-built ones")
        count("scene.edits")
        with span("scene.edit"):
            lights_r = fl.reorder_lights(lights)
            tables = {
                **fl.flatten_materials(materials),
                **fl.flatten_lights(lights_r, self.host.inst_material,
                                    self.host.inst_tri_first,
                                    self.host.inst_tri_count),
                **fl.build_sky_tables(lights_r, self.host.textures),
            }
            self.scene = self.scene._replace(
                **{k: fl.array_to(v, self.device)
                   for k, v in tables.items()})
            self.host = self.host._replace(materials=list(materials),
                                           lights=lights_r)
            self._scene_edited()

    def update_textures(self, textures):
        """Swaps the texture set: rebuilds the atlas and, as the reference
        rebuilds the sky distribution when its texture changes
        (scene.rs:1598-1616), the sky tables, and in a scene with opacity
        maps the opaque/alpha split. Restarts accumulation. The span
        ``scene.edit`` and the counter ``scene.edits``."""
        from glaze_tpu_torch.ops.texture import build_atlas
        from glaze_tpu_torch.scene import flatten as fl

        if self.host is None:
            raise ValueError(
                "update_textures needs a renderer built from a parsed scene")
        count("scene.edits")
        with span("scene.edit"):
            textures = list(textures)
            sky = fl.build_sky_tables(self.host.lights, textures)
            self.scene = self.scene._replace(
                atlas=build_atlas(textures, self.device),
                **{k: fl.array_to(v, self.device) for k, v in sky.items()})
            self.host = self.host._replace(textures=textures)
            self._scene_edited(textures_changed=True)

    def change_scene(self, parsed, camera=None):
        """Full scene swap (raytracer.rs change_scene), on the renderer's
        device; the parsed scene's camera is taken unless ``camera`` is
        given."""
        from glaze_tpu_torch.scene import flatten_scene

        self.scene, parsed_cam, self.host = flatten_scene(parsed, self.device)
        if camera is not None:
            self.camera = camera
        elif parsed_cam is not None:
            self.camera = parsed_cam
        # the flatten built the new scene's split: nothing to rebuild
        self._alpha_tex_cache = None
        self._scene_edited()

    def change_resolution(self, width: int, height: int):
        self.width, self.height = int(width), int(height)
        self._state = self._zero_state()
        self._dn_hist = None
        self._request_new_frame = True

    # -- rendering ------------------------------------------------------------
    def _maybe_restart(self):
        if self._request_new_frame:
            count("render.restarts")
            self._request_new_frame = False
            self._scheduler.rewind()
            self._state = self._zero_state()
            self._launch_no = 0

    def _take_offsets(self, n: int):
        """Sub-pixel jitters for n launches: (n, 2), or (n, sif, 2), one
        jitter per in-flight copy."""
        s = self.samples_in_flight
        if s == 1:
            return self._scheduler.take(n)
        return self._scheduler.take(n * s).reshape(n, s, 2)

    def launches(self, spp: int) -> int:
        """Launches of ``draw(spp)``: each advances samples_in_flight path
        states per pixel, so ceil(spp * steps_per_sample / sif)."""
        return -(-spp * self.integrator.steps_per_sample
                 // self.samples_in_flight)

    def draw(self, spp: int, callback: Optional[Callable[[int], None]] = None,
             return_image: bool = True):
        """Blocking render of ``spp`` samples/pixel; returns (H, W, 3) uint8
        (or None with ``return_image=False``). ``callback(launches_done)``
        fires after each chunk of launches. With adaptive stopping the tile
        mask is taken once per chunk, from the whole state before it. The
        spans ``render.chunk`` (a chunk's launches) and ``render.sync``
        (the wait for the card before the callback or the return)."""
        self._maybe_restart()
        c2w, s2c = integ.camera_matrices(self.camera, self.width, self.height)
        kw = dict(width=self.width, height=self.height,
                  is_persp=self.camera.is_perspective,
                  direct_only=self.integrator is Integrator.DIRECT,
                  alpha_rounds=self._alpha_rounds, coherent=self.coherent,
                  sampler=self.sampler, sampler_seed=self._sampler_seed)
        if self._mesh is not None:
            from glaze_tpu_torch.parallel import mesh as pmesh

            # a loaded checkpoint may have changed sif or the resolution
            self._check_mesh(self._mesh)
            shards = pmesh.shard_state(self._state, self._mesh)
        done = 0
        for n in _chunk_sizes(self.launches(spp)):
            with span("render.chunk"):
                seeds = self._rng.integers(0, 2**32, size=n, dtype=np.uint32)
                offsets = self._take_offsets(n)
                lane_active = self._lane_active(self._state)
                if self._mesh is None:
                    self._state = integ.render_steps(
                        self.scene, self._state, seeds, offsets, c2w, s2c,
                        steps=n, sif=self.samples_in_flight,
                        lane_active=lane_active,
                        after_launch=self._nan_check(), **kw)
                else:
                    shards = pmesh.render_steps_sharded(
                        self.scene, shards, seeds, offsets, c2w, s2c,
                        self._mesh, steps=n, lane_active=lane_active,
                        lanes=self._lanes(),
                        after_launch=self._nan_check(sharded=True), **kw)
                    # the whole state after every chunk, as unsharded: the
                    # adaptive mask and a Ctrl-C checkpoint read it
                    self._state = pmesh.unshard_state(shards, self.device)
            done += n
            self._launch_no += n
            if callback is not None:
                with span("render.sync"):
                    self._sync()
                callback(done)
        if not return_image:
            with span("render.sync"):
                self._sync()
            return None
        return self.get_image()

    def _lane_active(self, state):
        """The adaptive tile mask of the whole ``state``, or None with
        adaptive stopping off."""
        if not self.adaptive:
            return None
        lanes = self._lanes()
        blk = integ.TILE_W * integ.TILE_H
        if lanes is not None and (lanes.start % blk or lanes.stop % blk):
            raise ValueError(
                f"adaptive stopping over several processes needs each "
                f"process's lanes to be whole tiles; lanes {lanes.start}:"
                f"{lanes.stop} are not")
        return integ.adaptive_lane_mask(
            state, sif=self.samples_in_flight, tau=self.adaptive_tau,
            min_count=self.adaptive_min)

    def _sync(self):
        """Waits for the renderer's CUDA devices (the mesh's too)."""
        devices = {self.device}
        if self._mesh is not None:
            devices.update(self._mesh.devices.ravel())
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _nan_check(self, sharded: bool = False):
        """With ``GLAZE_DEBUG``, the ``after_launch`` hook that checks the
        state for NaN after each launch, naming it by its number since the
        restart (and, ``sharded``, the mesh slot); else None."""
        if not debug_nans():
            return None
        base = self._launch_no

        if sharded:
            def after_launch(k, slot, state):
                check_nans(integ.named_leaves(state),
                           f"launch {base + k} (mesh slot {slot})")
        else:
            def after_launch(k, state):
                check_nans(integ.named_leaves(state), f"launch {base + k}")
        return after_launch

    def draw_frame(self, return_image: bool = False):
        """One launch: every pixel advances one bounce (raytracer.rs
        draw_frame, :369-603).

        ``return_image=True`` also returns the frame's display on the
        renderer's device: the (P', 3) uint8 sRGB lanes in the swizzled
        lane order, or with ``denoise`` the denoised (ph, pw, 3) uint8
        image, spatial, or with ``temporal`` blended with the reprojected
        previous frame. A temporal frame that restarts the accumulation
        (after a camera move or an edit) takes its G-buffer from its own
        launch's camera rays; one that continues the paths with a stale
        G-buffer (``denoise`` just turned on) traces it."""
        from glaze_tpu_torch.render import denoise as dn

        if self._lanes() is not None:
            raise ValueError("draw_frame renders the whole image, not one "
                             "process's lanes")
        restarted = self._request_new_frame
        self._maybe_restart()
        c2w, s2c = integ.camera_matrices(self.camera, self.width, self.height)
        seeds = self._rng.integers(0, 2**32, size=1, dtype=np.uint32)
        offsets = self._take_offsets(1)
        kw = dict(width=self.width, height=self.height,
                  is_persp=self.camera.is_perspective,
                  direct_only=self.integrator is Integrator.DIRECT,
                  steps=1, alpha_rounds=self._alpha_rounds,
                  sif=self.samples_in_flight, coherent=self.coherent,
                  sampler=self.sampler, sampler_seed=self._sampler_seed,
                  after_launch=self._nan_check())
        launch = (seeds, offsets, c2w, s2c)
        lps = self.integrator.steps_per_sample
        img = None
        if not return_image:
            self._state = integ.render_steps(self.scene, self._state, *launch,
                                             **kw)
        elif not self.denoise:
            self._state, img = integ.render_steps_with_image(
                self.scene, self._state, *launch, self._exposure(), **kw)
        elif not self.temporal:
            self._state, img = dn.render_steps_denoised(
                self.scene, self._state, *launch, self._exposure(),
                self._gbuffer(), self._lane_map(), launches_per_spp=lps, **kw)
        else:
            key = (self.width, self.height)
            if self._dn_hist is None or self._dn_hist_key != key:
                self._dn_hist = dn.init_history(*key, self.device)
                self._dn_hist_key = key
                self._dn_prev = dn.world_to_screen(self.camera, *key)
            gb_key = self._gbuffer_key()
            if self._gb_key != gb_key and not restarted:
                # the launch continues the paths, so its first hits are
                # bounces, not the camera's: trace the G-buffer (ROADMAP
                # F14; glaze_tpu takes the launch's hits here too)
                self._gbuffer()
            if self._gb_key == gb_key:
                # the camera is still: the cached G-buffer
                self._state, self._dn_hist, img = (
                    dn.render_steps_denoised_temporal(
                        self.scene, self._state, self._dn_hist, *launch,
                        self._exposure(), self._gb, self._dn_prev,
                        self._lane_map(), launches_per_spp=lps, **kw))
            else:
                # the camera moved: the launch's own trace is the G-buffer
                self._state, self._dn_hist, img, self._gb = (
                    dn.render_steps_denoised_temporal_gb(
                        self.scene, self._state, self._dn_hist, *launch,
                        self._exposure(), self._dn_prev, self._lane_map(),
                        launches_per_spp=lps, **kw))
                self._gb_key = gb_key
            # this frame's camera is the next frame's reprojection source
            self._dn_prev = dn.world_to_screen(self.camera, *key)
        self._launch_no += 1
        return img

    def _lane_map(self):
        """The lane-to-image permutation of the current resolution
        (``denoise.lane_to_image``), built once per resolution."""
        from glaze_tpu_torch.render import denoise as dn

        key = (self.width, self.height)
        if getattr(self, "_lane_map_key", None) != key:
            self._lane_map_inv = dn.lane_to_image(*key, self.device)[0]
            self._lane_map_key = key
        return self._lane_map_inv

    def _exposure(self):
        return self.exposure if self.exposure is not None else self.scene.exposure

    def _gbuffer_key(self):
        c2w, s2c = integ.camera_matrices(self.camera, self.width, self.height)
        return (id(self.scene), self.width, self.height,
                self.camera.is_perspective, self._alpha_rounds,
                c2w.tobytes(), s2c.tobytes())

    def _gbuffer(self):
        """The denoiser's first-hit guide buffers, cached until the camera,
        scene, resolution or alpha rounds change (the events that restart
        the accumulation)."""
        from glaze_tpu_torch.render import denoise as dn

        key = self._gbuffer_key()
        if self._gb_key != key:
            c2w, s2c = integ.camera_matrices(self.camera, self.width,
                                             self.height)
            self._gb = dn.gbuffer_pass(
                self.scene, c2w, s2c, width=self.width, height=self.height,
                is_persp=self.camera.is_perspective,
                alpha_rounds=self._alpha_rounds)
            self._gb_key = key
        return self._gb

    def denoised_image(self) -> np.ndarray:
        """The current progressive result through the edge-aware display
        filter, (H, W, 3) uint8 sRGB; the accumulation is untouched."""
        from glaze_tpu_torch.render import denoise as dn

        pw, ph = integ.padded_dims(self.width, self.height)
        img = dn.denoised_display(
            self._state.accum, self._state.count, self._gbuffer(),
            self._lane_map(),
            self._exposure(), pw=pw, ph=ph, sif=self.samples_in_flight,
            launches_per_spp=self.integrator.steps_per_sample)
        return img[:self.height, :self.width].cpu().numpy()

    def get_image(self) -> np.ndarray:
        """Current progressive result as (H, W, 3) uint8 sRGB (denoised
        when ``self.denoise`` is set)."""
        if self.denoise:
            return self.denoised_image()
        return integ.render_image(self._state, self._exposure(), self.width,
                                  self.height, self.samples_in_flight)

    def save(self, path: str):
        from PIL import Image

        Image.fromarray(self.get_image()).save(path)

    # -- checkpoint / resume --------------------------------------------------
    @property
    def completed_spp(self) -> int:
        """Samples/pixel accumulated so far (count is per-lane launches;
        each launch advances samples_in_flight states per pixel)."""
        count = int(self._state.count.max().item())
        return (count * self.samples_in_flight
                // self.integrator.steps_per_sample)

    def _leaves(self):
        st = self._state
        return [st.importance, *st.origin, *st.direction, st.bounce,
                st.last_specular, *st.accum, st.count, st.path_no, st.sq]

    def save_checkpoint(self, path: str, scene_id: str = ""):
        """Writes the progressive state to ``path`` in the JAX package's
        ``.npz`` layout: the 15 PathState leaves (``path_no`` as uint32),
        the host PCG64 state as decimal strings and the scheduler.
        ``scene_id``: an opaque scene identity that ``load_checkpoint``
        holds the checkpoint to."""
        leaves = []
        for i, leaf in enumerate(self._leaves()):
            a = leaf.detach().cpu().numpy()
            if i == PATH_NO_LEAF:
                a = (a & 0xFFFFFFFF).astype(np.uint32)
            leaves.append(a)
        bg = self._rng.bit_generator.state["state"]
        sched = self._scheduler
        np.savez_compressed(
            path,
            scene_id=str(scene_id),
            n_leaves=len(leaves),
            width=self.width,
            height=self.height,
            samples_in_flight=self.samples_in_flight,
            integrator=self.integrator.value,
            sampler=self.sampler,
            sampler_seed=np.uint32(self._sampler_seed),
            rng_state=str(bg["state"]),
            rng_inc=str(bg["inc"]),
            scheduler_current=(np.asarray(sched.current, np.float32)
                               if sched.current
                               else np.zeros((0, 2, 2), np.float32)),
            scheduler_next=(np.asarray(sched.next, np.float32) if sched.next
                            else np.zeros((0, 2, 2), np.float32)),
            **{f"leaf_{i}": a for i, a in enumerate(leaves)},
        )

    def load_checkpoint(self, path: str, scene_id: str = ""):
        """Restores a checkpoint of :meth:`save_checkpoint` (or of the JAX
        package) onto the renderer's device. Its resolution, samples in
        flight, integrator and sampler win over the renderer's. Raises
        ValueError when both sides carry a scene_id and they differ. A
        checkpoint with fewer leaves (before ``path_no`` and ``sq``)
        resumes with zeros for them, and turns adaptive stopping off."""
        data = np.load(path, allow_pickle=False)
        ck_scene = str(data["scene_id"]) if "scene_id" in data else ""
        if scene_id and ck_scene and ck_scene != str(scene_id):
            raise ValueError(
                f"checkpoint {path!r} was written for a different scene "
                f"(scene_id {ck_scene!r} != {str(scene_id)!r})")
        ck_sif = (int(data["samples_in_flight"])
                  if "samples_in_flight" in data else 1)
        if (int(data["width"]) != self.width
                or int(data["height"]) != self.height
                or ck_sif != self.samples_in_flight):
            self.samples_in_flight = ck_sif
            self.change_resolution(int(data["width"]), int(data["height"]))
        self.integrator = Integrator(str(data["integrator"]))
        if "sampler" in data:
            self.sampler = str(data["sampler"])
            self._sampler_seed = int(data["sampler_seed"])
        cur = self._leaves()
        leaves = []
        for i, like in enumerate(cur):
            if i < int(data["n_leaves"]):
                a = np.asarray(data[f"leaf_{i}"]).astype(
                    np.int64 if i == PATH_NO_LEAF else np.float32)
                leaves.append(torch.from_numpy(a).to(self.device))
            else:
                # the trailing leaves (path_no, sq) are newer additions:
                # resume with zeros (the ld stratification restarts)
                leaves.append(torch.zeros(leaves[12].shape, dtype=like.dtype,
                                          device=self.device))
        shimmed = int(data["n_leaves"]) < len(cur)
        self._state = self._own_lanes(integ.PathState(
            importance=leaves[0], origin=tuple(leaves[1:4]),
            direction=tuple(leaves[4:7]), bounce=leaves[7],
            last_specular=leaves[8], accum=tuple(leaves[9:12]),
            count=leaves[12], path_no=leaves[13], sq=leaves[14]))
        if shimmed and self.adaptive:
            # a zero sq beside a large count reads as var = 0, which would
            # park every tile for good
            log.warning(
                "checkpoint predates the adaptive variance statistic; "
                "disabling adaptive sampling for this resumed render")
            self.adaptive = False
        state = self._rng.bit_generator.state
        state["state"]["state"] = int(str(data["rng_state"]))
        state["state"]["inc"] = int(str(data["rng_inc"]))
        self._rng.bit_generator.state = state
        sched = WorkScheduler()
        sched.current = [tuple(map(tuple, a)) for a in data["scheduler_current"]]
        sched.next = [tuple(map(tuple, a)) for a in data["scheduler_next"]]
        self._scheduler = sched
        self._request_new_frame = False

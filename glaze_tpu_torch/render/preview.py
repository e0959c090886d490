"""The flat-shaded instant preview (torch port of
:mod:`glaze_tpu.render.preview`).

The reference rasterizes a non-raytraced preview with per-material
pipelines and a skydome background (renderer.rs:561-655, flat.vert/.frag,
skydome.vert/.frag). Here it is one primary-visibility pass: one
closest-hit trace of the camera rays through pixel centres, flat shading
per material family, the sky on a miss. No NEE, no shadow rays, no RNG,
no accumulation. The trace goes through the port's closest-hit dispatch,
so on ``cuda`` it launches the traversal kernels and adds none of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from glaze_tpu_torch import accel
from glaze_tpu_torch.core import Camera
from glaze_tpu_torch.ops import fresnel as fr
from glaze_tpu_torch.ops import spectra
from glaze_tpu_torch.ops import texture as tx
from glaze_tpu_torch.ops import vec
from glaze_tpu_torch.render import integrator as integ
from glaze_tpu_torch.render import shade_cuda
from glaze_tpu_torch.scene import flatten as fl

# alpha re-test rounds of the preview when some material has an opacity
# map (flat_twosided.frag's opacity discard)
PREVIEW_ALPHA_ROUNDS = 4


def flat_pass(scene, cam2world, screen2cam, exposure, cone_scale, *, width,
              height, is_persp, alpha_rounds=0):
    """One flat-shaded frame: (P', 3) uint8 sRGB in the swizzled lane
    order, on the scene's device. ``cam2world``/``screen2cam``: float32
    NumPy; ``cone_scale``: a pixel's world width per unit distance
    (perspective) or its width (ortho), a host float.

    The looks per family: FLAT and INTERNAL_FLAT_2SIDED unlit diffuse;
    LAMBERT, UBER and FROSTED diffuse times a headlight n.v term; METAL
    and MIRROR the conductor's normal-incidence Fresnel tint with a
    view-dependent glint; GLASS a Fresnel rim. Opacity maps discard
    through ``alpha_rounds`` re-test rounds. The texture level comes from
    the hit's footprint (distance times ``cone_scale``, widened at
    grazing incidence) against its texel size."""
    px, py = integ.pixel_coords(width, height, scene.device)
    origin, direction = integ.camera_rays(
        integ.ndc(px, 0.5, width), integ.ndc(py, 0.5, height), cam2world,
        screen2cam, is_persp)
    if alpha_rounds > 0:
        hit = integ.trace_alpha(scene, origin, direction,
                                alpha_rounds=alpha_rounds)
    else:
        hit = accel.closest_hit_soa_auto(scene.bvh, origin, direction)
    missed = hit["tri"] < 0

    surf = shade_cuda.interpolate_hit(scene, hit)
    mat_id = surf["material_id"].long()
    tex = scene.mat_tex[mat_id][:, fl.MT_DIFFUSE]
    # the isotropic LOD: log2 of the pixel's world footprint over the
    # texel's world size (|dP/du| over the texture's u resolution)
    ndotv_g = torch.abs(vec.dot(surf["geom_normal"], direction))
    cone = float(np.float32(cone_scale))
    fw = hit["t"] * cone if is_persp else torch.full_like(hit["t"], cone)
    fw = fw / torch.clamp(ndotv_g, min=0.25)
    du = torch.sqrt(torch.clamp(vec.dot(surf["dpdu"], surf["dpdu"]),
                                min=1e-12))
    texel_w = du / scene.atlas.width[tex.long()].to(torch.float32)
    lod = torch.log2(torch.clamp(fw / torch.clamp(texel_w, min=1e-12),
                                 min=1e-6))
    r, g, b = tx.sample_rgb_lod_v(scene.atlas, tex, surf["uv"][0],
                                  surf["uv"][1], lod)
    s = scene.mat_scalars[mat_id]
    r = r * s[:, fl.MS_DIFFUSE_R]
    g = g * s[:, fl.MS_DIFFUSE_G]
    b = b * s[:, fl.MS_DIFFUSE_B]

    mtype = s[:, fl.MS_MTYPE].to(torch.int32)
    family = s[:, fl.MS_BSDF].to(torch.int32)
    ndotv = torch.abs(vec.dot(surf["shading_normal"], vec.neg(direction)))
    headlight = 0.25 + 0.75 * ndotv
    # metal and mirror: the conductor's Fresnel at normal incidence
    f0 = fr.fresnel_conductor_t(torch.ones_like(ndotv),
                                scene.mat_metal_ior[mat_id].T,
                                scene.mat_metal_fresnel[mat_id].T)
    f0r, f0g, f0b = spectra.to_rgb_t(f0)
    glint = 0.35 + 0.65 * torch.exp(8.0 * (ndotv - 1.0))
    rim = 0.08 + 0.92 * (1.0 - ndotv) ** 2

    is_unlit = (mtype == 0) | (mtype == 7)  # FLAT / INTERNAL_FLAT_2SIDED
    is_metal = (family == 1) | (family == 3)  # MIRROR / METAL
    is_glass = family == 2

    def style(c, f0c):
        out = torch.where(is_unlit, c, c * headlight)
        out = torch.where(is_metal, torch.clamp(f0c, 0.0, 1.0) * glint, out)
        return torch.where(is_glass, rim, out)

    surf_rgb = (style(r, f0r), style(g, f0g), style(b, f0b))
    # the skydome background (skydome.frag), black without a sky
    has_sky = scene.sky_tex > 0
    sky = tuple(torch.where(has_sky, c * scene.sky_intensity,
                            torch.zeros_like(c))
                for c in shade_cuda.sky_radiance(scene, direction))
    chans = []
    for surf_c, sky_c in zip(surf_rgb, sky):
        c = torch.where(missed, sky_c, surf_c) * exposure
        chans.append(torch.round(tx.linear_to_srgb(
            torch.clamp(c, 0.0, 1.0)) * 255.0).to(torch.uint8))
    return torch.stack(chans, dim=-1)


class FlatPreviewRenderer:
    """The renderer surface :class:`~glaze_tpu_torch.render.realtime.
    RealtimeRenderer` drives (``draw_frame``, ``get_image``,
    ``update_camera``, ``change_resolution``, ``set_exposure``), over a
    DeviceScene on its own device."""

    def __init__(self, scene, camera=None, width=800, height=600, host=None):
        self.scene = scene
        self.host = host
        self.camera = camera if camera is not None else Camera.default()
        self.width = int(width)
        self.height = int(height)
        self.exposure = None
        self._frame = None
        self._request_new_frame = True

    @property
    def _alpha_rounds(self) -> int:
        # from the scene's host tuple at every draw, so an edit that swaps
        # self.scene is followed with no device read
        return PREVIEW_ALPHA_ROUNDS if fl.MT_OPACITY in self.scene.tex_slots else 0

    def update_camera(self, camera):
        self.camera = camera
        self._request_new_frame = True

    def set_exposure(self, exposure: float):
        self.exposure = float(exposure)
        self._request_new_frame = True

    def change_resolution(self, width: int, height: int):
        self.width, self.height = int(width), int(height)
        self._request_new_frame = True

    def _cone_scale(self) -> float:
        """A pixel's world width per unit distance (perspective) or per
        pixel (ortho: the rays span the ndc box [-1, 1])."""
        if self.camera.is_perspective:
            return 2.0 * math.tan(self.camera.inner.fovx * 0.5) / self.width
        return 2.0 / self.width

    def draw_frame(self, return_image: bool = False):
        c2w, s2c = integ.camera_matrices(self.camera, self.width, self.height)
        exposure = (self.exposure if self.exposure is not None
                    else self.scene.exposure)
        self._frame = flat_pass(
            self.scene, c2w, s2c, exposure, self._cone_scale(),
            width=self.width, height=self.height,
            is_persp=self.camera.is_perspective,
            alpha_rounds=self._alpha_rounds)
        self._request_new_frame = False
        if return_image:
            return self._frame  # (P', 3) uint8 on the device, swizzled

    def get_image(self) -> np.ndarray:
        """The preview as (H, W, 3) uint8 NumPy, drawn first if the camera,
        exposure or resolution changed."""
        if self._frame is None or self._request_new_frame:
            self.draw_frame()
        return integ.lanes_to_image(self._frame, self.width, self.height)

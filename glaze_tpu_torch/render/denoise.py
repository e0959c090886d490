"""Edge-aware à-trous display denoiser (SVGF-style), in torch.

Port of the offline half of :mod:`glaze_tpu.render.denoise`: a G-buffer
pass (one primary trace, the integrator's camera rays without jitter)
gives the first hit's shading normal, distance and diffuse albedo per
lane; the accumulation's radiance mean is demodulated by the albedo,
filtered by ``iterations`` à-trous passes of 5x5 B3-spline taps
(dilation 1, 2, 4, ...) with edge-stopping weights on normal, relative
depth and luminance, and remodulated. The luminance sigma comes from the
local 3x3 variance and fades as ``sqrt(launches_per_spp / count)``, as
does the blend with the raw image, so the filter fades to identity as
the accumulation converges. It is display-only: nothing here writes the
accumulation state.

Every function runs on the device of its inputs; the G-buffer's trace
goes through the port's closest-hit dispatch (``trace_alpha`` with
alpha re-test rounds, else ``closest_hit_soa_auto``), so on ``cuda`` it
launches the traversal kernels and adds no kernel of its own. The
temporal reprojection of glaze_tpu (``denoised_display_temporal``) waits
for the interactive renderer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from glaze_tpu_torch import accel
from glaze_tpu_torch.ops import texture as tx
from glaze_tpu_torch.ops import vec
from glaze_tpu_torch.render import bsdf as bsdf_mod
from glaze_tpu_torch.render import integrator as integ
from glaze_tpu_torch.scene import flatten as fl

# depth of miss (sky) lanes: far beyond any scene hit, so the depth weight
# separates sky from geometry while sky pixels filter among themselves
SKY_DEPTH = float(np.float32(1e8))
# the 5-tap B3-spline kernel of the à-trous transform
_H = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def lane_to_image(width: int, height: int, device):
    """``(inv, pw, ph)``: the int64 permutation from the tile-swizzled lane
    axis to the flat padded image, ``img = lanes[inv].reshape(ph, pw)``,
    built on ``device``."""
    px, py = integ._pixel_coords_t(width, height, device)
    pw, ph = integ.padded_dims(width, height)
    flat = py * pw + px
    inv = torch.empty_like(flat)
    inv[flat] = torch.arange(flat.shape[0], dtype=torch.int64, device=device)
    return inv, pw, ph


def gbuffer_pass(scene, cam2world, screen2cam, *, width: int, height: int,
                 is_persp: bool, alpha_rounds: int = 0):
    """First-hit guide buffers per lane: ``normal`` (3 x (P,)), ``depth``,
    ``albedo`` (3 x (P,)) and ``wpos``, from one trace of the camera rays
    through pixel centres (float32 NumPy ``cam2world``/``screen2cam``), on
    the scene's device."""
    px, py = integ.pixel_coords(width, height, scene.device)
    origin, direction = integ.camera_rays(
        integ.ndc(px, 0.5, width), integ.ndc(py, 0.5, height), cam2world,
        screen2cam, is_persp)
    if alpha_rounds > 0:
        hit = integ.trace_alpha(scene, origin, direction,
                                alpha_rounds=alpha_rounds)
    else:
        hit = accel.closest_hit_soa_auto(scene.bvh, origin, direction)
    surf = integ._interpolate_hit(scene, hit)
    return _guides(scene, origin, direction, hit["tri"] < 0, hit["t"],
                   surf["shading_normal"], surf["material_id"], surf["uv"])


def _guides(scene, origin, direction, missed, t, shading_normal, material_id,
            uv):
    """Guide buffers from first-hit attributes. Sky lanes: the ray
    direction as normal and SKY_DEPTH as depth. Albedo: texture x
    multiplier for the diffuse-lobed families (Lambert, frosted, uber); 1
    for the specular ones and the sky, whose colour is not separable from
    a surface tint."""
    n = vec.where(missed, direction, shading_normal)
    z = torch.where(missed, torch.full_like(t, SKY_DEPTH), t)
    mid = material_id.long()
    texid = scene.mat_tex[mid][:, fl.MT_DIFFUSE]
    r, g, b = tx.sample_rgb_v(scene.atlas, texid, uv[0], uv[1])
    s = scene.mat_scalars[mid]
    r = r * s[:, fl.MS_DIFFUSE_R]
    g = g * s[:, fl.MS_DIFFUSE_G]
    b = b * s[:, fl.MS_DIFFUSE_B]
    family = s[:, fl.MS_BSDF].to(torch.int32)
    diffuse_lobed = ((family == bsdf_mod.FAMILY_LAMBERT)
                     | (family == bsdf_mod.FAMILY_FROSTED)
                     | (family == bsdf_mod.FAMILY_UBER))
    keep = missed | ~diffuse_lobed
    one = torch.ones_like(r)
    albedo = tuple(torch.where(keep, one, c) for c in (r, g, b))
    wpos = tuple(o + z * d for o, d in zip(origin, direction))
    return {"normal": n, "depth": z, "albedo": albedo, "wpos": wpos}


def _padded(a, pad):
    """``a`` (ph, pw) with ``pad`` edge-replicated pixels on every side."""
    return F.pad(a[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def _atrous(chans, lum, nx, ny, nz, z, sigma_l, *, iterations, sigma_n=32.0,
            sigma_z=0.08):
    """Edge-aware à-trous over (ph, pw) planes: ``chans`` (the demodulated
    radiance planes) are filtered; the guides (luminance, normal, depth)
    stay fixed across the iterations."""
    ph, pw = lum.shape
    for it in range(iterations):
        step = 1 << it
        pad = 2 * step
        padded = [_padded(a, pad) for a in (nx, ny, nz, z, lum, *chans)]
        num = [torch.zeros_like(chans[0]) for _ in chans]
        den = torch.zeros_like(chans[0])
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                h = float(np.float32(_H[dy + 2] * _H[dx + 2]))
                y0, x0 = pad + dy * step, pad + dx * step
                qnx, qny, qnz, qz, qlum, *qc = (
                    p[y0:y0 + ph, x0:x0 + pw] for p in padded)
                w_n = torch.clamp(nx * qnx + ny * qny + nz * qnz,
                                  min=0.0) ** sigma_n
                w_z = torch.exp(-torch.abs(z - qz)
                                / (sigma_z * torch.minimum(z, qz) + 1e-4))
                w_l = torch.exp(-torch.abs(lum - qlum)
                                / torch.clamp(sigma_l, min=1e-6))
                w = h * w_n * w_z * w_l
                num = [n + w * q for n, q in zip(num, qc)]
                den = den + w
        chans = [n / torch.clamp(den, min=1e-8) for n in num]
    return chans


def _local_sigma(lum, k):
    """Per-pixel luminance edge-stop from the local 3x3 variance: ``k``
    times its square root."""
    ph, pw = lum.shape
    p = _padded(lum, 1)
    mu = torch.zeros_like(lum)
    mu2 = torch.zeros_like(lum)
    for dy in range(3):
        for dx in range(3):
            q = p[dy:dy + ph, dx:dx + pw]
            mu = mu + q
            mu2 = mu2 + q * q
    # by a tensor, so that the quotients round alike on every device (see
    # integ.ndc): the variance is a difference of near-equal terms
    nine = lum.new_full((), 9.0)
    mu = mu / nine
    var = torch.clamp(mu2 / nine - mu * mu, min=0.0)
    return k * torch.sqrt(var)


def _display_linear(accum, count, gb, inv_map, *, pw, ph, iterations, sif,
                    sigma_l_scale, launches_per_spp):
    """Accumulation -> the filtered, remodulated linear planes (before
    exposure and sRGB). Returns (3 x (ph, pw), the count plane)."""
    accum, count = integ._fold_sif(accum, count, sif)
    cnt = torch.clamp(count, min=1.0)

    def plane(v):
        return v[inv_map].reshape(ph, pw)

    alb = [torch.clamp(plane(a), min=0.02) for a in gb["albedo"]]
    rgb = [plane(accum[i] / cnt) / alb[i] for i in range(3)]
    nx, ny, nz = (plane(gb["normal"][i]) for i in range(3))
    zd = plane(gb["depth"])
    lum = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
    # the explicit 1/sqrt(samples) factor makes the filter fade to identity
    # as the accumulation converges (launches_per_spp launches = 1 spp)
    fade = torch.clamp(torch.sqrt(float(np.float32(launches_per_spp))
                                  / plane(cnt)), max=1.0)
    sigma_l = _local_sigma(lum, float(np.float32(sigma_l_scale))) * fade
    filtered = _atrous(rgb, lum, nx, ny, nz, zd, sigma_l,
                       iterations=iterations)
    # blend by the same fade: the shown image converges to the raw
    # accumulation as samples accrue
    rgb = [r + fade * (f - r) for r, f in zip(rgb, filtered)]
    return [r * a for r, a in zip(rgb, alb)], plane(cnt)


def _to_srgb_u8(rgb_lin, exposure):
    chans = [torch.round(tx.linear_to_srgb(
        torch.clamp(c * exposure, 0.0, 1.0)) * 255.0).to(torch.uint8)
        for c in rgb_lin]
    return torch.stack(chans, dim=-1)


def denoised_display(accum, count, gb, inv_map, exposure, *, pw, ph,
                     iterations=4, sif=1, sigma_l_scale=3.0,
                     launches_per_spp=integ.PT_STEPS):
    """Accumulation state -> denoised (ph, pw, 3) uint8 sRGB image on the
    state's device. ``sigma_l_scale`` scales the luminance sigma (higher
    is smoother); ``launches_per_spp`` is the integrator's
    steps_per_sample (count is per launch; the fade is in samples)."""
    lin, _ = _display_linear(accum, count, gb, inv_map, pw=pw, ph=ph,
                             iterations=iterations, sif=sif,
                             sigma_l_scale=sigma_l_scale,
                             launches_per_spp=launches_per_spp)
    return _to_srgb_u8(lin, exposure)

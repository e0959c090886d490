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

The temporal half serves the interactive ``draw_frame``: while the
camera moves, the accumulation restarts every frame at one launch, so
the previous displayed frame is warped into the new camera (bilinear
taps at each first hit's reprojected position) and blended in where
depth and normal agree. The history's weight is capped at
``_HIST_CAP_SPP`` samples, so once the camera rests the display
converges to the raw accumulation. A frame after a camera move takes its
G-buffer from its own launch's camera-ray trace
(:func:`render_steps_denoised_temporal_gb`), not from a second trace.

Every function runs on the device of its inputs; the G-buffer's trace
goes through the port's closest-hit dispatch (``trace_alpha`` with
alpha re-test rounds, else ``closest_hit_soa_auto``), so on ``cuda`` it
launches the traversal kernels and adds no kernel of its own.
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
from glaze_tpu_torch.render import shade_cuda
from glaze_tpu_torch.scene import flatten as fl
from glaze_tpu_torch.utils.runtime import count, traced

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


@traced("denoise.gbuffer")
def gbuffer_pass(scene, cam2world, screen2cam, *, width: int, height: int,
                 is_persp: bool, alpha_rounds: int = 0):
    """First-hit guide buffers per lane: ``normal`` (3 x (P,)), ``depth``,
    ``albedo`` (3 x (P,)) and ``wpos``, from one trace of the camera rays
    through pixel centres (float32 NumPy ``cam2world``/``screen2cam``), on
    the scene's device. The span ``denoise.gbuffer`` and the counter
    ``denoise.gbuffer_traces``."""
    count("denoise.gbuffer_traces")
    px, py = integ.pixel_coords(width, height, scene.device)
    origin, direction = integ.camera_rays(
        integ.ndc(px, 0.5, width), integ.ndc(py, 0.5, height), cam2world,
        screen2cam, is_persp)
    if alpha_rounds > 0:
        hit = integ.trace_alpha(scene, origin, direction,
                                alpha_rounds=alpha_rounds)
    else:
        hit = accel.closest_hit_soa_auto(scene.bvh, origin, direction)
    surf = shade_cuda.interpolate_hit(scene, hit)
    return _guides(scene, origin, direction, hit["tri"] < 0, hit["t"],
                   surf["shading_normal"], surf["material_id"], surf["uv"])


@traced("denoise.gbuffer")
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


@traced("denoise.filter")
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


# ---------------------------------------------------------------------------
# Temporal reprojection: the previous displayed frame warped into the new
# camera and blended in where the geometry agrees. Display-only.

# the history's effective count is capped at this many samples, so it can
# never outweigh more than that many freshly accumulated ones
_HIST_CAP_SPP = 8.0


def world_to_screen(camera, width: int, height: int):
    """Host-side float32 NumPy (view, proj, position) of ``camera`` for
    the reprojection: the forward transforms whose inverses are
    ``integ.camera_matrices``."""
    view = camera.look_at_rh().astype(np.float32)
    proj = camera.projection(width, height).copy()
    proj[1, 1] *= -1.0  # the Vulkan clip-space flip of camera_matrices
    return (view, proj.astype(np.float32),
            np.asarray(camera.position(), np.float32))


def init_history(width: int, height: int, device):
    """Zero history (h = 0 everywhere): the first temporal frame blends
    nothing and equals the spatial denoised display."""
    pw, ph = integ.padded_dims(width, height)
    z = torch.zeros((ph, pw), dtype=torch.float32, device=device)
    return {"rgb": (z, z, z), "t": z, "n": (z, z, z), "h": z}


def _reproject(hist, gb_planes, prev, *, width, height, pw, ph, is_persp):
    """Bilinear gather of the history at each pixel's reprojected place.

    Returns (hist_rgb, hist_h, valid): the history colour (modulated
    linear), its effective launch count, and the consistency mask (all
    four taps on real pixels, in front of the previous camera, depth
    within 5% and normals with a dot product above 0.9)."""
    view, proj, prev_pos = prev
    v = [[float(x) for x in row] for row in view]
    p = [[float(x) for x in row] for row in proj]
    pos = [float(x) for x in prev_pos]
    wx, wy, wz = gb_planes["wpos"]
    # the current first hit in the previous camera's view space
    vx = v[0][0] * wx + v[0][1] * wy + v[0][2] * wz + v[0][3]
    vy = v[1][0] * wx + v[1][1] * wy + v[1][2] * wz + v[1][3]
    vz = v[2][0] * wx + v[2][1] * wy + v[2][2] * wz + v[2][3]
    if is_persp:
        cx = p[0][0] * vx + p[0][1] * vy + p[0][2] * vz + p[0][3]
        cy = p[1][0] * vx + p[1][1] * vy + p[1][2] * vz + p[1][3]
        cw = p[3][0] * vx + p[3][1] * vy + p[3][2] * vz + p[3][3]
        in_front = cw > 1e-6
        w = torch.where(in_front, cw, torch.ones_like(cw))
        ndc_x, ndc_y = cx / w, cy / w
        # the distance the previous frame's G-buffer would have recorded
        exp_t = torch.sqrt((wx - pos[0]) ** 2 + (wy - pos[1]) ** 2
                           + (wz - pos[2]) ** 2)
    else:
        # ortho rays start at cam2world @ (ndc, 0, 1): ndc is view-space
        # xy, depth the distance along the unit view direction
        ndc_x, ndc_y = vx, vy
        exp_t = -vz
        in_front = exp_t > 0.0
    fx = (ndc_x + 1.0) * 0.5 * float(width) - 0.5
    fy = (ndc_y + 1.0) * 0.5 * float(height) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx_ = fx - x0
    ty_ = fy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    # all four taps must land on real pixels (the padding holds junk)
    inb = ((x0i >= 0) & (x0i + 1 <= width - 1)
           & (y0i >= 0) & (y0i + 1 <= height - 1))
    # one gather of the 8 stacked planes per tap, by flat index
    stack = torch.stack([*hist["rgb"], hist["t"], *hist["n"], hist["h"]],
                        dim=0).reshape(8, ph * pw)

    def tap(xi, yi):
        idx = torch.clamp(yi, 0, ph - 1) * pw + torch.clamp(xi, 0, pw - 1)
        return stack[:, idx.reshape(-1)].reshape(8, ph, pw)

    w00 = (1 - tx_) * (1 - ty_)
    w10 = tx_ * (1 - ty_)
    w01 = (1 - tx_) * ty_
    w11 = tx_ * ty_
    g = (tap(x0i, y0i) * w00 + tap(x0i + 1, y0i) * w10
         + tap(x0i, y0i + 1) * w01 + tap(x0i + 1, y0i + 1) * w11)
    hist_rgb = (g[0], g[1], g[2])
    hist_t, hnx, hny, hnz, hist_h = g[3], g[4], g[5], g[6], g[7]
    nx, ny, nz = gb_planes["normal"]
    depth_ok = torch.abs(hist_t - exp_t) <= 0.05 * exp_t + 1e-3
    normal_ok = (hnx * nx + hny * ny + hnz * nz) > 0.9
    valid = inb & in_front & depth_ok & normal_ok & (hist_h > 0.0)
    return hist_rgb, hist_h, valid


@traced("denoise.filter")
def denoised_display_temporal(accum, count, gb, hist, prev, inv_map,
                              exposure, *, width, height, pw, ph, is_persp,
                              iterations=4, sif=1, sigma_l_scale=3.0,
                              launches_per_spp=integ.PT_STEPS):
    """The spatial display with the reprojected previous frame blended in
    where the geometry agrees, by effective counts (the history's capped
    at ``_HIST_CAP_SPP * launches_per_spp``). ``prev``: the previous
    frame's :func:`world_to_screen`. Returns ((ph, pw, 3) uint8, the new
    history)."""
    lin, cnt = _display_linear(accum, count, gb, inv_map, pw=pw, ph=ph,
                               iterations=iterations, sif=sif,
                               sigma_l_scale=sigma_l_scale,
                               launches_per_spp=launches_per_spp)

    def plane(v):
        return v[inv_map].reshape(ph, pw)

    gb_planes = {"wpos": tuple(plane(c) for c in gb["wpos"]),
                 "normal": tuple(plane(c) for c in gb["normal"])}
    hist_rgb, hist_h, valid = _reproject(
        hist, gb_planes, prev, width=width, height=height, pw=pw, ph=ph,
        is_persp=is_persp)
    cap = float(np.float32(_HIST_CAP_SPP * launches_per_spp))
    h = torch.where(valid, torch.clamp(hist_h, max=cap),
                    torch.zeros_like(hist_h))
    w_h = h / (h + cnt)
    out = [c + w_h * (hr - c) for c, hr in zip(lin, hist_rgb)]
    new_hist = {"rgb": tuple(out), "t": plane(gb["depth"]),
                "n": gb_planes["normal"], "h": torch.clamp(h + cnt, max=cap)}
    return _to_srgb_u8(out, exposure), new_hist


# ---------------------------------------------------------------------------
# The interactive frames: launches and the denoised display in one call


def render_steps_denoised(scene, state, seeds, offsets, cam2world,
                          screen2cam, exposure, gb, inv_map, *, iterations=4,
                          launches_per_spp=integ.PT_STEPS, **kw):
    """``integ.render_steps`` (keywords ``kw``) and the spatial denoised
    display of the new state with the G-buffer ``gb``. Returns (state,
    (ph, pw, 3) uint8)."""
    state = integ.render_steps(scene, state, seeds, offsets, cam2world,
                               screen2cam, **kw)
    pw, ph = integ.padded_dims(kw["width"], kw["height"])
    img = denoised_display(state.accum, state.count, gb, inv_map, exposure,
                           pw=pw, ph=ph, iterations=iterations,
                           sif=kw.get("sif", 1),
                           launches_per_spp=launches_per_spp)
    return state, img


def _temporal(state, hist, exposure, gb, prev, inv_map, iterations,
              launches_per_spp, kw):
    pw, ph = integ.padded_dims(kw["width"], kw["height"])
    img, hist = denoised_display_temporal(
        state.accum, state.count, gb, hist, prev, inv_map, exposure,
        width=kw["width"], height=kw["height"], pw=pw, ph=ph,
        is_persp=kw["is_persp"], iterations=iterations, sif=kw.get("sif", 1),
        launches_per_spp=launches_per_spp)
    return hist, img


def render_steps_denoised_temporal(scene, state, hist, seeds, offsets,
                                   cam2world, screen2cam, exposure, gb, prev,
                                   inv_map, *, iterations=4,
                                   launches_per_spp=integ.PT_STEPS, **kw):
    """``integ.render_steps`` and the temporal display with the cached
    G-buffer ``gb`` (the camera did not move). Returns (state, new
    history, (ph, pw, 3) uint8)."""
    state = integ.render_steps(scene, state, seeds, offsets, cam2world,
                               screen2cam, **kw)
    hist, img = _temporal(state, hist, exposure, gb, prev, inv_map,
                          iterations, launches_per_spp, kw)
    return state, hist, img


def render_steps_denoised_temporal_gb(scene, state, hist, seeds, offsets,
                                      cam2world, screen2cam, exposure, prev,
                                      inv_map, *, iterations=4,
                                      launches_per_spp=integ.PT_STEPS, **kw):
    """The frame after a camera move: the caller restarted the
    accumulation, so launch 0 traces camera rays, and with one sample in
    flight its hit attributes are the G-buffer (at that launch's
    sub-pixel jitter): no second primary trace. With ``sif`` > 1 the lanes
    are sif copies of each pixel and the guides stay per pixel, so
    :func:`gbuffer_pass` traces them. Returns (state, new history,
    (ph, pw, 3) uint8, G-buffer); the caller caches the G-buffer for the
    still frames that follow."""
    if kw.get("sif", 1) == 1:
        state, fh = integ.render_steps(scene, state, seeds, offsets,
                                       cam2world, screen2cam,
                                       want_first_hit=True, **kw)
        gb = _guides(scene, fh["origin"], fh["direction"], fh["missed"],
                     fh["t"], fh["shading_normal"], fh["material_id"],
                     fh["uv"])
    else:
        gb = gbuffer_pass(scene, cam2world, screen2cam, width=kw["width"],
                          height=kw["height"], is_persp=kw["is_persp"],
                          alpha_rounds=kw.get("alpha_rounds", 0))
        state = integ.render_steps(scene, state, seeds, offsets, cam2world,
                                   screen2cam, **kw)
    hist, img = _temporal(state, hist, exposure, gb, prev, inv_map,
                          iterations, launches_per_spp, kw)
    return state, hist, img, gb

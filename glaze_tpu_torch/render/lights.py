"""Next-event-estimation light sampling, all four light types, SoA (torch).

Port of :mod:`glaze_tpu.render.lights` (the ``light_*_sample_visible``
callables of the reference). Every sampler present in the scene runs over
the whole batch and the picked light's type selects the result.
Positions/directions are (x, y, z) tuples of (R,) tensors; emissions are
(16, R) spectra. Draw-driven table lookups run at CHAIN width C (C < R
when coherent sampling shares RNG chains across lanes) and ``expand``
broadcasts chain-width results to lane width where per-lane data mixes in.
On the card, the NEE stage runs :mod:`glaze_tpu_torch.render.shade_cuda`'s
kernel, one light type a lane, in place of :func:`sample_light`, which
stays its plain version.

Documented deviations from the reference (bug fixes, as in the JAX
package): AREA pdfs use the true world-space triangle area and wiW points
surface -> light; SKY CDF inversion indexes the tables exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from glaze_tpu_torch.ops import spectra
from glaze_tpu_torch.ops import texture as tx
from glaze_tpu_torch.ops import vec
from glaze_tpu_torch.scene.flatten import MS_DIFFUSE_B, MS_DIFFUSE_G, MS_DIFFUSE_R

PI = float(np.float32(3.1415926))
TWO_PI = float(np.float32(6.2831853))

TYPE_OMNI = 0
TYPE_SUN = 1
TYPE_AREA = 2
TYPE_SKY = 3

# light_scalars columns
LS_TYPE = 0
LS_INTENSITY = 1
LS_TRI_FIRST = 2
LS_TRI_COUNT = 3
LS_MATERIAL = 4


def _omni(scene, light_idx, ls, position, ex):
    p3 = scene.light_pos[light_idx]  # (C, 3)
    pos = (ex(p3[:, 0]), ex(p3[:, 1]), ex(p3[:, 2]))
    color = scene.light_color[light_idx].T  # (16, C)
    intensity = ls[:, LS_INTENSITY]
    delta = vec.sub(pos, position)
    d2 = vec.dot(delta, delta)
    dist = torch.sqrt(d2)
    wiw = vec.scale(delta, 1.0 / torch.clamp(dist, min=1e-20))
    emission = ex(color) * (ex(intensity) / torch.clamp(d2, min=1e-20))
    pdf = torch.ones_like(dist)
    return wiw, dist, emission, pdf


def _sun(scene, light_idx, ls, position, ex):
    color = scene.light_color[light_idx].T
    intensity = ls[:, LS_INTENSITY]
    d3 = scene.light_dir[light_idx]
    wiw = (ex(-d3[:, 0]), ex(-d3[:, 1]), ex(-d3[:, 2]))
    dist = torch.broadcast_to(2.0 * scene.scene_radius + 1.0, position[0].shape)
    emission = ex(color * intensity)
    pdf = torch.ones_like(dist)
    return wiw, dist, emission, pdf


def _area(scene, light_idx, ls, position, r3, ex):
    first = ls[:, LS_TRI_FIRST].to(torch.int32)
    count = torch.clamp(ls[:, LS_TRI_COUNT].to(torch.int32), min=1)
    intensity = ls[:, LS_INTENSITY]
    mat_id = ls[:, LS_MATERIAL].to(torch.int32)

    tri_id = first + torch.minimum(
        (r3[0] * count.to(torch.float32)).to(torch.int32), count - 1)
    tri_id = torch.clamp(tri_id, 0, scene.tri_pos_orig.shape[0] - 1)
    t9 = scene.tri_pos_orig[tri_id.long()]  # (R, 9)
    v0 = (t9[:, 0], t9[:, 1], t9[:, 2])
    v1 = (t9[:, 3], t9[:, 4], t9[:, 5])
    v2 = (t9[:, 6], t9[:, 7], t9[:, 8])
    area = 0.5 * vec.length(vec.cross(vec.sub(v1, v0), vec.sub(v2, v0)))

    sqr_u = torch.sqrt(r3[1])
    bu = 1.0 - sqr_u
    bv = r3[2] * sqr_u
    bw = 1.0 - bu - bv
    point = vec.add(vec.add(vec.scale(v0, bu), vec.scale(v1, bv)),
                    vec.scale(v2, bw))

    delta = vec.sub((ex(point[0]), ex(point[1]), ex(point[2])), position)
    d2 = vec.dot(delta, delta)
    dist = torch.sqrt(d2)
    wiw = vec.scale(delta, 1.0 / torch.clamp(dist, min=1e-20))

    dm = scene.mat_scalars[mat_id.long()]  # (C, MS_ROWS)
    emission = ex(spectra.from_surface_color_t(
        dm[:, MS_DIFFUSE_R], dm[:, MS_DIFFUSE_G], dm[:, MS_DIFFUSE_B]
    )) * (ex(intensity) / torch.clamp(d2, min=1e-20))
    pdf = ex(1.0 / (count.to(torch.float32) * torch.clamp(area, min=1e-20)))
    return wiw, dist, emission, pdf


def _alias_pick_rows(rows, rand, base, n_f):
    """O(1) alias-method draw from (N, 4) rows [prob, alias, value, extra].

    ``base``: row offset into the table; ``n_f``: bin count (float).
    Returns (picked bin, continuous position in [0, 1)). The fractional
    part serves both the accept test and the intra-bin position."""
    rn = rand * n_f
    j = torch.clamp(rn.to(torch.int32), min=0)
    j = torch.minimum(j, n_f.to(torch.int32) - 1)
    frac = rn - j.to(torch.float32)
    r0 = rows[(base + j).long()]
    p = r0[:, 0]
    alias = r0[:, 1].to(torch.int32)
    accept = frac < p
    jf = torch.where(accept, j, alias)
    pos = torch.where(
        accept,
        frac / torch.clamp(p, min=1e-20),
        (frac - p) / torch.clamp(1.0 - p, min=1e-20),
    )
    u = (jf.to(torch.float32) + torch.clamp(pos, 0.0, 0.999999)) / n_f
    return jf, u


def _sky(scene, light_idx, position, r3, ex):
    # marginal over rows (v), then conditional over columns (u)
    h = scene.sky_marg_rows.shape[0]
    h_f = torch.tensor(float(h), dtype=torch.float32, device=r3[1].device)
    zero = torch.zeros_like(r3[1], dtype=torch.int32)
    row, v = _alias_pick_rows(scene.sky_marg_rows, r3[1], zero, h_f)
    r_marg = scene.sky_marg_rows[row.long()]  # [_, _, val, cond_int]
    v_pdf = r_marg[:, 2] / scene.sky_marginal_integral
    cond_integral = r_marg[:, 3]

    w_f = scene.sky_cond_n.to(torch.float32)
    base = row * scene.sky_cond_n
    col, u = _alias_pick_rows(scene.sky_cond_rows, r3[0], base, w_f)
    u_pdf = scene.sky_cond_rows[(base + col).long()][:, 2] / cond_integral

    theta = v * PI
    sint = torch.sin(theta)
    phi = u * TWO_PI
    pdf = torch.where(
        (u_pdf * v_pdf > 0.0) & (sint != 0.0),
        u_pdf * v_pdf / (2.0 * PI * PI * sint),
        torch.zeros_like(sint),
    )
    wl = (sint * torch.cos(phi), sint * torch.sin(phi), torch.cos(theta))
    m = scene.sky_obj2world
    wiw = vec.normalize((
        m[0, 0] * wl[0] + m[0, 1] * wl[1] + m[0, 2] * wl[2],
        m[1, 0] * wl[0] + m[1, 1] * wl[1] + m[1, 2] * wl[2],
        m[2, 0] * wl[0] + m[2, 1] * wl[1] + m[2, 2] * wl[2],
    ))
    dist = torch.broadcast_to(2.0 * scene.scene_radius + 1.0, position[0].shape)
    tex = torch.broadcast_to(scene.sky_tex, pdf.shape)
    r, g, b = tx.sample_rgb_v(scene.atlas, tex, u, v)
    s = scene.sky_intensity
    emission = ex(spectra.from_illuminant_color_t(r * s, g * s, b * s))
    return (ex(wiw[0]), ex(wiw[1]), ex(wiw[2])), dist, emission, ex(pdf)


def sample_light(scene, light_idx, position, r3, expand=None):
    """Samples the picked light toward ``position`` (an (x, y, z) tuple).

    Returns (wiW tuple, distance (R,), emission (16, R), pdf (R,)), the
    SampledLight struct of raytrace_commons.glsl:52-60. ``r3``: three
    uniforms at chain width; ``expand`` maps chain width to lane width.
    Only the light types in ``scene.light_kinds`` are evaluated."""
    ex = expand if expand is not None else (lambda a: a)
    li = light_idx.long()
    ls = scene.light_scalars[li]  # (C, 8)
    fns = {
        TYPE_OMNI: lambda: _omni(scene, li, ls, position, ex),
        TYPE_SUN: lambda: _sun(scene, li, ls, position, ex),
        TYPE_AREA: lambda: _area(scene, li, ls, position, r3, ex),
        TYPE_SKY: lambda: _sky(scene, li, position, r3, ex),
    }
    present = list(scene.light_kinds) or [TYPE_OMNI]
    ltype = ls[:, LS_TYPE].to(torch.int32)
    wiw, dist, emission, pdf = fns[present[0]]()
    for t in present[1:]:
        r = fns[t]()
        sel = ex(ltype == t)
        wiw = vec.where(sel, r[0], wiw)
        dist = torch.where(sel, r[1], dist)
        emission = torch.where(sel, r[2], emission)
        pdf = torch.where(sel, r[3], pdf)
    return wiw, dist, emission, pdf

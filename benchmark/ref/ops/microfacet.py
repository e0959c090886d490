# Frozen copy of glaze_tpu_torch/ops/microfacet.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Heitz GGX microfacet model, SoA (torch port of the ``_v`` forms of
:mod:`glaze_tpu.ops.microfacet`, lib/src/shaders/microfacets.glsl).

Directions are (x, y, z) tuples of (R,) tensors and the anisotropic
roughness is (ax, ay). The pdf keeps the reference's G1(wh) term
(microfacets.glsl:96-101) so sample weights match.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.ref.ops import vec

PI = float(np.float32(3.1415926))
TWO_PI = float(np.float32(6.2831853))


def _zero_where_inf(x):
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


def ggx_d_v(wh, ax, ay):
    """GGX normal distribution (microfacets.glsl:59-71)."""
    cost = wh[2]
    cos2t = cost * cost
    cos4t = cos2t * cos2t
    sin2t = torch.clamp(1.0 - cos2t, min=0.0)
    tan2t = sin2t / cos2t
    cos2p = wh[0] * wh[0] / sin2t
    sin2p = wh[1] * wh[1] / sin2t
    eplus1 = 1.0 + (cos2p / (ax * ax) + sin2p / (ay * ay)) * tan2t
    d = 1.0 / (PI * ax * ay * cos4t * eplus1 * eplus1)
    return torch.where(torch.isinf(tan2t), torch.zeros_like(d), d)


def ggx_lambda_v(v, ax, ay):
    """Smith Lambda (microfacets.glsl:73-84)."""
    cost = v[2]
    cos2t = cost * cost
    sin2t = torch.clamp(1.0 - cos2t, min=0.0)
    tan2t = sin2t / cos2t
    cos2p = torch.clamp(v[0] * v[0] / sin2t, min=0.0)
    sin2p = torch.clamp(v[1] * v[1] / sin2t, min=0.0)
    alpha2 = cos2p * ax * ax + sin2p * ay * ay
    lam = (-1.0 + torch.sqrt(1.0 + tan2t * alpha2)) * 0.5
    return torch.where(torch.isinf(tan2t), torch.zeros_like(lam), lam)


def ggx_g_v(wo, wi, ax, ay):
    return 1.0 / (1.0 + ggx_lambda_v(wo, ax, ay) + ggx_lambda_v(wi, ax, ay))


def ggx_g1_v(v, ax, ay):
    return 1.0 / (1.0 + ggx_lambda_v(v, ax, ay))


def ggx_pdf_v(d, ax, ay, wo, wh):
    """Sampling pdf; keeps the reference's G1(wh) quirk
    (microfacets.glsl:96-101)."""
    dot_wowh = wo[0] * wh[0] + wo[1] * wh[1] + wo[2] * wh[2]
    return d * ggx_g1_v(wh, ax, ay) * torch.abs(dot_wowh) / torch.abs(wh[2])


def _sample_p22_v(cost, r0, r1):
    """Isotropic alpha=1 visible-slope sampling (microfacets.glsl:25-57)
    -> (sx, sy) tuple of (R,)."""
    r = torch.sqrt(r0 / (1.0 - r0))
    phi = TWO_PI * r1
    special_x = r * torch.cos(phi)
    special_y = r * torch.sin(phi)

    cos2t = cost * cost
    sin2t = torch.clamp(1.0 - cos2t, min=0.0)
    tan2t = _zero_where_inf(sin2t / cos2t)
    tant = torch.sqrt(tan2t)
    a2 = 1.0 / torch.clamp(tan2t, min=1e-20)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / a2))
    A = 2.0 * r0 / g1 - 1.0
    B = tant
    inv_a2m1 = 1.0 / (A * A - 1.0)
    sqrt_term = torch.sqrt(torch.clamp(
        B * B * inv_a2m1 * inv_a2m1 - (A * A - B * B) * inv_a2m1, min=0.0))
    sx1 = B * inv_a2m1 - sqrt_term
    sx2 = B * inv_a2m1 + sqrt_term
    sx = torch.where((A < 0.0) | (sx2 > 1.0 / torch.clamp(tant, min=1e-20)),
                     sx1, sx2)
    stepval = (r1 >= 0.5).to(torch.float32)
    s = 1.0 - 2.0 * stepval
    u = torch.where(stepval > 0.5, 2.0 * (0.5 - r1), 2.0 * (r1 - 0.5))
    z = (u * (u * (u * -0.3657289 + 0.7902350) - 0.4249658) + 0.0001529) / (
        u * (u * (u * (u * 0.1695078 - 0.3972035) - 0.2325005) + 1.0) - 0.5398259
    )
    sy = s * z * torch.sqrt(1.0 + sx * sx)
    special = cost > 0.999
    return (
        torch.where(special, special_x, sx),
        torch.where(special, special_y, sy),
    )


def ggx_sample_wh_v(wo, r0, r1, ax, ay):
    """Visible-normal sampling (microfacets.glsl:104-121); returns a
    normalized (x, y, z) tuple."""
    flip = torch.sign(wo[2])
    wi = vec.scale(wo, flip)
    stretched = vec.normalize((wi[0] * ax, wi[1] * ay, wi[2]))
    cost = stretched[2]
    sx0, sy0 = _sample_p22_v(cost, r0, r1)
    cos2t = cost * cost
    sin2t = torch.clamp(1.0 - cos2t, min=0.0)
    # NOTE: sqrt loses the sign of cos/sin phi; kept to match the reference.
    cosp = torch.sqrt(stretched[0] * stretched[0] / sin2t)
    sinp = torch.sqrt(stretched[1] * stretched[1] / sin2t)
    sx = cosp * sx0 - sinp * sy0
    sy = sinp * sx0 + cosp * sy0
    wh = vec.normalize((-ax * sx, -ay * sy, torch.ones_like(sx)))
    return vec.scale(wh, flip)

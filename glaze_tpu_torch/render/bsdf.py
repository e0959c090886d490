"""BSDF evaluation and sampling, all six families, branchless SoA (torch).

Port of :mod:`glaze_tpu.render.bsdf` (the ``mat_*_value`` /
``mat_*_sample_value`` callables of the reference). Every family present
in the scene is evaluated over the whole batch and the material's family
id selects the result. Directions are (x, y, z) tuples of (R,) tensors in
shading space; spectra are (16, R); uv is a (u, v) tuple. On the card,
the NEE and BSDF stages run :mod:`glaze_tpu_torch.render.shade_cuda`'s
kernels, one family a lane, in place of :func:`bsdf_value` and
:func:`bsdf_sample`, which stay their plain versions; the NEE kernel
hands the texels it fetched to the BSDF kernel as an argument.
"""

from __future__ import annotations

import numpy as np
import torch

from glaze_tpu_torch.ops import fresnel as fr
from glaze_tpu_torch.ops import microfacet as mf
from glaze_tpu_torch.ops import spectra
from glaze_tpu_torch.ops import texture as tx
from glaze_tpu_torch.ops import vec
from glaze_tpu_torch.scene.flatten import (
    MS_ANISOTROPY,
    MS_BSDF,
    MS_DIFFUSE_B,
    MS_DIFFUSE_G,
    MS_DIFFUSE_R,
    MS_IOR,
    MS_METALNESS_MUL,
    MS_ROUGHNESS_MUL,
    MT_DIFFUSE,
    MT_METALNESS,
    MT_ROUGHNESS,
)

PI = float(np.float32(3.1415926))
INV_PI = float(np.float32(0.3183099))
TWO_PI = float(np.float32(6.2831853))

FAMILY_LAMBERT = 0
FAMILY_MIRROR = 1
FAMILY_GLASS = 2
FAMILY_METAL = 3
FAMILY_FROSTED = 4
FAMILY_UBER = 5


def gather_material(scene, mat_id):
    """Per-ray material record: row gathers transposed to (K, R). Build it
    fresh per launch step: bsdf_value and bsdf_sample memoize texture
    fetches inside it."""
    mid = mat_id.long()
    scalars = scene.mat_scalars[mid].T  # (MS_ROWS, R)
    return {
        "bsdf": scalars[MS_BSDF].to(torch.int32),
        "scalars": scalars,
        "tex": scene.mat_tex[mid].T,  # (5, R)
        "metal_ior": scene.mat_metal_ior[mid].T,  # (16, R)
        "metal_fresnel": scene.mat_metal_fresnel[mid].T,
    }


def _nan0(x):
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _f(mask):
    return mask.to(torch.float32)


def _cosine_hemisphere(r0, r1, woz):
    """lambert_sample_value's mapping (mat_lambert_sample_value.rcall:20-29)."""
    t = TWO_PI * r0
    r = torch.sqrt(r1)
    x = r * torch.cos(t)
    y = r * torch.sin(t)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0)) * torch.sign(woz)
    return (x, y, z)


def _dielectric_etas(mat, woz):
    from_outside = woz >= 0.0
    ior = mat["scalars"][MS_IOR]
    default = torch.full_like(ior, fr.DEFAULT_IOR)
    etai = torch.where(from_outside, default, ior)
    etat = torch.where(from_outside, ior, default)
    return etai, etat


def _tex_memo(mat, uv, key, fn):
    """Memo of a texture fetch inside the per-launch ``mat`` dict, keyed on
    the uv tuple's identity: bsdf_value (NEE) and bsdf_sample (bounce)
    fetch the same texels for the same hit. Only this module's plain
    versions read and write it (``_texmemo``); the kernels pass theirs as
    an argument."""
    cache = mat.setdefault("_texmemo", {})
    hit = cache.get(key)
    if hit is not None and hit[0] is uv:
        return hit[1]
    val = fn()
    cache[key] = (uv, val)
    return val


def _diffuse_texel(scene, mat, uv):
    """diffuse texture * diffuse_mul -> (r, g, b); the multiplier alone when
    no material in the scene textures the slot (texture 0 is white)."""
    def fetch():
        s = mat["scalars"]
        if MT_DIFFUSE not in scene.tex_slots:
            return s[MS_DIFFUSE_R], s[MS_DIFFUSE_G], s[MS_DIFFUSE_B]
        r, g, b = tx.sample_rgb_v(scene.atlas, mat["tex"][MT_DIFFUSE],
                                  uv[0], uv[1])
        return r * s[MS_DIFFUSE_R], g * s[MS_DIFFUSE_G], b * s[MS_DIFFUSE_B]
    return _tex_memo(mat, uv, "diffuse", fetch)


def _roughness(scene, mat, uv):
    if MT_ROUGHNESS not in scene.tex_slots:
        return mat["scalars"][MS_ROUGHNESS_MUL]
    return _tex_memo(mat, uv, "rough", lambda: (
        tx.sample_r_v(scene.atlas, mat["tex"][MT_ROUGHNESS], uv[0], uv[1])
        * mat["scalars"][MS_ROUGHNESS_MUL]))


def _metalness(scene, mat, uv):
    if MT_METALNESS not in scene.tex_slots:
        return mat["scalars"][MS_METALNESS_MUL]
    return _tex_memo(mat, uv, "metal", lambda: (
        tx.sample_r_v(scene.atlas, mat["tex"][MT_METALNESS], uv[0], uv[1])
        * mat["scalars"][MS_METALNESS_MUL]))


def _alpha(mat, rough):
    """(alpha_x, alpha_y) (microfacets.glsl to_anisotropic)."""
    aniso = mat["scalars"][MS_ANISOTROPY]
    return rough * (1.0 + aniso), rough * (1.0 - aniso)


def _oren_nayar_term(wo, wi, roughness):
    """Oren-Nayar diffuse term (mat_uber_value.rcall:57-76), with the JAX
    package's documented fix of the reference's swapped sin(alpha) /
    tan(beta) arms (pbrt 9.4.1 orientation)."""
    sigma = roughness * 0.5
    sigma2 = sigma * sigma
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    woz, wiz = wo[2], wi[2]
    sinto = torch.sqrt(torch.clamp(1.0 - woz * woz, min=0.0))
    sinti = torch.sqrt(torch.clamp(1.0 - wiz * wiz, min=0.0))
    sinpi = wi[1] / sinti
    cospi = wi[0] / sinti
    sinpo = wo[1] / sinto
    cospo = wo[0] / sinto
    maxcos = _nan0(torch.clamp(cospi * cospo + sinpi * sinpo, min=0.0))
    wi_ge_wo = torch.abs(wiz) >= torch.abs(woz)
    sinalpha = torch.where(wi_ge_wo, sinto, sinti)
    tanbeta = _nan0(torch.where(wi_ge_wo, sinti / torch.abs(wiz),
                                sinto / torch.abs(woz)))
    return INV_PI * (a + b * maxcos * sinalpha * tanbeta)


def _ggx_reflect_terms(wo, wi, wh, ax, ay):
    costwo = torch.abs(wo[2])
    costwi = torch.abs(wi[2])
    dotwowh = vec.dot(wo, wh)
    d = mf.ggx_d_v(wh, ax, ay)
    g = mf.ggx_g_v(wo, wi, ax, ay)
    pdf = mf.ggx_pdf_v(d, ax, ay, wo, wh) / (4.0 * dotwowh)
    term = d * g / (4.0 * costwo * costwi)
    return term, pdf


def _zeros(x):
    return torch.zeros_like(x)


# ---------------------------------------------------------------------------
# value (NEE): given wo and wi in shading space, return ((16,R), pdf (R,))
# ---------------------------------------------------------------------------


def _lambert_value(scene, mat, wo, wi, uv, rand):
    same_hemi = _f(wo[2] * wi[2] >= 0.0)
    r, g, b = _diffuse_texel(scene, mat, uv)
    value = spectra.from_surface_color_t(r * INV_PI, g * INV_PI, b * INV_PI)
    pdf = same_hemi * torch.abs(wi[2]) * INV_PI
    return value, pdf


def _metal_value(scene, mat, wo, wi, uv, rand):
    wh = vec.normalize(vec.add(wo, wi))
    same = wo[2] * wi[2] > 0.0
    f = fr.fresnel_conductor_t(vec.dot(wi, wh), mat["metal_ior"],
                               mat["metal_fresnel"])
    rough = _roughness(scene, mat, uv)
    ax, ay = _alpha(mat, rough)
    term, pdf = _ggx_reflect_terms(wo, wi, wh, ax, ay)
    pdf = torch.where(same, _nan0(pdf), _zeros(pdf))
    value = f * torch.where(same, _nan0(term), _zeros(term))
    return value, pdf


def _frosted_value(scene, mat, wo, wi, uv, rand):
    rough = _roughness(scene, mat, uv)
    ax, ay = _alpha(mat, rough)
    woz = wo[2]
    same = woz * wi[2] > 0.0
    etai, etat = _dielectric_etas(mat, woz)
    eta = etai / etat
    costwo = torch.abs(woz)
    costwi = torch.abs(wi[2])

    # reflected lobe (mat_frosted_value.rcall:36-50)
    wh_r = vec.normalize(vec.add(wo, wi))
    dotwowh_r = vec.dot(wo, wh_r)
    dotwiwh_r = vec.dot(wi, wh_r)
    costi_r = vec.dot(wi, vec.scale(wh_r, torch.sign(wh_r[2])))
    f_r = fr.fresnel_dielectric(costi_r, etai, etat)
    d_r = _f(woz >= 0.0) * mf.ggx_d_v(wh_r, ax, ay)
    g_r = (_f(dotwowh_r >= 0.0) * _f(dotwiwh_r >= 0.0)
           * mf.ggx_g_v(wo, wi, ax, ay))
    pdf_r = _nan0(mf.ggx_pdf_v(d_r, ax, ay, wo, wh_r) / (4.0 * dotwowh_r))
    term_r = d_r * g_r * f_r / (4.0 * costwo * costwi)

    # transmitted lobe (:51-69)
    wh_t = vec.normalize(vec.add(wo, vec.scale(wi, eta)))
    wh_t = vec.scale(wh_t, torch.sign(woz))
    dotwowh_t = vec.dot(wo, wh_t)
    dotwiwh_t = vec.dot(wi, wh_t)
    f_t = fr.fresnel_dielectric(dotwowh_t, etai, etat)
    denom = dotwowh_t + eta * dotwiwh_t
    d_t = mf.ggx_d_v(wh_t, ax, ay)
    g_t = mf.ggx_g_v(wo, wi, ax, ay)
    pdf_t = _nan0(mf.ggx_pdf_v(d_t, ax, ay, wo, wh_t)
                  * torch.abs(eta * eta * dotwiwh_t) / (denom * denom))
    term_t = (d_t * g_t * (1.0 - f_t) * torch.abs(dotwiwh_t)
              * torch.abs(dotwowh_t) / (denom * denom * costwo * costwi))

    term = torch.where(same, term_r, term_t)
    pdf = torch.where(same, pdf_r, pdf_t)
    return spectra.uniform_t(_nan0(term)), _nan0(pdf)


def _uber_value(scene, mat, wo, wi, uv, rand):
    rough = _roughness(scene, mat, uv)
    same_hemi = _f(wo[2] * wi[2] >= 0.0)
    spec_branch = rand < 0.5

    # specular half (mat_uber_value.rcall:28-54); keeps the reference's
    # roughness*roughness_mul^2 quirk in to_anisotropic's argument
    ax, ay = _alpha(mat, rough * mat["scalars"][MS_ROUGHNESS_MUL])
    wh = vec.normalize(vec.add(wo, wi))
    metalness = _metalness(scene, mat, uv)
    woz = wo[2]
    etai, etat = _dielectric_etas(mat, woz)
    dotwowh = vec.dot(wo, wh)
    dotwiwh = vec.dot(wi, wh)
    costi = vec.dot(wi, vec.scale(wh, torch.sign(wh[2])))
    fd = spectra.uniform_t(fr.fresnel_dielectric(costi, etai, etat))
    fc = fr.fresnel_conductor_t(costi, mat["metal_ior"], mat["metal_fresnel"])
    f = fd + (fc - fd) * metalness
    d = _f(woz >= 0.0) * mf.ggx_d_v(wh, ax, ay)
    g = _f(dotwowh >= 0.0) * _f(dotwiwh >= 0.0) * mf.ggx_g_v(wo, wi, ax, ay)
    pdf_spec = _nan0(same_hemi * 0.5 * mf.ggx_pdf_v(d, ax, ay, wo, wh)
                     / (4.0 * dotwowh))
    term_spec = _nan0(d * g / (4.0 * torch.abs(woz) * torch.abs(wi[2])))
    value_spec = f * term_spec

    # diffuse half: Oren-Nayar (:55-77)
    r, g2, b = _diffuse_texel(scene, mat, uv)
    term_on = _oren_nayar_term(wo, wi, rough)
    value_diff = spectra.from_surface_color_t(r * term_on, g2 * term_on,
                                              b * term_on)
    pdf_diff = _nan0(same_hemi * 0.5 * torch.abs(wi[2]) * INV_PI)

    value = torch.where(spec_branch, value_spec, value_diff)
    pdf = torch.where(spec_branch, pdf_spec, pdf_diff)
    return value, pdf


_VALUE_FNS = {
    FAMILY_LAMBERT: _lambert_value,
    FAMILY_METAL: _metal_value,
    FAMILY_FROSTED: _frosted_value,
    FAMILY_UBER: _uber_value,
}


def bsdf_value(scene, mat, wo, wi, uv, rand):
    """NEE-side evaluation: (value (16, R), pdf (R,)). MIRROR and GLASS are
    delta distributions: pdf 0. Only ``scene.mat_families`` are evaluated."""
    present = [f for f in scene.mat_families if f in _VALUE_FNS]
    r = wo[2].shape[0]
    if not present:
        dev = wo[2].device
        return (torch.zeros((16, r), dtype=torch.float32, device=dev),
                torch.zeros((r,), dtype=torch.float32, device=dev))
    fam = mat["bsdf"]
    value = pdf = None
    for f in present:
        v, p = _VALUE_FNS[f](scene, mat, wo, wi, uv, rand)
        v = v.expand(16, r)
        if value is None:
            # single-family scenes skip the select, but delta families
            # (absent from _VALUE_FNS) must still zero out
            if len(present) == len(scene.mat_families) == 1:
                return v, p
            sel = fam == f
            value = torch.where(sel, v, _zeros(v))
            pdf = torch.where(sel, p, _zeros(p))
        else:
            sel = fam == f
            value = torch.where(sel, v, value)
            pdf = torch.where(sel, p, pdf)
    return value, pdf


# ---------------------------------------------------------------------------
# sample (bounce): given wo, return (wi tuple, value (16, R), pdf (R,))
# ---------------------------------------------------------------------------


def _lambert_sample(scene, mat, wo, uv, r3):
    wi = _cosine_hemisphere(r3[0], r3[1], wo[2])
    pdf = torch.abs(wi[2]) * INV_PI
    r, g, b = _diffuse_texel(scene, mat, uv)
    value = spectra.from_surface_color_t(r * INV_PI, g * INV_PI, b * INV_PI)
    return wi, value, pdf


def _mirror_sample(scene, mat, wo, uv, r3):
    wi = (-wo[0], -wo[1], wo[2])
    f = fr.fresnel_conductor_t(wo[2], mat["metal_ior"], mat["metal_fresnel"])
    value = f / torch.clamp(torch.abs(wo[2]), min=1e-20)
    pdf = torch.ones_like(wo[2])
    return wi, value, pdf


def _glass_sample(scene, mat, wo, uv, r3):
    woz = wo[2]
    from_outside = woz >= 0.0
    etai, etat = _dielectric_etas(mat, woz)
    costi = torch.where(from_outside, woz, torch.abs(woz))
    f = fr.fresnel_dielectric(costi, etai, etat)

    wi_refl = (-wo[0], -wo[1], woz)
    eval_refl = f / torch.clamp(torch.abs(woz), min=1e-20)

    zeros = torch.zeros_like(woz)
    n = (zeros, zeros, torch.sign(woz))
    wi_refr = vec.refract(wo, n, etai / etat)
    eval_refr = ((1.0 - f) * (etai * etai)
                 / torch.clamp(etat * etat * torch.abs(wi_refr[2]), min=1e-20))

    reflect = r3[2] < f
    wi = vec.where(reflect, wi_refl, wi_refr)
    value = spectra.uniform_t(torch.where(reflect, eval_refl, eval_refr))
    pdf = torch.where(reflect, f, 1.0 - f)
    return wi, value, pdf


def _metal_sample(scene, mat, wo, uv, r3):
    rough = _roughness(scene, mat, uv)
    ax, ay = _alpha(mat, rough)
    wh = mf.ggx_sample_wh_v(wo, r3[0], r3[1], ax, ay)
    wi = vec.normalize(vec.neg(vec.reflect(wo, wh)))
    same = wo[2] * wi[2] > 0.0
    f = fr.fresnel_conductor_t(vec.dot(wi, wh), mat["metal_ior"],
                               mat["metal_fresnel"])
    term, pdf = _ggx_reflect_terms(wo, wi, wh, ax, ay)
    value = f * torch.where(same, _nan0(term), _zeros(term))
    pdf = torch.where(same, _nan0(pdf), _zeros(pdf))
    return wi, value, pdf


def _frosted_sample(scene, mat, wo, uv, r3):
    rough = _roughness(scene, mat, uv)
    ax, ay = _alpha(mat, rough)
    wh = mf.ggx_sample_wh_v(wo, r3[0], r3[1], ax, ay)
    woz = wo[2]
    etai, etat = _dielectric_etas(mat, woz)
    eta = etai / etat
    costwo = torch.abs(woz)

    # reflect branch (mat_frosted_sample_value.rcall:31-50)
    wi_r = vec.normalize(vec.neg(vec.reflect(wo, wh)))
    dotwowh_r = vec.dot(wo, wh)
    dotwiwh_r = vec.dot(wi_r, wh)
    costi_r = vec.dot(wi_r, vec.scale(wh, torch.sign(wh[2])))
    f_r = fr.fresnel_dielectric(costi_r, etai, etat)
    d_r = _f(woz >= 0.0) * mf.ggx_d_v(wh, ax, ay)
    g_r = (_f(dotwowh_r >= 0.0) * _f(dotwiwh_r >= 0.0)
           * mf.ggx_g_v(wo, wi_r, ax, ay))
    pdf_r = _nan0(0.5 * mf.ggx_pdf_v(d_r, ax, ay, wo, wh) / (4.0 * dotwowh_r))
    term_r = d_r * g_r * f_r / (4.0 * costwo * torch.abs(wi_r[2]))

    # refract branch (:51-70)
    wi_t = vec.normalize(vec.refract(wo, wh, eta))
    dotwowh_t = vec.dot(wo, wh)
    dotwiwh_t = vec.dot(wi_t, wh)
    f_t = fr.fresnel_dielectric(dotwowh_t, etai, etat)
    denom = dotwowh_t + eta * dotwiwh_t
    d_t = mf.ggx_d_v(wh, ax, ay)
    g_t = mf.ggx_g_v(wo, wi_t, ax, ay)
    pdf_t = _nan0(0.5 * mf.ggx_pdf_v(d_t, ax, ay, wo, wh)
                  * torch.abs(eta * eta * dotwiwh_t) / (denom * denom))
    pdf_t = torch.where(dotwowh_t * dotwiwh_t < 0.0, pdf_t, _zeros(pdf_t))
    term_t = (d_t * g_t * (1.0 - f_t) * torch.abs(dotwiwh_t)
              * torch.abs(dotwowh_t)
              / (denom * denom * costwo * torch.abs(wi_t[2])))

    refl = r3[2] < 0.5
    wi = vec.where(refl, wi_r, wi_t)
    value = spectra.uniform_t(_nan0(torch.where(refl, term_r, term_t)))
    pdf = torch.where(refl, pdf_r, pdf_t)
    return wi, value, pdf


def _uber_sample(scene, mat, wo, uv, r3):
    rough = _roughness(scene, mat, uv)
    woz = wo[2]

    # specular branch (mat_uber_sample_value.rcall:28-56)
    ax, ay = _alpha(mat, rough * mat["scalars"][MS_ROUGHNESS_MUL])
    wh = mf.ggx_sample_wh_v(wo, r3[0], r3[1], ax, ay)
    wi_s = vec.normalize(vec.neg(vec.reflect(wo, wh)))
    metalness = _metalness(scene, mat, uv)
    etai, etat = _dielectric_etas(mat, woz)
    dotwowh = vec.dot(wo, wh)
    dotwiwh = vec.dot(wi_s, wh)
    costi = vec.dot(wi_s, vec.scale(wh, torch.sign(wh[2])))
    fd = spectra.uniform_t(fr.fresnel_dielectric(costi, etai, etat))
    fc = fr.fresnel_conductor_t(costi, mat["metal_ior"], mat["metal_fresnel"])
    f = fd + (fc - fd) * metalness
    d = _f(woz >= 0.0) * mf.ggx_d_v(wh, ax, ay)
    g = _f(dotwowh >= 0.0) * _f(dotwiwh >= 0.0) * mf.ggx_g_v(wo, wi_s, ax, ay)
    pdf_s = _nan0(0.5 * mf.ggx_pdf_v(d, ax, ay, wo, wh) / (4.0 * dotwowh))
    term_s = _nan0(d * g / (4.0 * torch.abs(woz) * torch.abs(wi_s[2])))
    value_s = f * term_s

    # diffuse branch (:57-83)
    wi_d = _cosine_hemisphere(r3[0], r3[1], woz)
    r, g2, b = _diffuse_texel(scene, mat, uv)
    term_on = _oren_nayar_term(wo, wi_d, rough)
    value_d = spectra.from_surface_color_t(r * term_on, g2 * term_on,
                                           b * term_on)
    pdf_d = 0.5 * torch.abs(wi_d[2]) * INV_PI

    spec = r3[2] < 0.5
    wi = vec.where(spec, wi_s, wi_d)
    value = torch.where(spec, value_s, value_d)
    pdf = torch.where(spec, pdf_s, pdf_d)
    return wi, value, pdf


_SAMPLE_FNS = {
    FAMILY_LAMBERT: _lambert_sample,
    FAMILY_MIRROR: _mirror_sample,
    FAMILY_GLASS: _glass_sample,
    FAMILY_METAL: _metal_sample,
    FAMILY_FROSTED: _frosted_sample,
    FAMILY_UBER: _uber_sample,
}


def bsdf_sample(scene, mat, wo, uv, r3):
    """Bounce sampling: (wi tuple, value (16, R), pdf (R,)). ``r3``: three
    (R,) uniforms. Only ``scene.mat_families`` are evaluated."""
    present = list(scene.mat_families) or [FAMILY_LAMBERT]
    fam = mat["bsdf"]
    r = wo[2].shape[0]
    wi, value, pdf = _SAMPLE_FNS[present[0]](scene, mat, wo, uv, r3)
    value = value.expand(16, r)
    for family in present[1:]:
        w, v, p = _SAMPLE_FNS[family](scene, mat, wo, uv, r3)
        sel = fam == family
        wi = vec.where(sel, w, wi)
        value = torch.where(sel, v, value)
        pdf = torch.where(sel, p, pdf)
    return wi, value, pdf

// The lane arithmetic of the integrator's three shading kernels:
//   * surface_lane, the shade stage of one lane: the hit's attributes, normal
//     mapping, the shading frame, wo, the material's specular flag and the
//     sky on a missed lane, as glaze_tpu_torch.render.shade_cuda.surface_plain
//     computes them (interpolate_hit, sky_radiance, spectra.to_rgb_t);
//   * nee_lane, the NEE stage of one lane before its shadow ray: the light
//     sample, the BSDF value, the weight and the unshadowed RGB
//     contribution, as glaze_tpu_torch.render.shade_cuda.nee_plain computes
//     them with render/lights.py (sample_light) and render/bsdf.py
//     (bsdf_value);
//   * bsdf_lane, the BSDF stage of one lane: the accumulation, Russian
//     roulette, the BSDF sample of the lane's own family and the path-state
//     update, as glaze_tpu_torch.render.shade_cuda.bsdf_plain computes them
//     with render/bsdf.py (bsdf_sample).
//
// Host-and-device code: csrc/shade.cu runs each once per thread, and a
// host compiler can build the same functions for a loop over lanes
// (tests/test_torch_nee.py, tests/test_torch_bsdf_stage.py and
// tests/test_torch_shade_stage.py hold those loops against the plain
// versions on the CPU). Every operation is the
// plain version's, in its order, one
// rounding each (nvcc --fmad=false, no fast math): a torch elementwise op
// on (R,) or (16, R) tensors is one scalar operation of a lane here, a
// torch.where of two branches is a branch that computes only the taken
// one, and a family or light type absent from the lane is not evaluated.
// Conventions that follow PyTorch's CUDA kernels, so that the kernel
// agrees bit for bit with the plain version run on the card:
//   * ``c / t`` for a Python float c is Tensor.__rtruediv__, a reciprocal
//     times c: an IEEE division 1.0f / x, then the product (rdiv below);
//   * ``t / <Python float>`` multiplies by the divisor's reciprocal,
//     taken in double and rounded to float (PyTorch's CUDA divide takes
//     that path for a CPU scalar); a division by a tensor, 0-d ones
//     included, divides;
//   * clamp and clamp_min pass a NaN through, else fmaxf / fminf;
//     torch.sign is (0 < x) - (x < 0), so 0 for NaN and for -0;
//   * Python float constants convert to float32 as torch converts a
//     wrapped double (F32 below);
//   * int remainder takes the divisor's sign (torch.remainder);
//   * torch.sum over the 16 bins of a (16, R) tensor: on the card four
//     accumulators, bin k into k % 4, joined in order (PyTorch's CUDA
//     reduction, four loads in flight a thread); on the host one
//     accumulator, bins ascending, as PyTorch's CPU sum (bin_sum below);
//   * torch.atan2, acos and ``**`` on the card are atan2f, acosf and powf.
// Only nee_lane's 16-bin sums of the XYZ integral run in another order
// than the plain version's torch.sum (bins ascending here).
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define GLAZE_HD __host__ __device__ __forceinline__
#else
#define GLAZE_HD inline
#endif

#define F32(x) static_cast<float>(x)

namespace glaze_shade {

constexpr int kBins = 16;
// the constants table (render/shade_cuda.py CONSTS): Smits bases (white,
// cyan, magenta, yellow, red, green, blue rows of 16), surface then
// illuminant; CIE x, y, z; the XYZ -> linear sRGB matrix by rows; the two
// basis scales and 1 / (sum of CIE y)
constexpr int kSurf = 0;
constexpr int kIllum = 7 * kBins;
constexpr int kCieX = 14 * kBins;
constexpr int kCieY = 15 * kBins;
constexpr int kCieZ = 16 * kBins;
constexpr int kXyzToRgb = 17 * kBins;
constexpr int kSurfScale = kXyzToRgb + 9;
constexpr int kIllumScale = kSurfScale + 1;
constexpr int kInvYSum = kSurfScale + 2;
constexpr int kConsts = kSurfScale + 3;

// lights.py and bsdf.py constants (float(np.float32(...)))
constexpr float kPi = F32(3.1415926);
constexpr float kTwoPi = F32(6.2831853);
constexpr float kInvPi = F32(0.3183099);
constexpr float kDefaultIor = F32(1.000293);
constexpr float kInv255 = F32(1.0 / 255.0);
constexpr float kTiny = F32(1e-20);

// light types (lights.py TYPE_*) and BSDF families (bsdf.py FAMILY_*)
enum { kOmni = 0, kSun = 1, kArea = 2, kSky = 3 };
enum { kLambert = 0, kMirror = 1, kGlass = 2, kMetal = 3, kFrosted = 4,
       kUber = 5 };
// tex_flags bits: the slot is textured somewhere in the scene
// (scene.tex_slots holds MT_DIFFUSE, MT_ROUGHNESS, MT_METALNESS, MT_NORMAL)
enum { kTexDiffuse = 1, kTexRoughness = 2, kTexMetalness = 4, kTexNormal = 8 };

struct NeeArgs {
  // lanes: hit point, shading frame (s, t, n = the shading normal), wo in
  // world space, uv, material row, importance (16, P), nee_active
  const float* px; const float* py; const float* pz;
  const float* sx; const float* sy; const float* sz;
  const float* tx; const float* ty; const float* tz;
  const float* nx; const float* ny; const float* nz;
  const float* wox; const float* woy; const float* woz;
  const float* u; const float* v;
  const int32_t* mat_id;
  const float* importance;
  const uint8_t* nee_active;
  // chains (width C; lane i reads entry i / lanes_per_chain): the light
  // pick, the three light draws, the BSDF draw
  const float* r_pick; const float* r_a; const float* r_b; const float* r_c;
  const float* r_bsdf;
  // tables, read in place
  const float* light_scalars;   // (L, 8)
  const float* light_pos;       // (L, 3)
  const float* light_dir;       // (L, 3)
  const float* light_color;     // (L, 16)
  const int32_t* lights_no;     // ()
  const float* tri_pos;         // (N0, 9)
  const float* mat_scalars;     // (M, 10)
  const int32_t* mat_tex;       // (M, 5)
  const float* metal_ior;       // (M, 16)
  const float* metal_fresnel;   // (M, 16)
  const int32_t* texels;        // (T, 4)
  const int32_t* tex_offset; const int32_t* tex_width;
  const int32_t* tex_height; const float* tex_srgb;
  const float* sky_marg_rows;   // (H, 4)
  const float* sky_cond_rows;   // (H * W, 4)
  const int32_t* sky_cond_n;    // ()
  const float* sky_marginal_integral;  // ()
  const float* sky_obj2world;   // (3, 3)
  const int32_t* sky_tex;       // ()
  const float* sky_intensity;   // ()
  const float* scene_radius;    // ()
  const float* scene_centre;    // (3,)
  const float* consts;          // kConsts
  // outputs, (P,) each; the texel outputs may be null (not wanted)
  float* wix; float* wiy; float* wiz;
  float* cap;
  uint8_t* shadow_active;
  float* rgb_r; float* rgb_g; float* rgb_b;
  int32_t* key;
  float* diffuse_r; float* diffuse_g; float* diffuse_b;
  float* roughness; float* metalness;
  // sizes
  int n_lanes;
  int lanes_per_chain;
  int n_tris;
  int sky_rows;
  int tex_flags;
};

struct V3 {
  float x, y, z;
};

GLAZE_HD V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
GLAZE_HD V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
GLAZE_HD V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
GLAZE_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
GLAZE_HD V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
GLAZE_HD float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
GLAZE_HD float clamp2(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
GLAZE_HD float nan0(float x) { return x != x ? 0.0f : x; }
// ``c / t`` for a Python float c (Tensor.__rtruediv__): the reciprocal,
// times c
GLAZE_HD float rdiv(float c, float x) { return (1.0f / x) * c; }
GLAZE_HD bool is_inf(float x) { return fabsf(x) > 3.40282347e38f; }
GLAZE_HD float sign(float x) { return F32((0.0f < x) - (x < 0.0f)); }
GLAZE_HD float step(bool b) { return b ? 1.0f : 0.0f; }
GLAZE_HD int imin(int a, int b) { return a < b ? a : b; }
GLAZE_HD int imax(int a, int b) { return a > b ? a : b; }
GLAZE_HD int int_remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
GLAZE_HD float length(V3 a) { return sqrtf(dot(a, a)); }
GLAZE_HD V3 normalize(V3 a) {
  const float inv = 1.0f / clamp_min(length(a), kTiny);
  return scale(a, inv);
}
// world -> shading space (ops/shading.py to_shading_space_v)
GLAZE_HD V3 to_shading(V3 w, V3 s, V3 t, V3 n) {
  return normalize({dot(w, s), dot(w, t), dot(w, n)});
}

// ---- spectra (ops/spectra.py) ----------------------------------------------

// from_rgb_t: Smits RGB -> spectrum, clamped to [0, 1]
GLAZE_HD void from_rgb(const float* K, float r, float g, float b, bool light,
                       float* out) {
  const float* B = K + (light ? kIllum : kSurf);
  const float scale_ = K[light ? kIllumScale : kSurfScale];
  const bool m1 = (r <= g) && (r <= b), m1a = g <= b;
  const bool m2 = (g <= r) && (g <= b), m2a = r <= b;
  const bool m3a = r <= g;
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    const float white = B[k], cyan = B[kBins + k], magenta = B[2 * kBins + k],
                yellow = B[3 * kBins + k], red = B[4 * kBins + k],
                green = B[5 * kBins + k], blue = B[6 * kBins + k];
    float res;
    if (m1)
      res = r * white + (m1a ? (g - r) * cyan + (b - g) * blue
                             : (b - r) * cyan + (g - b) * green);
    else if (m2)
      res = g * white + (m2a ? (r - g) * magenta + (b - r) * blue
                             : (b - g) * magenta + (r - b) * red);
    else
      res = b * white + (m3a ? (r - b) * yellow + (g - r) * green
                             : (g - b) * yellow + (r - g) * red);
    out[k] = clamp2(res * scale_, 0.0f, 1.0f);
  }
}

// ---- texture atlas (ops/texture.py) ----------------------------------------

GLAZE_HD float srgb_to_linear(float c) {
  return c <= F32(0.04045)
             ? c * F32(1.0 / 12.92)
             : powf((c + F32(0.055)) * F32(1.0 / 1.055), F32(2.4));
}

// bilinear fetch at mip 0, REPEAT wrap, of the first ``channels`` channels
// (``a``: NeeArgs or BsdfArgs, whose atlas fields share their names)
template <class Args>
GLAZE_HD void sample_tex(const Args& a, int tex, float u, float v,
                         int channels, float* out) {
  const int off = a.tex_offset[tex], w = a.tex_width[tex],
            h = a.tex_height[tex];
  const bool srgb = a.tex_srgb[tex] > 0.5f;
  u = u - floorf(u);
  v = v - floorf(v);
  const float x = u * F32(w) - 0.5f, y = v * F32(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = int_remainder(static_cast<int>(x0), w);
  const int y0i = int_remainder(static_cast<int>(y0), h);
  const int32_t* quad =
      a.texels + 4 * static_cast<int64_t>(off + y0i * w + x0i);
  int32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = quad[k];
  const float ofx = 1.0f - fx, ofy = 1.0f - fy;
#pragma unroll
  for (int c = 0; c < channels; ++c) {
    float tap[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x_ = F32((q[k] >> (8 * c)) & 0xFF) * kInv255;
      tap[k] = (c < 3 && srgb) ? srgb_to_linear(x_) : x_;
    }
    const float top = tap[0] * ofx + tap[1] * fx;
    const float bot = tap[2] * ofx + tap[3] * fx;
    out[c] = top * ofy + bot * fy;
  }
}

// ---- Fresnel and GGX (ops/fresnel.py, ops/microfacet.py) -------------------

GLAZE_HD float fresnel_conductor(float cosin, float ior, float ior2abs2) {
  const float cosin2 = cosin * cosin;
  const float etacosin2 = ior * (cosin * 2.0f);
  const float etacosin2plus = etacosin2 + cosin2;
  const float etacosin2plusplus = etacosin2 + 1.0f;
  const float rperpsq =
      (ior2abs2 - etacosin2plus) / (ior2abs2 + etacosin2plus);
  const float tmp = ior2abs2 * cosin2;
  const float rparsq =
      (tmp - etacosin2plusplus) / (tmp + etacosin2plusplus);
  return (rperpsq + rparsq) * 0.5f;
}

GLAZE_HD float fresnel_dielectric(float costi, float etai, float etat) {
  const float sin2ti = clamp_min(1.0f - costi * costi, 0.0f);
  const float sin2tt = (etai * etai) / (etat * etat) * sin2ti;
  const float costt = sqrtf(clamp_min(1.0f - sin2tt, 0.0f));
  const float etatcostt = etat * costt, etatcosti = etat * costi;
  const float etaicosti = etai * costi, etaicostt = etai * costt;
  const float rparl = (etatcosti - etaicostt) / (etatcosti + etaicostt);
  const float rperp = (etaicosti - etatcostt) / (etaicosti + etatcostt);
  const float f = (rparl * rparl + rperp * rperp) * 0.5f;
  return sin2tt >= 1.0f ? 1.0f : f;
}

GLAZE_HD float ggx_d(V3 wh, float ax, float ay) {
  const float cost = wh.z;
  const float cos2t = cost * cost;
  const float cos4t = cos2t * cos2t;
  const float sin2t = clamp_min(1.0f - cos2t, 0.0f);
  const float tan2t = sin2t / cos2t;
  const float cos2p = wh.x * wh.x / sin2t;
  const float sin2p = wh.y * wh.y / sin2t;
  const float eplus1 = 1.0f + (cos2p / (ax * ax) + sin2p / (ay * ay)) * tan2t;
  const float d = 1.0f / (kPi * ax * ay * cos4t * eplus1 * eplus1);
  return is_inf(tan2t) ? 0.0f : d;
}

GLAZE_HD float ggx_lambda(V3 v, float ax, float ay) {
  const float cost = v.z;
  const float cos2t = cost * cost;
  const float sin2t = clamp_min(1.0f - cos2t, 0.0f);
  const float tan2t = sin2t / cos2t;
  const float cos2p = clamp_min(v.x * v.x / sin2t, 0.0f);
  const float sin2p = clamp_min(v.y * v.y / sin2t, 0.0f);
  const float alpha2 = cos2p * ax * ax + sin2p * ay * ay;
  const float lam = (sqrtf(1.0f + tan2t * alpha2) + -1.0f) * 0.5f;
  return is_inf(tan2t) ? 0.0f : lam;
}

GLAZE_HD float ggx_g(V3 wo, V3 wi, float ax, float ay) {
  return 1.0f / (1.0f + ggx_lambda(wo, ax, ay) + ggx_lambda(wi, ax, ay));
}

GLAZE_HD float ggx_pdf(float d, float ax, float ay, V3 wo, V3 wh) {
  const float g1 = 1.0f / (1.0f + ggx_lambda(wh, ax, ay));
  return d * g1 * fabsf(dot(wo, wh)) / fabsf(wh.z);
}

// ---- light samples (render/lights.py) --------------------------------------

struct LightSample {
  V3 wiw;
  float dist, pdf;
  float em[kBins];
};

// the omni and area lights' direction, distance and 1/d^2 term toward p
GLAZE_HD float toward(V3 target, V3 p, LightSample& L) {
  const V3 delta = sub(target, p);
  const float d2 = dot(delta, delta);
  L.dist = sqrtf(d2);
  L.wiw = scale(delta, 1.0f / clamp_min(L.dist, kTiny));
  return clamp_min(d2, kTiny);
}

GLAZE_HD void sample_omni(const NeeArgs& a, int li, V3 p, LightSample& L) {
  const float* p3 = a.light_pos + 3 * li;
  const float q =
      a.light_scalars[8 * li + 1] / toward({p3[0], p3[1], p3[2]}, p, L);
  const float* color = a.light_color + kBins * li;
#pragma unroll
  for (int k = 0; k < kBins; ++k) L.em[k] = color[k] * q;
  L.pdf = 1.0f;
}

GLAZE_HD void sample_sun(const NeeArgs& a, int li, LightSample& L) {
  const float* d3 = a.light_dir + 3 * li;
  L.wiw = {-d3[0], -d3[1], -d3[2]};
  L.dist = 2.0f * *a.scene_radius + 1.0f;
  const float intensity = a.light_scalars[8 * li + 1];
  const float* color = a.light_color + kBins * li;
#pragma unroll
  for (int k = 0; k < kBins; ++k) L.em[k] = color[k] * intensity;
  L.pdf = 1.0f;
}

GLAZE_HD void sample_area(const NeeArgs& a, const float* K, int li, V3 p,
                          float ra, float rb, float rc, LightSample& L) {
  const float* ls = a.light_scalars + 8 * li;
  const int first = static_cast<int>(ls[2]);
  const int count = imax(static_cast<int>(ls[3]), 1);
  const float intensity = ls[1];
  const int mat = static_cast<int>(ls[4]);
  int tri = first + imin(static_cast<int>(ra * F32(count)), count - 1);
  tri = imin(imax(tri, 0), a.n_tris - 1);
  const float* t9 = a.tri_pos + 9 * static_cast<int64_t>(tri);
  const V3 v0 = {t9[0], t9[1], t9[2]}, v1 = {t9[3], t9[4], t9[5]},
           v2 = {t9[6], t9[7], t9[8]};
  const float area = 0.5f * length(cross(sub(v1, v0), sub(v2, v0)));
  const float sqr_u = sqrtf(rb);
  const float bu = 1.0f - sqr_u;
  const float bv = rc * sqr_u;
  const float bw = 1.0f - bu - bv;
  const V3 point = add(add(scale(v0, bu), scale(v1, bv)), scale(v2, bw));
  const float q = intensity / toward(point, p, L);
  const float* dm = a.mat_scalars + 10 * mat;
  from_rgb(K, dm[5], dm[6], dm[7], false, L.em);
#pragma unroll
  for (int k = 0; k < kBins; ++k) L.em[k] = L.em[k] * q;
  L.pdf = 1.0f / (F32(count) * clamp_min(area, kTiny));
}

// lights.py _alias_pick_rows: (picked bin, continuous position in [0, 1))
GLAZE_HD int alias_pick(const float* rows, float rand, int base, float n_f,
                        float& pos_out) {
  const float rn = rand * n_f;
  int j = imax(static_cast<int>(rn), 0);
  j = imin(j, static_cast<int>(n_f) - 1);
  const float frac = rn - F32(j);
  const float* r0 = rows + 4 * static_cast<int64_t>(base + j);
  const float p = r0[0];
  const bool accept = frac < p;
  const int jf = accept ? j : static_cast<int>(r0[1]);
  const float pos = accept ? frac / clamp_min(p, kTiny)
                           : (frac - p) / clamp_min(1.0f - p, kTiny);
  pos_out = (F32(jf) + clamp2(pos, 0.0f, F32(0.999999))) / n_f;
  return jf;
}

GLAZE_HD void sample_sky(const NeeArgs& a, const float* K, float ra,
                         float rb, LightSample& L) {
  // marginal over rows (v), then conditional over columns (u)
  float v, u;
  const int row = alias_pick(a.sky_marg_rows, rb, 0, F32(a.sky_rows), v);
  const float* rm = a.sky_marg_rows + 4 * static_cast<int64_t>(row);
  const float v_pdf = rm[2] / *a.sky_marginal_integral;
  const float cond_integral = rm[3];
  const int w = *a.sky_cond_n;
  const int base = row * w;
  const int col = alias_pick(a.sky_cond_rows, ra, base, F32(w), u);
  const float u_pdf =
      a.sky_cond_rows[4 * static_cast<int64_t>(base + col) + 2] /
      cond_integral;
  const float theta = v * kPi;
  const float sint = sinf(theta);
  const float phi = u * kTwoPi;
  const float uv_pdf = u_pdf * v_pdf;
  L.pdf = (uv_pdf > 0.0f && sint != 0.0f)
              ? uv_pdf / (sint * F32(2.0 * double(kPi) * double(kPi)))
              : 0.0f;
  const V3 wl = {sint * cosf(phi), sint * sinf(phi), cosf(theta)};
  const float* m = a.sky_obj2world;
  L.wiw = normalize({m[0] * wl.x + m[1] * wl.y + m[2] * wl.z,
                     m[3] * wl.x + m[4] * wl.y + m[5] * wl.z,
                     m[6] * wl.x + m[7] * wl.y + m[8] * wl.z});
  L.dist = 2.0f * *a.scene_radius + 1.0f;
  float rgb[3];
  sample_tex(a, *a.sky_tex, u, v, 3, rgb);
  const float s = *a.sky_intensity;
  from_rgb(K, rgb[0] * s, rgb[1] * s, rgb[2] * s, true, L.em);
}

// ---- BSDF values (render/bsdf.py) ------------------------------------------

struct Material {
  const float* s;       // mat_scalars row: ior, roughness_mul,
                        // metalness_mul, anisotropy, is_specular, diffuse
                        // rgb, family, type
  const float* ior;     // metal_ior row (16)
  const float* fres;    // metal_fresnel row (16)
  float diffuse[3];     // _diffuse_texel
  float rough;          // _roughness
  float metal;          // _metalness
};

GLAZE_HD void dielectric_etas(const Material& m, float woz, float& etai,
                              float& etat) {
  const bool from_outside = woz >= 0.0f;
  etai = from_outside ? kDefaultIor : m.s[0];
  etat = from_outside ? m.s[0] : kDefaultIor;
}

GLAZE_HD float lambert_value(const float* K, const Material& m, V3 wo, V3 wi,
                             float* val) {
  const float same = step(wo.z * wi.z >= 0.0f);
  from_rgb(K, m.diffuse[0] * kInvPi, m.diffuse[1] * kInvPi,
           m.diffuse[2] * kInvPi, false, val);
  return same * fabsf(wi.z) * kInvPi;
}

GLAZE_HD float metal_value(const Material& m, V3 wo, V3 wi, float* val) {
  const V3 wh = normalize(add(wo, wi));
  const bool same = wo.z * wi.z > 0.0f;
  const float cosin = dot(wi, wh);
  const float ax = m.rough * (1.0f + m.s[3]), ay = m.rough * (1.0f - m.s[3]);
  // bsdf.py _ggx_reflect_terms
  const float dotwowh = dot(wo, wh);
  const float d = ggx_d(wh, ax, ay);
  const float g = ggx_g(wo, wi, ax, ay);
  const float pdf = ggx_pdf(d, ax, ay, wo, wh) / (4.0f * dotwowh);
  const float term = d * g / (4.0f * fabsf(wo.z) * fabsf(wi.z));
  const float t = same ? nan0(term) : 0.0f;
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    val[k] = fresnel_conductor(cosin, m.ior[k], m.fres[k]) * t;
  return same ? nan0(pdf) : 0.0f;
}

GLAZE_HD float frosted_value(const Material& m, V3 wo, V3 wi, float* val) {
  const float ax = m.rough * (1.0f + m.s[3]), ay = m.rough * (1.0f - m.s[3]);
  const float woz = wo.z;
  const bool same = woz * wi.z > 0.0f;
  float etai, etat;
  dielectric_etas(m, woz, etai, etat);
  const float eta = etai / etat;
  const float costwo = fabsf(woz), costwi = fabsf(wi.z);
  float term, pdf;
  if (same) {
    // reflected lobe (mat_frosted_value.rcall:36-50)
    const V3 wh = normalize(add(wo, wi));
    const float dotwowh = dot(wo, wh), dotwiwh = dot(wi, wh);
    const float costi = dot(wi, scale(wh, sign(wh.z)));
    const float f = fresnel_dielectric(costi, etai, etat);
    const float d = step(woz >= 0.0f) * ggx_d(wh, ax, ay);
    const float g =
        step(dotwowh >= 0.0f) * step(dotwiwh >= 0.0f) * ggx_g(wo, wi, ax, ay);
    pdf = nan0(ggx_pdf(d, ax, ay, wo, wh) / (4.0f * dotwowh));
    term = d * g * f / (4.0f * costwo * costwi);
  } else {
    // transmitted lobe (:51-69)
    const V3 wh = scale(normalize(add(wo, scale(wi, eta))), sign(woz));
    const float dotwowh = dot(wo, wh), dotwiwh = dot(wi, wh);
    const float f = fresnel_dielectric(dotwowh, etai, etat);
    const float denom = dotwowh + eta * dotwiwh;
    const float d = ggx_d(wh, ax, ay);
    const float g = ggx_g(wo, wi, ax, ay);
    pdf = nan0(ggx_pdf(d, ax, ay, wo, wh) * fabsf(eta * eta * dotwiwh) /
               (denom * denom));
    term = d * g * (1.0f - f) * fabsf(dotwiwh) * fabsf(dotwowh) /
           (denom * denom * costwo * costwi);
  }
  const float t = nan0(term);
#pragma unroll
  for (int k = 0; k < kBins; ++k) val[k] = t;
  return nan0(pdf);
}

// Oren-Nayar diffuse term (bsdf.py _oren_nayar_term)
GLAZE_HD float oren_nayar(V3 wo, V3 wi, float roughness) {
  const float sigma = roughness * 0.5f;
  const float sigma2 = sigma * sigma;
  const float a_ = 1.0f - sigma2 / (2.0f * (sigma2 + F32(0.33)));
  const float b_ = F32(0.45) * sigma2 / (sigma2 + F32(0.09));
  const float woz = wo.z, wiz = wi.z;
  const float sinto = sqrtf(clamp_min(1.0f - woz * woz, 0.0f));
  const float sinti = sqrtf(clamp_min(1.0f - wiz * wiz, 0.0f));
  const float sinpi = wi.y / sinti, cospi = wi.x / sinti;
  const float sinpo = wo.y / sinto, cospo = wo.x / sinto;
  const float maxcos = nan0(clamp_min(cospi * cospo + sinpi * sinpo, 0.0f));
  const bool wi_ge_wo = fabsf(wiz) >= fabsf(woz);
  const float sinalpha = wi_ge_wo ? sinto : sinti;
  const float tanbeta =
      nan0(wi_ge_wo ? sinti / fabsf(wiz) : sinto / fabsf(woz));
  return (a_ + b_ * maxcos * sinalpha * tanbeta) * kInvPi;
}

GLAZE_HD float uber_value(const float* K, const Material& m, V3 wo, V3 wi,
                          float rand, float* val) {
  const float same_hemi = step(wo.z * wi.z >= 0.0f);
  if (rand < 0.5f) {
    // specular half (mat_uber_value.rcall:28-54), with the reference's
    // roughness * roughness_mul^2 quirk
    const float r2 = m.rough * m.s[1];
    const float ax = r2 * (1.0f + m.s[3]), ay = r2 * (1.0f - m.s[3]);
    const V3 wh = normalize(add(wo, wi));
    const float woz = wo.z;
    float etai, etat;
    dielectric_etas(m, woz, etai, etat);
    const float dotwowh = dot(wo, wh), dotwiwh = dot(wi, wh);
    const float costi = dot(wi, scale(wh, sign(wh.z)));
    const float fd = fresnel_dielectric(costi, etai, etat);
    const float d = step(woz >= 0.0f) * ggx_d(wh, ax, ay);
    const float g =
        step(dotwowh >= 0.0f) * step(dotwiwh >= 0.0f) * ggx_g(wo, wi, ax, ay);
    const float pdf =
        nan0(same_hemi * 0.5f * ggx_pdf(d, ax, ay, wo, wh) / (4.0f * dotwowh));
    const float term = nan0(d * g / (4.0f * fabsf(woz) * fabsf(wi.z)));
#pragma unroll
    for (int k = 0; k < kBins; ++k) {
      const float fc = fresnel_conductor(costi, m.ior[k], m.fres[k]);
      val[k] = (fd + (fc - fd) * m.metal) * term;
    }
    return pdf;
  }
  // diffuse half: Oren-Nayar (:55-77)
  const float on = oren_nayar(wo, wi, m.rough);
  from_rgb(K, m.diffuse[0] * on, m.diffuse[1] * on, m.diffuse[2] * on, false,
           val);
  return nan0(same_hemi * 0.5f * fabsf(wi.z) * kInvPi);
}

// ---- the shadow rays' sort key (render/integrator.py _trace_key) -----------

GLAZE_HD int spread3(int x) {
  x = (x | (x << 8)) & 0x100F;
  x = (x | (x << 4)) & 0x10C3;
  x = (x | (x << 2)) & 0x1249;
  return x;
}

GLAZE_HD int32_t trace_key(const NeeArgs& a, V3 o, V3 d, bool active) {
  int key = static_cast<int>(d.x >= 0.0f) |
            (static_cast<int>(d.y >= 0.0f) << 1) |
            (static_cast<int>(d.z >= 0.0f) << 2);
  const float radius = *a.scene_radius;
  const float inv = 1.0f / clamp_min(2.0f * radius, kTiny) * 31.0f;
  const float oc[3] = {o.x, o.y, o.z};
  int m = 0;
  for (int c = 0; c < 3; ++c) {
    const float lo = a.scene_centre[c] - radius;
    float q = clamp2((oc[c] - lo) * inv, 0.0f, 31.0f);
    if (q != q) q = 0.0f;
    m |= spread3(static_cast<int>(q)) << c;
  }
  key = (key << 15) | m;
  return active ? key : key | (1 << 19);
}

// ---- one lane --------------------------------------------------------------

GLAZE_HD void nee_lane(const NeeArgs& a, const float* K, int i) {
  const int chain = i / a.lanes_per_chain;
  const V3 p = {a.px[i], a.py[i], a.pz[i]};

  // the light pick and its sample (lights.py sample_light)
  const int lights_no = *a.lights_no;
  const float lights_no_f = F32(lights_no);
  const int li = imax(
      imin(static_cast<int>(a.r_pick[chain] * lights_no_f), lights_no - 1), 0);
  const float ra = a.r_a[chain], rb = a.r_b[chain], rc = a.r_c[chain];
  LightSample L;
  switch (static_cast<int>(a.light_scalars[8 * li])) {
    case kSun: sample_sun(a, li, L); break;
    case kArea: sample_area(a, K, li, p, ra, rb, rc, L); break;
    case kSky: sample_sky(a, K, ra, rb, L); break;
    default: sample_omni(a, li, p, L); break;
  }

  // the lane's material and the texels bsdf.py memoizes
  const int mid = a.mat_id[i];
  Material m;
  m.s = a.mat_scalars + 10 * static_cast<int64_t>(mid);
  m.ior = a.metal_ior + kBins * static_cast<int64_t>(mid);
  m.fres = a.metal_fresnel + kBins * static_cast<int64_t>(mid);
  const int32_t* mt = a.mat_tex + 5 * static_cast<int64_t>(mid);
  const int family = static_cast<int>(m.s[8]);
  const float u = a.u[i], v = a.v[i];
  if (a.diffuse_r || family == kLambert || family == kUber) {
    m.diffuse[0] = m.s[5];
    m.diffuse[1] = m.s[6];
    m.diffuse[2] = m.s[7];
    if (a.tex_flags & kTexDiffuse) {
      float rgb[3];
      sample_tex(a, mt[0], u, v, 3, rgb);
      m.diffuse[0] = rgb[0] * m.s[5];
      m.diffuse[1] = rgb[1] * m.s[6];
      m.diffuse[2] = rgb[2] * m.s[7];
    }
    if (a.diffuse_r) {
      a.diffuse_r[i] = m.diffuse[0];
      a.diffuse_g[i] = m.diffuse[1];
      a.diffuse_b[i] = m.diffuse[2];
    }
  }
  if (a.roughness || family == kMetal || family == kFrosted ||
      family == kUber) {
    m.rough = m.s[1];
    if (a.tex_flags & kTexRoughness) {
      float r;
      sample_tex(a, mt[1], u, v, 1, &r);
      m.rough = r * m.s[1];
    }
    if (a.roughness) a.roughness[i] = m.rough;
  }
  if (a.metalness || family == kUber) {
    m.metal = m.s[2];
    if (a.tex_flags & kTexMetalness) {
      float r;
      sample_tex(a, mt[2], u, v, 1, &r);
      m.metal = r * m.s[2];
    }
    if (a.metalness) a.metalness[i] = m.metal;
  }

  // the BSDF value toward the light (bsdf.py bsdf_value; MIRROR and GLASS
  // are delta distributions: pdf 0)
  const V3 s = {a.sx[i], a.sy[i], a.sz[i]}, t = {a.tx[i], a.ty[i], a.tz[i]},
           n = {a.nx[i], a.ny[i], a.nz[i]};
  const V3 wo = to_shading({a.wox[i], a.woy[i], a.woz[i]}, s, t, n);
  const V3 wi = to_shading(L.wiw, s, t, n);
  float val[kBins];
  float bsdf_pdf;
  switch (family) {
    case kLambert: bsdf_pdf = lambert_value(K, m, wo, wi, val); break;
    case kMetal: bsdf_pdf = metal_value(m, wo, wi, val); break;
    case kFrosted: bsdf_pdf = frosted_value(m, wo, wi, val); break;
    case kUber:
      bsdf_pdf = uber_value(K, m, wo, wi, a.r_bsdf[chain], val);
      break;
    default:
      bsdf_pdf = 0.0f;
#pragma unroll
      for (int k = 0; k < kBins; ++k) val[k] = 0.0f;
  }

  // the weight and the unshadowed contribution, straight to linear RGB
  const bool usable = L.pdf > 0.0f && bsdf_pdf > 0.0f;
  const bool active = a.nee_active[i] != 0 && usable;
  const float cos_term = fabsf(dot(L.wiw, n));
  const float weight = step(usable) * cos_term / clamp_min(L.pdf, kTiny);
  const float wl = weight * lights_no_f;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  const float* imp = a.importance + i;
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    const float rad =
        val[k] * L.em[k] * wl * imp[static_cast<int64_t>(k) * a.n_lanes];
    x = x + rad * K[kCieX + k];
    y = y + rad * K[kCieY + k];
    z = z + rad * K[kCieZ + k];
  }
  x = x * K[kInvYSum];
  y = y * K[kInvYSum];
  z = z * K[kInvYSum];
  const float* M = K + kXyzToRgb;
  a.rgb_r[i] = M[0] * x + M[1] * y + M[2] * z;
  a.rgb_g[i] = M[3] * x + M[4] * y + M[5] * z;
  a.rgb_b[i] = M[6] * x + M[7] * y + M[8] * z;
  a.wix[i] = L.wiw.x;
  a.wiy[i] = L.wiw.y;
  a.wiz[i] = L.wiw.z;
  a.cap[i] = L.dist - F32(1e-3);
  a.shadow_active[i] = active;
  a.key[i] = trace_key(a, p, L.wiw, active);
}

// ---- the BSDF stage (render/shade_cuda.py bsdf_plain) ---------------------

struct BsdfArgs {
  // lanes: the hit point (the new origin), the shading frame (s, t, n = the
  // shading normal), wo in world space, uv, the material row, the miss flag
  const float* px; const float* py; const float* pz;
  const float* sx; const float* sy; const float* sz;
  const float* tx; const float* ty; const float* tz;
  const float* nx; const float* ny; const float* nz;
  const float* wox; const float* woy; const float* woz;
  const float* u; const float* v;
  const int32_t* mat_id;
  const uint8_t* missed;
  // the launch's importance (16, P: 1 where the path regenerated), the sky's
  // and the NEE stage's RGB contributions
  const float* importance;
  const float* miss_r; const float* miss_g; const float* miss_b;
  const float* nee_r; const float* nee_g; const float* nee_b;
  // the state before the launch (importance, origin and direction are null
  // under direct_only)
  const float* state_importance;
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* bounce; const float* last_specular;
  const float* accum_r; const float* accum_g; const float* accum_b;
  const float* sq;
  // the texels the NEE stage fetched for these lanes, each null where it
  // did not: fetched here then
  const float* diffuse_r; const float* diffuse_g; const float* diffuse_b;
  const float* roughness; const float* metalness;
  // chains (width C; lane i reads entry i / lanes_per_chain): the roulette
  // draw and the BSDF sample's three (null under direct_only)
  const float* r_rr; const float* r_a; const float* r_b; const float* r_c;
  // tables, read in place
  const int32_t* lights_no;     // ()
  const float* mat_scalars;     // (M, 10)
  const int32_t* mat_tex;       // (M, 5)
  const float* metal_ior;       // (M, 16)
  const float* metal_fresnel;   // (M, 16)
  const int32_t* texels;        // (T, 4)
  const int32_t* tex_offset; const int32_t* tex_width;
  const int32_t* tex_height; const float* tex_srgb;
  const float* consts;          // kConsts
  // outputs, the new state: importance (16, P), origin and direction
  // (written unless direct_only), bounce, last_specular, accum, sq
  float* out_importance;
  float* out_ox; float* out_oy; float* out_oz;
  float* out_dx; float* out_dy; float* out_dz;
  float* out_bounce; float* out_last_specular;
  float* out_accum_r; float* out_accum_g; float* out_accum_b;
  float* out_sq;
  // sizes and modes
  int n_lanes;
  int lanes_per_chain;
  int tex_flags;
  int families;      // bit f: family f follows the first in the scene's list
  int first_family;  // the scene's first family: any other lane samples it
  int direct_only;
};

constexpr float kRoulette = 3.0f;  // integrator.RUSSIAN_ROULETTE
constexpr float kSteps = 6.0f;     // integrator.PT_STEPS

// torch.sum(sp * w, dim=0) of one lane's 16 bins (strided by ``stride``)
// against the 16 weights at K[table], summed as the torch of the device
// that runs this code sums them (header note)
GLAZE_HD float bin_sum(const float* K, int table, const float* sp,
                       int64_t stride) {
#ifdef __CUDA_ARCH__
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    acc[k % 4] = acc[k % 4] + sp[k * stride] * K[table + k];
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
#else
  float sum = 0.0f;
  for (int k = 0; k < kBins; ++k) sum = sum + sp[k * stride] * K[table + k];
  return sum;
#endif
}

// spectra.luminance_t of one lane's 16 bins
GLAZE_HD float luminance(const float* K, const float* sp, int64_t stride) {
  return bin_sum(K, kCieY, sp, stride) * K[kInvYSum];
}

GLAZE_HD V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
// GLSL reflect and refract (ops/vec.py); refract gives the zero vector on
// total internal reflection
GLAZE_HD V3 reflect(V3 i, V3 n) { return sub(i, scale(n, 2.0f * dot(n, i))); }
GLAZE_HD V3 refract(V3 i, V3 n, float eta) {
  const float ndi = dot(n, i);
  const float k = 1.0f - eta * eta * (1.0f - ndi * ndi);
  if (!(k >= 0.0f)) return {0.0f, 0.0f, 0.0f};
  const float coef = eta * ndi + sqrtf(clamp_min(k, 0.0f));
  return sub(scale(i, eta), scale(n, coef));
}
// shading -> world space (ops/shading.py to_world_space_v)
GLAZE_HD V3 to_world(V3 w, V3 s, V3 t, V3 n) {
  return normalize({s.x * w.x + t.x * w.y + n.x * w.z,
                    s.y * w.x + t.y * w.y + n.y * w.z,
                    s.z * w.x + t.z * w.y + n.z * w.z});
}

// bsdf.py _cosine_hemisphere
GLAZE_HD V3 cosine_hemisphere(float r0, float r1, float woz) {
  const float t = kTwoPi * r0;
  const float r = sqrtf(r1);
  const float x = r * cosf(t), y = r * sinf(t);
  return {x, y, sqrtf(clamp_min(1.0f - x * x - y * y, 0.0f)) * sign(woz)};
}

// microfacet.py _sample_p22_v: the isotropic visible-slope sample
GLAZE_HD void sample_p22(float cost, float r0, float r1, float& sx_out,
                         float& sy_out) {
  if (cost > F32(0.999)) {
    const float r = sqrtf(r0 / (1.0f - r0));
    const float phi = kTwoPi * r1;
    sx_out = r * cosf(phi);
    sy_out = r * sinf(phi);
    return;
  }
  const float cos2t = cost * cost;
  const float sin2t = clamp_min(1.0f - cos2t, 0.0f);
  float tan2t = sin2t / cos2t;
  if (is_inf(tan2t)) tan2t = 0.0f;
  const float tant = sqrtf(tan2t);
  const float a2 = 1.0f / clamp_min(tan2t, kTiny);
  const float g1 = rdiv(2.0f, 1.0f + sqrtf(1.0f + 1.0f / a2));
  const float A = 2.0f * r0 / g1 - 1.0f;
  const float B = tant;
  const float inv = 1.0f / (A * A - 1.0f);
  const float sqrt_term =
      sqrtf(clamp_min(B * B * inv * inv - (A * A - B * B) * inv, 0.0f));
  const float sx1 = B * inv - sqrt_term, sx2 = B * inv + sqrt_term;
  const float sx =
      (A < 0.0f || sx2 > 1.0f / clamp_min(tant, kTiny)) ? sx1 : sx2;
  const float stepval = step(r1 >= 0.5f);
  const float s = 1.0f - 2.0f * stepval;
  const float u = stepval > 0.5f ? 2.0f * (0.5f - r1) : 2.0f * (r1 - 0.5f);
  const float z =
      (u * (u * (u * F32(-0.3657289) + F32(0.7902350)) - F32(0.4249658)) +
       F32(0.0001529)) /
      (u * (u * (u * (u * F32(0.1695078) - F32(0.3972035)) -
                 F32(0.2325005)) +
            1.0f) -
       F32(0.5398259));
  sx_out = sx;
  sy_out = s * z * sqrtf(1.0f + sx * sx);
}

// microfacet.py ggx_sample_wh_v: the visible-normal sample
GLAZE_HD V3 ggx_sample_wh(V3 wo, float r0, float r1, float ax, float ay) {
  const float flip = sign(wo.z);
  const V3 w = scale(wo, flip);
  const V3 st = normalize({w.x * ax, w.y * ay, w.z});
  const float cost = st.z;
  float sx0, sy0;
  sample_p22(cost, r0, r1, sx0, sy0);
  const float cos2t = cost * cost;
  const float sin2t = clamp_min(1.0f - cos2t, 0.0f);
  const float cosp = sqrtf(st.x * st.x / sin2t);
  const float sinp = sqrtf(st.y * st.y / sin2t);
  const float sx = cosp * sx0 - sinp * sy0;
  const float sy = sinp * sx0 + cosp * sy0;
  return scale(normalize({-ax * sx, -ay * sy, 1.0f}), flip);
}

// the bounce samples (bsdf.py _*_sample): wi in shading space and the
// value; returns the pdf

GLAZE_HD float lambert_sample(const float* K, const Material& m, V3 wo,
                              float r0, float r1, V3& wi, float* val) {
  wi = cosine_hemisphere(r0, r1, wo.z);
  from_rgb(K, m.diffuse[0] * kInvPi, m.diffuse[1] * kInvPi,
           m.diffuse[2] * kInvPi, false, val);
  return fabsf(wi.z) * kInvPi;
}

GLAZE_HD float mirror_sample(const Material& m, V3 wo, V3& wi, float* val) {
  wi = {-wo.x, -wo.y, wo.z};
  const float c = clamp_min(fabsf(wo.z), kTiny);
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    val[k] = fresnel_conductor(wo.z, m.ior[k], m.fres[k]) / c;
  return 1.0f;
}

GLAZE_HD float glass_sample(const Material& m, V3 wo, float rc, V3& wi,
                            float* val) {
  const float woz = wo.z;
  float etai, etat;
  dielectric_etas(m, woz, etai, etat);
  const float f = fresnel_dielectric(woz >= 0.0f ? woz : fabsf(woz), etai,
                                     etat);
  float e, pdf;
  if (rc < f) {
    wi = {-wo.x, -wo.y, woz};
    e = f / clamp_min(fabsf(woz), kTiny);
    pdf = f;
  } else {
    wi = refract(wo, {0.0f, 0.0f, sign(woz)}, etai / etat);
    e = (1.0f - f) * (etai * etai) /
        clamp_min(etat * etat * fabsf(wi.z), kTiny);
    pdf = 1.0f - f;
  }
#pragma unroll
  for (int k = 0; k < kBins; ++k) val[k] = e;
  return pdf;
}

GLAZE_HD float metal_sample(const Material& m, V3 wo, float r0, float r1,
                            V3& wi, float* val) {
  const float ax = m.rough * (1.0f + m.s[3]), ay = m.rough * (1.0f - m.s[3]);
  const V3 wh = ggx_sample_wh(wo, r0, r1, ax, ay);
  wi = normalize(neg(reflect(wo, wh)));
  const bool same = wo.z * wi.z > 0.0f;
  const float cosin = dot(wi, wh);
  // bsdf.py _ggx_reflect_terms
  const float dotwowh = dot(wo, wh);
  const float d = ggx_d(wh, ax, ay);
  const float g = ggx_g(wo, wi, ax, ay);
  const float pdf = ggx_pdf(d, ax, ay, wo, wh) / (4.0f * dotwowh);
  const float term = d * g / (4.0f * fabsf(wo.z) * fabsf(wi.z));
  const float t = same ? nan0(term) : 0.0f;
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    val[k] = fresnel_conductor(cosin, m.ior[k], m.fres[k]) * t;
  return same ? nan0(pdf) : 0.0f;
}

GLAZE_HD float frosted_sample(const Material& m, V3 wo, float r0, float r1,
                              float rc, V3& wi, float* val) {
  const float ax = m.rough * (1.0f + m.s[3]), ay = m.rough * (1.0f - m.s[3]);
  const V3 wh = ggx_sample_wh(wo, r0, r1, ax, ay);
  const float woz = wo.z;
  float etai, etat;
  dielectric_etas(m, woz, etai, etat);
  const float eta = etai / etat;
  const float costwo = fabsf(woz);
  const float dotwowh = dot(wo, wh);
  float term, pdf;
  if (rc < 0.5f) {
    // reflect branch (mat_frosted_sample_value.rcall:31-50)
    wi = normalize(neg(reflect(wo, wh)));
    const float dotwiwh = dot(wi, wh);
    const float costi = dot(wi, scale(wh, sign(wh.z)));
    const float f = fresnel_dielectric(costi, etai, etat);
    const float d = step(woz >= 0.0f) * ggx_d(wh, ax, ay);
    const float g =
        step(dotwowh >= 0.0f) * step(dotwiwh >= 0.0f) * ggx_g(wo, wi, ax, ay);
    pdf = nan0(0.5f * ggx_pdf(d, ax, ay, wo, wh) / (4.0f * dotwowh));
    term = d * g * f / (4.0f * costwo * fabsf(wi.z));
  } else {
    // refract branch (:51-70)
    wi = normalize(refract(wo, wh, eta));
    const float dotwiwh = dot(wi, wh);
    const float f = fresnel_dielectric(dotwowh, etai, etat);
    const float denom = dotwowh + eta * dotwiwh;
    const float d = ggx_d(wh, ax, ay);
    const float g = ggx_g(wo, wi, ax, ay);
    const float p = nan0(0.5f * ggx_pdf(d, ax, ay, wo, wh) *
                         fabsf(eta * eta * dotwiwh) / (denom * denom));
    pdf = dotwowh * dotwiwh < 0.0f ? p : 0.0f;
    term = d * g * (1.0f - f) * fabsf(dotwiwh) * fabsf(dotwowh) /
           (denom * denom * costwo * fabsf(wi.z));
  }
  const float t = nan0(term);
#pragma unroll
  for (int k = 0; k < kBins; ++k) val[k] = t;
  return pdf;
}

GLAZE_HD float uber_sample(const float* K, const Material& m, V3 wo,
                           float r0, float r1, float rc, V3& wi, float* val) {
  const float woz = wo.z;
  if (rc < 0.5f) {
    // specular branch (mat_uber_sample_value.rcall:28-56), with the
    // reference's roughness * roughness_mul^2 quirk
    const float r2 = m.rough * m.s[1];
    const float ax = r2 * (1.0f + m.s[3]), ay = r2 * (1.0f - m.s[3]);
    const V3 wh = ggx_sample_wh(wo, r0, r1, ax, ay);
    wi = normalize(neg(reflect(wo, wh)));
    float etai, etat;
    dielectric_etas(m, woz, etai, etat);
    const float dotwowh = dot(wo, wh), dotwiwh = dot(wi, wh);
    const float costi = dot(wi, scale(wh, sign(wh.z)));
    const float fd = fresnel_dielectric(costi, etai, etat);
    const float d = step(woz >= 0.0f) * ggx_d(wh, ax, ay);
    const float g =
        step(dotwowh >= 0.0f) * step(dotwiwh >= 0.0f) * ggx_g(wo, wi, ax, ay);
    const float pdf =
        nan0(0.5f * ggx_pdf(d, ax, ay, wo, wh) / (4.0f * dotwowh));
    const float term = nan0(d * g / (4.0f * fabsf(woz) * fabsf(wi.z)));
#pragma unroll
    for (int k = 0; k < kBins; ++k) {
      const float fc = fresnel_conductor(costi, m.ior[k], m.fres[k]);
      val[k] = (fd + (fc - fd) * m.metal) * term;
    }
    return pdf;
  }
  // diffuse branch: Oren-Nayar (:57-83)
  wi = cosine_hemisphere(r0, r1, woz);
  const float on = oren_nayar(wo, wi, m.rough);
  from_rgb(K, m.diffuse[0] * on, m.diffuse[1] * on, m.diffuse[2] * on, false,
           val);
  return 0.5f * fabsf(wi.z) * kInvPi;
}

// ---- one lane of the BSDF stage --------------------------------------------

GLAZE_HD void bsdf_lane(const BsdfArgs& a, const float* K, int i) {
  const int64_t n = a.n_lanes;
  const bool enabled = *a.lights_no > 0;

  // the accumulation (path_trace.rgen update_result) and the launch's
  // squared luminance
  const float en = step(enabled);
  const float cr = a.miss_r[i] + a.nee_r[i], cg = a.miss_g[i] + a.nee_g[i],
              cb = a.miss_b[i] + a.nee_b[i];
  a.out_accum_r[i] = a.accum_r[i] + en * cr;
  a.out_accum_g[i] = a.accum_g[i] + en * cg;
  a.out_accum_b[i] = a.accum_b[i] + en * cb;
  const float c_lum =
      en * (cr * F32(0.2126) + cg * F32(0.7152) + cb * F32(0.0722));
  a.out_sq[i] = a.sq[i] + c_lum * c_lum;

  const bool missed = a.missed[i] != 0;
  const float* ms = a.mat_scalars + 10 * static_cast<int64_t>(a.mat_id[i]);
  const float last = a.last_specular[i];
  const float new_specular = missed ? last : step(ms[4] > 0.5f);
  a.out_last_specular[i] = enabled ? new_specular : last;
  const float bounce = a.bounce[i];
  if (a.direct_only) {
    a.out_bounce[i] = 0.0f;
    return;
  }

  // a lane whose path ends here keeps its state (as do all lanes with the
  // lights off), so only the others draw the roulette and sample
  const int chain = i / a.lanes_per_chain;
  const float* imp = a.importance + i;
  bool dead = missed;
  float rr_scale = 1.0f;
  if (enabled && !dead && bounce > kRoulette) {
    // Russian roulette (path_trace.rgen:196-211)
    const float kill_prob =
        clamp_min(1.0f - luminance(K, imp, n), F32(0.05));
    dead = a.r_rr[chain] < kill_prob;
    rr_scale = rdiv(1.0f, 1.0f - kill_prob);
  }
  if (enabled && !dead) {
    // the BSDF sample of the lane's own family (path_trace.rgen:212-228)
    const V3 s = {a.sx[i], a.sy[i], a.sz[i]}, t = {a.tx[i], a.ty[i], a.tz[i]},
             nn = {a.nx[i], a.ny[i], a.nz[i]};
    const V3 wo = to_shading({a.wox[i], a.woy[i], a.woz[i]}, s, t, nn);
    const float ra = a.r_a[chain], rb = a.r_b[chain], rc = a.r_c[chain];
    const int fam = static_cast<int>(ms[8]);
    const int family =
        (fam >= 0 && fam < 6 && ((a.families >> fam) & 1)) ? fam
                                                           : a.first_family;
    Material m;
    m.s = ms;
    m.ior = a.metal_ior + kBins * static_cast<int64_t>(a.mat_id[i]);
    m.fres = a.metal_fresnel + kBins * static_cast<int64_t>(a.mat_id[i]);
    const int32_t* mt = a.mat_tex + 5 * static_cast<int64_t>(a.mat_id[i]);
    const float u = a.u[i], v = a.v[i];
    if (family == kLambert || family == kUber) {
      if (a.diffuse_r) {
        m.diffuse[0] = a.diffuse_r[i];
        m.diffuse[1] = a.diffuse_g[i];
        m.diffuse[2] = a.diffuse_b[i];
      } else if (a.tex_flags & kTexDiffuse) {
        float rgb[3];
        sample_tex(a, mt[0], u, v, 3, rgb);
        m.diffuse[0] = rgb[0] * ms[5];
        m.diffuse[1] = rgb[1] * ms[6];
        m.diffuse[2] = rgb[2] * ms[7];
      } else {
        m.diffuse[0] = ms[5];
        m.diffuse[1] = ms[6];
        m.diffuse[2] = ms[7];
      }
    }
    if (family == kMetal || family == kFrosted || family == kUber) {
      if (a.roughness) {
        m.rough = a.roughness[i];
      } else if (a.tex_flags & kTexRoughness) {
        float r;
        sample_tex(a, mt[1], u, v, 1, &r);
        m.rough = r * ms[1];
      } else {
        m.rough = ms[1];
      }
    }
    if (family == kUber) {
      if (a.metalness) {
        m.metal = a.metalness[i];
      } else if (a.tex_flags & kTexMetalness) {
        float r;
        sample_tex(a, mt[2], u, v, 1, &r);
        m.metal = r * ms[2];
      } else {
        m.metal = ms[2];
      }
    }
    V3 wi;
    float val[kBins];
    float pdf;
    switch (family) {
      case kMirror: pdf = mirror_sample(m, wo, wi, val); break;
      case kGlass: pdf = glass_sample(m, wo, rc, wi, val); break;
      case kMetal: pdf = metal_sample(m, wo, ra, rb, wi, val); break;
      case kFrosted: pdf = frosted_sample(m, wo, ra, rb, rc, wi, val); break;
      case kUber: pdf = uber_sample(K, m, wo, ra, rb, rc, wi, val); break;
      default: pdf = lambert_sample(K, m, wo, ra, rb, wi, val); break;
    }
    const V3 wiw = to_world(wi, s, t, nn);
    dead = pdf <= 0.0f;
    if (!dead) {
      const float weight = fabsf(dot(wiw, nn)) / clamp_min(pdf, kTiny);
#pragma unroll
      for (int k = 0; k < kBins; ++k)
        a.out_importance[k * n + i] = imp[k * n] * rr_scale * val[k] * weight;
      a.out_ox[i] = a.px[i];
      a.out_oy[i] = a.py[i];
      a.out_oz[i] = a.pz[i];
      a.out_dx[i] = wiw.x;
      a.out_dy[i] = wiw.y;
      a.out_dz[i] = wiw.z;
    }
  }
  if (!enabled || dead) {
    const float* old = a.state_importance + i;
#pragma unroll
    for (int k = 0; k < kBins; ++k) a.out_importance[k * n + i] = old[k * n];
    a.out_ox[i] = a.ox[i];
    a.out_oy[i] = a.oy[i];
    a.out_oz[i] = a.oz[i];
    a.out_dx[i] = a.dx[i];
    a.out_dy[i] = a.dy[i];
    a.out_dz[i] = a.dz[i];
  }
  // "if bounce < PT_STEPS inc else reset"
  const bool at_max = bounce >= kSteps;
  a.out_bounce[i] =
      enabled ? ((dead || at_max) ? 0.0f : bounce + 1.0f) : bounce;
}

// ---- the shade stage (render/shade_cuda.py surface_plain) -------------------

struct SurfaceArgs {
  // lanes: the closest hit (attribute row, -1 on a miss, and barycentrics),
  // the ray's direction, the path's bounce and last_specular, the parked
  // lanes (null without adaptive stopping) and the launch's importance
  // (16, P)
  const int32_t* tri;
  const float* hit_u; const float* hit_v;
  const float* dx; const float* dy; const float* dz;
  const float* bounce; const float* last_specular;
  const uint8_t* parked;
  const float* importance;
  // tables, read in place
  const float* tri_attr;        // (N, 34)
  const float* mat_scalars;     // (M, 10)
  const int32_t* mat_tex;       // (M, 5)
  const int32_t* texels;        // (T, 4)
  const int32_t* tex_offset; const int32_t* tex_width;
  const int32_t* tex_height; const float* tex_srgb;
  const float* sky_world2obj;   // (3, 3)
  const int32_t* sky_tex;       // ()
  const float* consts;          // kConsts
  // outputs: (20, P) floats, the 17 lane floats that NeeArgs and BsdfArgs
  // take first, in their order (the hit point, s, t, n, wo, u, v), then the
  // sky's RGB; the material row, the miss flag and nee_active, (P,) each
  float* out;
  int32_t* mat_id;
  uint8_t* missed;
  uint8_t* nee_active;
  // sizes and modes (tex_flags: kTexNormal where some material has a
  // normal map)
  int n_lanes;
  int tex_flags;
};

// columns of tri_attr (scene/flatten.py ATTR_*) and of mat_tex (MT_*)
enum { kAttrV0 = 0, kAttrE1 = 3, kAttrE2 = 6, kAttrN0 = 9, kAttrN1 = 12,
       kAttrN2 = 15, kAttrUv0 = 18, kAttrUv1 = 20, kAttrUv2 = 22,
       kAttrGn = 24, kAttrDpdu = 27, kAttrMat = 33, kAttrRows = 34 };
constexpr int kMtNormal = 4;
constexpr float kInv2Pi = F32(0.1591549);  // shade_cuda.INV_2PI
constexpr int kSurfaceRows = 20;

GLAZE_HD V3 attr3(const float* row, int col) {
  return {row[col], row[col + 1], row[col + 2]};
}

// the sky's linear RGB along d, times the lane's importance (shade_cuda
// sky_radiance, spectra.from_illuminant_color_t, spectra.to_rgb_t)
GLAZE_HD void sky_rgb(const SurfaceArgs& a, const float* K, V3 d, int i,
                      float* rgb) {
  const float* m = a.sky_world2obj;
  const V3 w = normalize({m[0] * d.x + m[1] * d.y + m[2] * d.z,
                          m[3] * d.x + m[4] * d.y + m[5] * d.z,
                          m[6] * d.x + m[7] * d.y + m[8] * d.z});
  const float phi = atan2f(w.y, w.x);
  const float theta = acosf(clamp2(w.z, -1.0f, 1.0f));
  float tex[3];
  sample_tex(a, *a.sky_tex, phi * kInv2Pi, theta * kInvPi, 3, tex);
  float sp[kBins];
  from_rgb(K, tex[0], tex[1], tex[2], true, sp);
  const float* imp = a.importance + i;
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    sp[k] = imp[static_cast<int64_t>(k) * a.n_lanes] * sp[k];
  const float x = bin_sum(K, kCieX, sp, 1) * K[kInvYSum];
  const float y = bin_sum(K, kCieY, sp, 1) * K[kInvYSum];
  const float z = bin_sum(K, kCieZ, sp, 1) * K[kInvYSum];
  const float* M = K + kXyzToRgb;
  rgb[0] = M[0] * x + M[1] * y + M[2] * z;
  rgb[1] = M[3] * x + M[4] * y + M[5] * z;
  rgb[2] = M[6] * x + M[7] * y + M[8] * z;
}

GLAZE_HD void surface_lane(const SurfaceArgs& a, const float* K, int i) {
  // the closest-hit shader (raytrace_hit.rchit): barycentric attributes
  // from the lane's row; a missed lane reads row 0, as interpolate_hit does
  const int32_t tri = a.tri[i];
  const float* row = a.tri_attr + kAttrRows * static_cast<int64_t>(
                                      tri > 0 ? tri : 0);
  const float bu = a.hit_u[i], bv = a.hit_v[i];
  const float bw = 1.0f - bu - bv;
  const V3 point = add(attr3(row, kAttrV0),
                       add(scale(attr3(row, kAttrE1), bu),
                           scale(attr3(row, kAttrE2), bv)));
  V3 n = normalize(add(scale(attr3(row, kAttrN0), bw),
                       add(scale(attr3(row, kAttrN1), bu),
                           scale(attr3(row, kAttrN2), bv))));
  const float u = bw * row[kAttrUv0] + bu * row[kAttrUv1] + bv * row[kAttrUv2];
  const float v = bw * row[kAttrUv0 + 1] + bu * row[kAttrUv1 + 1] +
                  bv * row[kAttrUv2 + 1];
  const V3 dpdu = attr3(row, kAttrDpdu);
  const int mat = static_cast<int>(row[kAttrMat]);

  // normal mapping (rchit:55-64), where the lane's material has a map
  if (a.tex_flags & kTexNormal) {
    const int normal_tex = a.mat_tex[5 * static_cast<int64_t>(mat) + kMtNormal];
    if (normal_tex != 0) {
      float c[3];
      sample_tex(a, normal_tex, u, v, 3, c);
      const V3 s_old = normalize(dpdu);
      const V3 t_old = normalize(cross(n, s_old));
      const float nx = c[0] * 2.0f - 1.0f, ny = c[1] * 2.0f - 1.0f,
                  nz = c[2] * 2.0f - 1.0f;
      const V3 mapped = normalize({s_old.x * nx + t_old.x * ny + n.x * nz,
                                   s_old.y * nx + t_old.y * ny + n.y * nz,
                                   s_old.z * nx + t_old.z * ny + n.z * nz});
      n = scale(mapped, sign(dot(attr3(row, kAttrGn), mapped)));
    }
  }

  // the shading frame (ops/shading.py new_shading_space_v) and wo
  const V3 s = normalize(sub(dpdu, scale(n, dot(n, dpdu))));
  const V3 t = cross(n, s);
  const float wo[3] = {-a.dx[i], -a.dy[i], -a.dz[i]};

  // the miss flag, NEE's lanes and the sky on camera rays and after
  // specular bounces (path_trace.rgen:76-84)
  const bool missed = tri < 0;
  const bool parked = a.parked != nullptr && a.parked[i] != 0;
  const bool specular = a.mat_scalars[10 * static_cast<int64_t>(mat) + 4] >
                        0.5f;
  float sky[3] = {0.0f, 0.0f, 0.0f};
  if (missed && !parked && *a.sky_tex > 0 &&
      (a.bounce[i] == 0.0f || a.last_specular[i] == 1.0f))
    sky_rgb(a, K, {a.dx[i], a.dy[i], a.dz[i]}, i, sky);

  const float lane[kSurfaceRows] = {
      point.x, point.y, point.z, s.x, s.y, s.z, t.x, t.y, t.z,
      n.x, n.y, n.z, wo[0], wo[1], wo[2], u, v, sky[0], sky[1], sky[2]};
  float* o = a.out + i;
#pragma unroll
  for (int r = 0; r < kSurfaceRows; ++r)
    o[static_cast<int64_t>(r) * a.n_lanes] = lane[r];
  a.mat_id[i] = mat;
  a.missed[i] = missed;
  a.nee_active[i] = !missed && !specular && !parked;
}

}  // namespace glaze_shade

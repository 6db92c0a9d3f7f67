// Device functions of the PT and VCM bounces' shading, for NVIDIA Hopper
// (sm_90a): the per-lane ports of the torch functions that
// imbatracer_torch/ops/shade.py::pt_shade_plain and the plain versions of
// imbatracer_torch/ops/vcm_shade.py call.
//
//   PCG RNG          core/rng.py: hash_wang, seed, _pcg_step, _pcg_output,
//                    next_float
//   sampling         core/sampling.py: local_coordinates, to_world /
//                    to_local, the cosine and power-cosine hemisphere,
//                    the triangle, sphere, cone and concentric-disc
//                    samplers, russian_roulette_prob, mis_power_heuristic
//   surface          render/surface.py: make_interaction, _bump_normal
//   textures         scene/textures.py: _wrap_uv, sample_bilinear
//   materials        render/materials.py: eval_pdf_bsdf (both pdfs),
//                    pdf_bsdf, sample_bsdf (radiance and adjoint) and
//                    their fresnel, Cook-Torrance, Phong and Oren-Nayar
//                    helpers (all six kinds)
//   lights           render/lights.py: sample_direct and sample_emit
//                    (tri, point, dir, spot, env)
//   environment map  render/envmap.py: radiance, sample_dir
//   camera           render/camera.py: world_to_raster, raster_to_id
//   VCM              render/integrators/vcm.py: shading_normal_adjoint,
//                    _vertex_from_rec (a packed light-cache row)
//
// Torch evaluates every present kind's formula block for every lane and
// selects by kind; a lane here runs its own kind's block only.  For a
// kind the scene holds the two agree (the contract of `_has` in
// materials.py and lights.py).
//
// Numerics: every function computes what the torch ops compute on the
// card, op by op, in their order, so that the kernel's results equal
// the plain version's bit for bit where the card's math library is the
// same.  The library is built with --fmad=false: each product and sum is
// rounded on its own, as each torch op rounds its result.  What torch's
// CUDA ops do that plain C++ would not:
//   * torch.sum over a last dim of 3 adds (x0 + x2) + x1 (its reduce
//     kernel splits the row over two threads): sum3;
//   * torch.rsqrt is rsqrtf, not 1 / sqrtf;
//   * a tensor divided by a Python scalar is multiplied by the scalar's
//     reciprocal, a float32 constant (SceneTables.floats for the scene's
//     scalars, div_factor here);
//   * `1.0 / x` and `-1.0 / x` of a tensor are reciprocal(x) * 1.0 and
//     reciprocal(x) * -1.0, reciprocal an IEEE division;
//   * torch.pow of two tensors is powf;
//   * torch.linalg.cross computes a_i * b_j - a_j * b_i as
//     fmaf(a_i, b_j, -(a_j * b_i)) (aten is built with contraction on);
//   * clamp, maximum and minimum keep a NaN;
//   * Python float constants are double, cast to float32 where used.
//   * a float -> int32 cast (`.to(torch.int32)`) is the card's cvt.rzi:
//     it truncates and saturates out-of-range values (NaN -> 0), as
//     static_cast<int> does in device code; a CPU cast does not (probe
//     line "floor(x).to(int32)");
//   * torch.minimum of int32 tensors and the int32 product and floor
//     division of a tensor by a Python int wrap and floor as Python's
//     `//` does (probe lines "minimum int32" and "light pick"): int32_mul,
//     floor_div;
//   * a 0-d tensor divided by a Python int is the same multiply by the
//     double reciprocal (probe line "0-d x / int").
// imbatracer_torch/tools/cuda_op_probe.py checks each of these on a card.
#pragma once

#include <cstdint>
#include <math.h>

namespace shade {

constexpr double kPi = 3.141592653589793;       // math.pi
constexpr double kInvPi = 1.0 / kPi;             // core/sampling.INV_PI
constexpr double kBig = 1e30;                    // render/intersect.BIG
constexpr double kFar = 1e30;                    // render/lights.FAR

// Material and light kinds (render/materials.py, render/lights.py).
enum { MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS, MAT_GLOSSY, MAT_PHONG,
       MAT_OREN_NAYAR };
enum { LIGHT_TRI, LIGHT_POINT, LIGHT_DIR, LIGHT_SPOT, LIGHT_ENV };

// A Python float constant as torch uses it on a float32 tensor.
__host__ __device__ constexpr float F(double x) { return static_cast<float>(x); }

// The factor torch multiplies a float32 tensor by when it divides it by
// the Python scalar x.
__host__ __device__ constexpr float div_factor(double x) {
  return static_cast<float>(1.0 / x);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 zero3() { return {0.f, 0.f, 0.f}; }
__device__ __forceinline__ bool any_nonzero(V3 a) {
  return a.x != 0.f || a.y != 0.f || a.z != 0.f;
}
__device__ __forceinline__ bool any_positive(V3 a) {
  return a.x > 0.f || a.y > 0.f || a.z > 0.f;
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

// torch.sum(x, dim=-1) over a contiguous last dim of 3.
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// torch.clamp / maximum / minimum: a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
__device__ __forceinline__ float pos(float x) { return clamp_min(x, 0.f); }
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}

// `1.0 / x` of a tensor: reciprocal(x) * 1.0.
__device__ __forceinline__ float rdiv1(float x) { return (1.0f / x) * 1.0f; }

// normalize (core/vecmath.py): a * rsqrt(clamp(sum(a * a), min=1e-20)).
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, rsqrtf(clamp_min(dot(a, a), F(1e-20))));
}

// torch.linalg.cross(a, b, dim=-1).
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// ---------------------------------------------------------------- RNG

__device__ __forceinline__ uint32_t pcg_step(uint32_t s) {
  return s * 747796405u + 2891336453u;
}
__device__ __forceinline__ uint32_t pcg_output(uint32_t s) {
  const uint32_t w = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  return (w >> 22) ^ w;
}
// hash_wang: the Wang-style integer hash of core/rng.py.
__device__ __forceinline__ uint32_t hash_wang(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  return x ^ (x >> 15);
}
// seed(pixel_id, sample_id, frame): a lane's first RNG word.
__device__ __forceinline__ uint32_t seed(uint32_t pixel, uint32_t sample,
                                         uint32_t frame) {
  const uint32_t s = hash_wang(pixel + (sample + 1u) * 0x9E3779B9u);
  return hash_wang(s ^ (frame * 0x85EBCA6Bu + 0xC2B2AE35u)) | 1u;
}
// next_float: advance `s` and return a float32 in [0, 1).
__device__ __forceinline__ float next_float(uint32_t& s) {
  s = pcg_step(s);
  return static_cast<float>(pcg_output(s) >> 8) * F(1.0 / (1 << 24));
}

// int32 tensor arithmetic as torch does it: a product that wraps, and
// `//` by a positive Python int, which floors.
__device__ __forceinline__ int int32_mul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// ----------------------------------------------------------- sampling

// local_coordinates (Duff et al. 2017) -> (t, b).
__device__ __forceinline__ void local_coordinates(V3 n, V3& t, V3& b) {
  const float s = n.z >= 0.f ? 1.f : -1.f;
  const float a = (1.0f / (s + n.z)) * -1.0f;
  const float bb = (n.x * n.y) * a;
  t = {((s * n.x) * n.x) * a + 1.0f, s * bb, (-s) * n.x};
  b = {bb, s + (n.y * n.y) * a, -n.y};
}

// to_local / eval_pdf_bsdf's proj: (v.t, v.b, v.n).
__device__ __forceinline__ V3 project(V3 v, V3 t, V3 b, V3 n) {
  return {dot(v, t), dot(v, b), dot(v, n)};
}

// to_world: d.x * t + d.y * b + d.z * n.
__device__ __forceinline__ V3 to_world(V3 d, V3 t, V3 b, V3 n) {
  return add(add(scale(t, d.x), scale(b, d.y)), scale(n, d.z));
}

__device__ __forceinline__ float mis_power_heuristic(float a, float b) {
  return a / clamp_min(a + b, F(1e-20));
}

__device__ __forceinline__ float luminance(V3 c) {
  return (c.x * F(0.2126) + c.y * F(0.7152)) + c.z * F(0.0722);
}

__device__ __forceinline__ float russian_roulette_prob(V3 thr) {
  return clamp(luminance(thr) * 2.0f, 0.f, 1.f);
}

__device__ __forceinline__ float cos_hemisphere_pdf(float c) {
  return pos(c) * F(kInvPi);
}

// sample_cos_hemisphere: the direction (pdf unused by PT).
__device__ __forceinline__ V3 sample_cos_hemisphere(float u1, float u2) {
  const float phi = u1 * F(2.0 * kPi);
  const float r = sqrtf(u2);
  const float z = sqrtf(pos(1.0f - u2));
  return {r * cosf(phi), r * sinf(phi), z};
}

// sample_power_cos_hemisphere: the direction (pdf unused by PT).
__device__ __forceinline__ V3 sample_power_cos_hemisphere(float power,
                                                          float u1, float u2) {
  const float phi = u1 * F(2.0 * kPi);
  const float cos_t = powf(u2, rdiv1(power + 1.0f));
  const float sin_t = sqrtf(pos(1.0f - cos_t * cos_t));
  return {sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
}

// sample_uniform_sphere: the direction (pdf 1 / (4 pi)).
__device__ __forceinline__ V3 sample_uniform_sphere(float u1, float u2) {
  const float phi = u1 * F(2.0 * kPi);
  const float z = 1.0f - u2 * 2.0f;
  const float r = sqrtf(pos(1.0f - z * z));
  return {r * cosf(phi), r * sinf(phi), z};
}

// sample_uniform_cone about +z, cos_max per lane: the direction.
__device__ __forceinline__ V3 sample_uniform_cone(float cos_max, float u1,
                                                  float u2) {
  const float phi = u1 * F(2.0 * kPi);
  const float z = 1.0f - u2 * (1.0f - cos_max);
  const float r = sqrtf(pos(1.0f - z * z));
  return {r * cosf(phi), r * sinf(phi), z};
}

// uniform_cone_pdf: 1 / (2 pi clamp(1 - cos_max, 1e-20)).
__device__ __forceinline__ float uniform_cone_pdf(float cos_max) {
  return rdiv1(clamp_min(1.0f - cos_max, F(1e-20)) * F(2.0 * kPi));
}

// sample_concentric_disc (Shirley-Chiu), the selected branch only.
__device__ __forceinline__ void sample_concentric_disc(float u1, float u2,
                                                       float& x, float& y) {
  const float ox = u1 * 2.0f - 1.0f;
  const float oy = u2 * 2.0f - 1.0f;
  const bool zero = ox == 0.f && oy == 0.f;
  const bool use_x = fabsf(ox) > fabsf(oy);
  const float r = use_x ? ox : oy;
  const float theta =
      use_x ? (oy / (ox == 0.f ? 1.0f : ox)) * F(kPi / 4.0)
            : F(kPi / 2.0) - (ox / (oy == 0.f ? 1.0f : oy)) * F(kPi / 4.0);
  x = zero ? 0.f : r * cosf(theta);
  y = zero ? 0.f : r * sinf(theta);
}

// ----------------------------------------------------------- textures

// The texture atlas (scene/textures.py TextureAtlas).
struct Atlas {
  const float* texels;   // (T, 3)
  const int* offset;     // (K,)
  const int* width;
  const int* height;
  int num_tex, num_texels;
};

__device__ __forceinline__ int64_t py_mod(int64_t a, int64_t b) {
  int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ V3 texel(const Atlas& at, int64_t i) {
  i = i < 0 ? 0 : (i >= at.num_texels ? at.num_texels - 1 : i);
  return load3(at.texels + 3 * i);
}

// sample_bilinear for tex_id >= 0 (the caller keeps its value for a
// negative id); `channels` 1 computes the first channel only.
template <int channels>
__device__ V3 sample_bilinear(const Atlas& at, int tex_id, float u, float v) {
  int tid = tex_id < 0 ? 0 : tex_id;
  tid = tid >= at.num_tex ? at.num_tex - 1 : tid;
  const int64_t w = at.width[tid], h = at.height[tid], off = at.offset[tid];
  u = u - floorf(u);                                   // _wrap_uv
  v = 1.0f - (v - floorf(v));
  const float kx = u * static_cast<float>(w - 1);
  const float ky = v * static_cast<float>(h - 1);
  const int64_t x0 = static_cast<int64_t>(kx), y0 = static_cast<int64_t>(ky);
  const int64_t x1 = py_mod(x0 + 1, w), y1 = py_mod(y0 + 1, h);
  const float gx = kx - floorf(kx), gy = ky - floorf(ky);
  const V3 i00 = texel(at, off + y0 * w + x0), i10 = texel(at, off + y0 * w + x1);
  const V3 i01 = texel(at, off + y1 * w + x0), i11 = texel(at, off + y1 * w + x1);
  const float hx = 1.0f - gx, hy = 1.0f - gy;
  auto lerp = [&](float a00, float a10, float a01, float a11) {
    return hy * (hx * a00 + gx * a10) + gy * (hx * a01 + gx * a11);
  };
  V3 out = {lerp(i00.x, i10.x, i01.x, i11.x), 0.f, 0.f};
  if (channels == 3) {
    out.y = lerp(i00.y, i10.y, i01.y, i11.y);
    out.z = lerp(i00.z, i10.z, i01.z, i11.z);
  }
  return out;
}

// The mask record's alpha test (scene/textures.py MaskTest, the alpha_fn
// of render/integrators/pt.py alpha_fn_for): `rec` is one (P, 10) row of
// TriAttrs.mask_rec, mask texture, width, height and atlas offset as
// int32 bits, then the three uvs; the nearest texel of the wrapped uv is
// opaque where its channels sum above 0, and a triangle without a mask
// (mt < 0) is always opaque.  The float -> int32 casts saturate as
// torch's CUDA cast does; a negative texel index wraps as torch's
// indexing does, then the index is clamped into the atlas.
__device__ __forceinline__ bool mask_opaque(const float* rec, const Atlas& at,
                                            float u, float v) {
  const int mt = __float_as_int(rec[0]), w = __float_as_int(rec[1]);
  const int h = __float_as_int(rec[2]), off = __float_as_int(rec[3]);
  const float w0 = (1.0f - u) - v;
  float tu = (w0 * rec[4] + u * rec[6]) + v * rec[8];
  float tv = (w0 * rec[5] + u * rec[7]) + v * rec[9];
  tu = tu - floorf(tu);                                 // _wrap_uv
  tv = 1.0f - (tv - floorf(tv));
  const int x = min(max(static_cast<int>(tu * static_cast<float>(w)), 0),
                    w - 1);
  const int y = min(max(static_cast<int>(tv * static_cast<float>(h)), 0),
                    h - 1);
  int64_t i = static_cast<int>(static_cast<uint32_t>(off) +
                               static_cast<uint32_t>(int32_mul(y, w)) +
                               static_cast<uint32_t>(x));
  if (i < 0) i += at.num_texels;
  const V3 c = texel(at, i);
  return sum3(c.x, c.y, c.z) > 0.0f || mt < 0;
}

// ------------------------------------------------------- environment

// The environment map's tables (render/envmap.py EnvMapData) with the
// float32 constants torch derives from their shapes.
struct Env {
  const float* img;           // (H, W, 3)
  const float* pdf_table;     // (Ht, Wt)
  const float* row_cdf;       // (Ht, Wt + 1)
  const float* marginal_cdf;  // (Ht + 1,)
  int img_h, img_w, tab_h, tab_w;
  float img_wm1, img_hm1, tab_w_f, tab_h_f, inv_tab_w, inv_tab_h;
};

// torch.searchsorted(right=True): the first index whose value is > x.
__device__ __forceinline__ int upper_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] > x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// upper_bound over a non-decreasing array (a CDF), its first
// kWideRounds rounds with kWideProbes loads issued together, then one
// load a round: a round keeps the entries between the last probe <= x and
// the first probe > x, so a wide round cuts the entries by
// kWideProbes + 1 for one memory latency where upper_bound's dependent
// loads halve them.  On a non-decreasing array every such search returns
// the one index whose entry is the first > x (n if none): upper_bound's.
constexpr int kWideProbes = 3;
constexpr int kWideRounds = 2;
__device__ __forceinline__ int upper_bound_wide(const float* a, int n,
                                                float x) {
  int lo = 0, hi = n;
  for (int r = 0; r < kWideRounds && lo < hi; ++r) {
    const int span = hi - lo;
    float v[kWideProbes];
#pragma unroll
    for (int j = 0; j < kWideProbes; ++j)
      v[j] = a[lo + ((j + 1) * span) / (kWideProbes + 1)];
    int c = 0;
#pragma unroll
    for (int j = 0; j < kWideProbes; ++j) c += !(v[j] > x);
    const int next_lo = c ? lo + (c * span) / (kWideProbes + 1) + 1 : lo;
    if (c < kWideProbes) hi = lo + ((c + 1) * span) / (kWideProbes + 1);
    lo = next_lo;
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] > x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// _lookup: the nearest texel at (s, t).
__device__ __forceinline__ V3 env_lookup(const Env& e, float s, float t) {
  const int x = clampi(static_cast<int>(s * e.img_wm1), 0, e.img_w - 1);
  const int y = clampi(static_cast<int>(t * e.img_hm1), 0, e.img_h - 1);
  return load3(e.img + 3 * (static_cast<int64_t>(y) * e.img_w + x));
}

// _st_pdf_w: the solid-angle pdf at (s, t).
__device__ __forceinline__ float env_pdf_w(const Env& e, float s, float t) {
  const int col = clampi(static_cast<int>(s * e.tab_w_f), 0, e.tab_w - 1);
  const int row = clampi(static_cast<int>(t * e.tab_h_f), 0, e.tab_h - 1);
  const float p_st = e.pdf_table[static_cast<int64_t>(row) * e.tab_w + col];
  const float sin_t = clamp_min(sinf(t * F(kPi)), F(1e-5));
  return p_st / (sin_t * F(2.0 * kPi * kPi));
}

// radiance: the environment's radiance and pdf_direct_w toward the unit
// direction d.
__device__ __forceinline__ V3 env_radiance(const Env& e, V3 d, float& pdf_w) {
  float phi = atan2f(d.x, d.z);
  phi = phi < 0.f ? phi + F(2.0 * kPi) : phi;
  const float s = phi * div_factor(2.0 * kPi);
  const float t = acosf(clamp(d.y, -1.f, 1.f)) * div_factor(kPi);
  pdf_w = env_pdf_w(e, s, t);
  return env_lookup(e, s, t);
}

// sample_dir: an importance-sampled direction toward the environment,
// its radiance and pdf_w.  Wide: the CDFs searched by upper_bound_wide
// (fewer rounds of memory latency; the same result).  Each caller takes
// the search that measured faster in it (NVIDIA H100 80GB HBM3, 700.00
// W): the light band's start, a short kernel that waits on its
// environment lanes' dependent loads, the wide one (the instanced band
// ~6% faster); NEE in pt_shade_kernel and vcm_camera_shade_kernel the
// binary one (the wide one 1-6% slower there, with the environment on
// 11-33% of NEE's lanes: the bounce's other work hiding the binary
// search's loads is an inference, not traced).
template <bool Wide = false>
__device__ __forceinline__ V3 env_sample_dir(const Env& e, float u1, float u2,
                                             V3& li, float& pdf_w) {
  const int h = e.tab_h, w = e.tab_w;
  const float* m = e.marginal_cdf;
  const int row = clampi((Wide ? upper_bound_wide(m, h + 1, u1)
                               : upper_bound(m, h + 1, u1)) - 1,
                         0, h - 1);
  const float lo = e.marginal_cdf[row], hi = e.marginal_cdf[row + 1];
  const float v_res =
      clamp((u1 - lo) / clamp_min(hi - lo, F(1e-12)), 0.f, F(1.0 - 1e-7));
  const float* cdf = e.row_cdf + static_cast<int64_t>(row) * (w + 1);
  const int col = clampi((Wide ? upper_bound_wide(cdf, w + 1, u2)
                               : upper_bound(cdf, w + 1, u2)) - 1,
                         0, w - 1);
  const float c_lo = cdf[col], c_hi = cdf[col + 1];
  const float u_res =
      clamp((u2 - c_lo) / clamp_min(c_hi - c_lo, F(1e-12)), 0.f, F(1.0 - 1e-7));
  const float s = (static_cast<float>(col) + u_res) * e.inv_tab_w;
  const float t = (static_cast<float>(row) + v_res) * e.inv_tab_h;
  const float theta = t * F(kPi);
  const float sin_t = sinf(theta);
  const float phi = s * F(2.0 * kPi);
  li = env_lookup(e, s, t);
  pdf_w = env_pdf_w(e, s, t);
  return {sin_t * sinf(phi), cosf(theta), sin_t * cosf(phi)};
}

// ------------------------------------------------------------- lights

struct DirectSample {
  V3 dir;
  float distance;
  V3 radiance;
  float cos_out, pdf_emit_w, pdf_direct_w;
  bool is_delta;
};

// sample_direct for one lane: light row `rec` (render/lights.py
// LightTable.rec), the shading point `from`, uniforms u1, u2; `inv_r2` the
// bounding sphere's inverse squared radius (pdf_emit_w of dir and env
// lights).
__device__ DirectSample sample_direct(const float* rec, V3 from, float u1,
                                      float u2, const Env& env, bool has_env,
                                      float inv_r2 = 0.f) {
  const int kind = __float_as_int(rec[0]);
  const V3 p0 = load3(rec + 1), p1 = load3(rec + 4), p2 = load3(rec + 7);
  const V3 n = load3(rec + 10), intensity = load3(rec + 13);
  const float area = rec[16], cos_angle = rec[17];
  DirectSample ds;
  ds.is_delta =
      kind == LIGHT_POINT || kind == LIGHT_DIR || kind == LIGHT_SPOT;
  ds.cos_out = 1.0f;
  if (kind == LIGHT_TRI) {
    const float su = sqrtf(u1);
    const float tu = 1.0f - su, tv = u2 * su;
    const float tw = (1.0f - tu) - tv;
    const V3 p = add(add(scale(p0, tu), scale(p1, tv)), scale(p2, tw));
    const V3 to_l = sub(p, from);
    const float distsq = clamp_min(dot(to_l, to_l), F(1e-12));
    const float dist = sqrtf(distsq);
    const V3 dir = divs(to_l, dist);
    const float cos_out = dot(n, neg(dir));
    const bool front = cos_out > 0.f && cos_out < 1.f;
    ds.dir = dir;
    ds.distance = dist;
    ds.radiance = front ? scale(intensity, (cos_out * area) / distsq) : zero3();
    ds.pdf_emit_w =
        front ? cos_hemisphere_pdf(cos_out) / clamp_min(area, F(1e-12)) : 1.0f;
    ds.pdf_direct_w =
        front ? distsq / clamp_min(area * cos_out, F(1e-12)) : 1.0f;
    ds.cos_out = front ? cos_out : 1.0f;
  } else if (kind == LIGHT_POINT || kind == LIGHT_SPOT) {
    const V3 to_p = sub(p0, from);
    const float distsq = clamp_min(dot(to_p, to_p), F(1e-12));
    const float dist = sqrtf(distsq);
    const V3 dir = divs(to_p, dist);
    ds.dir = dir;
    ds.distance = dist;
    ds.pdf_direct_w = distsq;
    if (kind == LIGHT_POINT) {
      ds.radiance = divs(intensity, distsq * F(4.0 * kPi));
      ds.pdf_emit_w = F(1.0 / (4.0 * kPi));
    } else {
      const bool in_cone = -dot(dir, n) >= cos_angle;
      ds.radiance = in_cone ? divs(intensity, distsq) : zero3();
      ds.pdf_emit_w = in_cone ? uniform_cone_pdf(cos_angle) : 0.f;
    }
  } else if (kind == LIGHT_DIR) {
    ds.dir = neg(n);
    ds.distance = F(kFar);
    ds.radiance = intensity;
    ds.pdf_emit_w = inv_r2 * F(kInvPi);
    ds.pdf_direct_w = 1.0f;
  } else if (kind == LIGHT_ENV && has_env) {
    V3 li;
    float pdf;
    ds.dir = env_sample_dir(env, u1, u2, li, pdf);
    ds.distance = F(kFar);
    ds.radiance = divs(li, clamp_min(pdf, F(1e-20)));
    ds.pdf_emit_w = (inv_r2 * F(kInvPi)) * pdf;
    ds.pdf_direct_w = pdf;
  } else {
    ds.dir = zero3();
    ds.distance = 0.f;
    ds.radiance = zero3();
    ds.pdf_emit_w = 0.f;
    ds.pdf_direct_w = 0.f;
  }
  return ds;
}

// The bounding sphere (render/lights.py BSphere).
struct BSphere {
  V3 center;
  float radius, inv_r2;
};

struct EmitSample {
  V3 pos, dir, radiance;
  float cos_out, pdf_emit_w, pdf_direct_a;
  bool is_finite, is_delta;
};

// A point on the disc of the bounding sphere that faces along `-axis`:
// center + radius (axis' reverse + b dx + t dy) with (t, b) the frame of
// `axis` (the dir and env lights' emission origin).
__device__ __forceinline__ V3 disc_point(const BSphere& bs, V3 axis, float dx,
                                         float dy) {
  V3 t, b;
  local_coordinates(axis, t, b);
  const V3 inner = add(add(neg(axis), scale(b, dx)), scale(t, dy));
  return add(bs.center, scale(inner, bs.radius));
}

// sample_emit for one lane: light row `rec`, uniforms u1..u4, the
// environment (its CDFs searched by upper_bound_wide: its one caller, the
// light band's start, waits on those loads) and the bounding sphere.
__device__ EmitSample sample_emit(const float* rec, float u1, float u2,
                                  float u3, float u4, const Env& env,
                                  bool has_env, const BSphere& bs) {
  const int kind = __float_as_int(rec[0]);
  const V3 p0 = load3(rec + 1), p1 = load3(rec + 4), p2 = load3(rec + 7);
  const V3 n = load3(rec + 10), intensity = load3(rec + 13);
  const float area_row = rec[16], cos_angle = rec[17];
  EmitSample es;
  es.is_delta =
      kind == LIGHT_POINT || kind == LIGHT_DIR || kind == LIGHT_SPOT;
  es.is_finite = kind != LIGHT_DIR && kind != LIGHT_ENV;
  es.cos_out = 1.0f;
  es.pdf_direct_a = 1.0f;
  V3 dir = zero3();
  if (kind == LIGHT_TRI) {
    const float area = clamp_min(area_row, F(1e-12));
    const float su = sqrtf(u1);
    const float tu = 1.0f - su, tv = u2 * su;
    es.pos = add(add(scale(p0, tu), scale(p1, tv)), scale(p2, (1.0f - tu) - tv));
    const V3 d_loc = sample_cos_hemisphere(u3, u4);
    const float pdf_cos = d_loc.z * F(kInvPi);
    V3 t, b;
    local_coordinates(n, t, b);
    dir = to_world(d_loc, t, b, n);
    const bool degen = pdf_cos <= 0.f;
    es.radiance = degen ? zero3() : scale(intensity, area * F(kPi));
    es.pdf_emit_w = degen ? 1.0f : pdf_cos / area;
    es.pdf_direct_a = degen ? 1.0f : rdiv1(area);
    es.cos_out = degen ? 0.f : d_loc.z;
  } else if (kind == LIGHT_POINT) {
    es.pos = p0;
    dir = sample_uniform_sphere(u3, u4);
    es.radiance = intensity;
    es.pdf_emit_w = F(1.0 / (4.0 * kPi));
  } else if (kind == LIGHT_DIR) {
    float dx, dy;
    sample_concentric_disc(u1, u2, dx, dy);
    const float pdf_emit_d = bs.inv_r2 * F(kInvPi);
    es.pos = disc_point(bs, n, dx, dy);
    dir = n;
    es.radiance = divs(intensity, pdf_emit_d);
    es.pdf_emit_w = pdf_emit_d;
  } else if (kind == LIGHT_SPOT) {
    const V3 d_cone = sample_uniform_cone(cos_angle, u3, u4);
    const float pdf_cone = uniform_cone_pdf(cos_angle);
    V3 t, b;
    local_coordinates(n, t, b);
    es.pos = p0;
    dir = to_world(d_cone, t, b, n);
    es.radiance = divs(intensity, pdf_cone);
    es.pdf_emit_w = pdf_cone;
  } else if (kind == LIGHT_ENV && has_env) {
    V3 li;
    float env_pdf;
    const V3 inward = neg(env_sample_dir<true>(env, u3, u4, li, env_pdf));
    float dx, dy;
    sample_concentric_disc(u1, u2, dx, dy);
    const float pdf_emit_e = (bs.inv_r2 * F(kInvPi)) * env_pdf;
    es.pos = disc_point(bs, inward, dx, dy);
    dir = inward;
    es.radiance = divs(li, clamp_min(pdf_emit_e, F(1e-20)));
    es.pdf_emit_w = pdf_emit_e;
    es.pdf_direct_a = env_pdf;
  } else {
    es.pos = zero3();
    es.radiance = zero3();
    es.pdf_emit_w = 0.f;
  }
  es.dir = normalize(dir);
  return es;
}

// ---------------------------------------------------------- materials

// Per-lane material parameters (render/materials.py MatParams, kd after
// the texture).
struct Mat {
  int kind;
  V3 kd, ks, tf;
  float ns, ior;
};

__device__ __forceinline__ float fresnel_conductor(float cos_i, float kappa) {
  const float c2 = cos_i * cos_i;
  const float ek = kappa * kappa + 1.0f;          // eta * eta + kappa * kappa
  const float ekc = ek * c2;
  const float two_ec = cos_i * 2.0f;              // 2 * eta * cos_i
  const float par = ((ekc - two_ec) + 1.0f) / ((ekc + two_ec) + 1.0f);
  const float perp = ((ek - two_ec) + c2) / ((ek + two_ec) + c2);
  return (par + perp) * 0.5f;
}

__device__ __forceinline__ float fresnel_dielectric(float cos_i_signed,
                                                    float ior) {
  const bool entering = cos_i_signed > 0.f;
  const float eta_i = entering ? 1.0f : ior;
  const float eta_t = entering ? ior : 1.0f;
  const float cos_i = fabsf(cos_i_signed);
  const float sin_t = (eta_i / eta_t) * sqrtf(pos(1.0f - cos_i * cos_i));
  const bool tir = sin_t >= 1.0f;
  const float cos_t = sqrtf(pos(1.0f - sin_t * sin_t));
  const float par = (eta_t * cos_i - eta_i * cos_t) /
                    clamp_min(eta_t * cos_i + eta_i * cos_t, F(1e-20));
  const float perp = (eta_i * cos_i - eta_t * cos_t) /
                     clamp_min(eta_i * cos_i + eta_t * cos_t, F(1e-20));
  const float fr = (par * par + perp * perp) * 0.5f;
  return tir ? 1.0f : fr;
}

__device__ __forceinline__ V3 half_vector(V3 lo, V3 li) {
  const V3 h = add(lo, li);
  return divs(h, sqrtf(clamp_min(dot(h, h), F(1e-20))));
}

__device__ __forceinline__ float ct_g(V3 lo, V3 li, V3 h) {
  const float o_dot_h = clamp_min(dot(lo, h), F(1e-12));
  const float a = ((fabsf(h.z) * 2.0f) * fabsf(lo.z)) / o_dot_h;
  const float b = ((fabsf(h.z) * 2.0f) * fabsf(li.z)) / o_dot_h;
  return clamp_max(minimum(a, b), 1.0f);
}

// The Cook-Torrance value with Blinn D given the half vector, its
// power-term and cos_half (the fresnel angle).
__device__ __forceinline__ V3 ct_value(V3 ks, float ns, V3 lo, V3 li, V3 h,
                                       float pow_h, float cos_half) {
  const float fr = fresnel_conductor(cos_half, ns);
  const float d = ((ns + 2.0f) * div_factor(2.0 * kPi)) * pow_h;
  const float g = ct_g(lo, li, h);
  const float denom = clamp_min(fabsf(li.z) * fabsf(lo.z), F(1e-12)) * 4.0f;
  const bool same_hemi = lo.z * li.z > 0.f;
  return same_hemi ? scale(ks, ((d * g) * fr) / denom) : zero3();
}

// The Blinn half-vector pdf for o_dot_h.
__device__ __forceinline__ float blinn_pdf(float ns, float pow_h,
                                           float o_dot_h, bool same_hemi) {
  const float pdf =
      ((ns + 1.0f) * pow_h) / (clamp_min(o_dot_h, F(1e-12)) * F(2.0 * kPi * 4.0));
  return (same_hemi && o_dot_h > 0.f) ? pdf : 0.f;
}

__device__ __forceinline__ float blinn_pow(V3 h, float ns) {
  return powf(clamp_min(fabsf(h.z), F(1e-12)), ns);
}

__device__ __forceinline__ V3 lambert_eval(V3 kd, V3 lo, V3 li) {
  return lo.z * li.z > 0.f ? scale(kd, F(kInvPi)) : zero3();
}

// _mirror_local(a) * b, summed.
__device__ __forceinline__ float mirror_dot(V3 a, V3 b) {
  return sum3((-a.x) * b.x, (-a.y) * b.y, a.z * b.z);
}

__device__ __forceinline__ V3 phong_eval(V3 ks, float ns, V3 lo, V3 li) {
  const float cos_ro = clamp(mirror_dot(li, lo), 0.f, 1.f);
  const bool same = lo.z * li.z > 0.f;
  const float v = ((ns + 2.0f) * div_factor(2.0 * kPi)) * powf(cos_ro, ns);
  return same ? scale(ks, v) : zero3();
}

__device__ __forceinline__ float phong_pdf(float ns, float m) {
  return ((ns + 1.0f) * div_factor(2.0 * kPi)) * powf(pos(m), ns);
}

__device__ __forceinline__ V3 oren_nayar_eval(V3 kd, float sigma_deg, V3 lo,
                                              V3 li) {
  const float sigma = sigma_deg * F(kPi / 180.0);
  const float s2 = sigma * sigma;
  const float a = 1.0f - s2 / ((s2 + F(0.33)) * 2.0f);
  const float b = (s2 * F(0.45)) / (s2 + F(0.09));
  const float st_i = sqrtf(pos(1.0f - li.z * li.z));
  const float st_o = sqrtf(pos(1.0f - lo.z * lo.z));
  const float denom = clamp_min(st_i * st_o, F(1e-6));
  const float cos_dphi = (li.x * lo.x + li.y * lo.y) / denom;
  const float max_cos =
      (st_i > F(1e-4) && st_o > F(1e-4)) ? pos(cos_dphi) : 0.f;
  const float abs_ci = fabsf(li.z), abs_co = fabsf(lo.z);
  const bool ci_gt = abs_ci > abs_co;
  const float sin_alpha = ci_gt ? st_o : st_i;
  const float tan_beta = ci_gt ? st_i / clamp_min(abs_ci, F(1e-6))
                               : st_o / clamp_min(abs_co, F(1e-6));
  const bool same = lo.z * li.z > 0.f;
  const float v = (a + ((b * max_cos) * sin_alpha) * tan_beta) * F(kInvPi);
  return same ? scale(kd, v) : zero3();
}

// eval_pdf_bsdf: the BSDF value toward wi with its forward and reverse
// pdfs (zero for the delta kinds and across the geometric surface).
__device__ V3 eval_pdf_bsdf(const Mat& m, V3 n, V3 gn, V3 wo, V3 wi,
                            float& pdf_f, float& pdf_r) {
  V3 t, b;
  local_coordinates(n, t, b);
  const V3 lo = project(wo, t, b, n), li = project(wi, t, b, n);
  const bool same_geom = dot(wo, gn) * dot(wi, gn) > 0.f;
  const bool same_hemi = lo.z * li.z > 0.f;
  const float pdf_cos_f = same_hemi ? cos_hemisphere_pdf(fabsf(li.z)) : 0.f;
  const float pdf_cos_r = same_hemi ? cos_hemisphere_pdf(fabsf(lo.z)) : 0.f;
  V3 f = zero3();
  pdf_f = 0.f;
  pdf_r = 0.f;
  if (m.kind == MAT_DIFFUSE) {
    f = lambert_eval(m.kd, lo, li);
    pdf_f = pdf_cos_f;
    pdf_r = pdf_cos_r;
  } else if (m.kind == MAT_GLOSSY) {
    const V3 h = half_vector(lo, li);
    const float odh_f = dot(lo, h), odh_r = dot(li, h);
    const float pow_h = blinn_pow(h, m.ns);
    const V3 ct = ct_value(m.ks, m.ns, lo, li, h, pow_h, odh_r);
    f = scale(add(ct, lambert_eval(m.kd, lo, li)), 0.5f);
    pdf_f = (blinn_pdf(m.ns, pow_h, odh_f, same_hemi) + pdf_cos_f) * 0.5f;
    pdf_r = (blinn_pdf(m.ns, pow_h, odh_r, same_hemi) + pdf_cos_r) * 0.5f;
  } else if (m.kind == MAT_PHONG) {
    const float mm = mirror_dot(li, lo);
    const float v =
        ((m.ns + 2.0f) * div_factor(2.0 * kPi)) * powf(clamp(mm, 0.f, 1.f), m.ns);
    f = same_hemi ? scale(m.ks, v) : zero3();
    pdf_f = phong_pdf(m.ns, mm);
    pdf_r = pdf_f;
  } else if (m.kind == MAT_OREN_NAYAR) {
    f = oren_nayar_eval(m.kd, m.ns, lo, li);
    pdf_f = pdf_cos_f;
    pdf_r = pdf_cos_r;
  }
  if (!same_geom) {
    f = zero3();
    pdf_f = 0.f;
    pdf_r = 0.f;
  }
  return f;
}

// eval_pdf_bsdf with the forward pdf only.
__device__ __forceinline__ V3 eval_pdf_bsdf(const Mat& m, V3 n, V3 gn, V3 wo,
                                            V3 wi, float& pdf_f) {
  float pdf_r;
  return eval_pdf_bsdf(m, n, gn, wo, wi, pdf_f, pdf_r);
}

// pdf_bsdf: the solid-angle pdf of sample_bsdf picking wi from wo (zero
// for the delta kinds and across the geometric surface).
__device__ float pdf_bsdf(const Mat& m, V3 n, V3 gn, V3 wo, V3 wi) {
  V3 t, b;
  local_coordinates(n, t, b);
  const V3 lo = project(wo, t, b, n), li = project(wi, t, b, n);
  const bool same_geom = dot(wo, gn) * dot(wi, gn) > 0.f;
  const bool same_hemi = lo.z * li.z > 0.f;
  const float pdf_cos = same_hemi ? cos_hemisphere_pdf(fabsf(li.z)) : 0.f;
  float pdf = 0.f;
  if (m.kind == MAT_DIFFUSE || m.kind == MAT_OREN_NAYAR) {
    pdf = pdf_cos;
  } else if (m.kind == MAT_GLOSSY) {
    const V3 h = half_vector(lo, li);
    pdf = (blinn_pdf(m.ns, blinn_pow(h, m.ns), dot(lo, h), same_hemi) +
           pdf_cos) *
          0.5f;
  } else if (m.kind == MAT_PHONG) {
    pdf = phong_pdf(m.ns, mirror_dot(lo, li));
  }
  return same_geom ? pdf : 0.f;
}

struct BsdfSample {
  V3 wi, f;
  float pdf;
  bool specular, valid;
};

// sample_bsdf: radiance transport, or with `adjoint` (light paths) glass
// transmission without the (eta_i / eta_t)^2 radiance scaling.
__device__ BsdfSample sample_bsdf(const Mat& m, V3 n, V3 gn, V3 wo, float u1,
                                  float u2, float u3, bool adjoint = false) {
  V3 t, b;
  local_coordinates(n, t, b);
  const V3 lo = project(wo, t, b, n);
  const V3 li_mirror = {-lo.x, -lo.y, lo.z};
  V3 li = zero3(), f = zero3();
  float pdf = 0.f;
  bool transmission = false;
  auto cos_dir = [&]() {
    const V3 d = sample_cos_hemisphere(u1, u2);
    return V3{d.x, d.y, d.z * (lo.z >= 0.f ? 1.f : -1.f)};
  };
  auto pdf_diff = [&](V3 l) {
    return lo.z * l.z > 0.f ? cos_hemisphere_pdf(fabsf(l.z)) : 0.f;
  };
  switch (m.kind) {
    case MAT_DIFFUSE:
      li = cos_dir();
      f = lambert_eval(m.kd, lo, li);
      pdf = pdf_diff(li);
      break;
    case MAT_GLOSSY: {
      if (u3 < 0.5f) {                                 // _ct_sample
        const float c_theta = powf(u1, rdiv1(m.ns + 1.0f));
        const float s_theta = sqrtf(pos(1.0f - c_theta * c_theta));
        const float phi = (u2 * 2.0f) * F(kPi);
        V3 h = {s_theta * cosf(phi), s_theta * sinf(phi), c_theta};
        if (lo.z * h.z <= 0.f) h = neg(h);
        const float o_dot_h = dot(lo, h);
        li = add(neg(lo), scale(h, o_dot_h * 2.0f));
      } else {
        li = cos_dir();
      }
      const V3 h = half_vector(lo, li);
      const float pow_h = blinn_pow(h, m.ns);
      const V3 ct = ct_value(m.ks, m.ns, lo, li, h, pow_h, dot(li, h));
      f = scale(add(ct, lambert_eval(m.kd, lo, li)), 0.5f);
      const bool same_hemi = lo.z * li.z > 0.f;
      pdf = (blinn_pdf(m.ns, pow_h, dot(lo, h), same_hemi) + pdf_diff(li)) *
            0.5f;
      break;
    }
    case MAT_MIRROR:
      li = li_mirror;
      f = scale(m.ks, fresnel_conductor(lo.z, m.ns) /
                          clamp_min(fabsf(lo.z), F(1e-12)));
      pdf = 1.0f;
      break;
    case MAT_GLASS: {
      const float fr = fresnel_dielectric(lo.z, m.ior);
      const float btdf_prob = 1.0f - fr;
      const bool choose_trans = u3 < btdf_prob;
      const bool entering = lo.z > 0.f;
      const float eta_i = entering ? 1.0f : m.ior;
      const float eta_t = entering ? m.ior : 1.0f;
      const float eta_frac = eta_i / eta_t;
      const float sin_i_sqr = pos(1.0f - lo.z * lo.z);
      const float ef2 = eta_frac * eta_frac;
      const float sin_t_sqr = ef2 * sin_i_sqr;
      const bool tir = sin_t_sqr >= 1.0f;
      float cos_t = sqrtf(pos(1.0f - sin_t_sqr));
      cos_t = entering ? -cos_t : cos_t;
      V3 li_trans = {(-eta_frac) * lo.x, (-eta_frac) * lo.y, cos_t};
      li_trans = tir ? li_mirror : li_trans;
      const float t_scale = adjoint ? 1.0f - fr : ef2 * (1.0f - fr);
      const V3 f_trans =
          tir ? zero3()
              : scale(m.tf, t_scale / clamp_min(fabsf(li_trans.z), F(1e-12)));
      const V3 f_refl =
          scale(m.ks, fr / clamp_min(fabsf(lo.z), F(1e-12)));
      li = choose_trans ? li_trans : li_mirror;
      f = choose_trans ? f_trans : f_refl;
      pdf = choose_trans ? btdf_prob : 1.0f - btdf_prob;
      transmission = choose_trans && !tir;
      break;
    }
    case MAT_PHONG: {                                  // _phong_sample
      const V3 d = sample_power_cos_hemisphere(m.ns, u1, u2);
      V3 mt, mb;
      local_coordinates(li_mirror, mt, mb);
      li = to_world(d, mt, mb, li_mirror);
      f = phong_eval(m.ks, m.ns, lo, li);
      pdf = phong_pdf(m.ns, mirror_dot(lo, li));
      break;
    }
    case MAT_OREN_NAYAR:
      li = cos_dir();
      f = oren_nayar_eval(m.kd, m.ns, lo, li);
      pdf = pdf_diff(li);
      break;
    default:
      break;
  }
  BsdfSample s;
  s.wi = to_world(li, t, b, n);
  s.f = f;
  s.pdf = pdf;
  s.specular = m.kind == MAT_MIRROR || m.kind == MAT_GLASS;
  const bool same_geom = dot(wo, gn) * dot(s.wi, gn) > 0.f;
  const bool side_ok = transmission ? !same_geom : same_geom;
  s.valid = side_ok && pdf > 0.f && any_nonzero(f);
  return s;
}

// ------------------------------------------------------------ surface

// The shading point of one lane (render/surface.py SurfaceInteraction;
// uv and the texture ids are consumed here).
struct Interaction {
  V3 pos, w_out, normal, gn, emit;
  float uv_x, uv_y;
  int mat_id, light_id;
  float area;
  Mat m;
};

// _bump_normal for bump_tex >= 0: central differences of the bump
// texture's first channel, du = dv = 1e-3, vscale = 0.02.
__device__ V3 bump_normal(const Atlas& at, int bump_tex, float u, float v,
                          V3 n) {
  const float h0 = sample_bilinear<1>(at, bump_tex, u, v).x;
  const float hu = sample_bilinear<1>(at, bump_tex, u + F(1e-3), v).x;
  const float hv = sample_bilinear<1>(at, bump_tex, u, v + F(1e-3)).x;
  const float diff_u = ((hu - h0) * F(0.02)) * div_factor(1e-3);
  const float diff_v = ((hv - h0) * F(0.02)) * div_factor(1e-3);
  V3 t, b;
  local_coordinates(n, t, b);
  const V3 t2 = normalize(add(t, scale(n, diff_u)));
  const V3 b2 = normalize(add(b, scale(n, diff_v)));
  return normalize(cross(t2, b2));
}

// make_interaction for one lane: the shade-record row of the hit
// (prim_id < 0 reads row 0, which the caller masks), `col` the column map
// (the record's column of each canonical column, -1 where pruned).
__device__ Interaction make_interaction(const float* shade_rec, int rows,
                                        int ncols, const int* col,
                                        const Atlas& at, bool has_textures,
                                        bool has_bump, float t, int prim,
                                        float u, float v, V3 org, V3 d) {
  int row = prim < 0 ? 0 : prim;
  row = row >= rows ? rows - 1 : row;
  const float* rec = shade_rec + static_cast<int64_t>(row) * ncols;
  const float zero1 = t * 0.0f;
  auto row1 = [&](int c) { return col[c] >= 0 ? rec[col[c]] : zero1; };
  auto row3 = [&](int c) {
    const int k = col[c];
    return k >= 0 ? V3{rec[k], rec[k + 1], rec[k + 2]}
                  : V3{zero1, zero1, zero1};
  };
  auto bits = [&](int c) { return col[c] >= 0 ? __float_as_int(rec[col[c]]) : -1; };
  const float w0 = (1.0f - u) - v;
  float uv_x = zero1, uv_y = zero1;
  if (col[12] >= 0) {
    const float* a = rec + col[12];
    const float* b = rec + col[14];
    const float* c = rec + col[16];
    uv_x = (w0 * a[0] + u * b[0]) + v * c[0];
    uv_y = (w0 * a[1] + u * b[1]) + v * c[1];
  }
  V3 n = normalize(
      add(add(scale(row3(0), w0), scale(row3(3), u)), scale(row3(6), v)));
  Interaction s;
  s.gn = row3(9);
  s.m.kind = bits(22);
  s.m.kd = row3(23);
  const int kd_tex = bits(38);
  if (has_textures && kd_tex >= 0)
    s.m.kd = sample_bilinear<3>(at, kd_tex, uv_x, uv_y);
  s.m.ks = row3(26);
  s.m.tf = row3(29);
  s.m.ns = row1(32);
  s.m.ior = row1(33);
  const int bump_tex = bits(39);
  if (has_bump && has_textures && bump_tex >= 0)
    n = bump_normal(at, bump_tex, uv_x, uv_y, n);
  s.normal = dot(s.gn, n) < 0.f ? neg(n) : n;
  s.pos = add(org, scale(d, t));
  s.w_out = neg(normalize(d));
  s.uv_x = uv_x;
  s.uv_y = uv_y;
  s.mat_id = bits(18);
  s.light_id = bits(19);
  s.emit = row3(34);
  s.area = row1(37);
  return s;
}

// ------------------------------------------------------------- camera

// The pinhole camera (render/camera.py Camera) with the float32
// constants torch derives from its size: 0.5 w, 0.5 h and h / w.
struct Cam {
  V3 pos, forward, right, down;
  float ipd;
  int width, height;
  float half_w, half_h, h_over_w;
};

// world_to_raster: raster x and y of a world point.
__device__ __forceinline__ void world_to_raster(const Cam& c, V3 p, float& rx,
                                                float& ry) {
  const V3 dp = sub(p, c.pos);
  const float depth = dot(dp, c.forward);
  const float safe = fabsf(depth) < F(1e-8) ? F(1e-8) : depth;
  const float a = (dot(dp, c.right) * c.ipd) / safe;
  const float b = (dot(dp, c.down) * c.ipd) / safe;
  rx = a + c.half_w;
  ry = b * c.h_over_w + c.half_h;
}

// raster_to_id: the pixel id, -1 outside.  floor(x).to(int32) is the
// card's saturating cast (probe line "floor(x).to(int32)").
__device__ __forceinline__ int raster_to_id(const Cam& c, float rx, float ry) {
  const int x = static_cast<int>(floorf(rx));
  const int y = static_cast<int>(floorf(ry));
  const bool inside = x >= 0 && x < c.width && y >= 0 && y < c.height;
  return inside ? int32_mul(y, c.width) + x : -1;
}

// ---------------------------------------------------------------- VCM

// shading_normal_adjoint: Veach's adjoint-BSDF cosine correction.
__device__ __forceinline__ float shading_normal_adjoint(V3 normal, V3 gn,
                                                        V3 w_out, V3 w_in) {
  float denom = dot(w_out, gn);
  denom = fabsf(denom) < F(1e-9) ? (denom < 0.f ? F(-1e-9) : F(1e-9)) : denom;
  return (dot(w_out, normal) * dot(w_in, gn)) / denom;
}

// A light vertex of the packed (C, 24) cache (render/light_cache.py
// LightVertexCache.packed), its material gathered.
struct LightVertex {
  V3 pos, w_out, normal, gn, throughput;
  float d_vc, d_vcm, d_vm;
  int path_length;
  Mat m;
};

// _vertex_from_rec for one row: the material row `mat_id` of the (M, 24)
// material table (kind, kd, ks, tf, ns, ior, kd_tex), kd from its texture
// at the row's uv where the scene has textures and the id is >= 0.
// Inlined into the camera kernel's connection step.
__device__ __forceinline__ LightVertex vertex_from_rec(const float* rec, const float* mat_rec,
                                       int num_mats, const Atlas& at,
                                       bool has_textures) {
  LightVertex v;
  v.pos = load3(rec);
  v.w_out = load3(rec + 3);
  v.normal = load3(rec + 6);
  v.gn = load3(rec + 9);
  v.throughput = load3(rec + 15);
  v.d_vc = rec[18];
  v.d_vcm = rec[19];
  v.d_vm = rec[20];
  v.path_length = __float_as_int(rec[21]);
  const int mat_id = clampi(__float_as_int(rec[14]), 0, num_mats - 1);
  const float* mr = mat_rec + static_cast<int64_t>(mat_id) * 24;
  v.m.kind = __float_as_int(mr[0]);
  v.m.kd = load3(mr + 1);
  v.m.ks = load3(mr + 4);
  v.m.tf = load3(mr + 7);
  v.m.ns = mr[10];
  v.m.ior = mr[11];
  const int kd_tex = __float_as_int(mr[15]);
  if (has_textures && kd_tex >= 0)
    v.m.kd = sample_bilinear<3>(at, kd_tex, rec[12], rec[13]);
  return v;
}

}  // namespace shade

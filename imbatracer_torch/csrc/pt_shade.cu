// The PT bounce's shading, for NVIDIA Hopper (sm_90a).
//
// No Pallas kernel stands behind this file: it is the card's counterpart
// of the XLA fusions of JAX's compiled PT band, the shading of
// imbatracer_tpu/render/integrators/pt.py::_pt_bounce between and after
// its traversal calls.  Two kernels, one thread a lane:
//
//   pt_shade_kernel         imbatracer_torch/ops/shade.py::pt_shade_plain:
//                           env-miss MIS, the surface interaction, emitter
//                           MIS, NEE light sampling with the BSDF toward
//                           the light, the shadow ray, Russian roulette,
//                           BSDF sampling and the next carry;
//   pt_shade_finish_kernel  ops/shade.py::pt_shade_finish_plain: the NEE
//                           add where the shadow ray was not occluded.
//
// Layouts are the plain version's: the carry's columns (org, d,
// throughput, radiance (R, 3) f32; tmin, last_pdf (R,) f32; active,
// last_specular (R,) bool; depth (R,) i32; state (R,) i64 holding a
// 32-bit word), the hit's (t, u, v (R,) f32, prim_id (R,) i32), the
// scene's shade record (F, cols) f32 read through the column map, light
// rows (L, 24) f32, texture atlas and environment tables; out the next
// carry, the shadow ray (pos, dir (R, 3), tmin, tmax (R,), ok (R,) bool)
// and contrib (R, 3).  Each kernel adds its lanes' count (the active
// lanes, the shadow rays) to a copy of the carried count n_rays: a warp
// ballot, then one atomicAdd a warp.  Nothing is read on the host and
// nothing is allocated, so both run inside the captured bounce.
//
// What bounds it: the bytes a live lane moves (the carry, its hit, one
// shade-record row, one light row, texels and env-table entries, the
// outputs) against the arithmetic of one BSDF sample, one BSDF eval and
// one light sample a lane; the per-lane branches by material and light
// kind diverge within a warp.  The design is the plain one: a lane a
// thread, registers only, no shared memory.
//
// Numerics: see shading.cuh.  Built with --fmad=false.

#include <cuda_runtime.h>

#include <cstdint>

#include "shading.cuh"

namespace {

using namespace shade;

constexpr int kBlk = 128;
constexpr int kShadeColumns = 48;

// Pointer arguments, in the order of ops/shade.py: the carry in, the hit,
// the scene tables, the carry out, the count, the shadow ray, contrib.
enum Ptr {
  P_ORG, P_D, P_TMIN, P_THR, P_RAD, P_ACTIVE, P_DEPTH, P_LAST_PDF,
  P_LAST_SPEC, P_STATE,
  P_HIT_T, P_HIT_PRIM, P_HIT_U, P_HIT_V,
  P_SHADE_REC, P_LIGHT_REC, P_TEXELS, P_TEX_OFFSET, P_TEX_WIDTH,
  P_TEX_HEIGHT, P_ENV_IMG, P_ENV_PDF, P_ENV_ROW_CDF, P_ENV_MARGINAL_CDF,
  P_O_ORG, P_O_D, P_O_TMIN, P_O_THR, P_O_RAD, P_O_ACTIVE, P_O_DEPTH,
  P_O_LAST_PDF, P_O_LAST_SPEC, P_O_STATE,
  P_O_NRAYS,
  P_S_POS, P_S_DIR, P_S_TMIN, P_S_TMAX, P_S_OK,
  P_CONTRIB,
  NUM_PTRS
};

// Int arguments: the scene's, its column map, the call's.
enum Int {
  I_ROWS, I_COLS, I_LIGHTS, I_TEXTURES, I_TEXELS, I_IMG_H, I_IMG_W,
  I_TAB_H, I_TAB_W, I_HAS_ENV, I_HAS_TEXTURES,
  I_COLMAP,
  I_LANES = I_COLMAP + kShadeColumns, I_HAS_BUMP, I_MAX_LEN,
  NUM_INTS
};

// Float arguments: the float32 constants torch derives from the scene's
// light count and environment sizes (ops/shade.py SceneTables).
enum Flt {
  F_LIGHTS, F_INV_LIGHTS, F_PICK, F_INV_PICK, F_IMG_WM1, F_IMG_HM1,
  F_TAB_W, F_TAB_H, F_INV_TAB_W, F_INV_TAB_H,
  NUM_FLOATS
};

struct Args {
  void* p[NUM_PTRS];
  int i[NUM_INTS];
  float f[NUM_FLOATS];
};

template <class T>
__device__ __forceinline__ const T* in(const Args& a, int k) {
  return static_cast<const T*>(a.p[k]);
}
template <class T>
__device__ __forceinline__ T* out(const Args& a, int k) {
  return static_cast<T*>(a.p[k]);
}

// Add the warp's lanes with `c` set to *count: one atomicAdd a warp.
// Every lane of the warp must call it.
__device__ __forceinline__ void count_warp(bool c, unsigned long long* count) {
  const unsigned m = __ballot_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && m != 0u)
    atomicAdd(count, static_cast<unsigned long long>(__popc(m)));
}

__global__ void __launch_bounds__(kBlk)
    pt_shade_kernel(const __grid_constant__ Args a) {
  const int lanes = a.i[I_LANES];
  const int i = blockIdx.x * kBlk + threadIdx.x;
  const bool lane = i < lanes;
  const bool active0 = lane && in<uint8_t>(a, P_ACTIVE)[i] != 0;
  count_warp(active0, out<unsigned long long>(a, P_O_NRAYS));
  if (!lane) return;

  const V3 org = load3(in<float>(a, P_ORG) + 3 * i);
  const V3 d = load3(in<float>(a, P_D) + 3 * i);
  const V3 thr = load3(in<float>(a, P_THR) + 3 * i);
  V3 rad = load3(in<float>(a, P_RAD) + 3 * i);
  const int depth = in<int>(a, P_DEPTH)[i];
  const float last_pdf = in<float>(a, P_LAST_PDF)[i];
  const bool last_spec = in<uint8_t>(a, P_LAST_SPEC)[i] != 0;
  uint32_t st = static_cast<uint32_t>(in<int64_t>(a, P_STATE)[i]);
  const float t = in<float>(a, P_HIT_T)[i];
  const int prim = in<int>(a, P_HIT_PRIM)[i];
  const int num_lights = a.i[I_LIGHTS];
  const bool has_env = a.i[I_HAS_ENV] != 0;
  const bool mis_off = depth == 0 || last_spec;   // first | last_specular

  Env env;
  env.img = in<float>(a, P_ENV_IMG);
  env.pdf_table = in<float>(a, P_ENV_PDF);
  env.row_cdf = in<float>(a, P_ENV_ROW_CDF);
  env.marginal_cdf = in<float>(a, P_ENV_MARGINAL_CDF);
  env.img_h = a.i[I_IMG_H];
  env.img_w = a.i[I_IMG_W];
  env.tab_h = a.i[I_TAB_H];
  env.tab_w = a.i[I_TAB_W];
  env.img_wm1 = a.f[F_IMG_WM1];
  env.img_hm1 = a.f[F_IMG_HM1];
  env.tab_w_f = a.f[F_TAB_W];
  env.tab_h_f = a.f[F_TAB_H];
  env.inv_tab_w = a.f[F_INV_TAB_W];
  env.inv_tab_h = a.f[F_INV_TAB_H];

  // ---- environment misses ----------------------------------------------
  const bool miss = active0 && prim < 0;
  if (has_env) {
    V3 term = zero3();
    if (miss) {
      float pdf_w;
      const V3 li = env_radiance(env, normalize(d), pdf_w);
      const float pdf_di = pdf_w * a.f[F_INV_LIGHTS];
      const float w = mis_off ? 1.0f : mis_power_heuristic(last_pdf, pdf_di);
      term = scale(mul(thr, li), w);
    }
    rad = add(rad, term);
  }
  bool active = active0 && !miss;

  Atlas at;
  at.texels = in<float>(a, P_TEXELS);
  at.offset = in<int>(a, P_TEX_OFFSET);
  at.width = in<int>(a, P_TEX_WIDTH);
  at.height = in<int>(a, P_TEX_HEIGHT);
  at.num_tex = a.i[I_TEXTURES];
  at.num_texels = a.i[I_TEXELS];
  const Interaction s = make_interaction(
      in<float>(a, P_SHADE_REC), a.i[I_ROWS], a.i[I_COLS], a.i + I_COLMAP, at,
      a.i[I_HAS_TEXTURES] != 0, a.i[I_HAS_BUMP] != 0, t, prim,
      in<float>(a, P_HIT_U)[i], in<float>(a, P_HIT_V)[i], org, d);

  // ---- emitter hits ----------------------------------------------------
  const bool is_emitter = active && s.light_id >= 0;
  const float cos_geom = dot(s.gn, s.w_out);
  const float cos_shade = dot(s.normal, s.w_out);
  const float area = clamp_min(s.area, F(1e-12));
  const float pdf_di_emit = ((rdiv1(area) * a.f[F_INV_LIGHTS]) * (t * t)) /
                            (cos_shade <= 0.f ? 1.0f : cos_shade);
  const float w_emit =
      mis_off ? 1.0f : mis_power_heuristic(last_pdf, pdf_di_emit);
  const bool emit_ok = is_emitter && cos_geom > 0.f && cos_shade > 0.f;
  rad = add(rad, emit_ok ? scale(mul(thr, s.emit), w_emit) : zero3());
  active = active && !is_emitter;

  // ---- next-event estimation -------------------------------------------
  const float ul = next_float(st);
  const float ua = next_float(st);
  const float ub = next_float(st);
  int light_idx = static_cast<int>(ul * a.f[F_LIGHTS]);
  light_idx = light_idx > num_lights - 1 ? num_lights - 1 : light_idx;
  light_idx = light_idx < 0 ? 0 : light_idx;
  const DirectSample ds =
      sample_direct(in<float>(a, P_LIGHT_REC) + 24 * light_idx, s.pos, ua, ub,
                    env, has_env);
  float pdf_hit;
  const V3 f_nee = eval_pdf_bsdf(s.m, s.normal, s.gn, s.w_out, ds.dir, pdf_hit);
  const float pdf_di = ds.pdf_direct_w * a.f[F_PICK];
  const float w_nee =
      ds.is_delta ? 1.0f : pdf_di / clamp_min(pdf_di + pdf_hit, F(1e-20));
  const V3 contrib =
      scale(mul(mul(thr, f_nee), ds.radiance),
            (fabsf(dot(s.normal, ds.dir)) * w_nee) * a.f[F_INV_PICK]);
  const bool shadow_ok =
      active && pdf_hit > 0.f && pdf_di > 0.f && any_positive(contrib);
  const float offset =
      (ds.distance >= F(kBig) ? 1.0f : ds.distance) * F(1e-3);

  // ---- bounce ----------------------------------------------------------
  const float urr = next_float(st);
  const float u1 = next_float(st);
  const float u2 = next_float(st);
  const float u3 = next_float(st);
  const bool survive = urr < russian_roulette_prob(thr);
  const BsdfSample bs = sample_bsdf(s.m, s.normal, s.gn, s.w_out, u1, u2, u3);
  const float cos_term = fabsf(dot(s.normal, bs.wi));
  const V3 new_thr =
      scale(mul(thr, bs.f),
            cos_term / clamp_min(bs.pdf * russian_roulette_prob(thr), F(1e-20)));
  active = active && survive && bs.valid && depth + 1 < a.i[I_MAX_LEN];

  store3(out<float>(a, P_O_ORG) + 3 * i, active ? s.pos : org);
  store3(out<float>(a, P_O_D) + 3 * i, active ? bs.wi : d);
  out<float>(a, P_O_TMIN)[i] =
      active ? t * F(1e-3) : in<float>(a, P_TMIN)[i];
  store3(out<float>(a, P_O_THR) + 3 * i, active ? new_thr : thr);
  store3(out<float>(a, P_O_RAD) + 3 * i, rad);
  out<uint8_t>(a, P_O_ACTIVE)[i] = active;
  out<int>(a, P_O_DEPTH)[i] = active ? depth + 1 : depth;
  out<float>(a, P_O_LAST_PDF)[i] = active ? bs.pdf : last_pdf;
  out<uint8_t>(a, P_O_LAST_SPEC)[i] = active ? bs.specular : last_spec;
  out<int64_t>(a, P_O_STATE)[i] = static_cast<int64_t>(st);
  store3(out<float>(a, P_S_POS) + 3 * i, s.pos);
  store3(out<float>(a, P_S_DIR) + 3 * i, ds.dir);
  out<float>(a, P_S_TMIN)[i] = offset;
  out<float>(a, P_S_TMAX)[i] = ds.distance - offset;
  out<uint8_t>(a, P_S_OK)[i] = shadow_ok;
  store3(out<float>(a, P_CONTRIB) + 3 * i, contrib);
}

__global__ void __launch_bounds__(kBlk)
    pt_shade_finish_kernel(const float* __restrict__ radiance,
                           const float* __restrict__ contrib,
                           const uint8_t* __restrict__ shadow_ok,
                           const uint8_t* __restrict__ occluded,
                           float* __restrict__ out,
                           unsigned long long* count, int lanes) {
  const int i = blockIdx.x * kBlk + threadIdx.x;
  const bool lane = i < lanes;
  const bool cast = lane && shadow_ok[i] != 0;
  count_warp(cast, count);
  if (!lane) return;
  const bool lit = cast && occluded[i] == 0;
  for (int k = 0; k < 3; ++k)
    out[3 * i + k] = radiance[3 * i + k] + (lit ? contrib[3 * i + k] : 0.0f);
}

int blocks_for(int lanes) { return (lanes + kBlk - 1) / kBlk; }

}  // namespace

// pt_shade_kernel on the current stream.  `ptrs`, `ints`, `floats`: the
// arguments of enum Ptr, Int and Flt, with their counts; a count that is
// not the kernel's returns cudaErrorInvalidValue.  Returns a CUDA error
// code.
extern "C" int imba_pt_shade(void* const* ptrs, int nptrs, const int* ints,
                             int nints, const float* floats, int nfloats,
                             void* stream) {
  if (nptrs != NUM_PTRS || nints != NUM_INTS || nfloats != NUM_FLOATS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  for (int k = 0; k < NUM_PTRS; ++k) a.p[k] = ptrs[k];
  for (int k = 0; k < NUM_INTS; ++k) a.i[k] = ints[k];
  for (int k = 0; k < NUM_FLOATS; ++k) a.f[k] = floats[k];
  const int lanes = a.i[I_LANES];
  if (lanes > 0)
    pt_shade_kernel<<<blocks_for(lanes), kBlk, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// pt_shade_finish_kernel on the current stream: out (R, 3) = radiance +
// contrib where shadow_ok & ~occluded, and the shadow rays added to
// *count (int64).  Returns a CUDA error code.
extern "C" int imba_pt_shade_finish(const void* radiance, const void* contrib,
                                    const void* shadow_ok, const void* occluded,
                                    void* out, void* count, int lanes,
                                    void* stream) {
  if (lanes > 0)
    pt_shade_finish_kernel<<<blocks_for(lanes), kBlk, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(radiance), static_cast<const float*>(contrib),
        static_cast<const uint8_t*>(shadow_ok),
        static_cast<const uint8_t*>(occluded), static_cast<float*>(out),
        static_cast<unsigned long long*>(count), lanes);
  return static_cast<int>(cudaGetLastError());
}

// Resources of pt_shade_kernel (finish = 0) or pt_shade_finish_kernel:
// out[0] registers, out[1] static shared bytes, out[2] dynamic shared
// bytes, out[3] local (spill) bytes a thread, out[4] resident blocks an
// SM.  Returns a CUDA error code.
extern "C" int imba_pt_shade_resources(int finish, int* out) {
  const void* fn = finish ? reinterpret_cast<const void*>(pt_shade_finish_kernel)
                          : reinterpret_cast<const void*>(pt_shade_kernel);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlk, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  return static_cast<int>(cudaSuccess);
}

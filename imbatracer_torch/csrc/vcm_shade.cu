// The VCM family's light and camera bounces' shading, for NVIDIA Hopper
// (sm_90a).
//
// No Pallas kernel stands behind this file: it is the card's counterpart
// of the XLA fusions of JAX's compiled light-band and camera-band
// programs (imbatracer_tpu/render/integrators/vcm.py `_vcm_light_band`,
// `_vcm_camera_band`, `_vcm_camera_phase1` / `_phase2`), the shading of
// `_light_pass`'s and `_camera_body_fn`'s bodies between and after their
// traversal calls.  Four kernels, one thread a lane:
//
//   vcm_light_start_kernel   ops/vcm_shade.py::light_start_plain: a light
//                            band's seed, light pick, sample_emit and
//                            initial partial MIS weights;
//   vcm_light_shade_kernel   ops/vcm_shade.py::light_shade_plain: one light
//                            bounce between its closest hit and the camera
//                            connection's any hit -- the interaction, the
//                            partial weights, the vertex row and its store
//                            flag, the camera connection up to its shadow
//                            ray, and the adjoint bounce;
//   vcm_camera_shade_kernel  ops/vcm_shade.py::camera_shade_plain: one
//                            camera bounce between its closest hit and its
//                            shadow rays' any hit -- the env-miss and
//                            emitter MIS terms, the interaction and the
//                            partial weights, NEE and the vertex
//                            connections up to their shadow rays, the merge
//                            query's columns, and the bounce;
//   vcm_finish_kernel<camera> ops/vcm_shade.py::camera_finish_plain (each
//                            shadow set's contribution added where it was
//                            not occluded, in set order, the shadow rays
//                            counted) and light_finish_plain (the camera
//                            connection's row kept where it was not
//                            occluded, in place).
//
// Layouts are the plain versions': carry columns (org, d, throughput,
// radiance (R, 3) f32; tmin, d_vc, d_vcm, d_vm (R,) f32; active, finite
// (R,) bool; path_id (R,) i32; state (R,) i64 holding a 32-bit word), the
// hit's (t, u, v (R,) f32, prim_id (R,) i32), the scene's shade record
// (F, cols) f32 read through the column map, light rows (L, 24) f32,
// material rows (M, 24) f32, texture atlas, environment tables and the
// bounding sphere.  Everything that changes from frame to frame (the frame
// number, the MIS constants, the base radius, the working cache and its
// count, the band's path range, the camera) is read through a pointer, so
// a captured graph replays with the values of the frame it runs in; the
// plain int and float arguments are fixed by the graph's key.  Nothing is
// read on the host and nothing is allocated.
//
// What bounds it: the bytes a lane moves (its carry, hit, shade-record
// row, light rows and cache rows, its outputs) against one BSDF sample,
// one or two BSDF evaluations per NEE sample and connection, and one light
// sample; the branches by material and light kind diverge within a warp.
// The finish kernels are the plain design, a lane a thread, registers
// only; the two bounces, redesigned for Hopper, work in two phases a block
// (the note above the light bounce); the light start, redesigned for
// Hopper, writes its (R, 3) columns as 16-byte words (the note above it).
//
// Numerics: see shading.cuh.  Built with --fmad=false.

#include <cuda_runtime.h>

#include <cstdint>

#include "shading.cuh"

namespace {

using namespace shade;

constexpr int kBlk = 128;
constexpr int kShadeColumns = 48;

// Algorithms (render/integrators/vcm.py ALGOS) and technique bits
// (TECHNIQUES, in order).
enum Algo { ALGO_VCM, ALGO_BPT, ALGO_PPM, ALGO_LT, ALGO_PT };
enum Tech {
  T_LIGHT_HIT = 1, T_NEXT_EVENT = 2, T_CONNECT = 4, T_MERGE = 8,
  T_CAM_CONNECT = 16
};

// Kernels of imba_vcm_shade.
enum Which { K_LIGHT_START, K_LIGHT_SHADE, K_CAMERA_SHADE, NUM_SHADE };

// Pointer arguments, in the order of ops/vcm_shade.py: the scene tables,
// the frame's inputs, the carry in, the hit, the carry out, the light
// band's rows, the shadow rays, the merge query.  A kernel reads the slots
// it needs; the others are null.
enum Ptr {
  P_SHADE_REC, P_LIGHT_REC, P_TEXELS, P_TEX_OFFSET, P_TEX_WIDTH,
  P_TEX_HEIGHT, P_ENV_IMG, P_ENV_PDF, P_ENV_ROW_CDF, P_ENV_MARGINAL_CDF,
  P_MAT_REC, P_BS_CENTER, P_BS_RADIUS, P_BS_INV_R2,
  P_CAM_POS, P_CAM_FORWARD, P_CAM_RIGHT, P_CAM_DOWN, P_CAM_IPD,
  P_FRAME, P_MIS_ETA_VC, P_MIS_ETA_VM, P_BASE_RADIUS, P_CACHE_COUNT,
  P_CACHE_REC, P_PATH_START, P_PATH_END,
  P_ORG, P_D, P_TMIN, P_THR, P_RAD, P_ACTIVE, P_D_VC, P_D_VCM, P_D_VM,
  P_STATE, P_FINITE, P_PATH_ID, P_NRAYS,
  P_HIT_T, P_HIT_PRIM, P_HIT_U, P_HIT_V,
  P_O_ORG, P_O_D, P_O_TMIN, P_O_THR, P_O_RAD, P_O_ACTIVE, P_O_D_VC,
  P_O_D_VCM, P_O_D_VM, P_O_STATE, P_O_FINITE, P_O_PATH_ID, P_O_NRAYS,
  P_V_REC, P_V_STORE, P_CC_CONTRIB, P_CC_PIXEL,
  P_S_POS, P_S_DIR, P_S_TMIN, P_S_TMAX, P_S_OK, P_S_CONTRIB,
  P_Q_POS, P_Q_NORMAL, P_Q_GN, P_Q_W_OUT, P_Q_KIND, P_Q_KD, P_Q_KS, P_Q_NS,
  P_Q_D_VCM, P_Q_D_VM, P_Q_ACTIVE, P_Q_THR,
  NUM_PTRS
};

// Int arguments: the scene's, its column map, the material rows, the
// call's.
enum Int {
  I_ROWS, I_COLS, I_LIGHTS, I_TEXTURES, I_TEXELS, I_IMG_H, I_IMG_W,
  I_TAB_H, I_TAB_W, I_HAS_ENV, I_HAS_TEXTURES,
  I_COLMAP,
  I_MATS = I_COLMAP + kShadeColumns, I_LANES, I_HAS_BUMP, I_MAX_LEN,
  I_BOUNCE, I_ALGO, I_TECH, I_NUM_CONN, I_LPC, I_WIDTH, I_HEIGHT,
  I_USE_CACHE, I_USE_CC, I_PATH_START, I_CACHE_ROWS,
  NUM_INTS
};

// Float arguments: the scene's float32 constants (ops/shade.py
// SceneTables), then those torch derives from the call's Python numbers.
enum Flt {
  F_LIGHTS, F_INV_LIGHTS, F_PICK, F_INV_PICK, F_IMG_WM1, F_IMG_HM1,
  F_TAB_W, F_TAB_H, F_INV_TAB_W, F_INV_TAB_H,
  F_INV_PIXEL_AREA, F_INV_LPC, F_VC_NORM, F_HALF_W, F_HALF_H, F_H_OVER_W,
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

// Add `c` over the warp to *count: one atomicAdd a warp.  Every lane of
// the warp must call it.
__device__ __forceinline__ void count_warp(unsigned c,
                                           unsigned long long* count) {
  const unsigned sum = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && sum != 0u)
    atomicAdd(count, static_cast<unsigned long long>(sum));
}

__device__ __forceinline__ Env env_of(const Args& a) {
  Env e;
  e.img = in<float>(a, P_ENV_IMG);
  e.pdf_table = in<float>(a, P_ENV_PDF);
  e.row_cdf = in<float>(a, P_ENV_ROW_CDF);
  e.marginal_cdf = in<float>(a, P_ENV_MARGINAL_CDF);
  e.img_h = a.i[I_IMG_H];
  e.img_w = a.i[I_IMG_W];
  e.tab_h = a.i[I_TAB_H];
  e.tab_w = a.i[I_TAB_W];
  e.img_wm1 = a.f[F_IMG_WM1];
  e.img_hm1 = a.f[F_IMG_HM1];
  e.tab_w_f = a.f[F_TAB_W];
  e.tab_h_f = a.f[F_TAB_H];
  e.inv_tab_w = a.f[F_INV_TAB_W];
  e.inv_tab_h = a.f[F_INV_TAB_H];
  return e;
}

__device__ __forceinline__ Atlas atlas_of(const Args& a) {
  Atlas at;
  at.texels = in<float>(a, P_TEXELS);
  at.offset = in<int>(a, P_TEX_OFFSET);
  at.width = in<int>(a, P_TEX_WIDTH);
  at.height = in<int>(a, P_TEX_HEIGHT);
  at.num_tex = a.i[I_TEXTURES];
  at.num_texels = a.i[I_TEXELS];
  return at;
}

__device__ __forceinline__ BSphere bsphere_of(const Args& a) {
  BSphere bs;
  bs.center = load3(in<float>(a, P_BS_CENTER));
  bs.radius = *in<float>(a, P_BS_RADIUS);
  bs.inv_r2 = *in<float>(a, P_BS_INV_R2);
  return bs;
}

__device__ __forceinline__ Cam cam_of(const Args& a) {
  Cam c;
  c.pos = load3(in<float>(a, P_CAM_POS));
  c.forward = load3(in<float>(a, P_CAM_FORWARD));
  c.right = load3(in<float>(a, P_CAM_RIGHT));
  c.down = load3(in<float>(a, P_CAM_DOWN));
  c.ipd = *in<float>(a, P_CAM_IPD);
  c.width = a.i[I_WIDTH];
  c.height = a.i[I_HEIGHT];
  c.half_w = a.f[F_HALF_W];
  c.half_h = a.f[F_HALF_H];
  c.h_over_w = a.f[F_H_OVER_W];
  return c;
}

// The lane's hit shaded: make_interaction.
__device__ __forceinline__ Interaction interaction(const Args& a, int i,
                                                   float t, int prim, V3 org,
                                                   V3 d) {
  return make_interaction(in<float>(a, P_SHADE_REC), a.i[I_ROWS], a.i[I_COLS],
                          a.i + I_COLMAP, atlas_of(a),
                          a.i[I_HAS_TEXTURES] != 0, a.i[I_HAS_BUMP] != 0, t,
                          prim, in<float>(a, P_HIT_U)[i],
                          in<float>(a, P_HIT_V)[i], org, d);
}

__device__ __forceinline__ bool is_specular(const Mat& m) {
  return m.kind == MAT_MIRROR || m.kind == MAT_GLASS;
}

// vcm.py::_bounce for one lane: Russian roulette, BSDF sampling (adjoint
// on light paths; PPM camera paths follow specular chains only) and the
// partial-weight updates.  Writes the next carry's columns.
struct Bounce {
  V3 wi, throughput;
  float d_vc, d_vcm, d_vm;
  bool active;
};

__device__ Bounce vcm_bounce(const Interaction& s, V3 thr, float d_vc,
                             float d_vcm, float d_vm, bool active,
                             uint32_t& st, float eta_vc, float eta_vm,
                             bool adjoint, bool specular_only, bool last) {
  const float urr = next_float(st);
  const float u1 = next_float(st);
  const float u2 = next_float(st);
  const float u3 = next_float(st);
  const float rr_pdf = russian_roulette_prob(thr);
  const bool survive = urr < rr_pdf;
  const BsdfSample bs =
      sample_bsdf(s.m, s.normal, s.gn, s.w_out, u1, u2, u3, adjoint);
  bool valid = bs.valid;
  if (specular_only) valid = valid && bs.specular;
  const bool spec = bs.specular;
  const float pdf_rev =
      spec ? bs.pdf : pdf_bsdf(s.m, s.normal, s.gn, bs.wi, s.w_out);
  const float cos_i =
      adjoint ? fabsf(shading_normal_adjoint(s.normal, s.gn, s.w_out, bs.wi))
              : fabsf(dot(bs.wi, s.normal));
  const float safe_pdf = clamp_min(bs.pdf, F(1e-20));
  const float ratio = cos_i / safe_pdf;
  Bounce b;
  b.wi = bs.wi;
  b.d_vc = spec ? d_vc * cos_i : ratio * ((d_vc * pdf_rev + d_vcm) + eta_vm);
  b.d_vm = spec ? d_vm * cos_i
                : ratio * ((d_vm * pdf_rev + d_vcm * eta_vc) + 1.0f);
  b.d_vcm = spec ? 0.f : rdiv1(safe_pdf);
  b.throughput = scale(mul(thr, bs.f), cos_i / (rr_pdf * safe_pdf));
  b.active = active && survive && valid && !last;
  return b;
}

// The next carry of a bounce: vcm.py::_bounce's selects.
__device__ __forceinline__ void store_next(const Args& a, int i,
                                           const Bounce& b, V3 pos, V3 thr,
                                           float t, float d_vc, float d_vcm,
                                           float d_vm, uint32_t st) {
  const bool on = b.active;
  store3(out<float>(a, P_O_ORG) + 3 * i, on ? pos : zero3());
  store3(out<float>(a, P_O_D) + 3 * i, on ? b.wi : zero3());
  out<float>(a, P_O_TMIN)[i] = t * F(1e-4);
  store3(out<float>(a, P_O_THR) + 3 * i, on ? b.throughput : thr);
  out<uint8_t>(a, P_O_ACTIVE)[i] = on;
  out<float>(a, P_O_D_VC)[i] = on ? b.d_vc : d_vc;
  out<float>(a, P_O_D_VCM)[i] = on ? b.d_vcm : d_vcm;
  out<float>(a, P_O_D_VM)[i] = on ? b.d_vm : d_vm;
  out<int64_t>(a, P_O_STATE)[i] = static_cast<int64_t>(st);
}

// ---------------------------------------------------------------------------
// The light band's start: vcm.py::_light_pass before its loop (imbatracer_tpu/
// render/integrators/vcm.py:142-170), redesigned for Hopper.
//
// A lane's work is a chain of arithmetic with few loads: the seed hash and
// four draws, the light pick (an int32 product and floor division), the
// light's row (uniform across most warps), sample_emit (for the
// environment two binary searches over its CDFs and its texel and pdf
// reads), then 66 B of outputs.  Measured alone with variants of this
// kernel on 262,144-lane still-life bands (NVIDIA H100 80GB HBM3, 700.00
// W): an empty launch of the same grid takes ~3 us, the loads and
// sample_emit with one 4-byte store a lane ~6.5 us on the area light's
// bands and ~13.5 on the environment's, against 9.8 and 15.4 for the plain
// lane-a-thread kernel.  So the body bounds the environment's bands, and
// the stores a third of the area light's: written a lane a thread, each of
// the three (R, 3) columns is three 4-byte stores 12 bytes apart, nine
// store instructions a warp that touch 12 sectors each.
//
// Here a full warp moves its lanes' (x, y, z) by shuffles so that lanes
// 0-23 each write one 16-byte word of the warp's 96-float slab of a
// column: three store instructions a warp instead of nine.  Shuffles, not
// shared memory: staging in shared memory (a block's columns or a warp's,
// with or without a barrier) lost 3-7% on the environment's bands, whose
// tables the plain kernel's L1 holds (an inference: not traced, the
// carve-out the shared memory takes).  The other columns are one
// coalesced store a lane, as before; a warp at the band's ragged end (or
// an unaligned column) writes a lane a thread.  In a frame, a band with
// few environment lanes waits on their CDF searches' dependent loads (17
// on the instanced scene's 256 x 128 sky): sample_emit searches with
// upper_bound_wide (shading.cuh), two rounds of three loads issued
// together before the binary steps, the same index.  Built for 12
// resident blocks of 128 (40 registers, as the plain kernel): every value
// is computed by the same operations in the same order, so the outputs
// are the plain kernel's bit for bit.
// ---------------------------------------------------------------------------

// A light lane's start: the next carry's values.
struct StartOut {
  V3 pos, dir, thr;
  float d_vc, d_vcm, d_vm;
  uint32_t st;
  int path_id;
  bool active, finite;
};

// The start of lane i of the band from path `start`: the seed, the light
// pick, sample_emit and the initial partial weights; `end` the band's end
// (INT_MAX for none), `eta_vc` the frame's MIS constant.
__device__ __forceinline__ StartOut start_lane(const Args& a, int i,
                                               int start, uint32_t frame,
                                               int end, float eta_vc) {
  StartOut o;
  const int path_id = start + i;
  const int num_lights = a.i[I_LIGHTS];
  uint32_t st = seed(static_cast<uint32_t>(path_id), frame, 0x1157A9u);
  // The uniform split of the global path index over the lights, in int32.
  int light_idx = floor_div(int32_mul(path_id, num_lights), a.i[I_LPC]);
  light_idx = light_idx > num_lights - 1 ? num_lights - 1 : light_idx;
  light_idx = light_idx < 0 ? 0 : light_idx;
  const float u1 = next_float(st);
  const float u2 = next_float(st);
  const float u3 = next_float(st);
  const float u4 = next_float(st);
  const EmitSample es =
      sample_emit(in<float>(a, P_LIGHT_REC) + 24 * light_idx, u1, u2, u3, u4,
                  env_of(a), a.i[I_HAS_ENV] != 0, bsphere_of(a));
  o.d_vc = es.is_delta ? 0.f
                       : es.cos_out /
                             clamp_min(es.pdf_emit_w * a.f[F_PICK], F(1e-20));
  o.active = es.pdf_emit_w > 0.f && any_nonzero(es.radiance) &&
             path_id < end;
  o.pos = es.pos;
  o.dir = es.dir;
  o.thr = scale(es.radiance, a.f[F_INV_PICK]);
  o.d_vcm = es.pdf_direct_a / clamp_min(es.pdf_emit_w, F(1e-20));
  o.d_vm = o.d_vc * eta_vc;
  o.st = st;
  o.path_id = path_id;
  o.finite = es.is_finite;
  return o;
}

// Lane i's columns but the (R, 3) ones.
__device__ __forceinline__ void store_start_scalars(const Args& a, int i,
                                                    const StartOut& o) {
  out<float>(a, P_O_TMIN)[i] = F(1e-3);
  out<uint8_t>(a, P_O_ACTIVE)[i] = o.active;
  out<float>(a, P_O_D_VC)[i] = o.d_vc;
  out<float>(a, P_O_D_VCM)[i] = o.d_vcm;
  out<float>(a, P_O_D_VM)[i] = o.d_vm;
  out<int64_t>(a, P_O_STATE)[i] = static_cast<int64_t>(o.st);
  out<uint8_t>(a, P_O_FINITE)[i] = o.finite;
  out<int>(a, P_O_PATH_ID)[i] = o.path_id;
}

// The component of its (x, y, z) that lane s sends for slot j of the
// 16-byte words of a warp's 96-float (R, 3) slab: word q holds floats
// 4q .. 4q + 3, float e is lane e / 3's component e % 3, and for a fixed j
// at most one word takes a float of lane s (any component where none does).
__device__ __forceinline__ int slab_comp(int s, int j) {
  const int q = (3 * s + 2 - j) >> 2;
  const int c = 4 * q + j - 3 * s;
  return c >= 0 && c <= 2 ? c : 0;
}

// A full warp's (R, 3) column out to dst, its 96 floats 16-byte aligned,
// as 24 16-byte words: every lane calls it with its own (x, y, z).
__device__ __forceinline__ void warp_store3(float* dst, V3 v, int lane) {
  float w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = slab_comp(lane, j);
    const float mine = c == 0 ? v.x : c == 1 ? v.y : v.z;
    w[j] = __shfl_sync(0xffffffffu, mine, (4 * lane + j) / 3);
  }
  if (lane < 24)
    reinterpret_cast<float4*>(dst)[lane] = make_float4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kBlk, 12)
    vcm_light_start_kernel(const __grid_constant__ Args a) {
  const int i = blockIdx.x * kBlk + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int lanes = a.i[I_LANES];
  const int wbase = i - lane;
  if (wbase >= lanes) return;
  const int* start_p = in<int>(a, P_PATH_START);
  const int start = start_p ? *start_p : a.i[I_PATH_START];
  const int* end_p = in<int>(a, P_PATH_END);
  const int end = end_p ? *end_p : 0x7fffffff;
  const uint32_t frame = static_cast<uint32_t>(*in<int64_t>(a, P_FRAME));
  const float eta_vc = *in<float>(a, P_MIS_ETA_VC);
  float* org = out<float>(a, P_O_ORG);
  float* dir = out<float>(a, P_O_D);
  float* thr = out<float>(a, P_O_THR);
  // Warp-uniform: a full warp whose columns take 16-byte words.
  const bool words = lanes - wbase >= 32 &&
                     ((reinterpret_cast<uintptr_t>(org) |
                       reinterpret_cast<uintptr_t>(dir) |
                       reinterpret_cast<uintptr_t>(thr)) & 15) == 0;
  if (!words) {
    if (i >= lanes) return;
    const StartOut o = start_lane(a, i, start, frame, end, eta_vc);
    store3(org + 3 * i, o.pos);
    store3(dir + 3 * i, o.dir);
    store3(thr + 3 * i, o.thr);
    store_start_scalars(a, i, o);
    return;
  }
  const StartOut o = start_lane(a, i, start, frame, end, eta_vc);
  store_start_scalars(a, i, o);
  const int64_t b3 = 3 * static_cast<int64_t>(wbase);
  warp_store3(org + b3, o.pos, lane);
  warp_store3(dir + b3, o.dir, lane);
  warp_store3(thr + b3, o.thr, lane);
}

// ---------------------------------------------------------------------------
// The two bounces, redesigned for Hopper.
//
// A plain lane-a-thread bounce runs its whole body -- the interaction, the
// connections and the BSDF sampling, branching by material kind -- in
// every warp for as long as one of its lanes is alive: past the first
// bounce the live lanes are scattered, so every warp pays for the body
// whatever share of it is dead, and for every kind its lanes hold.  The
// camera bounce held 126 registers that way (4 resident blocks of 128 an
// SM); the light bounce ran every lane through the body, dead ones too
// (on an H100, 0.131 ms with 42% of its lanes alive against 0.138 ms
// with all).  Here a block works in two phases:
//   1. a lane a thread, up to what every lane writes.  A lane that does
//      not go on is finished here; a live lane puts its shading point and
//      the carry values phase 2 reads in shared memory (LiveLanes) and
//      counts itself into its material kind's bin;
//   2. the block's live lanes, compacted and ordered by material kind, a
//      thread each (order_by_kind).  Threads past them return, so a block
//      of few live lanes runs few warps, and a warp's lanes mostly share
//      their BSDF branch.
// Phase 2 reads the shading point back from shared memory for each of its
// steps, so that it does not hold it across them: the kernels are built
// for kTwoPhaseBlocks resident blocks.  Every value is computed by the
// same operations in the same order as the plain version (shading.cuh):
// the outputs are its outputs.
// ---------------------------------------------------------------------------

// Resident blocks an SM the two-phase kernels are built for: registers
// capped at 65,536 / (kTwoPhaseBlocks * kBlk) a thread.
constexpr int kTwoPhaseBlocks = 6;
// Material kinds phase 2 orders its lanes by (shading.cuh MAT_*; another
// value shares the last bin).
constexpr int kKindBins = 8;

// A live lane's words between the phases: its shading point and material,
// and the carry values phase 2 reads.
enum Word {
  W_POS = 0, W_NORMAL = 3, W_GN = 6, W_W_OUT = 9, W_KIND = 12, W_KD = 13,
  W_KS = 16, W_TF = 19, W_NS = 22, W_IOR = 23, W_THR = 24, W_D_VC = 27,
  W_D_VCM = 28, W_D_VM = 29, W_T = 30, W_ACTIVE = 31, NUM_WORDS = 32
};

// A block's live lanes between the phases: word w of the lane of thread
// p at word[w][p] (a warp's accesses to one word are consecutive in phase
// 1), the thread of phase 2's slot k at order[k], and the slots' bins by
// material kind.
struct LiveLanes {
  float word[NUM_WORDS][kBlk];
  int order[kBlk];
  int bin[kKindBins + 1];
};

__device__ __forceinline__ void put3(LiveLanes& l, int w, int k, V3 v) {
  l.word[w][k] = v.x;
  l.word[w + 1][k] = v.y;
  l.word[w + 2][k] = v.z;
}

__device__ __forceinline__ V3 get3(const LiveLanes& l, int w, int k) {
  return {l.word[w][k], l.word[w + 1][k], l.word[w + 2][k]};
}

// The shading point in column k, read anew: the compiler barrier makes every
// step of phase 2 load what it uses instead of holding it from the last.
__device__ __forceinline__ Interaction live_point(const LiveLanes& l, int k) {
  asm volatile("" ::: "memory");
  Interaction s;
  s.pos = get3(l, W_POS, k);
  s.normal = get3(l, W_NORMAL, k);
  s.gn = get3(l, W_GN, k);
  s.w_out = get3(l, W_W_OUT, k);
  s.m.kind = __float_as_int(l.word[W_KIND][k]);
  s.m.kd = get3(l, W_KD, k);
  s.m.ks = get3(l, W_KS, k);
  s.m.tf = get3(l, W_TF, k);
  s.m.ns = l.word[W_NS][k];
  s.m.ior = l.word[W_IOR][k];
  return s;
}

// The carry values of the lane in column k, read anew as live_point.
struct LiveCarry {
  V3 thr;
  float d_vc, d_vcm, d_vm, t;
  bool active;
};

__device__ __forceinline__ LiveCarry live_carry(const LiveLanes& l, int k) {
  asm volatile("" ::: "memory");
  LiveCarry c;
  c.thr = get3(l, W_THR, k);
  c.d_vc = l.word[W_D_VC][k];
  c.d_vcm = l.word[W_D_VCM][k];
  c.d_vm = l.word[W_D_VM][k];
  c.t = l.word[W_T][k];
  c.active = l.word[W_ACTIVE][k] != 0.f;
  return c;
}

// Phase 1's end, called by every thread of the block with its lane's bin
// (-1 for no live lane) once the live lanes are counted into live.bin:
// the bins' first slots, then each live lane's thread at its slot of
// live.order, bin by bin.  Returns the block's live lanes.
__device__ __forceinline__ int order_by_kind(LiveLanes& live, int bin) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int k = 0; k < kKindBins; ++k) {
      const int c = live.bin[k];
      live.bin[k] = sum;
      sum += c;
    }
    live.bin[kKindBins] = sum;
  }
  __syncthreads();
  if (bin >= 0) live.order[atomicAdd(&live.bin[bin], 1)] = threadIdx.x;
  __syncthreads();
  return live.bin[kKindBins];
}

// A live lane's words at column k and its count in its kind's bin, which
// it returns.
__device__ __forceinline__ int put_live(LiveLanes& live, int k,
                                        const Interaction& s, V3 thr,
                                        float d_vc, float d_vcm, float d_vm,
                                        float t, bool active) {
  put3(live, W_POS, k, s.pos);
  put3(live, W_NORMAL, k, s.normal);
  put3(live, W_GN, k, s.gn);
  put3(live, W_W_OUT, k, s.w_out);
  live.word[W_KIND][k] = __int_as_float(s.m.kind);
  put3(live, W_KD, k, s.m.kd);
  put3(live, W_KS, k, s.m.ks);
  put3(live, W_TF, k, s.m.tf);
  live.word[W_NS][k] = s.m.ns;
  live.word[W_IOR][k] = s.m.ior;
  put3(live, W_THR, k, thr);
  live.word[W_D_VC][k] = d_vc;
  live.word[W_D_VCM][k] = d_vcm;
  live.word[W_D_VM][k] = d_vm;
  live.word[W_T][k] = t;
  live.word[W_ACTIVE][k] = active ? 1.0f : 0.0f;
  const int bin = clampi(s.m.kind, 0, kKindBins - 1);
  atomicAdd(&live.bin[bin], 1);
  return bin;
}

// `s` advanced past n draws of next_float.
__device__ __forceinline__ uint32_t skip_draws(uint32_t s, int n) {
  for (int k = 0; k < n; ++k) s = pcg_step(s);
  return s;
}

// ---------------------------------------------------------------------------
// One light bounce: vcm.py::_light_pass's body, in two phases a block.
//   1. a lane a thread: the hit test (the carry's active flag, a hit, a
//      cosine above 0, no emitter), then for a lane that passes the
//      interaction, the completed partial weights, its vertex row and
//      store flag, and its words.  A lane dead on entry or missed reads
//      no shade-record row; a lane that fails the test writes
//      ops/vcm_shade.py DEAD_LIGHT's rows (kDeadLight*) and keeps its
//      carry, its RNG word past the bounce's 4 draws;
//   2. the live lanes: the camera connection up to its shadow ray, then
//      the adjoint bounce from the lane's RNG word (the connection draws
//      none).
// A lane's outputs but its vertex row are staged in shared memory
// (LightOut) at its column, by phase 1 for a lane that does not go on and
// by phase 2 for a live one, and the block writes them out together at
// the end: whole 16-byte words of its lanes' (R, 3) rows, consecutive
// words of the others.  Written a lane a thread, an (R, 3) column is
// three 4-byte stores 12 bytes apart, and phase 2's lanes are out of
// order.  The vertex row, 96 bytes, goes out from phase 1 as six 16-byte
// stores.
// ---------------------------------------------------------------------------

// A light bounce's rows of a lane that does not go on (ops/vcm_shade.py
// DEAD_LIGHT): no vertex stored, no connection, no shadow ray.
constexpr float kDeadLightRec = 0.0f;
constexpr bool kDeadLightStore = false;
constexpr float kDeadLightCc = 0.0f;
constexpr int kDeadLightPixel = -1;
constexpr float kDeadLightPos = 0.0f;
constexpr float kDeadLightDir = 0.0f;
constexpr float kDeadLightTmin = 0.0f;
constexpr float kDeadLightTmax = 0.0f;
constexpr bool kDeadLightOk = false;

// A block's light-bounce outputs, lane k's at column k: the next carry,
// the camera connection and its shadow ray.  The RNG word is read into
// `state` in phase 1 and advanced there or in phase 2.
struct __align__(16) LightOut {
  float org[3 * kBlk], d[3 * kBlk], thr[3 * kBlk];
  float cc[3 * kBlk], s_pos[3 * kBlk], s_dir[3 * kBlk];
  float tmin[kBlk], d_vc[kBlk], d_vcm[kBlk], d_vm[kBlk];
  float s_tmin[kBlk], s_tmax[kBlk];
  int pixel[kBlk];
  uint32_t state[kBlk];
  uint8_t active[kBlk], s_ok[kBlk];
};

__device__ __forceinline__ void stage3(float* col, int k, V3 v) {
  col[3 * k] = v.x;
  col[3 * k + 1] = v.y;
  col[3 * k + 2] = v.z;
}

// store_next into the staged outputs.
__device__ __forceinline__ void stage_next(LightOut& o, int k,
                                           const Bounce& b, V3 pos, V3 thr,
                                           float t, float d_vc, float d_vcm,
                                           float d_vm, uint32_t st) {
  const bool on = b.active;
  stage3(o.org, k, on ? pos : zero3());
  stage3(o.d, k, on ? b.wi : zero3());
  o.tmin[k] = t * F(1e-4);
  stage3(o.thr, k, on ? b.throughput : thr);
  o.active[k] = on;
  o.d_vc[k] = on ? b.d_vc : d_vc;
  o.d_vcm[k] = on ? b.d_vcm : d_vcm;
  o.d_vm[k] = on ? b.d_vm : d_vm;
  o.state[k] = st;
}

// The vertex row of lane i: six 16-byte stores (the rows are 16-byte
// aligned: ops/vcm_shade.py checks).
__device__ __forceinline__ void store_row(const Args& a, int i,
                                          const float4 (&w)[6]) {
  float4* r = reinterpret_cast<float4*>(out<float>(a, P_V_REC)) +
              6 * static_cast<int64_t>(i);
#pragma unroll
  for (int q = 0; q < 6; ++q) r[q] = w[q];
}

// Phase 1 of a light lane that does not go on: DEAD_LIGHT's rows and the
// carry kept (vcm.py::_bounce's select on an inactive lane, the partial
// weights as they came in).
__device__ void finish_dead_light(const Args& a, LightOut& o, int i, int k,
                                  float t) {
  if (a.i[I_USE_CACHE]) {
    const float z = kDeadLightRec;
    const float4 w[6] = {{z, z, z, z}, {z, z, z, z}, {z, z, z, z},
                         {z, z, z, z}, {z, z, z, z}, {z, z, z, z}};
    store_row(a, i, w);
    out<uint8_t>(a, P_V_STORE)[i] = kDeadLightStore;
  }
  if (a.i[I_USE_CC]) {
    stage3(o.cc, k, V3{kDeadLightCc, kDeadLightCc, kDeadLightCc});
    o.pixel[k] = kDeadLightPixel;
    stage3(o.s_pos, k, V3{kDeadLightPos, kDeadLightPos, kDeadLightPos});
    stage3(o.s_dir, k, V3{kDeadLightDir, kDeadLightDir, kDeadLightDir});
    o.s_tmin[k] = kDeadLightTmin;
    o.s_tmax[k] = kDeadLightTmax;
    o.s_ok[k] = kDeadLightOk;
  }
  const V3 thr = load3(in<float>(a, P_THR) + 3 * i);
  const float d_vc = in<float>(a, P_D_VC)[i];
  const float d_vcm = in<float>(a, P_D_VCM)[i];
  const float d_vm = in<float>(a, P_D_VM)[i];
  Bounce b;
  b.wi = zero3();
  b.throughput = thr;
  b.d_vc = d_vc;
  b.d_vcm = d_vcm;
  b.d_vm = d_vm;
  b.active = false;
  stage_next(o, k, b, zero3(), thr, t, d_vc, d_vcm, d_vm,
             skip_draws(o.state[k], 4));
}

// n floats of a staged column out to dst, the block's threads together:
// 16-byte words where dst is 16-byte aligned and n a multiple of 4.
__device__ __forceinline__ void copy_out(float* dst, const float* src,
                                         int n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (n & 3) == 0) {
    for (int q = threadIdx.x; q < n / 4; q += kBlk)
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(src)[q];
  } else {
    for (int q = threadIdx.x; q < n; q += kBlk) dst[q] = src[q];
  }
}

// The block's staged outputs of its n lanes from lane `base` out.
__device__ void write_light_out(const Args& a, const LightOut& o,
                                int64_t base, int n) {
  const int k = threadIdx.x;
  copy_out(out<float>(a, P_O_ORG) + 3 * base, o.org, 3 * n);
  copy_out(out<float>(a, P_O_D) + 3 * base, o.d, 3 * n);
  copy_out(out<float>(a, P_O_THR) + 3 * base, o.thr, 3 * n);
  if (k < n) {
    out<float>(a, P_O_TMIN)[base + k] = o.tmin[k];
    out<uint8_t>(a, P_O_ACTIVE)[base + k] = o.active[k];
    out<float>(a, P_O_D_VC)[base + k] = o.d_vc[k];
    out<float>(a, P_O_D_VCM)[base + k] = o.d_vcm[k];
    out<float>(a, P_O_D_VM)[base + k] = o.d_vm[k];
    out<int64_t>(a, P_O_STATE)[base + k] = static_cast<int64_t>(o.state[k]);
  }
  if (!a.i[I_USE_CC]) return;
  copy_out(out<float>(a, P_CC_CONTRIB) + 3 * base, o.cc, 3 * n);
  copy_out(out<float>(a, P_S_POS) + 3 * base, o.s_pos, 3 * n);
  copy_out(out<float>(a, P_S_DIR) + 3 * base, o.s_dir, 3 * n);
  if (k < n) {
    out<int>(a, P_CC_PIXEL)[base + k] = o.pixel[k];
    out<float>(a, P_S_TMIN)[base + k] = o.s_tmin[k];
    out<float>(a, P_S_TMAX)[base + k] = o.s_tmax[k];
    out<uint8_t>(a, P_S_OK)[base + k] = o.s_ok[k];
  }
}

__global__ void __launch_bounds__(kBlk, kTwoPhaseBlocks)
    vcm_light_shade_kernel(const __grid_constant__ Args a) {
  __shared__ LiveLanes live;
  __shared__ LightOut o;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlk;
  const int n = static_cast<int>(
      a.i[I_LANES] - base < kBlk ? a.i[I_LANES] - base : kBlk);
  const int i = static_cast<int>(base) + threadIdx.x;
  if (threadIdx.x <= kKindBins) live.bin[threadIdx.x] = 0;
  __syncthreads();
  const int bounce = a.i[I_BOUNCE];

  // ---- phase 1: a lane a thread ----------------------------------------
  int bin = -1;
  if (static_cast<int>(threadIdx.x) < n) {
    const int k = threadIdx.x;
    o.state[k] = static_cast<uint32_t>(in<int64_t>(a, P_STATE)[i]);
    const float t = in<float>(a, P_HIT_T)[i];
    const int prim = in<int>(a, P_HIT_PRIM)[i];
    // Light rays ignore the environment, and end at emitter surfaces.
    if (in<uint8_t>(a, P_ACTIVE)[i] != 0 && prim >= 0) {
      const Interaction s =
          interaction(a, i, t, prim, load3(in<float>(a, P_ORG) + 3 * i),
                      load3(in<float>(a, P_D) + 3 * i));
      const float cos_o = fabsf(dot(s.w_out, s.normal));
      if (cos_o > 0.f && s.light_id < 0) {
        // Complete the partial weights.
        const float t_sqr = t * t;
        const bool finite = bounce > 0 || in<uint8_t>(a, P_FINITE)[i] != 0;
        const float inv_cos = rdiv1(clamp_min(cos_o, F(1e-9)));
        const float d_vcm =
            (in<float>(a, P_D_VCM)[i] * (finite ? t_sqr : 1.0f)) * inv_cos;
        const float d_vc = in<float>(a, P_D_VC)[i] * inv_cos;
        const float d_vm = in<float>(a, P_D_VM)[i] * inv_cos;
        const V3 thr = load3(in<float>(a, P_THR) + 3 * i);
        if (a.i[I_USE_CACHE]) {                         // pack_batch's row
          const float4 w[6] = {
              {s.pos.x, s.pos.y, s.pos.z, s.w_out.x},
              {s.w_out.y, s.w_out.z, s.normal.x, s.normal.y},
              {s.normal.z, s.gn.x, s.gn.y, s.gn.z},
              {s.uv_x, s.uv_y, __int_as_float(s.mat_id), thr.x},
              {thr.y, thr.z, d_vc, d_vcm},
              {d_vm, __int_as_float(bounce + 2),
               __int_as_float(in<int>(a, P_PATH_ID)[i]), 0.f}};
          store_row(a, i, w);
          out<uint8_t>(a, P_V_STORE)[i] = !is_specular(s.m);
        }
        bin = put_live(live, k, s, thr, d_vc, d_vcm, d_vm, t, true);
      }
    }
    if (bin < 0) finish_dead_light(a, o, i, k, t);
  }
  const int live_lanes = order_by_kind(live, bin);

  // ---- phase 2: the live lanes, a thread each --------------------------
  // Each step reads the lane's words anew (live_point).
  if (static_cast<int>(threadIdx.x) < live_lanes) {
    const int k = live.order[threadIdx.x];
    if (a.i[I_USE_CC]) {                        // ---- _connect_to_camera
      const Interaction s = live_point(live, k);
      const LiveCarry c = live_carry(live, k);
      const Cam cam = cam_of(a);
      const V3 to_cam = sub(cam.pos, s.pos);
      const bool in_front = dot(neg(to_cam), cam.forward) >= 0.f;
      float rx, ry;
      world_to_raster(cam, s.pos, rx, ry);
      const int pixel = raster_to_id(cam, rx, ry);
      bool valid = !is_specular(s.m) && in_front && pixel >= 0;
      const float dist_sqr = clamp_min(dot(to_cam, to_cam), F(1e-12));
      const float dist = sqrtf(dist_sqr);
      const V3 dir_c = divs(to_cam, dist);
      const float cos_cam = fabsf(dot(cam.forward, neg(dir_c)));
      const float cos_surf =
          fabsf(shading_normal_adjoint(s.normal, s.gn, s.w_out, dir_c));
      float pdf_f, pdf_rev;
      const V3 f = eval_pdf_bsdf(s.m, s.normal, s.gn, s.w_out, dir_c, pdf_f,
                                 pdf_rev);
      valid = valid && pdf_rev > 0.f;
      const float img_to_surf =
          (((cam.ipd * cam.ipd) * cos_surf) /
           clamp_min(((dist_sqr * cos_cam) * cos_cam) * cos_cam, F(1e-12))) *
          a.f[F_INV_PIXEL_AREA];
      const float w_light =
          (img_to_surf * a.f[F_INV_LPC]) *
          ((*in<float>(a, P_MIS_ETA_VM) + c.d_vcm) + c.d_vc * pdf_rev);
      const float w = a.i[I_ALGO] == ALGO_LT ? 1.0f : rdiv1(w_light + 1.0f);
      const V3 contrib =
          scale(mul(c.thr, f), (w * img_to_surf) * a.f[F_INV_LPC]);
      valid = valid && any_positive(contrib);
      const float offset = dist * F(1e-3);
      stage3(o.cc, k, contrib);
      o.pixel[k] = pixel;
      stage3(o.s_pos, k, s.pos);
      stage3(o.s_dir, k, dir_c);
      o.s_tmin[k] = offset;
      o.s_tmax[k] = dist - offset;
      o.s_ok[k] = valid;
    }
    {                                           // ---- the adjoint bounce
      const Interaction s = live_point(live, k);
      const LiveCarry c = live_carry(live, k);
      uint32_t st = o.state[k];
      const Bounce b = vcm_bounce(
          s, c.thr, c.d_vc, c.d_vcm, c.d_vm, c.active, st,
          *in<float>(a, P_MIS_ETA_VC), *in<float>(a, P_MIS_ETA_VM), true,
          false, bounce + 1 >= a.i[I_MAX_LEN]);
      stage_next(o, k, b, s.pos, c.thr, c.t, c.d_vc, c.d_vcm, c.d_vm, st);
    }
  }
  __syncthreads();
  if (n > 0) write_light_out(a, o, base, n);
}

// ---------------------------------------------------------------------------
// One camera bounce: vcm.py::_camera_bounce without its traversals and
// its merge, in two phases a block.
//   1. a lane a thread: the env-miss and emitter terms, the interaction,
//      the completed partial weights, the radiance and the merge query.
//      A lane dead on entry (its carry's active flag false) is finished
//      here: NEE and the connections cast nothing from it, so its shadow
//      rows hold the DEAD_SHADOW constants (ops/vcm_shade.py), and its
//      bounce keeps the carry, its RNG advanced past the body's draws.
//      A live lane puts its shading point and carry in shared memory;
//   2. the live lanes: the bounce, NEE and the connections.
// The gathers a lane makes in phase 2 are prefetched at the start of phase
// 1: its connections' cache rows into L2, NEE's light row into L1.  The
// bounce runs first, from the RNG word that NEE's and the connections'
// draws leave (their count is fixed).
// ---------------------------------------------------------------------------

// A shadow set's row of a lane dead on entry (ops/vcm_shade.py
// DEAD_SHADOW): no ray and no light.
constexpr float kDeadPos = 0.0f;
constexpr float kDeadDir = 0.0f;
constexpr float kDeadTmin = 0.0f;
constexpr float kDeadTmax = 0.0f;
constexpr bool kDeadOk = false;
constexpr float kDeadContrib = 0.0f;

// A shadow set's row `k * lanes + i`.
__device__ __forceinline__ void store_shadow(const Args& a, int64_t row, V3 pos,
                                             V3 dir, float tmin, float tmax,
                                             bool ok, V3 contrib) {
  store3(out<float>(a, P_S_POS) + 3 * row, pos);
  store3(out<float>(a, P_S_DIR) + 3 * row, dir);
  out<float>(a, P_S_TMIN)[row] = tmin;
  out<float>(a, P_S_TMAX)[row] = tmax;
  out<uint8_t>(a, P_S_OK)[row] = ok;
  store3(out<float>(a, P_S_CONTRIB) + 3 * row, contrib);
}

// _connect's pick of a cache row from its uniform.
__device__ __forceinline__ const float* cache_row(const Args& a, float uc,
                                                  int count) {
  const int last_row = count - 1 > 0 ? count - 1 : 0;
  int j = static_cast<int>(uc * static_cast<float>(count));
  j = j < last_row ? j : last_row;
  j = clampi(j, 0, a.i[I_CACHE_ROWS] - 1);
  return in<float>(a, P_CACHE_REC) + 24 * static_cast<int64_t>(j);
}

// _direct_illum's light row, from the first draw after `st`.
__device__ __forceinline__ const float* nee_light(const Args& a, uint32_t st) {
  const float ul = next_float(st);
  const int num_lights = a.i[I_LIGHTS];
  int light_idx = static_cast<int>(ul * a.f[F_LIGHTS]);
  light_idx = light_idx > num_lights - 1 ? num_lights - 1 : light_idx;
  light_idx = light_idx < 0 ? 0 : light_idx;
  return in<float>(a, P_LIGHT_REC) + 24 * light_idx;
}

__global__ void __launch_bounds__(kBlk, kTwoPhaseBlocks)
    vcm_camera_shade_kernel(const __grid_constant__ Args a) {
  __shared__ LiveLanes live;
  const int lanes = a.i[I_LANES];
  const int i = blockIdx.x * kBlk + threadIdx.x;
  const bool lane = i < lanes;
  const bool active0 = lane && in<uint8_t>(a, P_ACTIVE)[i] != 0;
  unsigned long long* n_rays = out<unsigned long long>(a, P_O_NRAYS);
  if (n_rays) count_warp(active0 ? 1u : 0u, n_rays);
  if (threadIdx.x <= kKindBins) live.bin[threadIdx.x] = 0;
  __syncthreads();

  const int bounce = a.i[I_BOUNCE];
  const int algo = a.i[I_ALGO];
  const int tech = a.i[I_TECH];
  const bool ppm = algo == ALGO_PPM;
  const int num_conn =
      algo == ALGO_VCM || algo == ALGO_BPT ? a.i[I_NUM_CONN] : 0;
  const bool cast_nee = !ppm && (tech & T_NEXT_EVENT);
  const bool cast_conn = num_conn > 0 && (tech & T_CONNECT);
  const int sets = (cast_nee ? 1 : 0) + ((tech & T_CONNECT) ? num_conn : 0);
  const int64_t n = lanes;

  // ---- phase 1: a lane a thread ----------------------------------------
  int bin = -1;
  if (lane) {
    const uint32_t st_nee =
        static_cast<uint32_t>(in<int64_t>(a, P_STATE)[i]);
    const uint32_t st_conn = skip_draws(st_nee, ppm ? 0 : 3);
    if (active0) {                    // phase 2's gathers, issued first
      if (cast_nee)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(nee_light(a, st_nee)));
      if (cast_conn) {
        const int count = *in<int>(a, P_CACHE_COUNT);
        uint32_t st = st_conn;
        for (int k = 0; k < num_conn; ++k) {
          const float* row = cache_row(a, next_float(st), count);
          asm volatile("prefetch.global.L2 [%0];" ::"l"(row));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(row + 23));
        }
      }
    }
    const V3 org = load3(in<float>(a, P_ORG) + 3 * i);
    const V3 d = load3(in<float>(a, P_D) + 3 * i);
    const V3 thr = load3(in<float>(a, P_THR) + 3 * i);
    V3 rad = load3(in<float>(a, P_RAD) + 3 * i);
    const float t = in<float>(a, P_HIT_T)[i];
    const int prim = in<int>(a, P_HIT_PRIM)[i];
    const float inv_lights = a.f[F_INV_LIGHTS];
    const float inv_r2 = *in<float>(a, P_BS_INV_R2);

    // ---- environment misses --------------------------------------------
    const bool miss = active0 && prim < 0;
    if (a.i[I_HAS_ENV] != 0 && (tech & T_LIGHT_HIT)) {
      V3 term = zero3();
      if (miss) {
        float pdf_w;
        const V3 li = env_radiance(env_of(a), normalize(d), pdf_w);
        const float pdf_emit = (inv_r2 * F(kInvPi)) * pdf_w;
        const float w_cam =
            (pdf_w * inv_lights) * in<float>(a, P_D_VCM)[i] +
            (pdf_emit * inv_lights) * in<float>(a, P_D_VC)[i];
        const float w = (ppm || (algo == ALGO_PT && bounce == 0))
                            ? 1.0f
                            : rdiv1(w_cam + 1.0f);
        term = scale(mul(thr, li), w);
      }
      rad = add(rad, term);
    }
    bool active = active0 && !miss;

    const Interaction s = interaction(a, i, t, prim, org, d);
    const float cos_o = fabsf(dot(s.w_out, s.normal));
    const float inv_cos = rdiv1(clamp_min(cos_o, F(1e-9)));
    const float d_vcm = (in<float>(a, P_D_VCM)[i] * (t * t)) * inv_cos;
    const float d_vc = in<float>(a, P_D_VC)[i] * inv_cos;
    const float d_vm = in<float>(a, P_D_VM)[i] * inv_cos;
    active = active && cos_o > 0.f;

    // ---- emitter hits --------------------------------------------------
    const bool is_emitter = active && s.light_id >= 0;
    if (tech & T_LIGHT_HIT) {
      V3 term = zero3();
      if (is_emitter) {
        const float area = clamp_min(s.area, F(1e-12));
        const float cos_geom = dot(s.gn, s.w_out);
        const bool front = cos_geom > 0.f;
        const V3 li = front ? s.emit : zero3();
        const float pdf_direct_a = front ? rdiv1(area) : 1.0f;
        const float pdf_emit_w =
            front ? (pos(cos_geom) * div_factor(kPi)) / area : 1.0f;
        const float w_cam = (pdf_direct_a * inv_lights) * d_vcm +
                            (pdf_emit_w * inv_lights) * d_vc;
        const float w = (ppm || bounce == 0) ? 1.0f : rdiv1(w_cam + 1.0f);
        term = scale(mul(thr, li), w);
      }
      rad = add(rad, term);
    }
    store3(out<float>(a, P_O_RAD) + 3 * i, rad);
    active = active && !is_emitter;

    // ---- the merge query's columns -------------------------------------
    if (a.p[P_Q_POS]) {
      store3(out<float>(a, P_Q_POS) + 3 * i, s.pos);
      store3(out<float>(a, P_Q_NORMAL) + 3 * i, s.normal);
      store3(out<float>(a, P_Q_GN) + 3 * i, s.gn);
      store3(out<float>(a, P_Q_W_OUT) + 3 * i, s.w_out);
      out<int>(a, P_Q_KIND)[i] = s.m.kind;
      store3(out<float>(a, P_Q_KD) + 3 * i, s.m.kd);
      store3(out<float>(a, P_Q_KS) + 3 * i, s.m.ks);
      out<float>(a, P_Q_NS)[i] = s.m.ns;
      out<float>(a, P_Q_D_VCM)[i] = d_vcm;
      out<float>(a, P_Q_D_VM)[i] = d_vm;
      out<uint8_t>(a, P_Q_ACTIVE)[i] = active && !is_specular(s.m);
      store3(out<float>(a, P_Q_THR) + 3 * i, thr);
    }

    if (!active0) {          // ---- dead on entry: the carry kept, no ray
      Bounce b;
      b.wi = zero3();
      b.throughput = thr;
      b.d_vc = d_vc;
      b.d_vcm = d_vcm;
      b.d_vm = d_vm;
      b.active = false;
      store_next(a, i, b, s.pos, thr, t, d_vc, d_vcm, d_vm,
                 skip_draws(st_conn, num_conn + 4));
      for (int k = 0; k < sets; ++k)
        store_shadow(a, k * n + i, V3{kDeadPos, kDeadPos, kDeadPos},
                     V3{kDeadDir, kDeadDir, kDeadDir}, kDeadTmin, kDeadTmax,
                     kDeadOk, V3{kDeadContrib, kDeadContrib, kDeadContrib});
    } else {                 // ---- live: its words, its kind's bin
      bin = put_live(live, threadIdx.x, s, thr, d_vc, d_vcm, d_vm, t,
                     active);
    }
  }
  if (static_cast<int>(threadIdx.x) >= order_by_kind(live, bin)) return;

  // ---- phase 2: the live lanes, a thread each --------------------------
  // Each step reads the lane's words and RNG word anew (live_point).
  const int k = live.order[threadIdx.x];
  const int j = blockIdx.x * kBlk + k;
  const int nee_draws = ppm ? 0 : 3;

  {                     // ---- bounce (its draws follow NEE's and _connect's)
    const Interaction s = live_point(live, k);
    const LiveCarry c = live_carry(live, k);
    uint32_t st = skip_draws(static_cast<uint32_t>(in<int64_t>(a, P_STATE)[j]),
                             nee_draws + num_conn);
    const Bounce b =
        vcm_bounce(s, c.thr, c.d_vc, c.d_vcm, c.d_vm, c.active, st,
                   *in<float>(a, P_MIS_ETA_VC), *in<float>(a, P_MIS_ETA_VM),
                   false, ppm, bounce + 1 >= a.i[I_MAX_LEN]);
    store_next(a, j, b, s.pos, c.thr, c.t, c.d_vc, c.d_vcm, c.d_vm, st);
  }

  int set = 0;
  if (cast_nee) {                                     // ---- NEE
    const Interaction s = live_point(live, k);
    const LiveCarry c = live_carry(live, k);
    const uint32_t st0 = static_cast<uint32_t>(in<int64_t>(a, P_STATE)[j]);
    uint32_t st = skip_draws(st0, 1);
    const float ua = next_float(st);
    const float ub = next_float(st);
    const DirectSample ds =
        sample_direct(nee_light(a, st0), s.pos, ua, ub, env_of(a),
                      a.i[I_HAS_ENV] != 0, *in<float>(a, P_BS_INV_R2));
    const float cos_i = fabsf(dot(s.normal, ds.dir));
    float pdf_dir, pdf_rev;
    const V3 f =
        eval_pdf_bsdf(s.m, s.normal, s.gn, s.w_out, ds.dir, pdf_dir, pdf_rev);
    bool ok = c.active && pdf_dir > 0.f && pdf_rev > 0.f;
    const float pdf_forward = ds.is_delta ? 0.f : pdf_dir;
    const float w_light =
        (pdf_forward * a.f[F_LIGHTS]) / clamp_min(ds.pdf_direct_w, F(1e-20));
    const float w_cam =
        ((ds.pdf_emit_w * cos_i) /
         clamp_min(ds.pdf_direct_w * ds.cos_out, F(1e-20))) *
        ((*in<float>(a, P_MIS_ETA_VM) + c.d_vcm) + c.d_vc * pdf_rev);
    const float w =
        algo == ALGO_PT ? 1.0f : rdiv1((w_cam + 1.0f) + w_light);
    const V3 contrib = scale(mul(mul(c.thr, f), ds.radiance),
                             (w * cos_i) * a.f[F_LIGHTS]);
    ok = ok && any_positive(contrib);
    const float offset =
        (ds.distance >= F(kBig) ? 1.0f : ds.distance) * F(1e-3);
    store_shadow(a, j, s.pos, ds.dir, offset, ds.distance - offset, ok,
                 contrib);
    set = 1;
  }

  for (int q = 0; cast_conn && q < num_conn; ++q) {   // ---- _connect
    const Interaction s = live_point(live, k);
    const LiveCarry c = live_carry(live, k);
    uint32_t st = skip_draws(static_cast<uint32_t>(in<int64_t>(a, P_STATE)[j]),
                             nee_draws + q);
    const int count = *in<int>(a, P_CACHE_COUNT);
    const LightVertex v =
        vertex_from_rec(cache_row(a, next_float(st), count),
                        in<float>(a, P_MAT_REC), a.i[I_MATS], atlas_of(a),
                        a.i[I_HAS_TEXTURES] != 0);
    bool ok = c.active && !is_specular(s.m) && count > 0 &&
              v.path_length + (bounce + 1) <= a.i[I_MAX_LEN];
    const V3 to_v = sub(v.pos, s.pos);
    const float dist_sq = clamp_min(dot(to_v, to_v), F(1e-20));
    const float dist = sqrtf(dist_sq);
    const V3 cdir = divs(to_v, dist);
    ok = ok && dist >= *in<float>(a, P_BASE_RADIUS);
    float pdf_cam, pdf_cam_rev, pdf_light, pdf_light_rev;
    const V3 f_cam = eval_pdf_bsdf(s.m, s.normal, s.gn, s.w_out, cdir,
                                   pdf_cam, pdf_cam_rev);
    const V3 f_light = eval_pdf_bsdf(v.m, v.normal, v.gn, v.w_out, neg(cdir),
                                     pdf_light, pdf_light_rev);
    ok = ok && pdf_cam > 0.f && pdf_cam_rev > 0.f && pdf_light > 0.f &&
         pdf_light_rev > 0.f;
    const float cos_cam = fabsf(dot(s.normal, cdir));
    const float cos_light =
        fabsf(shading_normal_adjoint(v.normal, v.gn, v.w_out, neg(cdir)));
    const float geom = (cos_cam * cos_light) / dist_sq;
    ok = ok && geom > 0.f;
    const float eta_vm = *in<float>(a, P_MIS_ETA_VM);
    const float pdf_cam_a = (pdf_cam * cos_light) / dist_sq;
    const float pdf_light_a = (pdf_light * cos_cam) / dist_sq;
    const float w_light =
        pdf_cam_a * ((eta_vm + v.d_vcm) + v.d_vc * pdf_light_rev);
    const float w_cam =
        pdf_light_a * ((eta_vm + c.d_vcm) + c.d_vc * pdf_cam_rev);
    const float w = rdiv1((w_cam + 1.0f) + w_light);
    const float vc_weight = static_cast<float>(count) * a.f[F_VC_NORM];
    const V3 contrib =
        scale(mul(mul(mul(c.thr, v.throughput), f_cam), f_light),
              (w * geom) * vc_weight);
    ok = ok && any_positive(contrib);
    const float offset = dist * F(1e-3);
    store_shadow(a, (set + q) * n + j, s.pos, cdir, offset, dist - offset,
                 ok, contrib);
  }
}

// ---------------------------------------------------------------------------
// After the any hit.
// ---------------------------------------------------------------------------

// camera: out (R, 3) = radiance plus each of the `sets` shadow sets'
// contrib (S R, 3) where ok & ~occluded, in set order, and the ok rays
// added to *count (may be null).  light: contrib (R, 3) and pixel (R,)
// kept where ok & ~occluded, zero and -1 elsewhere, in place.
template <bool kCamera>
__global__ void __launch_bounds__(kBlk)
    vcm_finish_kernel(const float* __restrict__ radiance, float* contrib,
                      int* pixel, const uint8_t* __restrict__ ok,
                      const uint8_t* __restrict__ occluded,
                      float* __restrict__ out, unsigned long long* count,
                      int lanes, int sets) {
  const int i = blockIdx.x * kBlk + threadIdx.x;
  const bool lane = i < lanes;
  if (kCamera) {
    unsigned cast = 0;
    V3 rad = lane ? load3(radiance + 3 * i) : zero3();
    for (int k = 0; k < sets; ++k) {
      const int64_t r = static_cast<int64_t>(k) * lanes + i;
      const bool c = lane && ok[r] != 0;
      cast += c ? 1u : 0u;
      if (lane)
        rad = add(rad, (c && occluded[r] == 0) ? load3(contrib + 3 * r)
                                               : zero3());
    }
    if (count) count_warp(cast, count);
    if (lane) store3(out + 3 * i, rad);
  } else {
    if (!lane) return;
    if (!(ok[i] != 0 && occluded[i] == 0)) {
      store3(contrib + 3 * i, zero3());
      pixel[i] = -1;
    }
  }
}

int blocks_for(int lanes) { return (lanes + kBlk - 1) / kBlk; }

const void* kernel_of(int which) {
  switch (which) {
    case K_LIGHT_START:
      return reinterpret_cast<const void*>(vcm_light_start_kernel);
    case K_LIGHT_SHADE:
      return reinterpret_cast<const void*>(vcm_light_shade_kernel);
    case K_CAMERA_SHADE:
      return reinterpret_cast<const void*>(vcm_camera_shade_kernel);
    case NUM_SHADE:
      return reinterpret_cast<const void*>(vcm_finish_kernel<true>);
    default:
      return reinterpret_cast<const void*>(vcm_finish_kernel<false>);
  }
}

}  // namespace

// One of the three shade kernels (`which`: 0 light start, 1 light shade,
// 2 camera shade) on the current stream.  `ptrs`, `ints`, `floats`: the
// arguments of enum Ptr, Int and Flt, with their counts; a count that is
// not the kernel's returns cudaErrorInvalidValue.  Returns a CUDA error
// code.
extern "C" int imba_vcm_shade(int which, void* const* ptrs, int nptrs,
                              const int* ints, int nints, const float* floats,
                              int nfloats, void* stream) {
  if (nptrs != NUM_PTRS || nints != NUM_INTS || nfloats != NUM_FLOATS ||
      which < 0 || which >= NUM_SHADE)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  for (int k = 0; k < NUM_PTRS; ++k) a.p[k] = ptrs[k];
  for (int k = 0; k < NUM_INTS; ++k) a.i[k] = ints[k];
  for (int k = 0; k < NUM_FLOATS; ++k) a.f[k] = floats[k];
  const int lanes = a.i[I_LANES];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes > 0) {
    if (which == K_LIGHT_START)
      vcm_light_start_kernel<<<blocks_for(lanes), kBlk, 0, s>>>(a);
    else if (which == K_LIGHT_SHADE)
      vcm_light_shade_kernel<<<blocks_for(lanes), kBlk, 0, s>>>(a);
    else
      vcm_camera_shade_kernel<<<blocks_for(lanes), kBlk, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// vcm_finish_kernel on the current stream: `camera` 1 with radiance, the
// sets' contrib, ok and occluded, out and count (int64, or null); `camera`
// 0 with contrib and pixel (updated in place), ok and occluded.  Returns a
// CUDA error code.
extern "C" int imba_vcm_finish(int camera, const void* radiance, void* contrib,
                               void* pixel, const void* ok,
                               const void* occluded, void* out, void* count,
                               int lanes, int sets, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(contrib);
  auto o = static_cast<const uint8_t*>(ok);
  auto occ = static_cast<const uint8_t*>(occluded);
  if (lanes > 0) {
    if (camera)
      vcm_finish_kernel<true><<<blocks_for(lanes), kBlk, 0, s>>>(
          static_cast<const float*>(radiance), c, nullptr, o, occ,
          static_cast<float*>(out), static_cast<unsigned long long*>(count),
          lanes, sets);
    else
      vcm_finish_kernel<false><<<blocks_for(lanes), kBlk, 0, s>>>(
          nullptr, c, static_cast<int*>(pixel), o, occ, nullptr, nullptr,
          lanes, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resources of kernel `which` (0-2 as imba_vcm_shade, 3 the camera finish,
// 4 the light finish): out[0] registers, out[1] static shared bytes,
// out[2] dynamic shared bytes, out[3] local (spill) bytes a thread, out[4]
// resident blocks an SM.  Returns a CUDA error code.
extern "C" int imba_vcm_resources(int which, int* out) {
  const void* fn = kernel_of(which);
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

// Shared machinery of the port's traversal kernels (stream_traverse.cu,
// khit_traverse.cu, pairs_kernel.cu) over the (sbox, tiles[, inst])
// layout documented in imbatracer_torch/ops/stream_traverse.py.
//
// Replaces, together with the two kernel files, the TPU kernels
//   imbatracer_tpu/ops/pallas_stream.py::_make_kernel (flat and instanced)
//   imbatracer_tpu/ops/pallas_vmem.py::_make_vmem_kernel
//   imbatracer_tpu/ops/pallas_khit.py::_khit_kernel
// and the XLA-side candidate lists that fed them (pallas_stream.py::
// superchunk_candidates).
//
// What it holds:
//   * the tests: the slab test of a super-chunk or chunk box, the
//     feature-dot Moller-Trumbore test of one triangle slot (over any row
//     source: global tiles for the pair kernel, shared-memory copies for
//     the block walk), the instance transform of a ray;
//   * block_candidates: the candidate stage every stream and khit launch
//     runs as its prologue -- one block of kBlk rays slab-tests the
//     super-chunk boxes (behind a group box over each 8), reduces over the
//     block (any lane for the hit flag, the minimum of max(tn, 0) for the
//     key, as uint bits: every key is >= +0), compacts the hit entries and
//     sorts them by (key, index) in shared memory: the lists of
//     superchunk_candidates, built on the card;
//   * block_walk: the traversal of that list, shared by the closest-hit,
//     any-hit and K-nearest kernels through a hit policy.
//
// What bounds a walk with one thread a ray over global tiles, its lists
// built by torch ops: every tile value its own dependent load from L2 (6 a
// chunk box, up to 17 a triangle, 4 KB apart), ~65 torch launches a
// dispatch for the lists (~600 at S = 1,404), and warps whose lanes
// entered different chunks running them one after the other.  What the
// staging does: a block walks its list in lockstep; for each candidate
// super-chunk any thread still needs, 96 threads stage its 64 chunk boxes
// (tile rows 6, 7, 14, 15, 22, 23, lanes 0-63) with cp.async into a double
// buffer, so the next candidate's boxes load while the current ones are
// tested; padding chunks (inverted box, lo.x > hi.x: all 16 slots are
// padding, so skipping them is exact) are skipped; the block's union of
// entered chunks is staged, 17 feature rows of 64 bytes a chunk, in
// double-buffered batches of kBatch chunks.  The tests out of shared
// memory are spread over (ray, chunk) pairs, so the lanes of a warp test
// together whatever chunks their own rays enter, and each thread then
// takes its hits in its sequential walk order (candidates in list order,
// chunks and slots ascending, a chunk's box re-tested against its current
// bound): it accepts the same hits in the same order as a walk of its own
// would, and keeps its tie choices (block_walk says why).  What bounds it
// now: the block barriers of the walk (five a candidate, four a feature
// batch) and, at large S, the candidate stage's slab tests.  Left for
// later: persistent blocks (blocks with short lists finish early), TMA in
// place of cp.async, and a ray sort on the card (the dispatch still sorts
// rays with torch ops).
//
// Numerics: the kernels are built with --fmad=false; every product and
// sum below is rounded on its own, in the order the plain PyTorch
// version (stream_traverse._slab / _mt) uses, and division is IEEE, so
// the kernels compute t/u/v bit for bit as the plain version does.
// Comparisons are strict (t > tmin, t < limit); |det| < 1e-12 rejects.
//
// Work counting: each kernel is a template over a counter type.  The
// launch the renderer uses takes NoWork, whose calls compile to nothing;
// the counting launch takes Work, which tallies per thread the slab tests
// (super-chunk and non-padding chunk boxes of the walk), how far each
// first-pass Moller-Trumbore test got (the stage it returned at), the
// candidate stage's slab tests (group and super-chunk boxes) and the
// walk's second looks (chunk boxes against a thread's current bound; a
// masked slot's re-run), and adds the tallies to a global array of
// kWorkSlots counters at exit.

#pragma once

#include <cuda_runtime.h>

namespace imba {

constexpr int kTileRows = 24;
constexpr int kTriRows = 1024;
constexpr int kSuper = 64;
constexpr int kChunk = 16;
constexpr float kBig = 1e30f;
constexpr int kBlk = 128;             // rays per block == per candidate list
constexpr int kWarps = kBlk / 32;
constexpr int kFeatRows = 17;         // tile rows a Moller-Trumbore test reads
constexpr int kBatch = 8;             // chunks a feature staging batch holds
constexpr int kMaxSuper = 16384;      // super-chunks a shared-memory list holds
constexpr int kGroup = 8;             // super-chunk boxes under one group box

// Moller-Trumbore stages, in test order: empty slot, |det| rejected, t
// rejected, u rejected, v rejected, hit.
enum MtStage { kEmpty, kDet, kT, kU, kV, kHit, kStages };
// Counter slots: slab tests, one per MtStage, candidate-stage slab tests,
// the walk's second looks.
constexpr int kCandSlot = 1 + kStages;
constexpr int kRetestSlot = kCandSlot + 1;
constexpr int kWorkSlots = kRetestSlot + 1;

struct NoWork {
  __device__ __forceinline__ void slab() {}
  __device__ __forceinline__ void mt(MtStage) {}
  __device__ __forceinline__ void cand() {}
  __device__ __forceinline__ void retest() {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

struct Work {
  unsigned int n[kWorkSlots] = {};
  __device__ __forceinline__ void slab() { ++n[0]; }
  __device__ __forceinline__ void mt(MtStage s) { ++n[1 + s]; }
  __device__ __forceinline__ void cand() { ++n[kCandSlot]; }
  __device__ __forceinline__ void retest() { ++n[kRetestSlot]; }
  __device__ __forceinline__ void flush(unsigned long long* out) {
#pragma unroll
    for (int i = 0; i < kWorkSlots; ++i)
      if (n[i]) atomicAdd(out + i, (unsigned long long)n[i]);
  }
};

__device__ __forceinline__ float safe_inv(float x) {
  const float s = x >= 0.0f ? 1.0f : -1.0f;
  return s / fmaxf(fabsf(x), 1e-12f);
}

// One ray in registers: origin, direction, their reciprocal and o x d.
struct Ray {
  float ox, oy, oz, tmin, dx, dy, dz, tmax;
  float ix, iy, iz, cx, cy, cz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float tmin, float dx, float dy,
                                        float dz, float tmax) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz; r.tmin = tmin;
  r.dx = dx; r.dy = dy; r.dz = dz; r.tmax = tmax;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  r.cx = oy * dz - oz * dy;
  r.cy = oz * dx - ox * dz;
  r.cz = ox * dy - oy * dx;
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ row) {
  return make_ray(row[0], row[1], row[2], row[3], row[4], row[5], row[6],
                  row[7]);
}

// Two-level instancing: the ray in the mesh space of an instance whose
// world->mesh 3x4 affine is m[0..11] (row-major, global or shared
// memory), each product and sum rounded on its own, left to right, as the
// plain version (stream_traverse.instance_ray) computes it.  The direction
// stays unnormalised, so t is the same in both spaces and a best t found
// in one instance bounds the others.
__device__ __forceinline__ Ray instance_ray(const Ray& w, const float* m) {
  return make_ray(
      m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3],
      m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7],
      m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11],
      w.tmin,
      m[0] * w.dx + m[1] * w.dy + m[2] * w.dz,
      m[4] * w.dx + m[5] * w.dy + m[6] * w.dz,
      m[8] * w.dx + m[9] * w.dy + m[10] * w.dz,
      w.tmax);
}

// Slab test: true when the ray's [tmin, limit] interval enters the box;
// tn is the slab entry t.
__device__ __forceinline__ bool slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     const Ray& r, float limit, float& tn) {
  const float tx0 = (lox - r.ox) * r.ix, tx1 = (hix - r.ox) * r.ix;
  const float ty0 = (loy - r.oy) * r.iy, ty1 = (hiy - r.oy) * r.iy;
  const float tz0 = (loz - r.oz) * r.iz, tz1 = (hiz - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return (tn <= tf) && (tf >= r.tmin) && (tn <= limit);
}

__device__ __forceinline__ bool enters(float lox, float loy, float loz,
                                       float hix, float hiy, float hiz,
                                       const Ray& r, float limit) {
  float tn;
  return slab(lox, loy, loz, hix, hiy, hiz, r, limit, tn);
}

// Chunk c's box sits in lane c of tile rows 6, 7, 14 (lo) and 15, 22, 23
// (hi): box coordinate r (lo.xyz, hi.xyz) in row cbox_row(r).
__host__ __device__ constexpr int cbox_row(int r) {
  return 6 + 8 * (r >> 1) + (r & 1);
}

// Tile rows straight from a tile in global memory (the pair kernel).
struct GlobalRows {
  const float* __restrict__ T;
  __device__ __forceinline__ float operator()(int row, int lane) const {
    return __ldg(T + row * kTriRows + lane);
  }
};

// A chunk whose box is inverted (lo.x > hi.x) holds 16 padding slots: a
// walk skips it (its box would read as all of space).
__device__ __forceinline__ bool padding_chunk(const float* __restrict__ T,
                                              int c) {
  const GlobalRows g{T};
  return g(6, c) > g(15, c);
}

__device__ __forceinline__ bool enters_chunk(const float* __restrict__ T,
                                             int c, const Ray& r,
                                             float limit) {
  const GlobalRows g{T};
  return enters(g(6, c), g(7, c), g(14, c), g(15, c), g(22, c), g(23, c), r,
                limit);
}

// The 17 tile rows the Moller-Trumbore test reads, in staging order
// (row 0..4, 8..13, 16..21), and the inverse map.
__host__ __device__ constexpr int feat_row(int f) {
  return f < 5 ? f : (f < 11 ? f + 3 : f + 5);
}
__host__ __device__ constexpr int feat_index(int row) {
  return row < 5 ? row : (row < 16 ? row - 3 : row - 5);
}

// One chunk's 17 feature rows staged in shared memory, 16 lanes each:
// slot j of the chunk is lane j.
struct SharedRows {
  const float* F;
  __device__ __forceinline__ float operator()(int row, int j) const {
    return F[feat_index(row) * kChunk + j];
  }
};

// Moller-Trumbore in feature-dot form against triangle slot j of the row
// source T: true, with (t, u, v, id), when the ray hits it at tmin < t <
// limit.
template <class Rows, class W>
__device__ __forceinline__ bool hit_slot(const Rows& T, int j, const Ray& r,
                                         float limit, float& t, float& u,
                                         float& v, float& id, W& work) {
  id = T(4, j);
  if (!(id >= 0.0f)) { work.mt(kEmpty); return false; }
  const float nx = T(0, j), ny = T(1, j), nz = T(2, j);
  const float det = -(r.dx * nx + r.dy * ny + r.dz * nz);
  const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
  if (inv_det == 0.0f) { work.mt(kDet); return false; }
  t = (r.ox * nx + r.oy * ny + r.oz * nz - T(3, j)) * inv_det;
  if (!(t > r.tmin && t < limit)) { work.mt(kT); return false; }
  const float u_num = r.cx * T(11, j) + r.cy * T(12, j) + r.cz * T(13, j) +
                      r.dx * T(8, j) + r.dy * T(9, j) + r.dz * T(10, j);
  u = u_num * inv_det;
  if (!(u >= 0.0f)) { work.mt(kU); return false; }
  const float v_num = r.cx * T(19, j) + r.cy * T(20, j) + r.cz * T(21, j) +
                      r.dx * T(16, j) + r.dy * T(17, j) + r.dz * T(18, j);
  v = v_num * inv_det;
  if (!(v >= 0.0f && u + v <= 1.0f)) { work.mt(kV); return false; }
  work.mt(kHit);
  return true;
}

// --------------------------------------------------------------------------
// Asynchronous copies (cp.async, 16 bytes, bypassing L1)
// --------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --------------------------------------------------------------------------
// Dynamic shared memory of a stream or khit block
// --------------------------------------------------------------------------

// One candidate super-chunk's staged metadata: its 64 chunk boxes (rows
// lo.x lo.y lo.z hi.x hi.y hi.z), its sbox row and, under instancing, its
// instance's itab row.
struct CandBuf {
  float box[6][kSuper];
  float sb[8];
  float it[16];
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Layout: the sorted list (8 bytes an entry, a power of two >= max(S, 2),
// so the buffers after it start on 16 bytes, as cp.async needs), two
// CandBufs, two feature batches (kBatch chunks x 17 rows x 16 floats); the
// candidate stage's scratch aliases the feature batches.
//
// Above kMaxSuper super-chunks a block's list no longer fits its shared
// memory beside the staging buffers.  It then lives in a global scratch
// buffer, one row of list_stride(S) words a block: a list launch
// (block_candidates_kernel) builds and sorts each block's list in its row,
// and the walk launch reads it from there.  The shared memory then starts
// with the CandBufs, as at S <= kMaxSuper it starts 16-byte aligned after
// the list.
constexpr int kFeatBatchFloats = kBatch * kFeatRows * kChunk;
constexpr int kTailBytes =
    2 * (int)sizeof(CandBuf) + 2 * kFeatBatchFloats * (int)sizeof(float);

__host__ __device__ inline bool global_list(int num_s) {
  return num_s > kMaxSuper;
}

__host__ __device__ inline size_t list_stride(int num_s) {
  return (size_t)pow2_at_least(num_s < 2 ? 2 : num_s);
}

__host__ __device__ inline size_t list_bytes(int num_s) {
  return global_list(num_s) ? 0 : 8 * list_stride(num_s);
}

__host__ __device__ inline size_t block_smem_bytes(int num_s) {
  return list_bytes(num_s) + kTailBytes;
}

struct BlockSmem {
  unsigned long long* list;          // null when the list is global
  CandBuf* cand;
  float* feat;

  __device__ __forceinline__ BlockSmem(unsigned char* base, int num_s) {
    list = global_list(num_s) ? nullptr
                              : reinterpret_cast<unsigned long long*>(base);
    cand = reinterpret_cast<CandBuf*>(base + list_bytes(num_s));
    feat = reinterpret_cast<float*>(cand + 2);
  }
};

// Host side: set a kernel's dynamic shared-memory limit to what this
// launch asks for (a block whose static and dynamic shared memory pass 48
// KB may not launch without it; the call is cheap beside a launch).
template <class K>
cudaError_t prepare(K* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The launch shapes a stream or khit kernel takes: whole 128-ray blocks,
// S >= 1, and above kMaxSuper a global list buffer `glist`.
inline bool bad_shape(int num_rays, int num_s, const void* glist) {
  return num_rays % kBlk != 0 || num_s < 1 ||
         (global_list(num_s) && glist == nullptr);
}

// A kernel's resources at S super-chunks: out[0] registers a thread,
// out[1] static shared bytes, out[2] dynamic shared bytes, out[3] local
// (spill) bytes a thread, out[4] resident blocks an SM.
template <class K>
cudaError_t resources(K* kernel, int num_s, int* out) {
  const size_t smem = block_smem_bytes(num_s);
  cudaError_t e = prepare(kernel, smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBlk,
                                                      smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = (int)a.localSizeBytes;
  out[4] = blocks;
  return cudaSuccess;
}

// --------------------------------------------------------------------------
// The candidate stage
// --------------------------------------------------------------------------

// Every thread of the block (kBlk rays, inactive lanes included, as the
// plain version does) slab-tests its ray over [tmin, tmax] against each
// super-chunk box; the block keeps the boxes any lane enters, keyed by the
// block minimum of max(tn, 0) over the lanes that enter (kBig for the
// others, as superchunk_candidates' where(m, clamp(tn, 0), BIG).amin()),
// and sorts them by (key, index).  Leaves the count entries, each key
// bits << 32 | index, in list[0, count) and returns count (uniform over
// the block).  Boxes go through shared memory kBlk at a time, with a
// group box over each kGroup consecutive ones (consecutive super-chunks
// are neighbours: leaf order, or one instance's mesh): a warp none of
// whose rays enters a group box skips its boxes.  That is exact: a box
// inside the group box cannot pass the slab test where the group box
// fails, because rounding is monotone (each of lo - o, (lo - o) * inv,
// min and max only grows or shrinks with its input), so the group box's
// tn is at most the box's and its tf at least the box's.  A group with
// an inverted box (which reads as all of space) gets an infinite one.
// `list` is the block's shared-memory list or, above kMaxSuper, its row of
// the global list buffer: the compaction and the bitonic sort are the same
// code on either, since __syncthreads orders a block's global accesses as
// it does its shared ones.
template <class W>
__device__ int block_candidates(const Ray& ray, const float* __restrict__ sbox,
                                int num_s, unsigned long long* list,
                                float* scratch, W& work) {
  __shared__ int s_wcnt[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* s_box = scratch;                               // [kBlk][6]
  float* s_wkey = scratch + kBlk * 6;                   // [kWarps][kBlk]
  unsigned char* s_whit =
      reinterpret_cast<unsigned char*>(s_wkey + kWarps * kBlk);
  float* s_gbox = s_wkey + kWarps * kBlk + kWarps * kBlk / 4;  // [kBlk/8][6]

  int count = 0;
  for (int g = 0; g < num_s; g += kBlk) {
    const int nb = min(kBlk, num_s - g);
    __syncthreads();                  // the last batch's scratch is read
    if (tid < nb) {
      const float* b = sbox + (size_t)(g + tid) * 8;
#pragma unroll
      for (int c = 0; c < 6; ++c) s_box[tid * 6 + c] = __ldg(b + c);
    }
    __syncthreads();
    if (tid < kBlk / kGroup * 6) {
      const int q = tid / 6, r = tid % 6;
      float v = r < 3 ? kBig : -kBig;
      bool inverted = false;
      for (int i = q * kGroup; i < min(q * kGroup + kGroup, nb); ++i) {
        inverted |= s_box[i * 6] > s_box[i * 6 + 3];
        v = r < 3 ? fminf(v, s_box[i * 6 + r]) : fmaxf(v, s_box[i * 6 + r]);
      }
      s_gbox[tid] = inverted ? (r < 3 ? -kBig : kBig) : v;
    }
    __syncthreads();
    for (int i = 0; i < nb; ++i) {
      if (i % kGroup == 0) {
        const float* gb = s_gbox + i / kGroup * 6;
        float tn;
        work.cand();
        if (!__any_sync(0xffffffffu, slab(gb[0], gb[1], gb[2], gb[3], gb[4],
                                          gb[5], ray, ray.tmax, tn))) {
          const int n = min(kGroup, nb - i);
          if (lane < n) {
            s_wkey[warp * kBlk + i + lane] = kBig;
            s_whit[warp * kBlk + i + lane] = 0;
          }
          i += n - 1;
          continue;
        }
      }
      const float* b = s_box + i * 6;
      float tn;
      work.cand();
      const bool m = slab(b[0], b[1], b[2], b[3], b[4], b[5], ray, ray.tmax,
                          tn);
      // + 0.0f turns a -0 key into +0, so the uint bits order the keys.
      const float key = m ? fmaxf(tn, 0.0f) + 0.0f : kBig;
      const unsigned any = __ballot_sync(0xffffffffu, m);
      if (any) {
        const unsigned bits =
            __reduce_min_sync(0xffffffffu, __float_as_uint(key));
        if (lane == 0) s_wkey[warp * kBlk + i] = __uint_as_float(bits);
      } else if (lane == 0) {
        s_wkey[warp * kBlk + i] = kBig;
      }
      if (lane == 0) s_whit[warp * kBlk + i] = any != 0u;
    }
    __syncthreads();
    bool hit = false;
    float key = kBig;
    if (tid < nb) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        hit |= s_whit[w * kBlk + tid] != 0;
        key = fminf(key, s_wkey[w * kBlk + tid]);
      }
    }
    const unsigned hb = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_wcnt[warp] = __popc(hb);
    __syncthreads();
    int off = count, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_wcnt[w] : 0;
      total += s_wcnt[w];
    }
    if (hit)
      list[off + __popc(hb & ((1u << lane) - 1u))] =
          ((unsigned long long)__float_as_uint(key) << 32) |
          (unsigned)(g + tid);
    count += total;
  }

  // Bitonic sort of list[0, n) ascending, padded with ~0.
  const int n = pow2_at_least(count);
  for (int i = count + tid; i < n; i += kBlk) list[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (n >> 1); p += kBlk) {
        const int i = 2 * p - (p & (j - 1));
        const unsigned long long a = list[i], b = list[i + j];
        if ((a > b) == ((i & k) == 0)) {
          list[i] = b;
          list[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  return count;
}

// --------------------------------------------------------------------------
// The block walk
// --------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long warp_or64(unsigned long long x) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)x);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(x >> 32));
  return ((unsigned long long)hi << 32) | lo;
}

// The lowest `n` set bits of *rest, removed from it.
__device__ __forceinline__ unsigned long long take_lowest(
    unsigned long long& rest, int n) {
  unsigned long long got = 0;
  for (int i = 0; i < n && rest; ++i) {
    const unsigned long long b = rest & (~rest + 1ull);
    got |= b;
    rest ^= b;
  }
  return got;
}

// Stage candidate `sc`'s chunk boxes, sbox row and (INST) itab row.
template <bool INST>
__device__ __forceinline__ void stage_candidate(
    CandBuf* cb, int sc, const float* __restrict__ sbox,
    const float* __restrict__ tiles, const int* __restrict__ tile_idx,
    const int* __restrict__ inst_of, const float* __restrict__ itab) {
  const int tid = threadIdx.x;
  if (tid < 96) {
    const int r = tid >> 4, seg = tid & 15;
    const size_t tile = INST ? (size_t)__ldg(tile_idx + sc) : (size_t)sc;
    cp_async16(&cb->box[r][seg * 4],
               tiles + (tile * kTileRows + cbox_row(r)) * kTriRows + seg * 4);
  } else if (tid < 98) {
    cp_async16(&cb->sb[(tid - 96) * 4], sbox + (size_t)sc * 8 + (tid - 96) * 4);
  } else if (INST && tid < 102) {
    cp_async16(&cb->it[(tid - 98) * 4],
               itab + (size_t)__ldg(inst_of + sc) * 16 + (tid - 98) * 4);
  }
}

// Stage the 17 feature rows of the chunks of `batch` (ascending, at most
// kBatch) of tile T: 68 copies of 16 bytes a chunk.
__device__ __forceinline__ void stage_features(float* buf,
                                               const float* __restrict__ T,
                                               unsigned long long batch) {
  const int tasks = __popcll(batch) * kFeatRows * 4;
  for (int q = threadIdx.x; q < tasks; q += kBlk) {
    const int bs = q / (kFeatRows * 4), w = q % (kFeatRows * 4);
    const int f = w >> 2, part = w & 3;
    unsigned long long m = batch;
    for (int i = 0; i < bs; ++i) m &= m - 1ull;
    const int c = __ffsll((long long)m) - 1;
    cp_async16(buf + (bs * kFeatRows + f) * kChunk + part * 4,
               T + feat_row(f) * kTriRows + c * kChunk + part * 4);
  }
}

// Per-block state of the walk: each thread's ray in the current
// candidate's frame (one row a field, tmax replaced by the thread's bound
// at the candidate's start), the chunk masks, the compacted rays that
// entered the super-chunk, and one feature batch's (ray, chunk) pairs with
// their first-pass hit masks.
struct WalkShared {
  float ray[14][kBlk];
  unsigned mine[2][kBlk];
  int elist[kBlk];
  unsigned short pair[kBlk * kBatch];
  unsigned short hits[kBlk * kBatch];
  unsigned long long wmask[kWarps];
  int wcnt[kWarps];
};

__device__ __forceinline__ void put_ray(WalkShared& w, int i, const Ray& r,
                                        float limit) {
  const float f[14] = {r.ox, r.oy, r.oz, r.tmin, r.dx, r.dy, r.dz,
                       limit, r.ix, r.iy, r.iz, r.cx, r.cy, r.cz};
#pragma unroll
  for (int k = 0; k < 14; ++k) w.ray[k][i] = f[k];
}

// The ray thread i stored, its tmax field holding that thread's bound.
__device__ __forceinline__ Ray get_ray(const WalkShared& w, int i) {
  Ray r;
  r.ox = w.ray[0][i]; r.oy = w.ray[1][i]; r.oz = w.ray[2][i];
  r.tmin = w.ray[3][i];
  r.dx = w.ray[4][i]; r.dy = w.ray[5][i]; r.dz = w.ray[6][i];
  r.tmax = w.ray[7][i];
  r.ix = w.ray[8][i]; r.iy = w.ray[9][i]; r.iz = w.ray[10][i];
  r.cx = w.ray[11][i]; r.cy = w.ray[12][i]; r.cz = w.ray[13][i];
  return r;
}

// Exclusive prefix sum of v over the block; *total gets the sum.  One
// barrier; the caller puts another between this and the next scan.
__device__ __forceinline__ int block_scan(int v, int* wcnt, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wcnt[warp] = x;
  __syncthreads();
  int off = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? wcnt[w] : 0;
    sum += wcnt[w];
  }
  *total = sum;
  return off + x - v;
}

__device__ __forceinline__ bool enters_box(const CandBuf& cb, int c,
                                           const Ray& r, float limit) {
  return enters(cb.box[0][c], cb.box[1][c], cb.box[2][c], cb.box[3][c],
                cb.box[4][c], cb.box[5][c], r, limit);
}

// The hit policies of the single-hit kernels (stream_traverse.cu,
// pairs_kernel.cu): a closest-hit thread's bound is its best t, an any-hit
// thread's its tmax, and an any-hit thread stops at its first hit.
struct Closest {
  float t, u = 0.0f, v = 0.0f, id = -1.0f;
  __device__ explicit Closest(float tmax) : t(tmax) {}
  __device__ __forceinline__ float bound() const { return t; }
  __device__ __forceinline__ bool done() const { return false; }
  __device__ __forceinline__ void accept(float t_, float u_, float v_,
                                         float id_) {
    t = t_;
    u = u_;
    v = v_;
    id = id_;
  }
};

struct Any {
  float tmax;
  bool hit = false;
  __device__ explicit Any(float tmax_) : tmax(tmax_) {}
  __device__ __forceinline__ float bound() const { return tmax; }
  __device__ __forceinline__ bool done() const { return hit; }
  __device__ __forceinline__ void accept(float, float, float, float) {
    hit = true;
  }
};

// A single-hit kernel's output row: [t u v id 0 0 0 0], or [flag 0 ...].
template <bool OCCL, class P>
__device__ __forceinline__ void write_hit(const P& pol, float* o) {
  if constexpr (OCCL) {
    o[0] = pol.hit ? 1.0f : 0.0f;
    o[1] = o[2] = o[3] = 0.0f;
  } else {
    o[0] = pol.t;
    o[1] = pol.u;
    o[2] = pol.v;
    o[3] = pol.id;
  }
  o[4] = o[5] = o[6] = o[7] = 0.0f;
}

// The walk of one block over its sorted candidate list.  P is the hit
// policy: bound() (the thread's current exit and Moller-Trumbore limit),
// done() (an any-hit thread that has its hit) and accept(t, u, v, id).
// A thread needs candidate k while it is live, not done and the key is
// below its bound; the keys ascend and bounds only fall, so a thread that
// stops needing candidates never needs one again, and the block stops
// when no thread needs the next one.
//
// Work is spread over (ray, chunk) pairs so that the lanes of a warp run
// the same test at once, whatever chunks their own rays enter: the chunk
// boxes of the rays that enter the super-chunk, 32 boxes of one ray a
// warp; then, per feature batch, the 16 slots of each (ray, chunk) pair,
// one slot a lane, against the ray's bound at the candidate's start, into
// a 16-bit mask of first-pass hits.  Each thread then walks its own pairs
// in its sequential order -- chunks ascending, the box re-tested against its
// current bound, slots ascending -- and re-runs the test on the masked
// slots alone with its current bound.  A slot the sequential walk accepts
// has t below the current bound, which is at most the first pass's, so
// it is in the mask, and the re-run decides as the sequential walk does:
// the thread accepts the same hits in the same order.
template <bool INST, class P, class W>
__device__ void block_walk(const Ray& ray, P& pol,
                           const unsigned long long* list, int count,
                           CandBuf* cand, float* feat,
                           const float* __restrict__ sbox,
                           const float* __restrict__ tiles,
                           const int* __restrict__ tile_idx,
                           const int* __restrict__ inst_of,
                           const float* __restrict__ itab, W& work) {
  __shared__ WalkShared ws;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool live = ray.tmax >= 0.0f;

  if (count > 0)
    stage_candidate<INST>(cand, (int)(list[0] & 0xffffffffu), sbox, tiles,
                          tile_idx, inst_of, itab);
  cp_async_commit();
  for (int k = 0; k < count; ++k) {
    const unsigned long long e = list[k];
    const float key = __uint_as_float((unsigned)(e >> 32));
    const int sc = (int)(e & 0xffffffffu);
    cp_async_wait<0>();
    const bool need = live && !pol.done() && key < pol.bound();
    if (!__syncthreads_or(need)) break;
    if (k + 1 < count)
      stage_candidate<INST>(cand + ((k + 1) & 1),
                            (int)(list[k + 1] & 0xffffffffu), sbox, tiles,
                            tile_idx, inst_of, itab);
    cp_async_commit();
    const CandBuf& cb = cand[k & 1];

    // The super-chunk box with the world ray; the rays that enter it, in
    // the super-chunk's frame, go to shared memory.
    bool entered = false;
    Ray mray = ray;
    if (need) {
      work.slab();
      entered = enters(cb.sb[0], cb.sb[1], cb.sb[2], cb.sb[3], cb.sb[4],
                       cb.sb[5], ray, pol.bound());
      if (entered) {
        if (INST) mray = instance_ray(ray, cb.it);
        put_ray(ws, tid, mray, pol.bound());
      }
    }
    int num_e;
    const int ei = block_scan(entered ? 1 : 0, ws.wcnt, &num_e);
    if (entered) ws.elist[ei] = tid;
    __syncthreads();
    if (num_e == 0) continue;

    // Their non-padding chunk boxes, a ray's 32 chunks a warp.
    for (int t0 = warp * 32; t0 < num_e * kSuper; t0 += kBlk) {
      const int r = ws.elist[t0 >> 6], c = (t0 & 63) + lane;
      bool in = false;
      if (!(cb.box[0][c] > cb.box[3][c])) {          // padding chunk
        work.slab();
        in = enters_box(cb, c, get_ray(ws, r), ws.ray[7][r]);
      }
      const unsigned b = __ballot_sync(0xffffffffu, in);
      if (lane == 0) ws.mine[c >> 5][r] = b;
    }
    __syncthreads();
    unsigned long long mine =
        entered ? ((unsigned long long)ws.mine[1][tid] << 32) | ws.mine[0][tid]
                : 0ull;
    const unsigned long long wm = warp_or64(mine);
    if (lane == 0) ws.wmask[warp] = wm;
    __syncthreads();
    unsigned long long rest = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) rest |= ws.wmask[w];
    if (!rest) continue;

    // The union's triangles, kBatch chunks at a time, double-buffered.
    const size_t tile = INST ? (size_t)__ldg(tile_idx + sc) : (size_t)sc;
    const float* T = tiles + tile * kTileRows * kTriRows;
    const float id_base = INST ? cb.it[12] : 0.0f;
    unsigned long long batch = take_lowest(rest, kBatch);
    stage_features(feat, T, batch);
    cp_async_commit();
    for (int i = 0; batch; ++i) {
      const unsigned long long next = take_lowest(rest, kBatch);
      if (next) stage_features(feat + ((i + 1) & 1) * kFeatBatchFloats, T,
                               next);
      cp_async_commit();
      cp_async_wait<1>();
      const float* buf = feat + (i & 1) * kFeatBatchFloats;

      // This thread's (ray, chunk) pairs of the batch, in chunk order;
      // the scan's barrier also publishes the batch's staged rows.
      const unsigned long long own = mine & batch;
      int num_p;
      const int first = block_scan(__popcll(own), ws.wcnt, &num_p);
      int last = first;
      for (unsigned long long m = own; m; m &= m - 1ull) {
        const int c = __ffsll((long long)m) - 1;
        const int bs = __popcll(batch & ((1ull << c) - 1ull));
        ws.pair[last++] = (unsigned short)((tid << 9) | (bs << 6) | c);
      }
      __syncthreads();

      // First pass: one slot a lane, 16 lanes a pair.
      for (int q0 = warp * 32; q0 < num_p * kChunk; q0 += kBlk) {
        const int q = q0 + lane;
        bool h = false;
        if (q < num_p * kChunk) {
          const unsigned pr = ws.pair[q >> 4];
          const Ray rr = get_ray(ws, (int)(pr >> 9));
          const SharedRows rows{buf + ((pr >> 6) & 7) * kFeatRows * kChunk};
          float t, u, v, id;
          h = hit_slot(rows, q & 15, rr, rr.tmax, t, u, v, id, work);
        }
        const unsigned b = __ballot_sync(0xffffffffu, h);
        if ((lane & 15) == 0 && q < num_p * kChunk)
          ws.hits[q >> 4] = (unsigned short)(b >> (lane & 16));
      }
      __syncthreads();

      // Second pass: this thread's pairs in its walk order.
      for (int p = first; p < last && !pol.done(); ++p) {
        const unsigned pr = ws.pair[p];
        work.retest();
        if (!enters_box(cb, (int)(pr & 63), mray, pol.bound())) continue;
        const SharedRows rows{buf + ((pr >> 6) & 7) * kFeatRows * kChunk};
        NoWork quiet;
        for (unsigned m16 = ws.hits[p]; m16 && !pol.done();
             m16 &= m16 - 1u) {
          float t, u, v, id;
          work.retest();
          if (hit_slot(rows, __ffs(m16) - 1, mray, pol.bound(), t, u, v, id,
                       quiet))
            pol.accept(t, u, v, INST ? id + id_base : id);
        }
      }
      mine &= ~batch;
      if (pol.done()) mine = 0;
      // The buffer just read is refilled two batches on; stop early when
      // no thread has a chunk left in this super-chunk.
      if (!__syncthreads_or(mine != 0)) break;
      batch = next;
    }
    cp_async_wait<0>();
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------------------
// The candidate stage as a launch of its own
// --------------------------------------------------------------------------

// Block b builds its sorted list: in shared memory, or above kMaxSuper in
// row b of `glist` (list_stride(S) words a row), where it stays for the
// walk launch, with its count in gcount[b] when gcount is non-null.  With
// `slist` non-null it also writes the list out as the candidate stage
// alone returns it: slist[b, :count] (int32) and skey[b, :count] (float32),
// rows of num_s, and the count in scount[b].
template <class W>
__global__ void __launch_bounds__(kBlk)
block_candidates_kernel(const float* __restrict__ rays,
                        const float* __restrict__ sbox, int num_s,
                        unsigned long long* __restrict__ glist,
                        int* __restrict__ gcount, int* __restrict__ slist,
                        float* __restrict__ skey, int* __restrict__ scount,
                        unsigned long long* __restrict__ work_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem sm(smem, num_s);
  const Ray ray =
      load_ray(rays + ((size_t)blockIdx.x * kBlk + threadIdx.x) * 8);
  // The list launch of a walk leaves a block with no live lane an empty
  // list (block_list returns before reading it); the candidate stage
  // alone builds every block's list, as superchunk_candidates does.
  if (!slist && !__syncthreads_or(ray.tmax >= 0.0f)) {
    if (gcount && threadIdx.x == 0) gcount[blockIdx.x] = 0;
    return;
  }
  W work;
  unsigned long long* list =
      sm.list ? sm.list : glist + blockIdx.x * list_stride(num_s);
  const int count = block_candidates(ray, sbox, num_s, list, sm.feat, work);
  work.flush(work_out);
  if (slist) {
    const size_t row = (size_t)blockIdx.x * num_s;
    for (int i = threadIdx.x; i < count; i += kBlk) {
      const unsigned long long e = list[i];
      slist[row + i] = (int)(e & 0xffffffffu);
      skey[row + i] = __uint_as_float((unsigned)(e >> 32));
    }
    if (threadIdx.x == 0) scount[blockIdx.x] = count;
  }
  if (gcount && threadIdx.x == 0) gcount[blockIdx.x] = count;
}

// Host side: launch the list stage for num_rays rays (see above); the
// counting instantiation when `work` is non-null.
inline cudaError_t launch_candidates(const void* rays, const void* sbox,
                                     int num_rays, int num_s, void* glist,
                                     void* gcount, void* slist, void* skey,
                                     void* scount, void* work,
                                     cudaStream_t stream) {
  auto* k = work ? block_candidates_kernel<Work>
                 : block_candidates_kernel<NoWork>;
  const size_t smem = block_smem_bytes(num_s);
  const cudaError_t e = prepare(k, smem);
  if (e != cudaSuccess) return e;
  k<<<num_rays / kBlk, kBlk, smem, stream>>>(
      static_cast<const float*>(rays), static_cast<const float*>(sbox), num_s,
      static_cast<unsigned long long*>(glist), static_cast<int*>(gcount),
      static_cast<int*>(slist), static_cast<float*>(skey),
      static_cast<int*>(scount), static_cast<unsigned long long*>(work));
  return cudaGetLastError();
}

// The walk's list and count: the block's own, built here in shared memory,
// or (glist non-null, above kMaxSuper) the row the list launch wrote.  A
// block with no live lane (tmax < 0 everywhere: padding, dead lanes of a
// sorted dispatch) gets an empty list, so its walk only writes its miss
// rows, which are what a walk of its list would write.
template <class W>
__device__ __forceinline__ int block_list(const Ray& ray,
                                          const float* __restrict__ sbox,
                                          int num_s, const BlockSmem& sm,
                                          unsigned long long* glist,
                                          const int* gcount,
                                          unsigned long long*& list,
                                          W& work) {
  if (!__syncthreads_or(ray.tmax >= 0.0f)) {
    list = sm.list;
    return 0;
  }
  if (glist) {
    list = glist + blockIdx.x * list_stride(num_s);
    return gcount[blockIdx.x];
  }
  list = sm.list;
  return block_candidates(ray, sbox, num_s, sm.list, sm.feat, work);
}

}  // namespace imba

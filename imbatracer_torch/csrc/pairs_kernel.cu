// The pair-queue route on the card: per-ray candidates, the queue, the
// traversal of (ray, super-chunk) pairs and the per-ray resolve, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel
//   imbatracer_tpu/ops/pallas_pairs.py::_make_span_kernel(occl, instanced)
// in all four variants (OCCL x INST), and the XLA-side candidates, queue
// sort and resolve around it (pallas_pairs.py ray_candidates,
// closest_hit_pairs / any_hit_pairs).  Layouts of rays, sbox, tiles and the
// two-level instancing metadata are those of ops/stream_traverse.py; the
// route's steps and their plain versions are in ops/pairs.py.
//
// a. pair_candidates_kernel: one thread a ray.  The block stages kCandBoxes
//    sbox rows at a time in shared memory with a group box over each 8
//    (exact, as in traverse_common.cuh block_candidates: rounding is
//    monotone), slab-tests them and keeps the ray's k + 1 nearest entries
//    (key bits << 32 | index, key = max(tn, 0) with -0 made +0) in a sorted
//    insertion list in registers.  It writes the k = min(8, S) nearest
//    super-chunks front to back (ties to the lower index), their entry t,
//    the count of every super-chunk the ray enters and `mindrop`, the
//    (k + 1)-th entry t: ray_candidates, bit for bit.  It also counts each
//    super-chunk's candidates and takes each candidate's rank in its
//    super-chunk's run (atomicAdd).
// b. The queue: one block scans the histogram over S into run offsets and
//    a segment table (each run cut into segments of at most kBlk lanes:
//    [sc, start, length]), and a scatter puts pair p = ray * k + j at
//    offset[sc] + rank.  The order of lanes inside a run is the order in
//    which the atomics were served, not the rays' Morton order; each lane
//    writes its hit to its own pair slot, so that order changes no result.
// c. pairs_kernel: one block a segment, one thread a lane.  The block walks
//    the segment's one super-chunk with the stream kernel's block walk
//    (traverse_common.cuh block_walk over a one-entry list): its chunk
//    boxes, sbox and (INST) itab rows staged once by cp.async, padding
//    chunks skipped, the union of the lanes' entered chunks staged in
//    double-buffered feature batches, tests spread over (lane, chunk)
//    pairs, and each thread taking its hits in its sequential walk order --
//    the order of pairs_plain, so hits, ties and rounding are its own.  The
//    super-chunk box test it repeats passes for every lane (the candidate
//    stage made the lane from the same test).
// d. pair_resolve_kernel: one thread a ray: the minimum-t lane of its
//    min(count, k) (the lower j on a tie), or the OR of their flags; the
//    miss row at tmax; the saturation flag (count > k and a miss or a t
//    beyond mindrop; any hit: count > k and not occluded), the ray row the
//    stream kernel's fallback re-traces (tmax -1 where not saturated) and
//    the number of saturated rays.
//
// What bounds the one-thread-a-lane kernel this replaces: every tile value
// a dependent L2 load of its own, and lanes of a warp entering different
// chunks; around it, ~100 torch launches for the candidates and the queue
// (an (R, S) entry matrix sorted a 32,768-ray chunk at a time).  What the
// design does: candidates in registers and no (R, S) matrix, the queue in
// three launches, tiles out of shared memory.  What bounds it now: the
// walk's block barriers per feature batch, and the candidates kernel's S
// slab tests a ray (behind the group boxes).
//
// Numerics: built with --fmad=false, with the tests of traverse_common.cuh,
// so rows round as pairs_plain's do, bit for bit; with bit-equal t the
// first triangle in walk order wins.

#include <type_traits>

#include "traverse_common.cuh"

namespace {

using namespace imba;

constexpr int kMaxK = 8;            // candidates kept a ray (ops/pairs.K_MAX)
constexpr int kCandBoxes = 1024;    // sbox rows a candidates block stages
constexpr int kScanThreads = 1024;  // threads of the queue's scan block

// --------------------------------------------------------------------------
// a. Per-ray candidates
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kBlk)
pair_candidates_kernel(const float* __restrict__ rays,
                       const float* __restrict__ sbox, int num_r, int num_s,
                       int k, int* __restrict__ idx, float* __restrict__ ent,
                       int* __restrict__ count_out,
                       float* __restrict__ mindrop, int* __restrict__ hist,
                       int* __restrict__ rank) {
  __shared__ float s_box[kCandBoxes * 6];
  __shared__ float s_gbox[kCandBoxes / kGroup * 6];
  const int tid = threadIdx.x;
  const int r = blockIdx.x * kBlk + tid;
  const bool in = r < num_r;
  const Ray ray = in ? load_ray(rays + (size_t)r * 8)
                     : make_ray(0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f,
                                -1.0f);
  unsigned long long best[kMaxK + 1];
#pragma unroll
  for (int i = 0; i <= kMaxK; ++i) best[i] = ~0ull;
  int count = 0;

  for (int g0 = 0; g0 < num_s; g0 += kCandBoxes) {
    const int nb = min(kCandBoxes, num_s - g0);
    const int ng = (nb + kGroup - 1) / kGroup;
    __syncthreads();                  // the last batch's boxes are read
    for (int i = tid; i < nb * 6; i += kBlk)
      s_box[i] = __ldg(sbox + (size_t)(g0 + i / 6) * 8 + i % 6);
    __syncthreads();
    for (int q = tid; q < ng * 6; q += kBlk) {
      const int g = q / 6, c = q % 6;
      float v = c < 3 ? kBig : -kBig;
      bool inverted = false;
      for (int i = g * kGroup; i < min(g * kGroup + kGroup, nb); ++i) {
        inverted |= s_box[i * 6] > s_box[i * 6 + 3];
        v = c < 3 ? fminf(v, s_box[i * 6 + c]) : fmaxf(v, s_box[i * 6 + c]);
      }
      s_gbox[q] = inverted ? (c < 3 ? -kBig : kBig) : v;
    }
    __syncthreads();
    for (int g = 0; g < ng; ++g) {
      const float* gb = s_gbox + g * 6;
      float tn;
      if (!slab(gb[0], gb[1], gb[2], gb[3], gb[4], gb[5], ray, ray.tmax, tn))
        continue;
      for (int i = g * kGroup; i < min(g * kGroup + kGroup, nb); ++i) {
        const float* b = s_box + i * 6;
        if (!slab(b[0], b[1], b[2], b[3], b[4], b[5], ray, ray.tmax, tn))
          continue;
        // + 0.0f turns a -0 key into +0, so the uint bits order the keys.
        const float key = fmaxf(tn, 0.0f) + 0.0f;
        if (!(key < kBig)) continue;
        ++count;
        unsigned long long e =
            ((unsigned long long)__float_as_uint(key) << 32) |
            (unsigned)(g0 + i);
#pragma unroll
        for (int s = 0; s <= kMaxK; ++s) {
          const unsigned long long cur = best[s];
          best[s] = e < cur ? e : cur;
          e = e < cur ? cur : e;
        }
      }
    }
  }
  if (!in) return;

  float drop = kBig;
#pragma unroll
  for (int j = 0; j <= kMaxK; ++j) {
    const bool valid = j < count;
    const int sc = (int)(best[j] & 0xffffffffu);
    const float key = __uint_as_float((unsigned)(best[j] >> 32));
    if (j < k) {
      const size_t p = (size_t)r * k + j;
      idx[p] = valid ? sc : -1;
      ent[p] = valid ? key : kBig;
      if (valid) rank[p] = atomicAdd(hist + sc, 1);
    } else if (j == k && valid && num_s > k) {
      drop = key;
    }
  }
  count_out[r] = count;
  mindrop[r] = drop;
}

// --------------------------------------------------------------------------
// b. The queue
// --------------------------------------------------------------------------

// Exclusive prefix sum of v over the kScanThreads threads of the block;
// *total gets the sum.  `ws` holds 32 ints of shared scratch.
__device__ __forceinline__ int scan_block(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = ws[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    ws[lane] = w;
  }
  __syncthreads();
  const int off = warp ? ws[warp - 1] : 0;
  *total = ws[31];
  __syncthreads();                    // ws is rewritten by the next scan
  return off + x - v;
}

// One block: run offsets off[s] (exclusive scan of hist), the segment
// table seg[i] = [sc, start, length, 0] (runs ascending, each cut into
// segments of at most kBlk lanes) and its row count nseg[0].
__global__ void __launch_bounds__(kScanThreads)
pair_queue_scan_kernel(const int* __restrict__ hist, int num_s,
                       int* __restrict__ off, int4* __restrict__ seg,
                       int* __restrict__ nseg) {
  __shared__ int ws[32];
  int base = 0, sbase = 0;
  for (int s0 = 0; s0 < num_s; s0 += kScanThreads) {
    const int s = s0 + threadIdx.x;
    const int c = s < num_s ? hist[s] : 0;
    const int n = (c + kBlk - 1) / kBlk;
    int total, stotal;
    const int e = scan_block(c, ws, &total);
    const int es = scan_block(n, ws, &stotal);
    if (s < num_s) {
      off[s] = base + e;
      for (int j = 0; j < n; ++j)
        seg[sbase + es + j] =
            make_int4(s, base + e + j * kBlk, min(kBlk, c - j * kBlk), 0);
    }
    base += total;
    sbase += stotal;
  }
  if (threadIdx.x == 0) nseg[0] = sbase;
}

__global__ void __launch_bounds__(kBlk)
pair_queue_scatter_kernel(const int* __restrict__ idx,
                          const int* __restrict__ rank,
                          const int* __restrict__ off, int num_p,
                          int* __restrict__ order) {
  const int p = blockIdx.x * kBlk + threadIdx.x;
  if (p >= num_p) return;
  const int sc = idx[p];
  if (sc >= 0) order[off[sc] + rank[p]] = p;
}

// --------------------------------------------------------------------------
// c. The pair kernel
// --------------------------------------------------------------------------

template <bool OCCL, bool INST, class W>
__global__ void __launch_bounds__(kBlk, 4)
pairs_kernel(const float* __restrict__ rays, const float* __restrict__ sbox,
             const float* __restrict__ tiles,
             const int* __restrict__ tile_idx,
             const int* __restrict__ inst_of,
             const float* __restrict__ itab, const int* __restrict__ order,
             const int4* __restrict__ seg, const int* __restrict__ nseg,
             int k, float* __restrict__ out,
             unsigned long long* __restrict__ work_out) {
  if ((int)blockIdx.x >= __ldg(nseg)) return;       // uniform over the block
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_list[2];
  CandBuf* cand = reinterpret_cast<CandBuf*>(smem);
  float* feat = reinterpret_cast<float*>(cand + 2);
  const int4 sg = seg[blockIdx.x];
  const int lane =
      (int)threadIdx.x < sg.z ? __ldg(order + sg.y + threadIdx.x) : -1;
  const Ray ray = lane >= 0 ? load_ray(rays + (size_t)(lane / k) * 8)
                            : make_ray(0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 1.0f,
                                       1.0f, -1.0f);
  // One candidate, its key -inf (bits 0xff800000) so that every live lane
  // needs it.
  if (threadIdx.x == 0)
    s_list[0] = (0xff800000ull << 32) | (unsigned)sg.x;
  __syncthreads();
  W work;
  using P = typename std::conditional<OCCL, Any, Closest>::type;
  P pol(ray.tmax);
  block_walk<INST>(ray, pol, s_list, 1, cand, feat, sbox, tiles, tile_idx,
                   inst_of, itab, work);
  work.flush(work_out);
  if (lane >= 0) write_hit<OCCL>(pol, out + (size_t)lane * 8);
}

using PairsFn = void (*)(const float*, const float*, const float*,
                         const int*, const int*, const float*, const int*,
                         const int4*, const int*, int, float*,
                         unsigned long long*);

template <bool OCCL, bool INST>
PairsFn pick(bool work) {
  return work ? pairs_kernel<OCCL, INST, Work>
              : pairs_kernel<OCCL, INST, NoWork>;
}

PairsFn pairs_for(int occl, bool inst, bool work) {
  return occl ? (inst ? pick<true, true>(work) : pick<true, false>(work))
              : (inst ? pick<false, true>(work) : pick<false, false>(work));
}

// --------------------------------------------------------------------------
// d. Resolve
// --------------------------------------------------------------------------

template <bool OCCL>
__global__ void __launch_bounds__(kBlk)
pair_resolve_kernel(const float* __restrict__ rays,
                    const float* __restrict__ lanes,
                    const int* __restrict__ count,
                    const float* __restrict__ mindrop, int num_r, int k,
                    float* __restrict__ out, float* __restrict__ again,
                    unsigned char* __restrict__ sat, int* __restrict__ nsat) {
  const int r = blockIdx.x * kBlk + threadIdx.x;
  if (r >= num_r) return;
  const float* ray = rays + (size_t)r * 8;
  const float tmax = ray[7];
  const int cnt = count[r];
  const int n = min(cnt, k);
  float row[8] = {tmax, 0.0f, 0.0f, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool s;
  if (OCCL) {
    bool occ = false;
    for (int j = 0; j < n; ++j)
      occ |= lanes[((size_t)r * k + j) * 8] > 0.0f;
    row[0] = occ ? 1.0f : 0.0f;
    row[3] = 0.0f;
    s = cnt > k && !occ;
  } else {
    float best = kBig;
    int bj = -1;
    for (int j = 0; j < n; ++j) {
      const float* l = lanes + ((size_t)r * k + j) * 8;
      if (l[3] >= 0.0f && l[0] < best) {
        best = l[0];
        bj = j;
      }
    }
    if (bj >= 0) {
      const float* l = lanes + ((size_t)r * k + bj) * 8;
#pragma unroll
      for (int c = 0; c < 4; ++c) row[c] = l[c];
    }
    s = cnt > k && (bj < 0 || row[0] > mindrop[r]);
  }
  s = s && tmax >= 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    out[(size_t)r * 8 + c] = row[c];
    again[(size_t)r * 8 + c] = c == 7 ? (s ? tmax : -1.0f) : ray[c];
  }
  sat[r] = s ? 1 : 0;
  if (s) atomicAdd(nsat, 1);
}

inline int blocks_for(long long n) { return (int)((n + kBlk - 1) / kBlk); }

}  // namespace

// C entry points.  Each launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launches (0 on
// success).

// (a) rays (num_r, 8) f32, sbox (num_s, 8) f32 -> idx (num_r, k) i32,
// ent (num_r, k) f32, count (num_r,) i32, mindrop (num_r,) f32, with
// 1 <= k <= 8 and k <= num_s; it also counts each super-chunk's
// candidates in hist (num_s int32, zeroed) and writes each candidate's
// rank in its run to rank (num_r, k) i32.
extern "C" int imba_pair_candidates(const void* rays, const void* sbox,
                                    int num_r, int num_s, int k, void* idx,
                                    void* ent, void* count, void* mindrop,
                                    void* hist, void* rank, void* stream) {
  if (k < 1 || k > kMaxK || k > num_s)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_r > 0)
    pair_candidates_kernel<<<blocks_for(num_r), kBlk, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays), static_cast<const float*>(sbox),
        num_r, num_s, k, static_cast<int*>(idx), static_cast<float*>(ent),
        static_cast<int*>(count), static_cast<float*>(mindrop),
        static_cast<int*>(hist), static_cast<int*>(rank));
  return static_cast<int>(cudaGetLastError());
}

// (b) From (a)'s idx and rank (num_p = num_r * k lanes) and hist: off
// (num_s,) i32 scratch, order (num_p,) i32 -- pair slots grouped by
// super-chunk, runs ascending, sum(hist) of them written --, seg
// (max_segs, 4) i32 rows [sc, start, length, 0] with max_segs >=
// num_p / 128 + num_s + 1, and nseg (1,) i32 its row count.
extern "C" int imba_pair_queue(const void* idx, const void* rank,
                               const void* hist, int num_p, int num_s,
                               void* off, void* order, void* seg, void* nseg,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_queue_scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int*>(hist), num_s, static_cast<int*>(off),
      static_cast<int4*>(seg), static_cast<int*>(nseg));
  if (num_p > 0)
    pair_queue_scatter_kernel<<<blocks_for(num_p), kBlk, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const int*>(rank),
        static_cast<const int*>(off), num_p, static_cast<int*>(order));
  return static_cast<int>(cudaGetLastError());
}

// (c) One block a row of seg (max_segs blocks; those past nseg[0] exit):
// out (num_r * k, 8) f32 rows [t u v id 0 0 0 0] (a miss: t = tmax, id -1)
// or [flag 0 ...] at each queued pair slot; other rows are not written.
// With `tile_idx` non-null the two-level instanced variant; with `work`
// non-null the counting instantiation, which adds its kWorkSlots tallies
// (traverse_common.cuh) to the zero-initialised uint64 array `work`.
extern "C" int imba_pairs_traverse(const void* rays, const void* sbox,
                                   const void* tiles, const void* tile_idx,
                                   const void* inst_of, const void* itab,
                                   const void* order, const void* seg,
                                   const void* nseg, int max_segs, int k,
                                   void* out, int occl, void* work,
                                   void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (max_segs == 0) return static_cast<int>(cudaGetLastError());
  PairsFn fn = pairs_for(occl, tile_idx != nullptr, work != nullptr);
  const cudaError_t e = prepare(fn, kTailBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fn<<<max_segs, kBlk, kTailBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(sbox),
      static_cast<const float*>(tiles), static_cast<const int*>(tile_idx),
      static_cast<const int*>(inst_of), static_cast<const float*>(itab),
      static_cast<const int*>(order), static_cast<const int4*>(seg),
      static_cast<const int*>(nseg), k, static_cast<float*>(out),
      static_cast<unsigned long long*>(work));
  return static_cast<int>(cudaGetLastError());
}

// (d) rays (num_r, 8), lanes (num_r * k, 8) from (c), count and mindrop
// from (a) -> out (num_r, 8) the resolved rows, again (num_r, 8) the rays
// with tmax -1 where not saturated, sat (num_r,) u8, and nsat[0] (zeroed
// int32) += the saturated rays.
extern "C" int imba_pair_resolve(const void* rays, const void* lanes,
                                 const void* count, const void* mindrop,
                                 int num_r, int k, int occl, void* out,
                                 void* again, void* sat, void* nsat,
                                 void* stream) {
  if (num_r > 0) {
    auto* fn = occl ? pair_resolve_kernel<true> : pair_resolve_kernel<false>;
    fn<<<blocks_for(num_r), kBlk, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays), static_cast<const float*>(lanes),
        static_cast<const int*>(count), static_cast<const float*>(mindrop),
        num_r, k, static_cast<float*>(out), static_cast<float*>(again),
        static_cast<unsigned char*>(sat), static_cast<int*>(nsat));
  }
  return static_cast<int>(cudaGetLastError());
}

// Resources of the pair kernel imba_pairs_traverse would launch: out[0]
// registers, out[1] static shared bytes, out[2] dynamic shared bytes,
// out[3] local (spill) bytes a thread, out[4] resident blocks an SM.
extern "C" int imba_pairs_resources(int occl, int inst, int work, int* out) {
  PairsFn fn = pairs_for(occl, inst != 0, work != 0);
  cudaError_t e = prepare(fn, kTailBytes);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlk,
                                                      kTailBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = kTailBytes;
  out[3] = (int)a.localSizeBytes;
  out[4] = blocks;
  return static_cast<int>(cudaSuccess);
}

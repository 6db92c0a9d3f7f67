// K-nearest-hit ray traversal over super-chunk feature tiles, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel
//   imbatracer_tpu/ops/pallas_khit.py::_khit_kernel (via _khit_call)
// which returns, per ray, the K = 4 nearest hits in (tmin, tmax) sorted
// by t -- the input of the exact alpha-masked closest hit
// (imbatracer_torch/render/traverse.py), which alpha-tests the K hits
// outside the kernel and re-traces only rays whose K hits were all
// masked out.  Layouts: rays, sbox, tiles and the candidate lists as in
// imbatracer_torch/ops/stream_traverse.py; out (R, 8K) f32, hit k in
// columns 8k..8k+3 = [t u v id]; an absent hit is t = 1e30, u = v = 0,
// id = -1 (not tmax, unlike the single-hit kernel).
//
// Design: one thread per ray, BLK = 128 rays a block walking the block's
// front-to-back candidate super-chunk list.  Each thread keeps K sorted
// slots (t, u, v, id) in registers (K is a template parameter, the slot
// loops unroll, so the slots never touch local memory) and inserts an
// accepted hit by a bubble-down with strict <, so hits of equal t keep
// their walk order.  The early-exit and Moller-Trumbore limit is the
// thread's own K-th best t (starting at tmax): every accepted hit has
// t < bound, and a super-chunk or chunk whose slab entry lies beyond the
// bound is skipped.  That is tighter than the Pallas kernel's per-column
// bound (the minimum over 128 lane columns of each column's 4th best)
// and still gap-free, because a thread sees every triangle closer than
// its current K-th hit.  The walk stops at the first candidate whose
// block-min entry t is at or beyond the bound.  The TPU-only machinery
// of the Pallas kernel -- the (4K, BLK, 128) slot planes, the final K-pass
// resolve over concatenated columns, SMEM group compaction and the DMA
// double buffer, all there because Mosaic has no cross-lane reductions --
// has no counterpart.
//
// What bounds it: as the single-hit kernel (stream_traverse.cu), memory
// latency of tile loads from L2 (the still-life scene's ~14 MB of tiles
// fit the 50 MB L2) and warp divergence across chunks; the K-th-best
// bound prunes less than a closest-hit bound, so a ray tests more
// triangles than a closest-hit walk does, and the K-slot insertion adds
// ~4K selects per accepted hit.  Flops per tested triangle (~25) keep it
// far from the compute bound.  The design answers with registers only
// (no shared memory, no atomics) and the torch-side ray sort that keeps
// warps coherent.
//
// Numerics: traverse_common.cuh (shared with stream_traverse.cu), built
// with --fmad=false, so t/u/v match the plain PyTorch version
// (imbatracer_torch/ops/khit.py) bit for bit.  Ties (equal t on a shared
// edge) keep insertion order here; the tests compare t exactly and ids up
// to exact-t ties.

#include "traverse_common.cuh"

namespace {

using namespace imba;

template <int K, class W>
__global__ void __launch_bounds__(128)
khit_kernel(const float* __restrict__ rays, const float* __restrict__ sbox,
            const float* __restrict__ tiles, const int* __restrict__ slist,
            const float* __restrict__ skey, const int* __restrict__ scount,
            float* __restrict__ out, int num_rays, int num_s, int blk,
            unsigned long long* __restrict__ work_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const Ray ray = load_ray(rays + (size_t)r * 8);
  W work;
  float st[K], su[K], sv[K], sid[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    st[s] = ray.tmax;
    su[s] = 0.0f;
    sv[s] = 0.0f;
    sid[s] = -1.0f;
  }

  if (ray.tmax >= 0.0f) {
    const int b = r / blk;
    const int n = scount[b];
    const int* list = slist + (size_t)b * num_s;
    const float* keys = skey + (size_t)b * num_s;

    for (int k = 0; k < n; ++k) {
      if (keys[k] >= st[K - 1]) break;
      const int sc = list[k];
      work.slab();
      if (!enters_superchunk(sbox + (size_t)sc * 8, ray, st[K - 1]))
        continue;
      const float* T = tiles + (size_t)sc * kTileRows * kTriRows;
      for (int c = 0; c < kSuper; ++c) {
        work.slab();
        if (!enters_chunk(T, c, ray, st[K - 1])) continue;
        for (int j = c * kChunk; j < (c + 1) * kChunk; ++j) {
          float t, u, v, id;
          if (!hit_slot(T, j, ray, st[K - 1], t, u, v, id, work)) continue;
          // Bubble-down: the candidate takes the first slot it beats
          // (strictly) and carries the displaced entry further down.
#pragma unroll
          for (int s = 0; s < K; ++s) {
            const bool take = t < st[s];
            const float ot = st[s], ou = su[s], ov = sv[s], oid = sid[s];
            st[s] = take ? t : ot;
            su[s] = take ? u : ou;
            sv[s] = take ? v : ov;
            sid[s] = take ? id : oid;
            t = take ? ot : t;
            u = take ? ou : u;
            v = take ? ov : v;
            id = take ? oid : id;
          }
        }
      }
    }
  }

  work.flush(work_out);
  float* o = out + (size_t)r * 8 * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool got = sid[s] >= 0.0f;
    o[8 * s + 0] = got ? st[s] : kBig;
    o[8 * s + 1] = got ? su[s] : 0.0f;
    o[8 * s + 2] = got ? sv[s] : 0.0f;
    o[8 * s + 3] = got ? sid[s] : -1.0f;
    o[8 * s + 4] = o[8 * s + 5] = o[8 * s + 6] = o[8 * s + 7] = 0.0f;
  }
}

template <class W>
void launch(int blocks, cudaStream_t s, const void* rays, const void* sbox,
            const void* tiles, const void* slist, const void* skey,
            const void* scount, void* out, int num_rays, int num_s, int blk,
            void* work) {
  khit_kernel<4, W><<<blocks, 128, 0, s>>>(
      static_cast<const float*>(rays), static_cast<const float*>(sbox),
      static_cast<const float*>(tiles), static_cast<const int*>(slist),
      static_cast<const float*>(skey), static_cast<const int*>(scount),
      static_cast<float*>(out), num_rays, num_s, blk,
      static_cast<unsigned long long*>(work));
}

}  // namespace

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch (0 on success),
// or cudaErrorInvalidValue for a K that is not instantiated.  With `work`
// null it launches the renderer's kernel; otherwise the counting
// instantiation, which adds its kWorkSlots tallies (slab tests, then
// Moller-Trumbore tests by the stage they ended at) to the
// zero-initialised uint64 array `work`.
extern "C" int imba_khit_traverse(const void* rays, const void* sbox,
                                  const void* tiles, const void* slist,
                                  const void* skey, const void* scount,
                                  void* out, int num_rays, int num_s, int blk,
                                  int k, void* work, void* stream) {
  if (k != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_rays + 127) / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    auto* go = work ? launch<Work> : launch<NoWork>;
    go(blocks, s, rays, sbox, tiles, slist, skey, scount, out, num_rays,
       num_s, blk, work);
  }
  return static_cast<int>(cudaGetLastError());
}

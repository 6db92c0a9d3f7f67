// K-nearest-hit ray traversal over super-chunk feature tiles, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel
//   imbatracer_tpu/ops/pallas_khit.py::_khit_kernel (via _khit_call)
// and the candidate lists that fed it, and returns, per ray, the K = 4
// nearest hits in (tmin, tmax) sorted by t -- the input of the exact
// alpha-masked closest hit (imbatracer_torch/render/traverse.py), which
// alpha-tests the K hits outside the kernel and re-traces only rays whose
// K hits were all masked out.  Layouts: rays, sbox and tiles as in
// imbatracer_torch/ops/stream_traverse.py; out (R, 8K) f32, hit k in
// columns 8k..8k+3 = [t u v id]; an absent hit is t = 1e30, u = v = 0,
// id = -1 (not tmax, unlike the single-hit kernel).
//
// Design: the block machinery of the stream kernel (traverse_common.cuh:
// one launch a dispatch, two above kMaxSuper super-chunks, where the
// lists go through a global buffer; each 128-ray block builds its sorted
// candidate list in shared memory, then walks it with chunk boxes and triangles
// staged in shared memory by cp.async, the tests spread over (ray, chunk)
// pairs).  Each thread keeps K sorted slots (t, u, v, id) in registers (K
// is a template parameter and the slot loops unroll, so the slots never
// touch local memory) and inserts its hits, in its own walk order, by a
// bubble-down with strict <, so hits of equal t keep their walk order.
// The thread's bound, for the walk's exit and the Moller-Trumbore limit,
// is its own K-th best t (starting at tmax): every accepted hit has t <
// bound, and a super-chunk or chunk whose slab entry lies beyond it is
// skipped.  That is tighter than the Pallas kernel's per-column bound and
// still gap-free, because a thread sees every triangle closer than its
// current K-th hit.  The TPU-only machinery of the Pallas kernel -- the
// (4K, BLK, 128) slot planes, the final K-pass resolve over concatenated
// columns, SMEM group compaction and the DMA double buffer -- has no
// counterpart.
//
// What bounds it now: as the stream kernel (stream_traverse.cu), block
// barriers and the latency of each feature batch's staging; the K-th-best
// bound prunes less than a closest-hit bound, so more chunks stay live a
// candidate, and the insertion adds ~4K selects a hit.  What the staging
// does about the L2 latency and divergence of a walk with one thread a ray
// over global tiles, and what is left for later, is in
// traverse_common.cuh.
//
// Numerics: traverse_common.cuh, built with --fmad=false, so t/u/v match
// the plain PyTorch version (imbatracer_torch/ops/khit.py) bit for bit.
// Ties (equal t on a shared edge) keep insertion order here; the tests
// compare t exactly and ids up to exact-t ties.

#include "traverse_common.cuh"

namespace {

using namespace imba;

template <int K>
struct KNearest {
  float st[K], su[K], sv[K], sid[K];
  __device__ explicit KNearest(float tmax) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      st[s] = tmax;
      su[s] = 0.0f;
      sv[s] = 0.0f;
      sid[s] = -1.0f;
    }
  }
  __device__ __forceinline__ float bound() const { return st[K - 1]; }
  __device__ __forceinline__ bool done() const { return false; }
  // Bubble-down: the hit takes the first slot it beats (strictly) and
  // carries the displaced entry further down.
  __device__ __forceinline__ void accept(float t, float u, float v,
                                         float id) {
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
};

template <int K, class W>
__global__ void __launch_bounds__(kBlk, 4)
khit_kernel(const float* __restrict__ rays, const float* __restrict__ sbox,
            const float* __restrict__ tiles, float* __restrict__ out,
            int num_s, unsigned long long* __restrict__ glist,
            const int* __restrict__ gcount,
            unsigned long long* __restrict__ work_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem sm(smem, num_s);
  const int r = blockIdx.x * kBlk + threadIdx.x;
  const Ray ray = load_ray(rays + (size_t)r * 8);
  W work;
  unsigned long long* list;
  const int count = block_list(ray, sbox, num_s, sm, glist, gcount, list,
                               work);
  KNearest<K> pol(ray.tmax);
  block_walk<false>(ray, pol, list, count, sm.cand, sm.feat, sbox, tiles,
                    nullptr, nullptr, nullptr, work);

  work.flush(work_out);
  float* o = out + (size_t)r * 8 * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool got = pol.sid[s] >= 0.0f;
    o[8 * s + 0] = got ? pol.st[s] : kBig;
    o[8 * s + 1] = got ? pol.su[s] : 0.0f;
    o[8 * s + 2] = got ? pol.sv[s] : 0.0f;
    o[8 * s + 3] = got ? pol.sid[s] : -1.0f;
    o[8 * s + 4] = o[8 * s + 5] = o[8 * s + 6] = o[8 * s + 7] = 0.0f;
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, float*,
                          int, unsigned long long*, const int*,
                          unsigned long long*);

KernelFn kernel_for(bool work) {
  return work ? khit_kernel<4, Work> : khit_kernel<4, NoWork>;
}

}  // namespace

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch (0 on success),
// or cudaErrorInvalidValue for a K that is not instantiated, num_rays
// that is not a multiple of 128, num_s < 1, or num_s > kMaxSuper without
// the list buffers `glist` / `gcount` (as for imba_stream_traverse: above
// kMaxSuper a list launch writes each block's sorted list there and the
// walk launch reads it).  With `work` null it launches the renderer's
// kernels; otherwise the counting instantiations, which add their
// kWorkSlots tallies (traverse_common.cuh) to the zero-initialised uint64
// array `work`.
extern "C" int imba_khit_traverse(const void* rays, const void* sbox,
                                  const void* tiles, void* out, int num_rays,
                                  int num_s, int k, void* glist, void* gcount,
                                  void* work, void* stream) {
  if (k != 4 || bad_shape(num_rays, num_s, glist) ||
      (global_list(num_s) && gcount == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = num_rays / kBlk;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!global_list(num_s)) {
    glist = nullptr;
    gcount = nullptr;
  } else {
    const cudaError_t e = launch_candidates(rays, sbox, num_rays, num_s, glist,
                                            gcount, nullptr, nullptr, nullptr,
                                            work, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  KernelFn fn = kernel_for(work != nullptr);
  const size_t smem = block_smem_bytes(num_s);
  const cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fn<<<blocks, kBlk, smem, s>>>(
      static_cast<const float*>(rays), static_cast<const float*>(sbox),
      static_cast<const float*>(tiles), static_cast<float*>(out), num_s,
      static_cast<unsigned long long*>(glist),
      static_cast<const int*>(gcount),
      static_cast<unsigned long long*>(work));
  return static_cast<int>(cudaGetLastError());
}

// Resources of the kernel imba_khit_traverse would launch (traverse_
// common.cuh resources()); returns a CUDA error code.
extern "C" int imba_khit_resources(int work, int num_s, int* out) {
  return static_cast<int>(resources(kernel_for(work != 0), num_s, out));
}

// Streaming closest-hit / any-hit ray traversal over super-chunk feature
// tiles, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels
//   imbatracer_tpu/ops/pallas_stream.py::_make_kernel (instanced=False)
//   imbatracer_tpu/ops/pallas_vmem.py::_make_vmem_kernel
// which compute the same function over the same (sbox, tiles) packing;
// the layouts are documented in imbatracer_torch/ops/stream_traverse.py.
//
// Design: one thread per ray, best hit in registers.  Each block of BLK
// threads walks the candidate super-chunk list of its ray block (built by
// torch ops, sorted front-to-back by the block-min entry t), and every
// thread stops its own walk as soon as the next candidate's entry t is at
// or beyond its best hit (closest hit) or its tmax (any hit) -- the list is
// ascending and a ray's own entry t is never below the block minimum, so
// no later candidate can matter.  Inside a super-chunk the thread slab-
// tests its 64 chunk boxes and runs the feature-dot Moller-Trumbore test
// on the 16 triangles of each chunk it enters; an any-hit thread stops
// at its first hit.  The TPU-only machinery of the Pallas kernels (column-
// best planes, SMEM group compaction, the grid-carried exit bound, the DMA
// double buffer) has no counterpart: an exit bound here is per thread.
//
// What bounds it: memory latency.  Tile rows are read straight from
// global memory through the read-only path; at the main-path scene (S = 68
// super-chunks, 6.7 MB of tiles) the whole tile set sits in the 50 MB L2,
// so loads hit L2, and threads of a warp walking the same chunk read the
// same addresses (broadcast).  Work per ray is ~25 flops per tested
// triangle, far below the card's compute bound.  Divergence (threads of
// one warp entering different chunks) is the main inefficiency; ray
// sorting on the torch side (octant-major, Morton-minor keys) keeps warps
// coherent.  Shared-memory tile staging, warp-level culling and tensor-
// core formulations are left to later work.
//
// Numerics: the slab and Moller-Trumbore tests are those of
// traverse_common.cuh (shared with khit_traverse.cu), which match the
// plain version bit for bit.  With bit-equal t, the first triangle found
// in walk order wins.

#include "traverse_common.cuh"

namespace {

using namespace imba;

// The minimum of 8 resident blocks an SM gives ptxas a 64-register
// budget; without it ptxas kept the any-hit kernel at 40 registers with an
// 8-byte stack frame and 4 bytes of spill stores.
template <bool OCCL, class W>
__global__ void __launch_bounds__(128, 8)
stream_traverse_kernel(const float* __restrict__ rays,
                       const float* __restrict__ sbox,
                       const float* __restrict__ tiles,
                       const int* __restrict__ slist,
                       const float* __restrict__ skey,
                       const int* __restrict__ scount,
                       float* __restrict__ out, int num_rays, int num_s,
                       int blk, unsigned long long* __restrict__ work_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const Ray ray = load_ray(rays + (size_t)r * 8);
  float* o = out + (size_t)r * 8;
  W work;
  float best_t = ray.tmax, best_u = 0.0f, best_v = 0.0f, best_id = -1.0f;
  bool occluded = false;

  if (ray.tmax >= 0.0f) {
    const int b = r / blk;
    const int n = scount[b];
    const int* list = slist + (size_t)b * num_s;
    const float* keys = skey + (size_t)b * num_s;

    for (int k = 0; k < n; ++k) {
      if (keys[k] >= best_t) break;  // best_t == tmax for any hit
      const int sc = list[k];
      work.slab();
      if (!enters_superchunk(sbox + (size_t)sc * 8, ray, best_t)) continue;
      const float* T = tiles + (size_t)sc * kTileRows * kTriRows;
      for (int c = 0; c < kSuper; ++c) {
        work.slab();
        if (!enters_chunk(T, c, ray, best_t)) continue;
        for (int j = c * kChunk; j < (c + 1) * kChunk; ++j) {
          float t, u, v, id;
          if (!hit_slot(T, j, ray, best_t, t, u, v, id, work)) continue;
          if (OCCL) {
            occluded = true;
            goto done;
          }
          best_t = t;
          best_u = u;
          best_v = v;
          best_id = id;
        }
      }
    }
  }

done:
  work.flush(work_out);
  if (OCCL) {
    o[0] = occluded ? 1.0f : 0.0f;
    o[1] = o[2] = o[3] = 0.0f;
  } else {
    o[0] = best_t;
    o[1] = best_u;
    o[2] = best_v;
    o[3] = best_id;
  }
  o[4] = o[5] = o[6] = o[7] = 0.0f;
}

template <bool OCCL, class W>
void launch(int blocks, cudaStream_t s, const void* rays, const void* sbox,
            const void* tiles, const void* slist, const void* skey,
            const void* scount, void* out, int num_rays, int num_s, int blk,
            void* work) {
  stream_traverse_kernel<OCCL, W><<<blocks, 128, 0, s>>>(
      static_cast<const float*>(rays), static_cast<const float*>(sbox),
      static_cast<const float*>(tiles), static_cast<const int*>(slist),
      static_cast<const float*>(skey), static_cast<const int*>(scount),
      static_cast<float*>(out), num_rays, num_s, blk,
      static_cast<unsigned long long*>(work));
}

}  // namespace

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch (0 on success).
// With `work` null it launches the renderer's kernel; otherwise the
// counting instantiation, which adds its kWorkSlots tallies (slab tests,
// then Moller-Trumbore tests by the stage they ended at) to the
// zero-initialised uint64 array `work`.
extern "C" int imba_stream_traverse(const void* rays, const void* sbox,
                                    const void* tiles, const void* slist,
                                    const void* skey, const void* scount,
                                    void* out, int num_rays, int num_s,
                                    int blk, int occl, void* work,
                                    void* stream) {
  const int blocks = (num_rays + 127) / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    auto* go = occl ? (work ? launch<true, Work> : launch<true, NoWork>)
                    : (work ? launch<false, Work> : launch<false, NoWork>);
    go(blocks, s, rays, sbox, tiles, slist, skey, scount, out, num_rays,
       num_s, blk, work);
  }
  return static_cast<int>(cudaGetLastError());
}

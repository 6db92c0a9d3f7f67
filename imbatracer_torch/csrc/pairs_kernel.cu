// Closest-hit / any-hit traversal over a sorted (ray, super-chunk) pair
// queue, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
//   imbatracer_tpu/ops/pallas_pairs.py::_make_span_kernel(occl, instanced)
// in all four variants (OCCL x INST).  The queue (ops/pairs.py) holds
// P = R * k lanes: each ray's k nearest candidate super-chunks, sorted by
// super-chunk (stable, so each super-chunk's run keeps the rays' Morton
// order), with the ray row as payload; lanes past a ray's candidate count
// carry sc = -1 and tmax = -1.  The layouts of rays, tiles and the
// two-level instancing metadata are those of ops/stream_traverse.py.
//
// Design: one thread per pair lane.  It reads its ray row and its super-
// chunk, slab-tests that super-chunk's non-padding chunk boxes (a padding
// chunk's inverted box would read as all of space) and runs the
// feature-dot Moller-Trumbore test (traverse_common.cuh) on the 16
// triangles of each chunk it enters, keeping its best hit in registers,
// bounded from tmax (closest hit), or stops at its first hit (any hit).
// Under INST the tile is tile_idx[sc] and the ray is transformed into the
// mesh space of instance inst_of[sc] (instance_ray), and the hit id is
// offset by the instance's flat primitive-id base (a float add: ids exact
// below 2^24 flat triangles).  The super-chunk box itself is not tested:
// the lane exists because the ray's [tmin, tmax] enters it.  Per-ray
// resolution (the minimum t over a ray's k lanes, or their OR) and the
// saturation fallback run in ops/pairs.py.
//
// The Pallas kernel's per-block [first, last] span walk with the lane mask
// `lane_sc == ti` and its tile-DMA cache exist because Mosaic cannot index
// per lane; here each thread indexes its own tile, and threads of a warp
// walking one super-chunk (the sorted queue makes that the common case)
// read the same tile rows (broadcast through L1 / L2).
//
// What bounds it: as the stream kernel, memory latency of dependent tile
// loads from L2 and divergence between lanes entering different chunks;
// its counted work (a `Work` instantiation) is far below the compute bound.
//
// Numerics: the tests of traverse_common.cuh, built with --fmad=false,
// round as the plain version (ops/pairs.py::pairs_plain) does, bit for
// bit; with bit-equal t the first triangle in walk order wins.

#include "traverse_common.cuh"

namespace {

using namespace imba;

template <bool OCCL, bool INST, class W>
__global__ void __launch_bounds__(128, 8)
pairs_kernel(const float* __restrict__ rows, const int* __restrict__ sc_of,
             const float* __restrict__ tiles,
             const int* __restrict__ tile_idx,
             const int* __restrict__ inst_of,
             const float* __restrict__ itab, float* __restrict__ out,
             int num_pairs, unsigned long long* __restrict__ work_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= num_pairs) return;
  const Ray wray = load_ray(rows + (size_t)p * 8);
  float* o = out + (size_t)p * 8;
  W work;
  float best_t = wray.tmax, best_u = 0.0f, best_v = 0.0f, best_id = -1.0f;
  bool occluded = false;
  const int sc = __ldg(sc_of + p);

  if (wray.tmax >= 0.0f && sc >= 0) {
    const float* m = INST ? itab + (size_t)__ldg(inst_of + sc) * 16
                          : nullptr;
    const Ray ray = INST ? instance_ray(wray, m) : wray;
    const size_t tile = INST ? (size_t)__ldg(tile_idx + sc) : (size_t)sc;
    const float* T = tiles + tile * kTileRows * kTriRows;
    for (int c = 0; c < kSuper; ++c) {
      if (padding_chunk(T, c)) continue;
      work.slab();
      if (!enters_chunk(T, c, ray, best_t)) continue;
      for (int j = c * kChunk; j < (c + 1) * kChunk; ++j) {
        float t, u, v, id;
        if (!hit_slot(GlobalRows{T}, j, ray, best_t, t, u, v, id, work))
          continue;
        if (OCCL) {
          occluded = true;
          goto done;
        }
        best_t = t;
        best_u = u;
        best_v = v;
        best_id = INST ? id + __ldg(m + 12) : id;
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

template <bool OCCL, bool INST, class W>
void launch(int blocks, cudaStream_t s, const void* rows, const void* sc,
            const void* tiles, const void* tile_idx, const void* inst_of,
            const void* itab, void* out, int num_pairs, void* work) {
  pairs_kernel<OCCL, INST, W><<<blocks, 128, 0, s>>>(
      static_cast<const float*>(rows), static_cast<const int*>(sc),
      static_cast<const float*>(tiles), static_cast<const int*>(tile_idx),
      static_cast<const int*>(inst_of), static_cast<const float*>(itab),
      static_cast<float*>(out), num_pairs,
      static_cast<unsigned long long*>(work));
}

template <bool OCCL, bool INST>
auto pick(void* work) {
  return work ? launch<OCCL, INST, Work> : launch<OCCL, INST, NoWork>;
}

}  // namespace

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch (0 on success).
// rows: (num_pairs, 8) f32; sc: (num_pairs,) i32 super-chunk per lane
// (-1: no pair); with `tile_idx` non-null the two-level instanced variant
// (tile_idx, inst_of one int32 per super-chunk, itab 16 floats per
// instance).  With `work` non-null the counting instantiation adds its
// kWorkSlots tallies to the zero-initialised uint64 array `work`.
extern "C" int imba_pairs_traverse(const void* rows, const void* sc,
                                   const void* tiles, const void* tile_idx,
                                   const void* inst_of, const void* itab,
                                   void* out, int num_pairs, int occl,
                                   void* work, void* stream) {
  const int blocks = (num_pairs + 127) / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const bool inst = tile_idx != nullptr;
    auto* go = occl ? (inst ? pick<true, true>(work) : pick<true, false>(work))
                    : (inst ? pick<false, true>(work)
                            : pick<false, false>(work));
    go(blocks, s, rows, sc, tiles, tile_idx, inst_of, itab, out, num_pairs,
       work);
  }
  return static_cast<int>(cudaGetLastError());
}

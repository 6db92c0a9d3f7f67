// Streaming closest-hit / any-hit ray traversal over super-chunk feature
// tiles, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels
//   imbatracer_tpu/ops/pallas_stream.py::_make_kernel (instanced=False and
//       instanced=True, the INST template parameter here)
//   imbatracer_tpu/ops/pallas_vmem.py::_make_vmem_kernel
// and the candidate lists that fed them (superchunk_candidates), over the
// same (sbox, tiles[, inst]) packing; the layouts are documented in
// imbatracer_torch/ops/stream_traverse.py.
//
// Design: one launch a dispatch, one block of kBlk = 128 rays, one thread
// a ray with its best hit in registers.  The block first builds its own
// candidate list in shared memory (traverse_common.cuh block_candidates:
// the super-chunks any of its rays enters, sorted by the block-min entry
// t; above kMaxSuper = 16,384 super-chunks a list launch of its own builds
// the lists in a global buffer, which the walk launch reads), then walks it (block_walk): super-chunk box with the world ray,
// chunk boxes and triangles staged in shared memory with cp.async and
// tested, spread over (ray, chunk) pairs, with the ray in the super-chunk's
// frame; each thread takes its hits in its own walk order.  A closest-hit
// thread's bound is its best t, an any-hit thread's its tmax, and an
// any-hit thread stops at its first hit.  Under two-level instancing
// (INST) the chunk and triangle tests run on tile tile_idx[sc] with the
// ray transformed into the mesh space of instance inst_of[sc], and the
// hit id is offset by that instance's flat primitive-id base, a float add,
// so ids are exact below 2^24 flat triangles.  The TPU-only machinery of
// the Pallas kernels (column-best planes, SMEM group compaction, the
// grid-carried exit bound) has no counterpart: an exit bound here is per
// thread.
//
// What bounds it now: block barriers (five a candidate, four a feature
// batch) and the latency of each batch's staging; at S = 1,404 (the
// instanced card scene) the candidate stage's slab tests and warp
// reductions are two fifths of the launch.  What the design does about the
// one-thread-a-ray kernel's limits is in traverse_common.cuh: tile values
// from shared memory rather than dependent L2 loads, the next candidate's
// boxes loading while the current ones are tested, padding chunks skipped,
// lanes busy on (ray, chunk) pairs rather than idle behind other lanes'
// chunks, no torch ops for the lists.  Left for later there too:
// persistent blocks, TMA, a ray sort on the card.
//
// Numerics: the slab and Moller-Trumbore tests are those of
// traverse_common.cuh (shared with khit_traverse.cu), which match the
// plain version bit for bit.  With bit-equal t, the first triangle found
// in walk order wins.

#include <type_traits>

#include "traverse_common.cuh"

namespace {

using namespace imba;

// Four resident blocks an SM give ptxas a budget of 128 registers.
template <bool OCCL, bool INST, class W>
__global__ void __launch_bounds__(kBlk, 4)
stream_traverse_kernel(const float* __restrict__ rays,
                       const float* __restrict__ sbox,
                       const float* __restrict__ tiles,
                       const int* __restrict__ tile_idx,
                       const int* __restrict__ inst_of,
                       const float* __restrict__ itab,
                       float* __restrict__ out, int num_s,
                       unsigned long long* __restrict__ glist,
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
  using P = typename std::conditional<OCCL, Any, Closest>::type;
  P pol(ray.tmax);
  block_walk<INST>(ray, pol, list, count, sm.cand, sm.feat, sbox, tiles,
                   tile_idx, inst_of, itab, work);

  work.flush(work_out);
  write_hit<OCCL>(pol, out + (size_t)r * 8);
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const int*, const int*, const float*, float*, int,
                          unsigned long long*, const int*,
                          unsigned long long*);

template <bool OCCL, bool INST>
KernelFn pick(bool work) {
  return work ? stream_traverse_kernel<OCCL, INST, Work>
              : stream_traverse_kernel<OCCL, INST, NoWork>;
}

KernelFn kernel_for(int occl, bool inst, bool work) {
  return occl ? (inst ? pick<true, true>(work) : pick<true, false>(work))
              : (inst ? pick<false, true>(work) : pick<false, false>(work));
}

}  // namespace

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue when num_rays is not a multiple of 128, num_s < 1,
// or num_s > kMaxSuper without the list buffers.  Above kMaxSuper it makes
// two launches: the list launch writes each block's sorted list to its row
// of `glist` (num_rays / 128 rows of list_stride(num_s) uint64) and its
// count to `gcount` (num_rays / 128 int32), and the walk launch reads them
// (traverse_common.cuh); at or below it one launch builds each list in
// shared memory and `glist` / `gcount` are not read.  With `work` null it
// launches the renderer's kernels; otherwise the counting instantiations,
// which add their kWorkSlots tallies (traverse_common.cuh) to the
// zero-initialised uint64 array `work`.  With `tile_idx` non-null it
// launches the two-level instanced variant (tile_idx, inst_of: one int32
// per super-chunk; itab: 16 floats per instance).
extern "C" int imba_stream_traverse(const void* rays, const void* sbox,
                                    const void* tiles, const void* tile_idx,
                                    const void* inst_of, const void* itab,
                                    void* out, int num_rays, int num_s,
                                    int occl, void* glist, void* gcount,
                                    void* work, void* stream) {
  if (bad_shape(num_rays, num_s, glist) ||
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
  KernelFn k = kernel_for(occl, tile_idx != nullptr, work != nullptr);
  const size_t smem = block_smem_bytes(num_s);
  const cudaError_t e = prepare(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<blocks, kBlk, smem, s>>>(
      static_cast<const float*>(rays), static_cast<const float*>(sbox),
      static_cast<const float*>(tiles), static_cast<const int*>(tile_idx),
      static_cast<const int*>(inst_of), static_cast<const float*>(itab),
      static_cast<float*>(out), num_s,
      static_cast<unsigned long long*>(glist),
      static_cast<const int*>(gcount),
      static_cast<unsigned long long*>(work));
  return static_cast<int>(cudaGetLastError());
}

// The candidate stage alone (tests and chip_smoke.py; no main path calls
// it): block b of the rays' 128-ray blocks writes its sorted list to
// slist[b, :count] (int32) and skey[b, :count] (float32), rows of num_s,
// and count to scount[b]; above kMaxSuper it sorts the list in its row of
// `glist` (as for imba_stream_traverse).  Entries past the count are left
// as they were.
extern "C" int imba_block_candidates(const void* rays, const void* sbox,
                                     void* slist, void* skey, void* scount,
                                     void* glist, int num_rays, int num_s,
                                     void* stream) {
  if (bad_shape(num_rays, num_s, glist))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_candidates(
      rays, sbox, num_rays, num_s, global_list(num_s) ? glist : nullptr,
      nullptr, slist, skey, scount, nullptr,
      static_cast<cudaStream_t>(stream)));
}

// Resources of the kernel imba_stream_traverse would launch for these
// arguments (traverse_common.cuh resources()); returns a CUDA error code.
extern "C" int imba_stream_resources(int occl, int inst, int work, int num_s,
                                     int* out) {
  return static_cast<int>(resources(kernel_for(occl, inst != 0, work != 0),
                                    num_s, out));
}

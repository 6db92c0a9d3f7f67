// A measuring build beside the port, for scripts/redesign_ab.py's `grid`
// cell: the other place the photon grid's scalars (bbox_min, inv_cell,
// radius_sqr) can be computed once.  The port's grid_keys_kernel
// (imbatracer_torch/csrc/grid_build.cu) computes them in thread 0 of each
// of its blocks into shared memory; here the selection's gather computes
// them in its last block, the first to know the whole box, and the keys
// read them from global memory.  The gather is select_gather_kernel
// (imbatracer_torch/csrc/select.cu) with that tail: each block's box
// atomics fenced, a ticket a block, and the block that takes the last
// ticket reads the box, writes the scalars and resets the ticket for the
// next launch.  The helpers (the order-preserving bits, grid_scalars,
// cell_of) are the port's own, included from its sources, so both designs
// compute the same bits.
//
// Built by scripts/redesign_ab.py with the port's nvcc flags and
// `-I imbatracer_torch/csrc`.

#include <cuda_runtime.h>

#include <cstdint>

namespace sel {
#include "select.cu"
}
namespace grd {
#include "grid_build.cu"
}

namespace {

constexpr int kBlk = 256;
constexpr int kWords = 6;            // float4 words a packed row
constexpr int kPadKey = 1 << 25;     // ops/merge.py PAD_KEY

__global__ void __launch_bounds__(kBlk)
    gather_last_block_kernel(const float4* rec, const int64_t* order1,
                             const int64_t* order2, int64_t kept,
                             int64_t rows, float4* out, unsigned* box,
                             float4* pos, const int* count,
                             const float* radius, float* scal,
                             unsigned* ticket) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t i = w / kWords;
  unsigned lo[3] = {0u, 0u, 0u}, hi[3] = {0u, 0u, 0u};
  if (i < rows) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < kept) {
      int64_t r = order2[i];
      if (order1) r = order1[r];
      v = rec[r * kWords + w % kWords];
      if (w % kWords == 0) {
        const float p[3] = {v.x, v.y, v.z};
        for (int k = 0; k < 3; ++k) {
          hi[k] = sel::ordered(p[k]);
          lo[k] = ~hi[k];
        }
      }
    }
    out[w] = v;
    if (w % kWords == 0) pos[i] = make_float4(v.x, v.y, v.z, 0.f);
  }
  __shared__ unsigned part[kBlk / 32][6];
  __shared__ bool last;
  for (int k = 0; k < 3; ++k)
    for (int s = 16; s > 0; s >>= 1) {
      lo[k] = max(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], s));
      hi[k] = max(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], s));
    }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0)
    for (int k = 0; k < 3; ++k) {
      part[warp][k] = lo[k];
      part[warp][3 + k] = hi[k];
    }
  __syncthreads();
  if (threadIdx.x < 6) {
    unsigned m = 0u;
    for (int j = 0; j < kBlk / 32; ++j) m = max(m, part[j][threadIdx.x]);
    if (m) atomicMax(box + threadIdx.x, m);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  unsigned b[6];
  for (int k = 0; k < 6; ++k) b[k] = atomicOr(box + k, 0u);
  const grd::Scalars s = grd::grid_scalars(b, *count, rows, *radius);
  for (int k = 0; k < 3; ++k) scal[k] = s.bmin[k];
  scal[3] = s.inv_cell;
  scal[4] = s.r2;
  *ticket = 0u;
}

__global__ void __launch_bounds__(kBlk)
    keys_from_scalars_kernel(const float4* pos, const int* count,
                             const float* scal, int64_t rows, int* keys) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= rows) return;
  const float4 p = pos[i];
  if (i >= *count) {
    keys[i] = kPadKey;
    return;
  }
  const float inv = scal[3];
  const int cx = grd::cell_of(p.x, scal[0], inv);
  const int cy = grd::cell_of(p.y, scal[1], inv);
  const int cz = grd::cell_of(p.z, scal[2], inv);
  keys[i] = (cx * 256 + cy) * 256 + cz;
}

}  // namespace

// The gather as imba_select_gather (rows > 0), and scal (5,) f32 the
// grid's scalars for count (0-d i32) photons and radius (0-d f32);
// ticket (1,) u32, zero before the first launch, left zero.  Returns a
// CUDA error.
extern "C" int imba_ab_gather_last_block(const void* rec, const void* order1,
                                         const void* order2, int64_t kept,
                                         int64_t rows, void* out, void* box,
                                         void* pos, const void* count,
                                         const void* radius, void* scal,
                                         void* ticket, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(box, 0, 6 * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n = rows * kWords;
  gather_last_block_kernel<<<static_cast<unsigned>((n + kBlk - 1) / kBlk),
                             kBlk, 0, s>>>(
      static_cast<const float4*>(rec), static_cast<const int64_t*>(order1),
      static_cast<const int64_t*>(order2), kept, rows,
      static_cast<float4*>(out), static_cast<unsigned*>(box),
      static_cast<float4*>(pos), static_cast<const int*>(count),
      static_cast<const float*>(radius), static_cast<float*>(scal),
      static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// The keys as imba_grid_keys, from the scalars the gather wrote.
extern "C" int imba_ab_keys_from_scalars(const void* pos, const void* count,
                                         const void* scal, int64_t rows,
                                         void* keys, void* stream) {
  if (rows > 0)
    keys_from_scalars_kernel<<<static_cast<unsigned>((rows + kBlk - 1) /
                                                     kBlk),
                               kBlk, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(pos), static_cast<const int*>(count),
        static_cast<const float*>(scal), rows, static_cast<int*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// The light band's tail, for NVIDIA Hopper (sm_90a).
//
// No Pallas kernel stands behind this file: it is the card's counterpart
// of two XLA ops of JAX's compiled light band (imbatracer_tpu/render/
// integrators/vcm.py `_vcm_light_band` :1078), which run once a band
// after its bounces:
//
//   collect_append_kernel  imbatracer_tpu/render/light_cache.py
//                          append_packed (:109-150): the band's staged
//                          (N, 24) vertex rows scattered after the
//                          cache's rows, slot count + (valid rows before
//                          it), the rows past the capacity dropped
//                          (`mode="drop"`); then collect_tail_kernel, one
//                          thread, moves the count and adds the rows that
//                          did not fit to `lost`;
//   splat_kernel           imbatracer_tpu/render/film.py splat (:15-23):
//                          the segment_sum of the camera connections into
//                          the film, pixel < 0 dropped (its trash
//                          segment).
//
// Only the valid rows write: an invalid row, a row past the capacity or
// a splat with no pixel reads its flag and stops.  The append reads the
// cache's count through a pointer before any thread writes it: the tail
// is a second launch on the same stream, so no thread of the first reads
// a count the tail has moved.  The count, the capacity of the buffer the
// graph holds and the band's rows are all the append needs, so both run
// inside the captured light graph.
//
// What bounds them: bytes.  The append reads a row's flag and prefix
// (5 B) and copies the valid rows, 96 B each, as six 16-byte words, one
// thread a word: neighbouring threads read and write neighbouring words
// (the valid rows of a band land in consecutive cache rows).  The splat
// reads a row's pixel (4 B) and, where it has one, its 12 B contribution
// and adds it with three atomics.
//
// Numerics: the append copies bits.  The splat adds in the atomics'
// order, as index_add_ on the card does: sums agree within rounding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlk = 256;
constexpr int kRecW = 24;                 // render/light_cache.py REC_W
constexpr int kWords = kRecW / 4;         // float4 words a row

__global__ void collect_append_kernel(const float4* rows,
                                      const uint8_t* valid,
                                      const int* incl, const int* count,
                                      int cap, int64_t n, float4* rec) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (w >= n * kWords) return;
  const int64_t k = w / kWords;
  if (!valid[k]) return;
  const int slot = *count + incl[k] - 1;
  if (slot >= cap) return;
  rec[static_cast<int64_t>(slot) * kWords + w % kWords] = rows[w];
}

__global__ void collect_tail_kernel(const int* incl, int64_t n, int cap,
                                    int* count, int* lost) {
  const int total = *count + (n > 0 ? incl[n - 1] : 0);
  *lost += max(total - cap, 0);
  *count = min(total, cap);
}

__global__ void splat_kernel(const float* contrib, const int* pixel,
                             int64_t n, int num_pixels, float* film) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= n) return;
  const int p = pixel[k];
  if (p < 0 || p >= num_pixels) return;
  for (int c = 0; c < 3; ++c)
    atomicAdd(film + 3 * static_cast<int64_t>(p) + c, contrib[3 * k + c]);
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kBlk - 1) / kBlk);
}

}  // namespace

// collect_append_kernel, then collect_tail_kernel, on the current stream:
// rows (n, 24) f32 and rec (cap + 1, 24) f32, both 16-byte aligned;
// valid (n,) bool; incl (n,) i32, the inclusive prefix sum of valid;
// count, lost 0-d i32, updated in place.  Returns a CUDA error.
extern "C" int imba_collect_append(const void* rows, const void* valid,
                                   const void* incl, void* count, void* lost,
                                   int cap, int64_t n, void* rec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    collect_append_kernel<<<blocks_for(n * kWords), kBlk, 0, s>>>(
        static_cast<const float4*>(rows), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(incl), static_cast<const int*>(count), cap,
        n, static_cast<float4*>(rec));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  collect_tail_kernel<<<1, 1, 0, s>>>(static_cast<const int*>(incl), n, cap,
                                      static_cast<int*>(count),
                                      static_cast<int*>(lost));
  return static_cast<int>(cudaGetLastError());
}

// splat_kernel on the current stream: contrib (n, 3) f32, pixel (n,) i32,
// film (num_pixels, 3) f32 zeroed by the caller.  Returns a CUDA error.
extern "C" int imba_splat(const void* contrib, const void* pixel, int64_t n,
                          int num_pixels, void* film, void* stream) {
  if (n > 0)
    splat_kernel<<<blocks_for(n), kBlk, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(contrib), static_cast<const int*>(pixel),
        n, num_pixels, static_cast<float*>(film));
  return static_cast<int>(cudaGetLastError());
}

// Resources of kernel `which` (0 collect append, 1 collect tail, 2
// splat): out[0] registers, out[1] static shared bytes, out[2] dynamic
// shared bytes, out[3] local (spill) bytes a thread, out[4] resident
// blocks an SM.  Returns a CUDA error code.
extern "C" int imba_light_tail_resources(int which, int* out) {
  const void* fns[] = {reinterpret_cast<const void*>(collect_append_kernel),
                       reinterpret_cast<const void*>(collect_tail_kernel),
                       reinterpret_cast<const void*>(splat_kernel)};
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fns[which]);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fns[which], which == 1 ? 1 : kBlk, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  return static_cast<int>(cudaSuccess);
}

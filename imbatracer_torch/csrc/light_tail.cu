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
//                          (`mode="drop"`), each row's (path_length,
//                          path_id) pair also written into the cache's
//                          key columns (JAX's own int32 columns, :38-39);
//                          the count moved and the rows that did not fit
//                          added to `lost`, all in one launch;
//   splat_kernel           imbatracer_tpu/render/film.py splat (:15-23):
//                          the segment_sum of the camera connections into
//                          the film, pixel < 0 dropped (its trash
//                          segment).
//
// The count, the capacity of the buffer the graph holds and the band's
// rows are all the append needs, so both run inside the captured light
// graph.
//
// What bounds them: bytes.  The append reads each staged row's flag (1
// B) and copies the valid rows that fit, 96 B in and 96 B out, plus 8 B
// of key pair out.  The splat reads a row's pixel (4 B) and, where it
// has one, its 12 B contribution and adds it with three atomics.
//
// The append (redesigned for Hopper) was five launches a band: the
// flags' cast and the library's two scan kernels (torch.cumsum), a copy
// of a thread a 16-byte word of every staged row, ~69% of whose threads
// read a flag and stopped while each of a valid row's six re-read its
// flag and prefix, and a one-thread tail.  It is now one launch, an
// ordered compaction in a single pass (csrc/lookback.cuh): a tile's
// valid rows are listed in shared memory in order, then the block moves
// them as 16-byte words, neighbouring threads on neighbouring words of
// consecutive slots, so each row's three sectors are read whole and the
// stores coalesce (collect_append_kernel's note).
//
// Numerics: the append copies bits.  The splat adds in the atomics'
// order, as index_add_ on the card does: sums agree within rounding.

#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace {

constexpr int kBlk = 256;
constexpr int kRecW = 24;                 // render/light_cache.py REC_W
constexpr int kWords = kRecW / 4;         // float4 words a row
constexpr int kColLength = 21;            // path_length (int32 bits)
constexpr int kColId = 22;                // path_id (int32 bits)
constexpr int kKeyWord = kColLength / 4;  // the word holding both
constexpr int kCopyUnroll = 4;            // words a thread has in flight
constexpr int kMaxTiles = 8192;  // ops/light_tail.py APPEND_MAX_ROWS / 4096

static_assert(kColId / 4 == kKeyWord && kColLength % 4 == 1,
              "the key pair is a word's .y and .z");

// The append's tiles meet in status words, one a tile (lookback.cuh's
// protocol); append_ticket hands out the blocks' tickets in the order
// they start; append_done counts the blocks done.  The last block done
// puts all of it back to 0, so no launch clears them.  One append at a
// time a device: the light bands' appends are ordered on one stream, in
// and out of the light graph (the graph's warm-up runs on a side stream
// that waits for the current one and is waited for), and each process
// has its own copy of these words.
__device__ unsigned long long append_status[kMaxTiles];
__device__ unsigned int append_ticket = 0u;
__device__ unsigned int append_done = 0u;

// The collect append in one launch: a grid of `tiles` blocks of 4,096
// staged rows.  Each block takes a ticket as it starts and reads the
// cache's count; its threads load 16 valid flags each, and the block
// finds the valid rows before its tile by decoupled look-back
// (lookback::scan_tile), lists its own in order in shared memory, and
// moves those that fit (slot count + before + rank < cap) as 16-byte
// words, kCopyUnroll a thread in flight: the thread that moves a row's
// word kKeyWord also writes its (path_length, path_id) into keys[slot].
// The count is both an input and an output (which is why the earlier
// design had a tail launch): every block reads it before it counts
// itself done, and only the last block done, which the done counter
// names, writes count = min(count + total, cap) and adds max(count +
// total - cap, 0) to lost, then resets the status words, the ticket and
// the counter, so a graph replays the kernel.
__global__ void __launch_bounds__(lookback::kThreads)
    collect_append_kernel(const float4* rows, const uint8_t* valid,
                          int64_t n, int tiles, int cap, int* count,
                          int* lost, float4* rec, int2* keys) {
  using lookback::kFlags;
  using lookback::kThreads;
  __shared__ int ticket_s, count_s, last_s, total_s;
  __shared__ int scratch[lookback::kWarps + 2];
  __shared__ unsigned short list_s[lookback::kTile];
  const int t = threadIdx.x;
  if (t == 0) {
    ticket_s = static_cast<int>(atomicAdd(&append_ticket, 1u));
    count_s = *count;
  }
  __syncthreads();
  const int tile = ticket_s;
  const int64_t base = static_cast<int64_t>(tile) * lookback::kTile;
  const unsigned bits = lookback::load_flags(
      valid, base + static_cast<int64_t>(t) * kFlags, n);
  const lookback::TileScan scan = lookback::scan_tile(
      append_status, tile, __popc(bits), scratch, [](int, int) {});
  int k = scan.offset;
  for (unsigned b = bits; b; b &= b - 1)
    list_s[k++] = static_cast<unsigned short>(t * kFlags + __ffs(b) - 1);
  __syncthreads();
  const int64_t slot0 = static_cast<int64_t>(count_s) + scan.before;
  const int64_t room = cap - slot0;
  const int fit = room <= 0 ? 0 : room < scan.agg ? static_cast<int>(room)
                                                  : scan.agg;
  const int words = fit * kWords;
  for (int w0 = t; w0 < words; w0 += kThreads * kCopyUnroll) {
    float4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int w = w0 + u * kThreads;
      if (w < words) {
        const int r = w / kWords;
        v[u] = __ldcs(rows + (base + list_s[r]) * kWords + (w - r * kWords));
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int w = w0 + u * kThreads;
      if (w < words) {
        const int r = w / kWords, q = w - r * kWords;
        __stcs(rec + (slot0 + r) * kWords + q, v[u]);
        if (q == kKeyWord)
          keys[slot0 + r] = make_int2(__float_as_int(v[u].y),
                                      __float_as_int(v[u].z));
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last_s = atomicAdd(&append_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  if (t == 0) {
    __threadfence();
    total_s = static_cast<int>(
        lookback::load_word(&append_status[tiles - 1]) & 0xffffffffull);
  }
  __syncthreads();
  for (int i = t; i < tiles; i += kThreads) append_status[i] = 0ull;
  if (t == 0) {
    const int64_t total = static_cast<int64_t>(count_s) + total_s;
    *count = total < cap ? static_cast<int>(total) : cap;
    if (total > cap) *lost += static_cast<int>(total - cap);
    append_ticket = 0u;
    append_done = 0u;
  }
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

// collect_append_kernel on the current stream, one launch: rows (n, 24)
// f32 and rec (cap + 1, 24) f32, both 16-byte aligned; valid (n,) bool;
// keys (cap + 1, 2) i32; count, lost 0-d i32, updated in place.
// Returns a CUDA error (cudaErrorInvalidValue past kMaxTiles tiles).
extern "C" int imba_collect_append(const void* rows, const void* valid,
                                   int64_t n, void* count, void* lost,
                                   int cap, void* rec, void* keys,
                                   void* stream) {
  const int64_t tiles =
      n > 0 ? (n + lookback::kTile - 1) / lookback::kTile : 1;
  if (n < 0 || tiles > kMaxTiles || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  collect_append_kernel<<<static_cast<unsigned>(tiles), lookback::kThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const uint8_t*>(valid),
      n, static_cast<int>(tiles), cap, static_cast<int*>(count),
      static_cast<int*>(lost), static_cast<float4*>(rec),
      static_cast<int2*>(keys));
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

// Resources of kernel `which` (0 collect append, 1 splat): out[0]
// registers, out[1] static shared bytes, out[2] dynamic shared bytes,
// out[3] local (spill) bytes a thread, out[4] resident blocks an SM.
// Returns a CUDA error code.
extern "C" int imba_light_tail_resources(int which, int* out) {
  const void* fns[] = {reinterpret_cast<const void*>(collect_append_kernel),
                       reinterpret_cast<const void*>(splat_kernel)};
  if (which < 0 || which > 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fns[which]);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fns[which], which == 0 ? lookback::kThreads : kBlk, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  return static_cast<int>(cudaSuccess);
}

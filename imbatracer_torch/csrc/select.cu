// The VCM frame's collect selection and canonical order, for NVIDIA
// Hopper (sm_90a).
//
// No Pallas kernel stands behind this file: it is the card's counterpart
// of two jitted XLA programs that JAX runs once a frame, between the
// light bands and the camera bands (imbatracer_tpu/render/integrators/
// vcm.py:1478-1482):
//
//   select_keys_kernel    the sort keys of imbatracer_tpu/render/
//                         light_cache.py select_shallowest (:165, the
//                         (path_length, path_id) admission key) and
//                         canonicalize (:197, the (path_id, path_length)
//                         layout key), read from (path_length, path_id)
//                         int32 pairs `stride` ints apart: the collect
//                         cache's (C + 1, 2) key columns (stride 2), as
//                         JAX keeps both as columns of their own
//                         (:38-39), or the packed (C, 24) rows at column
//                         21 (stride 24) for a cache without them; over
//                         the valid rows only (the first `n`, or the rows
//                         an order names);
//   select_gather_kernel  their gathers of the kept rows
//                         (`cache.packed()[order]`), both sorts'
//                         permutations composed into one pass: row i <
//                         kept of the output is rec[order1[order2[i]]]
//                         (rec[order2[i]] with no first order), the rows
//                         past it zero, as the gather of a zeroed
//                         cache's invalid rows gives them.  While the
//                         rows pass through, it reduces the kept photons'
//                         box (min and max of pos) and writes their
//                         position column, (rows, 4) f32 (x, y, z, 0;
//                         zero past the kept rows), for the photon grid's
//                         build (csrc/grid_build.cu).
//
// The sorts between them are the library's (torch.sort, stable), as
// lax.sort is JAX's.  A key is exact in either width: 64 bits hold
// (major << 32) + minor for any non-negative int32 pair, 32 bits hold
// (major << bits) | minor when the caller's bounds say both fit.
//
// What bounds them: bytes.  The keys read a valid row's 8 B pair and
// write 4 or 8 B.  The keys (redesigned for Hopper) read the pair from
// the packed rows, where those 8 B sat alone in a 32-byte sector a row,
// so the card read at least 4x the bytes the bound counts; they now read
// the key columns that the collect append writes beside the rows: two
// rows a thread, their pairs one 16-byte load in the admission pass over
// the first n, two 8-byte gathers through the order in the canonical
// pass (select_keys_kernel's note).  The
// gather reads the order entries and the kept rows, 96 B each as six
// 16-byte words, one thread a word, neighbouring threads on neighbouring
// words of one row, and writes the output rows the same way.  The box
// adds a block reduction and six atomics a block.  The thread of a row's
// word 0, which holds pos, also writes the row's 16-byte word of the
// position column: the grid's keys then read 16 B a photon in one
// coalesced load, where from the 96-byte rows each photon's 12 B of pos
// cost two 64-byte DRAM reads (csrc/grid_build.cu).
//
// Numerics: the keys are integers and the gather copies bits.  The box
// is a min and a max, exact in any order; it is kept as order-preserving
// unsigned bits so that atomicMax can take both (the min as the max of
// the complement), and a zeroed slot means no kept photon.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlk = 256;
constexpr int kRecW = 24;                 // render/light_cache.py REC_W
constexpr int kWords = kRecW / 4;         // float4 words a row

// Key modes (ops/select.py SHALLOW, CANONICAL).
constexpr int kShallow = 1;               // (path_length, path_id)
constexpr int kCanonical = 2;             // (path_id, path_length)

// Order-preserving unsigned bits of a float (NaN aside): negative values
// flip every bit, the others only the sign bit.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The (path_length, path_id) pair at p: one 8-byte load where p is
// aligned (the key columns), else two 4-byte loads (a packed row's
// columns 21-22, 4-byte aligned).
__device__ __forceinline__ int2 load_pair(const int* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0)
    return *reinterpret_cast<const int2*>(p);
  return make_int2(p[0], p[1]);
}

template <bool Wide>
__device__ __forceinline__ void put_key(void* keys, int64_t i, int2 pair,
                                        int mode, int bits) {
  const int major = mode == kShallow ? pair.x : pair.y;
  const int minor = mode == kShallow ? pair.y : pair.x;
  if (Wide)
    static_cast<int64_t*>(keys)[i] =
        static_cast<int64_t>(major) * (int64_t{1} << 32) + minor;
  else
    static_cast<int*>(keys)[i] = (major << bits) | minor;
}

// Keys i and i + 1 a thread (i even): row i's pair at pairs + r * stride,
// r = order[i] (r = i without an order).  Over the first n rows of key
// columns (stride 2, a 16-byte aligned base) both pairs are one 16-byte
// load; else each pair is loaded alone (load_pair), through the order
// where one is given.
template <bool Wide>
__global__ void select_keys_kernel(const int* pairs, int64_t stride,
                                   const int64_t* order, int64_t n, int mode,
                                   int bits, void* keys) {
  const int64_t i = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                         threadIdx.x);
  if (i >= n) return;
  const bool two = i + 1 < n;
  int2 a, b = make_int2(0, 0);
  if (!order && stride == 2 && two &&
      (reinterpret_cast<uintptr_t>(pairs) & 15) == 0) {
    const int4 w = *reinterpret_cast<const int4*>(pairs + 2 * i);
    a = make_int2(w.x, w.y);
    b = make_int2(w.z, w.w);
  } else {
    const int64_t r0 = order ? order[i] : i;
    const int64_t r1 = !two ? 0 : order ? order[i + 1] : i + 1;
    a = load_pair(pairs + r0 * stride);
    if (two) b = load_pair(pairs + r1 * stride);
  }
  put_key<Wide>(keys, i, a, mode, bits);
  if (two) put_key<Wide>(keys, i + 1, b, mode, bits);
}

__global__ void select_gather_kernel(const float4* rec, const int64_t* order1,
                                     const int64_t* order2, int64_t kept,
                                     int64_t rows, float4* out,
                                     unsigned* box, float4* pos) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t i = w / kWords;
  // lo / hi: this thread's share of the box (a kept row's word 0 holds
  // its pos); the identity elsewhere.
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
          hi[k] = ordered(p[k]);
          lo[k] = ~hi[k];
        }
      }
    }
    out[w] = v;
    if (w % kWords == 0) pos[i] = make_float4(v.x, v.y, v.z, 0.f);
  }
  // Block reduction: warps by shuffles, then the warps' results in
  // shared memory, then one atomic a slot a block.
  __shared__ unsigned part[kBlk / 32][6];
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
  }
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kBlk - 1) / kBlk);
}

}  // namespace

// select_keys_kernel on the current stream: pairs, (path_length,
// path_id) int32 pairs `stride` ints apart, 4-byte aligned (the key
// columns, stride 2; or a packed (C, 24) row's columns 21-22, stride 24);
// order (n,) i64 or null (row i itself); mode kShallow or kCanonical;
// wide != 0: keys (n,) i64, else keys (n,) i32 with the minor key in the
// low `bits` bits, 16-byte aligned.  Returns a CUDA error.
extern "C" int imba_select_keys(const void* pairs, int64_t stride,
                                const void* order, int64_t n, int mode,
                                int wide, int bits, void* keys,
                                void* stream) {
  if ((mode != kShallow && mode != kCanonical) || stride < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pairs);
  const int64_t* o = static_cast<const int64_t*>(order);
  if (n > 0) {
    const unsigned blocks = blocks_for((n + 1) / 2);
    if (wide)
      select_keys_kernel<true><<<blocks, kBlk, 0, s>>>(p, stride, o, n, mode,
                                                       bits, keys);
    else
      select_keys_kernel<false><<<blocks, kBlk, 0, s>>>(p, stride, o, n,
                                                        mode, bits, keys);
  }
  return static_cast<int>(cudaGetLastError());
}

// select_gather_kernel on the current stream: rec (C, 24) f32 and out
// (rows, 24) f32, both 16-byte aligned; order1 (>= kept,) i64 or null;
// order2 (kept,) i64; box (6,) u32, zeroed here first: slots 0-2 the
// complement of the least ordered bits of pos x, y, z over the kept
// rows, 3-5 the greatest; 0 where no row is kept; pos (rows, 4) f32,
// 16-byte aligned: out's pos and a zero, (0, 0, 0, 0) past the kept
// rows.  Returns a CUDA error.
extern "C" int imba_select_gather(const void* rec, const void* order1,
                                  const void* order2, int64_t kept,
                                  int64_t rows, void* out, void* box,
                                  void* pos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(box, 0, 6 * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (rows > 0)
    select_gather_kernel<<<blocks_for(rows * kWords), kBlk, 0, s>>>(
        static_cast<const float4*>(rec), static_cast<const int64_t*>(order1),
        static_cast<const int64_t*>(order2), kept, rows,
        static_cast<float4*>(out), static_cast<unsigned*>(box),
        static_cast<float4*>(pos));
  return static_cast<int>(cudaGetLastError());
}

// Resources of kernel `which` (0 the 32-bit keys, 1 the 64-bit keys, 2
// the gather): out[0] registers, out[1] static shared bytes, out[2]
// dynamic shared bytes, out[3] local (spill) bytes a thread, out[4]
// resident blocks an SM.  Returns a CUDA error code.
extern "C" int imba_select_resources(int which, int* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(select_keys_kernel<false>),
      reinterpret_cast<const void*>(select_keys_kernel<true>),
      reinterpret_cast<const void*>(select_gather_kernel)};
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fns[which]);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[which],
                                                      kBlk, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  return static_cast<int>(cudaSuccess);
}

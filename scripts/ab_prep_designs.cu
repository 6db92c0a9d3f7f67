// A measuring build beside the port, for scripts/redesign_ab.py's `prep`
// cell: the merge query preparation's other designs.
//
// The rows written in sorted order, staged (imba_ab_rows_sorted).  The
// port's merge_query_rows_kernel (imbatracer_torch/csrc/merge_kernel.cu)
// builds the rows in query order and writes query q's row to row inv[q]
// after an inverse-permutation launch; here a block of 128 sorted rows
// reads perm coalesced, a thread gathers its query's inputs (every load
// issued before any is used), writes its row into shared memory (128
// rows x 160 B = 20 KB), and the block stores its 20 KB of contiguous
// rows as 16-byte words: no inverse.
//
// The sort keys and the inverse at other widths (imba_ab_sort_keys,
// imba_ab_inverse): the port's kernels (one entry a thread) at 1, 2, 4 or
// 8 entries a thread with 16-byte loads and stores, and 64 to 512
// threads a block.
//
// The row (query_row) and the combo keys are the port's, included from
// its source, so every design writes the same bits.  Built by
// scripts/redesign_ab.py with the port's nvcc flags and
// `-I imbatracer_torch/csrc`.

#include <cuda_runtime.h>

#include <cstdint>

namespace mk {
#include "merge_kernel.cu"
}

namespace {

constexpr int kBlk = 128;             // sorted rows a block
constexpr int kWords = mk::kQW / 4;   // 16-byte words a row

__global__ void __launch_bounds__(kBlk)
    rows_sorted_kernel(const long long* __restrict__ perm, mk::QueryCols in,
                       const float* __restrict__ bbox_min,
                       const float* __restrict__ inv_cell, int num_q,
                       float4* __restrict__ qrec) {
  __shared__ float4 tile[kBlk * kWords];
  const int first = blockIdx.x * kBlk;
  const int i = first + threadIdx.x;
  if (i < num_q) {
    const float lo[3] = {bbox_min[0], bbox_min[1], bbox_min[2]};
    float r[mk::kQW];
    mk::query_row(in, (size_t)perm[i], lo, *inv_cell, r);
    float4* s = tile + threadIdx.x * kWords;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      s[j] = make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  }
  __syncthreads();
  const int n = min(kBlk, num_q - first) * kWords;
  float4* o = qrec + (size_t)first * kWords;
  for (int k = threadIdx.x; k < n; k += kBlk) o[k] = tile[k];
}


// The sort keys at kPer (1, 2, 4 or 8) queries a thread and kBlock
// threads a block.  `wide`: qpos 16-byte aligned, active aligned to kPer
// bytes, sort_key to 16 bytes, so a thread's queries are 3 * kPer / 4
// float4 loads (float2 for 2), one load of kPer flags and kPer / 4 int4
// stores (int2 for 2); otherwise (and for a ragged last group) a query at
// a time, as the port's kernel.
template <int kPer, int kBlock>
__global__ void __launch_bounds__(kBlock)
    keys_wide_kernel(const float* __restrict__ qpos,
                     const unsigned char* __restrict__ active,
                     const float* __restrict__ bbox_min,
                     const float* __restrict__ inv_cell, int num_q, int wide,
                     int* __restrict__ sort_key) {
  const int q0 = (blockIdx.x * kBlock + threadIdx.x) * kPer;
  if (q0 >= num_q) return;
  const float ic = *inv_cell;
  // combo key 0 of mk::combo_keys, or 1 << 30 for an inactive query
  auto key_of = [&](const float* p, unsigned f) {
    int k[4];
    mk::combo_keys(p, bbox_min, ic, k);
    return f ? k[0] : 1 << 30;
  };
  if (kPer > 1 && wide && q0 + kPer <= num_q) {
    float p[3 * kPer];
    unsigned f[kPer];
    if constexpr (kPer == 2) {
      const float2* p2 = reinterpret_cast<const float2*>(qpos + 3 * q0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 v = p2[j];
        p[2 * j] = v.x;
        p[2 * j + 1] = v.y;
      }
      const uchar2 a = *reinterpret_cast<const uchar2*>(active + q0);
      f[0] = a.x;
      f[1] = a.y;
    } else {
      const float4* p4 = reinterpret_cast<const float4*>(qpos + 3 * q0);
#pragma unroll
      for (int j = 0; j < 3 * kPer / 4; ++j) {
        const float4 v = p4[j];
        p[4 * j] = v.x;
        p[4 * j + 1] = v.y;
        p[4 * j + 2] = v.z;
        p[4 * j + 3] = v.w;
      }
      const unsigned* a = reinterpret_cast<const unsigned*>(active + q0);
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j) {
        const unsigned w = a[j];
#pragma unroll
        for (int b = 0; b < 4; ++b) f[4 * j + b] = (w >> (8 * b)) & 0xffu;
      }
    }
    int k[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) k[j] = key_of(p + 3 * j, f[j]);
    if constexpr (kPer == 2) {
      *reinterpret_cast<int2*>(sort_key + q0) = make_int2(k[0], k[1]);
    } else {
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j)
        reinterpret_cast<int4*>(sort_key + q0)[j] =
            make_int4(k[4 * j], k[4 * j + 1], k[4 * j + 2], k[4 * j + 3]);
    }
    return;
  }
  for (int q = q0; q < min(q0 + kPer, num_q); ++q)
    sort_key[q] = key_of(qpos + 3 * (size_t)q, active[q]);
}

// The inverse at kPer consecutive permutation entries a thread (16-byte
// loads for 2 or more where `wide`: perm 16-byte aligned) and kBlock
// threads a block.
template <int kPer, int kBlock>
__global__ void __launch_bounds__(kBlock)
    inverse_wide_kernel(const long long* __restrict__ perm, int num_q,
                        int wide, int* __restrict__ inv) {
  const int i0 = (blockIdx.x * kBlock + threadIdx.x) * kPer;
  if (kPer > 1 && wide && i0 + kPer <= num_q) {
    long long q[kPer];
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) {
      const longlong2 v = reinterpret_cast<const longlong2*>(perm + i0)[j];
      q[2 * j] = v.x;
      q[2 * j + 1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) inv[q[j]] = i0 + j;
    return;
  }
  for (int i = i0; i < min(i0 + kPer, num_q); ++i) inv[perm[i]] = i;
}

template <int kPer, int kBlock>
void launch_keys(const float* qpos, const unsigned char* active,
                 const float* bbox_min, const float* inv_cell, int num_q,
                 int* sort_key, cudaStream_t stream) {
  const int wide = reinterpret_cast<uintptr_t>(qpos) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sort_key) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(active) % kPer == 0;
  const int threads = (num_q + kPer - 1) / kPer;
  keys_wide_kernel<kPer, kBlock>
      <<<(threads + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
          qpos, active, bbox_min, inv_cell, num_q, wide, sort_key);
}

template <int kPer, int kBlock>
void launch_inverse(const long long* perm, int num_q, int* inv,
                    cudaStream_t stream) {
  const int wide = reinterpret_cast<uintptr_t>(perm) % 16 == 0;
  const int threads = (num_q + kPer - 1) / kPer;
  inverse_wide_kernel<kPer, kBlock>
      <<<(threads + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
          perm, num_q, wide, inv);
}

// A kernel that does nothing: the floor of a grid of its shape.
__global__ void empty_kernel() {}

}  // namespace

// The widths the keys' and the inverse's entry points take: (entries a
// thread, threads a block).
#define KEY_WIDTHS(X) X(1, 128) X(1, 256) X(1, 512) X(1, 1024) X(2, 128) \
  X(2, 256) X(4, 64) X(4, 128) X(8, 64)
#define INVERSE_WIDTHS(X) X(1, 128) X(1, 256) X(1, 512) X(1, 1024) \
  X(2, 256) X(4, 256)

// The sort keys at `per` queries a thread and `block` threads a block
// (one of KEY_WIDTHS); -1 for another width.
extern "C" int imba_ab_sort_keys(int per, int block, const void* qpos,
                                 const void* active, const void* bbox_min,
                                 const void* inv_cell, int num_q,
                                 void* sort_key, void* stream) {
  const auto* p = static_cast<const float*>(qpos);
  const auto* a = static_cast<const unsigned char*>(active);
  const auto* lo = static_cast<const float*>(bbox_min);
  const auto* ic = static_cast<const float*>(inv_cell);
  auto* k = static_cast<int*>(sort_key);
  auto s = static_cast<cudaStream_t>(stream);
  if (num_q <= 0) return static_cast<int>(cudaGetLastError());
#define LAUNCH(P, B)                                        \
  if (per == P && block == B) {                             \
    launch_keys<P, B>(p, a, lo, ic, num_q, k, s);           \
    return static_cast<int>(cudaGetLastError());            \
  }
  KEY_WIDTHS(LAUNCH)
#undef LAUNCH
  return -1;
}

// The inverse at `per` entries a thread and `block` threads a block (one
// of INVERSE_WIDTHS); -1 for another width.
extern "C" int imba_ab_inverse(int per, int block, const void* perm,
                               int num_q, void* inv, void* stream) {
  const auto* p = static_cast<const long long*>(perm);
  auto* o = static_cast<int*>(inv);
  auto s = static_cast<cudaStream_t>(stream);
  if (num_q <= 0) return static_cast<int>(cudaGetLastError());
#define LAUNCH(P, B)                                  \
  if (per == P && block == B) {                       \
    launch_inverse<P, B>(p, num_q, o, s);             \
    return static_cast<int>(cudaGetLastError());      \
  }
  INVERSE_WIDTHS(LAUNCH)
#undef LAUNCH
  return -1;
}

// The sorted-order rows: qrec (num_q, 40) f32, row i for query perm[i]
// (int64), from the arrays of imba_merge_query_rows.
extern "C" int imba_ab_rows_sorted(
    const void* perm, const void* qpos, const void* normal, const void* gn,
    const void* w_out, const void* kind, const void* kd, const void* ks,
    const void* ns, const void* d_vcm, const void* d_vm, const void* active,
    const void* bbox_min, const void* inv_cell, int num_q, void* qrec,
    void* stream) {
  if (num_q > 0) {
    const mk::QueryCols in{
        static_cast<const float*>(qpos), static_cast<const float*>(normal),
        static_cast<const float*>(gn), static_cast<const float*>(w_out),
        static_cast<const int*>(kind), static_cast<const float*>(kd),
        static_cast<const float*>(ks), static_cast<const float*>(ns),
        static_cast<const float*>(d_vcm), static_cast<const float*>(d_vm),
        static_cast<const unsigned char*>(active)};
    rows_sorted_kernel<<<(num_q + kBlk - 1) / kBlk, kBlk, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(perm), in,
        static_cast<const float*>(bbox_min),
        static_cast<const float*>(inv_cell), num_q,
        static_cast<float4*>(qrec));
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty launch of `blocks` blocks of `threads` threads.
extern "C" int imba_ab_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Single-pass ordered compaction by decoupled look-back, for NVIDIA Hopper
// (sm_90a): the tile scan that slot_gather_kernel (csrc/dispatch.cu) and
// collect_append_kernel (csrc/light_tail.cu) share.
//
// Such a kernel hands its blocks tickets in the order they start (an
// atomicAdd on a counter of its own), and the first tickets are tiles of
// kTile flags.  A thread tests kFlags of them (one 16-byte load where the
// flags are aligned and the tile whole, else a byte at a time), the block
// scans the counts (warp shuffles, then one warp over the warps' sums),
// and its first warp publishes the tile's count in the tile's status
// word at once and finds the set flags before the tile by decoupled
// look-back: 32 earlier tiles' words a step, adding counts back to the
// nearest tile whose word holds a prefix; then it publishes its own
// prefix.  A status word is 0 until its tile has counted, then
// kAggregate | its count, then kPrefix | the set flags up to its end.  A
// tile waits only on tiles of lower tickets, which have started, so no
// order of the blocks on the SMs can deadlock it.  The status words are
// 0 at a launch's start: each kernel's last block done puts them back,
// so one launch at a time a device may use them.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lookback {

// Threads a block, flags a thread (one 16-byte word), flags a tile.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFlags = 16;
constexpr int kTile = kThreads * kFlags;

constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kAggregate = 1ull << 62;

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The set flags of a 4-byte word of bools, one bit a byte.
__device__ __forceinline__ unsigned flag_bits(unsigned x) {
  const unsigned m = __vcmpne4(x, 0u) & 0x01010101u;
  return (m | m >> 7 | m >> 14 | m >> 21) & 0xfu;
}

// Bit j set where p[first + j] is, for j < kFlags and first + j < n.
__device__ __forceinline__ unsigned load_flags(const uint8_t* p,
                                               int64_t first, int64_t n) {
  if (first + kFlags <= n &&
      (reinterpret_cast<uintptr_t>(p + first) & 15) == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + first);
    return flag_bits(w.x) | flag_bits(w.y) << 4 | flag_bits(w.z) << 8 |
           flag_bits(w.w) << 12;
  }
  unsigned bits = 0u;
  for (int j = 0; j < kFlags; ++j)
    if (first + j < n && p[first + j]) bits |= 1u << j;
  return bits;
}

// Called by all 32 lanes of one warp of tile `tile`, whose set flags
// number `agg`: publishes the tile's count, then its prefix, in
// status[tile], and returns (in every lane) the set flags before it.
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         int tile, int agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_word(&status[0], kPrefix | agg);
    return 0;
  }
  if (lane == 0) store_word(&status[tile], kAggregate | agg);
  int before = 0;
  for (int k = tile - 1;; k -= 32) {
    const int j = k - lane;
    unsigned long long s;
    do {
      s = j >= 0 ? load_word(&status[j]) : kPrefix;
    } while (__any_sync(0xffffffffu, s == 0ull));
    const unsigned p = __ballot_sync(0xffffffffu, (s & kPrefix) != 0);
    const int stop = p ? __ffs(p) - 1 : 31;
    before += __reduce_add_sync(
        0xffffffffu, lane <= stop ? static_cast<int>(s & 0xffffffffull) : 0);
    if (p) break;
  }
  if (lane == 0)
    store_word(&status[tile], kPrefix | static_cast<unsigned>(before + agg));
  return before;
}

struct TileScan {
  int before;   // set flags before the tile
  int agg;      // set flags in the tile
  int offset;   // set flags of the tile's threads before this one
};

// The block's scan of tile `tile`: every thread of a kThreads block calls
// it with its count `c` of set flags.  `scratch`: kWarps + 2 ints of
// shared memory.  `found(before, agg)` runs in one thread as soon as the
// look-back ends, before the block's barrier (a kernel's last tile
// publishes its total there without waiting for the block).
template <typename Found>
__device__ __forceinline__ TileScan scan_tile(unsigned long long* status,
                                              int tile, int c, int* scratch,
                                              Found found) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int x = c;                   // inclusive scan over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? scratch[lane] : 0;
    int inc = v;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    const int agg = __shfl_sync(0xffffffffu, inc, kWarps - 1);
    if (lane < kWarps) scratch[lane] = inc - v;
    const int before = look_back(status, tile, agg);
    if (lane == 0) {
      scratch[kWarps] = before;
      scratch[kWarps + 1] = agg;
      found(before, agg);
    }
  }
  __syncthreads();
  return {scratch[kWarps], scratch[kWarps + 1], scratch[warp] + x - c};
}

}  // namespace lookback

// The traversal dispatch glue and the masked re-trace's slot
// bookkeeping, for NVIDIA Hopper (sm_90a).
//
// No Pallas kernel stands behind this file: it is the card's counterpart
// of the XLA fusions around JAX's traversal calls, which run inside its
// compiled band programs.  Four kernels, one thread a lane or a row (two
// threads a row for the rows, below):
//
//   dispatch_keys_kernel   imbatracer_tpu/ops/pallas_stream.py::sort_keys
//                          (:619): a lane's int32 sort key, direction
//                          octant major, Morton code of the quantised,
//                          recentred origin minor, 2^30 where inactive;
//   dispatch_rows_kernel   _sorted_dispatch's gathers (:698) and _rays8t
//                          (:751): the (R_pad, 8) ray rows in sorted
//                          order, [o - center, tmin', d, tmax'];
//   khit_resolve_kernel    the khit while loop's body
//                          (imbatracer_tpu/render/traverse.py:360-384):
//                          a sorted (R, 32) khit row's K = 4 hits alpha-
//                          tested, the first opaque one taken, the lane's
//                          need flag, tcur and hit written in place;
//   stream_resolve_kernel  closest_hit_stream / any_hit_stream's decode
//                          (pallas_stream.py:769-790) and the one-layer
//                          re-trace's body (traverse.py:276-297): a sorted
//                          (R, 8) stream row decoded into its lane's hit or
//                          occlusion flag, in re-trace mode selected by the
//                          lane's re-trace flag and alpha-tested.
//
// and two more around the WHILE node of the graph-ready re-trace
// (imbatracer_torch/render/traverse.py), the counterpart of the while
// loop's carry in JAX (traverse.py:276-297, :360-384), which XLA fuses
// into the loop body: JAX's rounds run at full width, the port's past
// the first on `slots` lanes, the first lanes in need in lane order:
//
//   slot_gather_kernel     the slots selected and their state after the
//                          first round, in one launch: each slot's lane
//                          (torch.nonzero_static's, 0 past the count), the
//                          valid flags (slot < the lanes in need), the
//                          loop's need flags, each slot's lane's tcur and
//                          hit, the lanes in need and those past the
//                          slots;
//   slot_finish_kernel     a grid over the SMs, after the loop: each valid
//                          slot's hit written into its lane of the
//                          dispatch's hit, in place (the bodies' carry
//                          select of the hits, :288-293, :371-376); the
//                          lanes still unresolved and those past the slots
//                          added to the overflow counter, and the
//                          dispatch's device counts (an empty dispatch,
//                          its rounds, the lanes carried past the first
//                          round, dropped, capped, and the counts the
//                          loop's body ticks a run, times the runs).
//
// Indexing (the plain versions' in imbatracer_torch/ops/dispatch.py):
// sorted row j holds slot s = perm[j] (perm null: s = j) of the dispatch;
// slot s is lane lanes[s] of the ray arrays (lanes null: the lane is s);
// the state a dispatch reads and writes (active / need flags, tcur, the
// hit) is indexed by the lane when `by_lane` is set, else by the slot.
// Ray arrays are read by lane: org, d (R, 3) f32, tmin, tmax (R,) f32 at
// a stride of 0 (one value broadcast) or 1.  Every frame-varying value
// is read through a pointer, so each kernel runs inside a captured graph
// and a WHILE node's body.
//
// What bounds them: bytes.  A lane's key reads 24 B of rays and writes
// 4; a row reads its ~40 B of lane arrays through perm and writes 32 B;
// a khit resolve reads a 128 B row and up to K mask-record rows (40 B)
// and texels, and writes up to 21 B at its lane; a stream resolve reads
// 32 B and writes up to 14.  The design is the plain one: coalesced reads
// and writes of the sorted rows, scattered reads and writes at the lane;
// but the rows (redesigned for Hopper): a row's reads sit behind two or
// three dependent scattered loads (perm -> lanes -> its words), so each
// thread writes half a row as one float4 and keeps two rows' chains in
// flight (dispatch_rows_kernel's note).
// A slot gather reads every lane's need flag and a valid slot's lane's
// 16-20 B, and writes 26-30 B a slot; the finish reads every active flag
// and every slot's two flags, and a valid slot's 24 B (its lane and hit),
// and writes its lane's 16.  The slot gather (redesigned for Hopper) was the last of
// a chain of launches: torch.nonzero_static's, a sum of the flags, then
// a slot a thread, each ~1-5 us of launch against a bound of ~0.1 us; it
// is now one launch, an ordered compaction in a single pass whose tiles
// find their offsets by decoupled look-back (slot_gather_kernel's note).
// The finish (redesigned for Hopper) was one block of 1,024 threads on
// one SM, its 7-8 us latency against a 0.08 us bound; it is now a grid of
// up to one block an SM, 16-byte words a thread, whose blocks meet in one
// atomic word and whose last block updates the counts a thread each
// (slot_finish_kernel's note); it adds the counts of the re-trace loop's
// body (n x (rounds - 1) a count) that one-element adds made each round;
// and its walk over the slots also merges their hits, which a kernel of
// its own did after it in one more launch at the floor of a launch in a
// graph (~1-2 us for a body that mostly writes nothing).
//
// Numerics: the plain versions' torch ops on the card, as shading.cuh
// sets out; built with --fmad=false.

#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"
#include "shading.cuh"

namespace {

using namespace shade;

constexpr int kBlk = 128;
constexpr int kK = 4;                  // ops/khit.py K
// dispatch_rows_kernel's geometry: threads a block (two a row), rows a
// thread, the rows a block covers in one pass (kRowPass apart) and in all.
constexpr int kRowThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr int kRowPass = kRowThreads / 2;
constexpr int kRowTile = kRowPass * kRowsPerThread;
constexpr int kDeadKey = 1 << 30;

// Sorted row / slot -> slot, lane and state index.
struct Map {
  const int64_t* perm;    // (n,) or null
  const int64_t* lanes;   // (n,) or null
  int by_lane;
  int n;
};

struct Where {
  int64_t slot, lane, state;
};

__device__ __forceinline__ Where where_slot(const Map& m, int64_t s) {
  const int64_t lane = m.lanes ? m.lanes[s] : s;
  return {s, lane, m.by_lane ? lane : s};
}

__device__ __forceinline__ Where where_row(const Map& m, int64_t j) {
  return where_slot(m, m.perm ? m.perm[j] : j);
}

// The ray arrays of a dispatch.
struct Rays {
  const float* org;       // (R, 3)
  const float* d;         // (R, 3)
  const float* center;    // (3,) or null: origins used as they are
  const float* tmin;      // (R,) at tmin_stride
  const float* tmax;      // (R,) at tmax_stride
  int tmin_stride, tmax_stride;
  const uint8_t* active;  // by state index, or null: every slot active
  const float* tcur;      // by state index, or null: tmin' = tmin
  int step;               // tmin' = tcur + 1e-3 * max(tcur, 1e-3)
};

// The alpha test of a masked dispatch: the mask record with the atlas's
// texels, or opaque flags by sorted row (K a row for khit).
struct Alpha {
  const float* mask_rec;  // (P, 10) or null
  int mask_rows;
  Atlas at;
  const uint8_t* flags;   // or null
};

__device__ __forceinline__ bool opaque(const Alpha& a, int64_t flag, int id,
                                       float u, float v) {
  if (a.flags) return a.flags[flag] != 0;
  const int p = min(max(id, 0), a.mask_rows - 1);
  return mask_opaque(a.mask_rec + 10 * static_cast<int64_t>(p), a.at, u, v);
}

// t + 1e-3 * clamp(t, min=1e-3): the re-trace's next tmin.
__device__ __forceinline__ float past(float t) {
  return t + F(1e-3) * clamp_min(t, F(1e-3));
}

__device__ __forceinline__ int part1by2(int x) {
  x &= 0xFF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

__global__ void dispatch_keys_kernel(Rays r, Map m, const float* bounds,
                                     int* keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m.n) return;
  const Where w = where_slot(m, i);
  if (r.active && !r.active[w.state]) {
    keys[i] = kDeadKey;
    return;
  }
  int q[3];
  for (int a = 0; a < 3; ++a) {
    float o = r.org[3 * w.lane + a];
    if (r.center) o = o - r.center[a];
    const float lo = bounds[a];
    const float span = clamp_min(bounds[3 + a] - lo, F(1e-6));
    const float x = clamp(((o - lo) / span) * 256.0f, 0.0f, 255.0f);
    q[a] = static_cast<int>(x);
  }
  const int morton = (part1by2(q[0]) << 2) | (part1by2(q[1]) << 1) |
                     part1by2(q[2]);
  const float* d = r.d + 3 * w.lane;
  const int octant = (d[0] < 0.0f) + 2 * (d[1] < 0.0f) + 4 * (d[2] < 0.0f);
  keys[i] = (octant << 24) | morton;
}

// dispatch_rows_kernel: two threads a row, each writing one 16-byte half
// of it as one float4 store -- [o - center, tmin'] or [d, tmax'] -- so a
// warp stores 16 whole rows, 512 contiguous bytes, and a row is one
// 32-byte sector.  A thread takes kRowsPerThread rows kRowPass apart and
// issues each step's loads for all of them before it uses any: the slots
// (perm, read coalesced), then the lanes, then the row's words, so a
// thread keeps that many dependent chains in flight.  Both halves of a
// row read its active flag and tcur; the center is read once a thread.
__global__ void __launch_bounds__(kRowThreads)
    dispatch_rows_kernel(Rays r, Map m, float4* __restrict__ out,
                         int n_pad) {
  const int h = threadIdx.x & 1;
  const int first = blockIdx.x * kRowTile + (threadIdx.x >> 1);
  const float* __restrict__ xyz = h ? r.d : r.org;
  const float* __restrict__ lim = h ? r.tmax : r.tmin;
  const int stride = h ? r.tmax_stride : r.tmin_stride;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  const bool recentre = !h && r.center;
  if (recentre) {
    cx = r.center[0];
    cy = r.center[1];
    cz = r.center[2];
  }
  int64_t slot[kRowsPerThread], lane[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int j = first + k * kRowPass;
    slot[k] = j < m.n ? (m.perm ? m.perm[j] : j) : 0;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int j = first + k * kRowPass;
    lane[k] = j < m.n && m.lanes ? m.lanes[slot[k]] : slot[k];
  }
  float v[kRowsPerThread][4];
  bool act[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int j = first + k * kRowPass;
    if (j >= m.n) continue;
    const int64_t state = m.by_lane ? lane[k] : slot[k];
    const float* p = xyz + 3 * lane[k];
    v[k][0] = p[0];
    v[k][1] = p[1];
    v[k][2] = p[2];
    v[k][3] = lim[lane[k] * stride];
    act[k] = !r.active || r.active[state];
    if (!h && r.tcur) {
      const float c = r.tcur[state];
      if (act[k]) v[k][3] = r.step ? past(c) : c;
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int j = first + k * kRowPass;
    if (j >= n_pad) continue;
    float4 q;
    if (j >= m.n) {
      q = make_float4(0.f, 0.f, 0.f, h ? -1.0f : 0.f);
    } else if (h) {
      q = make_float4(v[k][0], v[k][1], v[k][2], act[k] ? v[k][3] : -1.0f);
    } else if (recentre) {
      q = make_float4(v[k][0] - cx, v[k][1] - cy, v[k][2] - cz, v[k][3]);
    } else {
      q = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    }
    out[2 * static_cast<int64_t>(j) + h] = q;
  }
}

struct HitOut {
  float* t;
  int* id;
  float* u;
  float* v;
};

__global__ void khit_resolve_kernel(const float* rows, Map m,
                                    const uint8_t* need_in, uint8_t* need_out,
                                    float* tcur, HitOut hit, Alpha a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m.n) return;
  const Where w = where_row(m, j);
  if (need_in && !need_in[w.state]) {
    need_out[w.state] = 0;
    return;
  }
  const float* row = rows + 8 * kK * static_cast<int64_t>(j);
  bool found = false;
  for (int k = 0; k < kK && !found; ++k) {
    const float* h = row + 8 * k;
    const int id = static_cast<int>(h[3]);
    if (id >= 0 && opaque(a, static_cast<int64_t>(kK) * j + k, id, h[1], h[2])) {
      hit.t[w.state] = h[0];
      hit.u[w.state] = h[1];
      hit.v[w.state] = h[2];
      hit.id[w.state] = id;
      found = true;
    }
  }
  const float* last = row + 8 * (kK - 1);
  const bool exhausted = !found && static_cast<int>(last[3]) >= 0;
  need_out[w.state] = exhausted;
  if (exhausted) tcur[w.state] = past(last[0]);
}

enum { MODE_CLOSEST, MODE_OCCLUSION, MODE_RETRACE };

__global__ void stream_resolve_kernel(const float* rows, Map m, int mode,
                                      int select, const uint8_t* retrace_in,
                                      uint8_t* out_flag, HitOut hit, Alpha a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m.n) return;
  const Where w = where_row(m, j);
  const float* row = rows + 8 * static_cast<int64_t>(j);
  if (mode == MODE_OCCLUSION) {
    out_flag[w.state] = row[0] > 0.0f;
    return;
  }
  const bool sel = mode != MODE_RETRACE || !retrace_in || retrace_in[w.state];
  if (select && !sel) {
    out_flag[w.state] = 0;
    return;
  }
  const int id = static_cast<int>(row[3]);
  hit.t[w.state] = id >= 0 ? row[0] : F(kBig);
  hit.id[w.state] = id;
  hit.u[w.state] = row[1];
  hit.v[w.state] = row[2];
  if (mode == MODE_RETRACE)
    out_flag[w.state] = sel && id >= 0 && !opaque(a, j, id, row[1], row[2]);
}

struct HitIn {
  const float* t;
  const int* id;
  const float* u;
  const float* v;
};

// slot_gather_kernel's geometry: the tiles of csrc/lookback.cuh (256
// threads, 16 lanes a thread, 4,096 lanes a tile), the slots a fill block
// writes, and the most tiles (2^25 lanes).
constexpr int kSelThreads = lookback::kThreads;
constexpr int kFillSlots = 4096;
constexpr int kSelMaxTiles = 8192;   // ops/dispatch.py SLOT_MAX_LANES / 4096

// The selection's tiles meet in status words, one a tile
// (lookback.cuh's protocol).  sel_total is kPrefix | the lanes in need
// once the last tile knows them; sel_ticket hands out the blocks'
// tickets in the order they start; sel_done counts the blocks done.  The
// last block done puts all of it back to 0, so no launch clears them: a
// selection's launches are ordered on its stream, in and out of a graph,
// one at a time a device.
__device__ unsigned long long sel_status[kSelMaxTiles];
__device__ unsigned long long sel_total = 0ull;
__device__ unsigned int sel_ticket = 0u;
__device__ unsigned int sel_done = 0u;

struct SlotOut {
  int64_t* idx;
  uint8_t* valid;
  uint8_t* need;
  float* tcur;        // or null
  HitOut hit;
  int* count;
  int* dropped;
};

// The slots of the lanes in need (torch.nonzero_static(need, size=slots,
// fill_value=0)) and their state, in one launch: an ordered compaction in
// a single pass (csrc/lookback.cuh).  Each block takes a ticket as it
// starts.  The first `tiles` tickets are tiles of 4,096 lanes, which scan
// their need flags and find the lanes in need before them by decoupled
// look-back (lookback::scan_tile); a tile's lanes in need then write their
// slots, those below `slots`, with the lane's tcur and hit.  The last
// tile writes the count and the dropped lanes.  The tickets past the
// tiles are fill blocks of kFillSlots slots, which wait for the count
// (every tile has started by then) and write the empty slots: lane 0 and
// its state, flags 0.  What bounds it is the launch: the bytes (the flags
// and the slots) take ~0.1-0.6 us on the card.
__global__ void __launch_bounds__(kSelThreads)
    slot_gather_kernel(const uint8_t* need, int64_t num_r, int tiles,
                       int slots, const float* tcur, HitIn hit,
                       SlotOut out) {
  using lookback::kFlags;
  using lookback::kPrefix;
  __shared__ int ticket_s, prefix_s, last_s;
  __shared__ int scratch[lookback::kWarps + 2];
  const int t = threadIdx.x;
  if (t == 0) ticket_s = static_cast<int>(atomicAdd(&sel_ticket, 1u));
  __syncthreads();
  const int ticket = ticket_s;
  if (ticket < tiles) {
    const int64_t first = static_cast<int64_t>(ticket) * lookback::kTile +
                          static_cast<int64_t>(t) * kFlags;
    unsigned bits = lookback::load_flags(need, first, num_r);
    const lookback::TileScan scan = lookback::scan_tile(
        sel_status, ticket, __popc(bits), scratch,
        [&](int before, int agg) {
          if (ticket != tiles - 1) return;
          const int total = before + agg;
          *out.count = total;
          *out.dropped = max(total - slots, 0);
          lookback::store_word(&sel_total,
                               kPrefix | static_cast<unsigned>(total));
        });
    int slot = scan.before + scan.offset;
    while (bits && slot < slots) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1;
      const int64_t l = first + j;
      out.idx[slot] = l;
      out.valid[slot] = 1;
      out.need[slot] = 1;
      if (tcur) out.tcur[slot] = tcur[l];
      out.hit.t[slot] = hit.t[l];
      out.hit.id[slot] = hit.id[l];
      out.hit.u[slot] = hit.u[l];
      out.hit.v[slot] = hit.v[l];
      ++slot;
    }
  } else {
    if (t == 0) {
      unsigned long long w;
      do {
        w = lookback::load_word(&sel_total);
      } while (w == 0ull);
      prefix_s = static_cast<int>(w & 0xffffffffull);
    }
    __syncthreads();
    const int f = ticket - tiles;
    const int end = min(slots, (f + 1) * kFillSlots);
    const int begin = max(prefix_s, f * kFillSlots);
    if (begin < end) {
      const float t0 = tcur ? tcur[0] : 0.0f;
      const float ht = hit.t[0], hu = hit.u[0], hv = hit.v[0];
      const int hid = hit.id[0];
      for (int s = begin + t; s < end; s += kSelThreads) {
        out.idx[s] = 0;
        out.valid[s] = 0;
        out.need[s] = 0;
        if (tcur) out.tcur[s] = t0;
        out.hit.t[s] = ht;
        out.hit.id[s] = hid;
        out.hit.u[s] = hu;
        out.hit.v[s] = hv;
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last_s = atomicAdd(&sel_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last_s) {
    for (int i = t; i < tiles; i += kSelThreads) sel_status[i] = 0ull;
    if (t == 0) {
      sel_total = 0ull;
      sel_ticket = 0u;
      sel_done = 0u;
    }
  }
}

// slot_finish_kernel's geometry: threads a block, and at most one block an
// SM of the card.
constexpr int kFinishThreads = 256;
constexpr int kFinishBlocks = 132;
constexpr int kFinishKeys = 5;   // ops/dispatch.py FINISH_KEYS
constexpr int kMaxDeltas = 16;   // ops/dispatch.py MAX_DELTAS

// The device counts' slots of FINISH_KEYS and whether each is a maximum;
// then the counts a run of the loop's body ticks, (slot, n) each, added
// (rounds - 1) times.
struct CountSlots {
  int slot[kFinishKeys];
  int is_max[kFinishKeys];
  int deltas;
  int delta_slot[kMaxDeltas];
  int delta_n[kMaxDeltas];
};

// The finish's blocks meet in one 64-bit word: the unresolved slots in its
// low 32 bits, the blocks that saw an active flag in the next 16, the
// blocks done in the top 16.  Each block adds its share with one atomic,
// whose old value tells the last block the others' shares.  Zero between
// launches (the last block of each resets it), one launch at a time a
// device: a dispatch's finish launches are ordered on its stream, in and
// out of a graph.
constexpr int kLiveShift = 32;
constexpr int kDoneShift = 48;
__device__ unsigned long long finish_word = 0ull;

// Whether a flag of p[0:n] (bools, 0 or 1 a byte) that this thread reads in
// a grid-stride walk is set, and how many are: 16-byte words where p is
// aligned, else bytes.
template <bool kCount>
__device__ int grid_flags(const uint8_t* p, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const int64_t words = aligned ? n / 16 : 0;
  const uint4* w = reinterpret_cast<const uint4*>(p);
  int c = 0;
  for (int64_t i = first; i < words; i += stride) {
    const uint4 x = w[i];
    c += kCount ? __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w)
                : ((x.x | x.y | x.z | x.w) != 0u);
  }
  for (int64_t i = 16 * words + first; i < n; i += stride) c += p[i] != 0;
  return c;
}

// Write each valid slot's hit into its lane (valid[s]: sub's row s into
// hit's row idx[s]), a slot a thread in a grid-stride walk, so that a
// grid of a thread a slot keeps every valid slot's scattered chain in
// flight at once; `v0` is the flag of the thread's first slot, loaded
// early.  The valid slots' lanes are distinct, so no two threads write
// one lane.
__device__ void merge_slots(uint8_t v0, const uint8_t* valid,
                            const int64_t* idx, int slots, HitIn sub,
                            HitOut hit) {
  const int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < slots;
       s += stride) {
    if (!(s < stride ? v0 : valid[s])) continue;
    const int64_t lane = idx[s];
    hit.t[lane] = sub.t[s];
    hit.id[lane] = sub.id[s];
    hit.u[lane] = sub.u[s];
    hit.v[lane] = sub.v[s];
  }
}

// Each block ORs its share of the active flags (only for the device
// counts, which need whether none is set) and counts its share of the
// unresolved slots, and adds both to finish_word with one atomic; while
// that atomic is in flight, it merges its share of the slots' hits
// (merge_slots, the first slot's flag loaded with the flags: the merge
// writes neither a flag nor the word, so it needs no ordering against
// the rest).  The last block, which the atomic's old
// value names and hands every other block's share, updates the counts a
// thread each, with atomics, so that none waits on another: the loop's
// per-run counts (rounds - 1) times, the FINISH_KEYS and the overflow
// counter (no slot is both a maximum and another count's:
// ops/dispatch.py checks).
__global__ void __launch_bounds__(kFinishThreads)
    slot_finish_kernel(const uint8_t* active, int64_t num_r,
                       const uint8_t* unresolved, int slots,
                       const int* count, const int* dropped,
                       const int* rounds, int* overflow, int* counts,
                       CountSlots cs, const uint8_t* valid,
                       const int64_t* idx, HitIn sub, HitOut hit) {
  __shared__ int block_left;
  __shared__ unsigned long long total;
  const int t = threadIdx.x;
  if (t < 32) {                  // what the counts read, in flight early
    asm volatile("prefetch.global.L1 [%0];" ::"l"(rounds));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(count));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(dropped));
  }
  if (t == 0) block_left = 0;
  const int first = blockIdx.x * blockDim.x + t;
  const uint8_t v0 = first < slots ? valid[first] : 0;
  const int mine = grid_flags<true>(unresolved, slots);
  const int any =
      __syncthreads_or(counts ? grid_flags<false>(active, num_r) : 0);
  const int w = __reduce_add_sync(0xffffffffu, mine);
  if ((t & 31) == 0 && w) atomicAdd(&block_left, w);
  __syncthreads();
  unsigned long long share = 0ull, old = 0ull;
  if (t == 0) {
    share = static_cast<unsigned long long>(block_left) |
            (static_cast<unsigned long long>(any != 0) << kLiveShift) |
            (1ull << kDoneShift);
    old = atomicAdd(&finish_word, share);
  }
  merge_slots(v0, valid, idx, slots, sub, hit);
  if (t == 0)
    total = (old >> kDoneShift) == gridDim.x - 1 ? old + share : 0ull;
  __syncthreads();
  if (total == 0ull) return;     // not the last block (its done count > 0)
  if (t == 0) finish_word = 0ull;
  const int live = static_cast<int>((total >> kLiveShift) & 0xffffu);
  const int left = static_cast<int>(total & 0xffffffffu);
  if (counts && t < cs.deltas) {
    atomicAdd(counts + cs.delta_slot[t], cs.delta_n[t] * (*rounds - 1));
  } else if (counts && t < cs.deltas + kFinishKeys) {
    const int vals[kFinishKeys] = {live == 0, *rounds, *count, *dropped, left};
    const int k = t - cs.deltas;
    int val = vals[0];             // selected, not indexed: no local memory
#pragma unroll
    for (int j = 1; j < kFinishKeys; ++j)
      if (k == j) val = vals[j];
    int* c = counts + cs.slot[k];
    if (cs.is_max[k])
      atomicMax(c, val);
    else
      atomicAdd(c, val);
  } else if (t == kMaxDeltas + kFinishKeys) {
    atomicAdd(overflow, *dropped + left);
  }
}

int blocks_for(int n) { return (n + kBlk - 1) / kBlk; }

Map make_map(const void* perm, const void* lanes, int by_lane, int n) {
  return {static_cast<const int64_t*>(perm), static_cast<const int64_t*>(lanes),
          by_lane, n};
}

// Pointer arguments of the keys and rows launches, in the order of
// ops/dispatch.py RAY_PTRS.
enum RayPtr { R_ORG, R_D, R_CENTER, R_TMIN, R_TMAX, R_ACTIVE, R_TCUR,
              R_PERM, R_LANES, NUM_RAY_PTRS };
// Int arguments: the strides of tmin and tmax, step, by_lane, n.
enum RayInt { R_TMIN_STRIDE, R_TMAX_STRIDE, R_STEP, R_BY_LANE, R_N,
              NUM_RAY_INTS };

Rays make_rays(void* const* p, const int* i) {
  return {static_cast<const float*>(p[R_ORG]), static_cast<const float*>(p[R_D]),
          static_cast<const float*>(p[R_CENTER]),
          static_cast<const float*>(p[R_TMIN]),
          static_cast<const float*>(p[R_TMAX]), i[R_TMIN_STRIDE],
          i[R_TMAX_STRIDE], static_cast<const uint8_t*>(p[R_ACTIVE]),
          static_cast<const float*>(p[R_TCUR]), i[R_STEP]};
}

// Alpha arguments, in the order of ops/dispatch.py ALPHA_PTRS: the mask
// record, the atlas's texels, the flags; then its ints: the record's rows
// and the atlas's texels.
Alpha make_alpha(void* const* p, const int* i) {
  Atlas at = {static_cast<const float*>(p[1]), nullptr, nullptr, nullptr, 0,
              i[1]};
  return {static_cast<const float*>(p[0]), i[0], at,
          static_cast<const uint8_t*>(p[2])};
}

HitOut make_hit(void* const* p) {
  return {static_cast<float*>(p[0]), static_cast<int*>(p[1]),
          static_cast<float*>(p[2]), static_cast<float*>(p[3])};
}

HitIn make_hit_in(void* const* p) {
  return {static_cast<const float*>(p[0]), static_cast<const int*>(p[1]),
          static_cast<const float*>(p[2]), static_cast<const float*>(p[3])};
}

}  // namespace

// dispatch_keys_kernel on the current stream: keys (n,) i32 of the slots
// (perm unused), bounds (6,) f32 [lo.xyz hi.xyz].  Returns a CUDA error.
extern "C" int imba_dispatch_keys(void* const* ptrs, const int* ints,
                                  const void* bounds, void* keys,
                                  void* stream) {
  const Map m = make_map(nullptr, ptrs[R_LANES], ints[R_BY_LANE], ints[R_N]);
  if (m.n > 0)
    dispatch_keys_kernel<<<blocks_for(m.n), kBlk, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        make_rays(ptrs, ints), m, static_cast<const float*>(bounds),
        static_cast<int*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// dispatch_rows_kernel on the current stream: out (n_pad, 8) f32, 16-byte
// aligned.
extern "C" int imba_dispatch_rows(void* const* ptrs, const int* ints,
                                  void* out, int n_pad, void* stream) {
  const Map m = make_map(ptrs[R_PERM], ptrs[R_LANES], ints[R_BY_LANE],
                         ints[R_N]);
  if (n_pad > 0)
    dispatch_rows_kernel<<<(n_pad + kRowTile - 1) / kRowTile, kRowThreads,
                           0, static_cast<cudaStream_t>(stream)>>>(
        make_rays(ptrs, ints), m, static_cast<float4*>(out), n_pad);
  return static_cast<int>(cudaGetLastError());
}

// khit_resolve_kernel on the current stream over the first n rows of
// `rows` (sorted (R_pad, 32) khit rows): map = (perm, lanes), hit = (t,
// id, u, v), alpha = ALPHA_PTRS; ints = (by_lane, n, record rows,
// texels).
extern "C" int imba_khit_resolve(const void* rows, const void* perm,
                                 const void* lanes, const void* need_in,
                                 void* need_out, void* tcur,
                                 void* const* hit, void* const* alpha,
                                 const int* ints, void* stream) {
  const Map m = make_map(perm, lanes, ints[0], ints[1]);
  if (m.n > 0)
    khit_resolve_kernel<<<blocks_for(m.n), kBlk, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), m,
        static_cast<const uint8_t*>(need_in), static_cast<uint8_t*>(need_out),
        static_cast<float*>(tcur), make_hit(hit), make_alpha(alpha, ints + 2));
  return static_cast<int>(cudaGetLastError());
}

// stream_resolve_kernel on the current stream over the first n rows of
// `rows` (sorted (R_pad, 8) stream rows): ints = (by_lane, n, mode,
// select, record rows, texels); out_flag is the occlusion flag or the
// re-trace flag out.
extern "C" int imba_stream_resolve(const void* rows, const void* perm,
                                   const void* lanes, const void* retrace_in,
                                   void* out_flag, void* const* hit,
                                   void* const* alpha, const int* ints,
                                   void* stream) {
  const Map m = make_map(perm, lanes, ints[0], ints[1]);
  if (m.n > 0)
    stream_resolve_kernel<<<blocks_for(m.n), kBlk, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), m, ints[2], ints[3],
        static_cast<const uint8_t*>(retrace_in),
        static_cast<uint8_t*>(out_flag), make_hit(hit),
        make_alpha(alpha, ints + 4));
  return static_cast<int>(cudaGetLastError());
}

// slot_gather_kernel on the current stream: need (R,) bool, the lanes
// in need; tcur (R,) f32 or null, hit = (t, id, u, v) of the R lanes
// (R > 0 where slots > 0); out: idx (slots,) i64, valid, s_need
// (slots,) bool, s_tcur (slots,) f32 (when tcur), s_hit (slots,) each,
// count and dropped 0-d i32.  A grid of the tiles of R, then the fill
// blocks of the slots.  Returns a CUDA error (cudaErrorInvalidValue past
// kSelMaxTiles tiles).
extern "C" int imba_slot_gather(const void* need, int64_t num_r, int slots,
                                const void* tcur, void* const* hit,
                                void* idx, void* valid, void* s_need,
                                void* s_tcur, void* const* s_hit,
                                void* count, void* dropped, void* stream) {
  const int64_t tiles =
      num_r > 0 ? (num_r + lookback::kTile - 1) / lookback::kTile : 1;
  if (tiles > kSelMaxTiles || slots < 0 || (slots > 0 && num_r <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fills = (slots + kFillSlots - 1) / kFillSlots;
  const SlotOut out = {static_cast<int64_t*>(idx),
                       static_cast<uint8_t*>(valid),
                       static_cast<uint8_t*>(s_need),
                       static_cast<float*>(s_tcur), make_hit(s_hit),
                       static_cast<int*>(count), static_cast<int*>(dropped)};
  slot_gather_kernel<<<static_cast<unsigned>(tiles) + fills, kSelThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(need), num_r, static_cast<int>(tiles),
      slots, static_cast<const float*>(tcur), make_hit_in(hit), out);
  return static_cast<int>(cudaGetLastError());
}

// slot_finish_kernel on the current stream, a block a 4,096 bytes of the
// flags it reads or a 256 slots it merges, at most kFinishBlocks: active (num_r,) bool,
// unresolved (slots,) bool; count, dropped, rounds 0-d i32; overflow 0-d
// i32, updated in place; counts the device counts or null, with ints =
// (slot, is_max) of each FINISH_KEYS entry, then the number of per-run
// counts and their (slot, n) pairs (at most kMaxDeltas); valid (slots,)
// bool, idx (slots,) i64 and sub (slots,) each, merged into hit (R,) each
// in place.  Returns a CUDA error.
extern "C" int imba_slot_finish(const void* active, int64_t num_r,
                                const void* unresolved, int slots,
                                const void* count, const void* dropped,
                                const void* rounds, void* overflow,
                                void* counts, const int* ints,
                                const void* valid, const void* idx,
                                void* const* sub, void* const* hit,
                                void* stream) {
  CountSlots cs = {};
  if (counts) {
    for (int k = 0; k < kFinishKeys; ++k) {
      cs.slot[k] = ints[k];
      cs.is_max[k] = ints[kFinishKeys + k];
    }
    cs.deltas = ints[2 * kFinishKeys];
    if (cs.deltas < 0 || cs.deltas > kMaxDeltas)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < cs.deltas; ++k) {
      cs.delta_slot[k] = ints[2 * kFinishKeys + 1 + 2 * k];
      cs.delta_n[k] = ints[2 * kFinishKeys + 2 + 2 * k];
    }
  }
  // A thread reads 16 flag bytes a word, and merges a slot.
  const int64_t bytes = counts && num_r > slots ? num_r : slots;
  const int64_t flag_blocks =
      (bytes + 16 * kFinishThreads - 1) / (16 * kFinishThreads);
  const int64_t merge_blocks = (slots + kFinishThreads - 1) / kFinishThreads;
  const int64_t want = flag_blocks > merge_blocks ? flag_blocks : merge_blocks;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : want > kFinishBlocks ? kFinishBlocks : want);
  slot_finish_kernel<<<blocks, kFinishThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(active), num_r,
      static_cast<const uint8_t*>(unresolved), slots,
      static_cast<const int*>(count), static_cast<const int*>(dropped),
      static_cast<const int*>(rounds), static_cast<int*>(overflow),
      static_cast<int*>(counts), cs, static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(idx),
      make_hit_in(sub), make_hit(hit));
  return static_cast<int>(cudaGetLastError());
}

// Resources of kernel `which` (0 keys, 1 rows, 2 khit resolve, 3 stream
// resolve, 4 slot gather, 5 slot finish): out[0] registers, out[1] static
// shared bytes, out[2] dynamic
// shared bytes, out[3] local (spill) bytes a thread, out[4] resident
// blocks an SM.  Returns a CUDA error code.
extern "C" int imba_dispatch_resources(int which, int* out) {
  const void* fns[] = {reinterpret_cast<const void*>(dispatch_keys_kernel),
                       reinterpret_cast<const void*>(dispatch_rows_kernel),
                       reinterpret_cast<const void*>(khit_resolve_kernel),
                       reinterpret_cast<const void*>(stream_resolve_kernel),
                       reinterpret_cast<const void*>(slot_gather_kernel),
                       reinterpret_cast<const void*>(slot_finish_kernel)};
  if (which < 0 || which > 5) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fns[which]);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fns[which],
        which == 5   ? kFinishThreads
        : which == 4 ? kSelThreads
        : which == 1 ? kRowThreads
                     : kBlk,
        0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  return static_cast<int>(cudaSuccess);
}

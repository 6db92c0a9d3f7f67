// Vertex merging's photon gather, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
//   imbatracer_tpu/ops/pallas_merge.py::_make_kernel (via _merge_call)
// which sums, per query vertex, over the photons of its 2x2x2 cell block
// that lie within the merge radius, throughput * f * w * max(1 - d^2/r^2,
// 0): f, pdf_dir and pdf_rev are the inline diffuse / glossy (Cook-Torrance
// + Lambert) / Phong / Oren-Nayar terms, w the partial MIS weight of
// vertex merging (1 for PPM).  Layouts as in
// imbatracer_torch/ops/merge.py: qrec (Q, 40) f32 query rows sorted by
// anchor key, the four combo cell keys in columns 29:33 (-2 = invalid);
// keys (N,) i32 sorted photon cell keys (N = T * 256, padding last);
// tiles (T, 16, 256) f32 component-major photon rows, photon i's row r at
// tiles[i / 256][r][i % 256]; scal (2,) f32 [r^2, eta_vc]; out (Q, 8) f32,
// columns 0:3 the sum, 3:8 zero.
//
// Design: one block of kQB = 128 consecutive sorted queries, one thread a
// query, its sum in registers.  The block's queries share most of their
// cells, so the block finds, per combo c (0..3), the photon span [lo_c,
// hi_c) of its queries' valid combo keys -- two binary searches on `keys`
// a combo, 8 a block, where the one-thread-a-query kernel made 8 a thread
// --, merges the four spans' tile intervals into disjoint ones (the JAX
// kernel's union spans) and walks them, 256-photon tile by tile.  Each
// tile's keys and positions are staged in shared memory by cp.async in a
// ring of kStages tiles, kStages - 1 of them in flight while one is
// summed.  Each thread finds its own range {k_c <= key < k_c + 2} of each
// combo within the staged keys (a binary search over 256 keys in shared
// memory, skipped when the tile's first and last keys miss the range) and
// tests the range's positions; the other rows (w_in, throughput, d_vcm,
// d_vm) of the few photons within the radius (17,467 of 2,919,904
// examined on the still-life frame's busiest band) come from L2.  Tiles
// ascend and a thread's combo ranges ascend and are disjoint, so every
// query sums its photons in ascending index, the order of the plain
// version.  A block whose queries cross a cell boundary can span many
// more photons than its queries' ranges (a span runs from a combo's
// smallest key to its largest); before staging tiles the block votes on
// them, 32 at a time, by each tile's first and last key against each
// thread's ranges, and skips a tile that none meets, so the photons in the
// gaps are not loaded.
// The material kinds are a runtime mask (diffuse always on): a query's
// kind picks one BSDF block, the same function as the Pallas kernel's
// compiled-out kinds.
//
// What bounds it: the block's barriers (one a staged tile, three a vote
// on 32 tiles), the latency of the tiles' staging and of the block's 8
// binary searches on `keys`; the arithmetic per
// accepted pair (~100 float instructions for glossy) is far from the
// compute bound.
//
// Query preparation (merge_sort_key_kernel, merge_inverse_kernel,
// merge_query_rows_kernel): the anchor sort key of each query (its first
// combo key, 1 << 30 for an inactive one); after the caller's stable sort
// (perm), the inverse permutation inv[perm[i]] = i; then the (Q, 40) rows
// in sorted order -- the local frame, the four projections, the parameters
// and the combo keys -- each product and sum rounded on its own, left to
// right, and division IEEE, as ops/merge.py::prepare_queries computes them
// with torch ops, so the rows are its rows bit for bit.  With `perm` the
// gather writes query i's sum to the caller's row perm[i].
//
// The rows are built in query order, the JAX package's own structure
// (imbatracer_tpu/ops/pallas_merge.py::merge_contrib builds its rows by
// query and gathers them through perm): two threads a query read its
// inputs where a warp's loads of the (Q, 3) columns are contiguous words,
// and each writes one 16-byte half of every 32-byte sector of the row
// inv[q], so a warp store covers 16 rows' sectors whole.  Built in sorted
// order, a thread gathers 22 scattered words of query perm[i]: staged in
// shared memory and stored whole, that took twice as long
// (scripts/ab_prep_designs.cu).  The sort keys take one query a thread:
// at a band's 262,144 queries the kernel is bound by its launch and one
// trip to DRAM, not by its 17 bytes a query, and wider threads or other
// blocks traced no faster (the same file).
//
// Numerics: built with --fmad=false; every product and sum is rounded on
// its own, in the order of the plain PyTorch version
// (imbatracer_torch/ops/merge.py::pair_terms), and division and sqrt are
// IEEE, so the two agree to the ulps of powf against torch.pow.  The sum
// runs in ascending photon index, as the plain version's index_add_ does
// on the CPU; the Pallas kernel sums per 256-photon tile, so against it
// the relative error is a few ulps times the pair count (all terms are
// non-negative).
//
// Work counting: the kernel is a template over a counter type.  The
// renderer's launch takes NoWork, whose calls compile to nothing; the
// counting launch takes Work, which tallies per thread the photons
// examined, those within the radius, the BSDF evaluations by the query's
// kind and the pairs accepted, and adds them to a global array at exit.

#include <cuda_runtime.h>

namespace {

constexpr int kPT = 256;
constexpr int kRows = 16;
constexpr int kQW = 40;
constexpr int kQB = 128;              // queries a block
constexpr int kStages = 4;            // photon tiles a block's ring holds
constexpr int kGrid = 256;            // cells an axis (ops/merge.GRID)
constexpr int kInvalid = -2;          // an invalid combo key
constexpr float kInvPi = 0.318309886183790671538f;      // 1 / pi
constexpr float k2Pi = 6.28318530717958647692f;         // 2 pi
constexpr float k8Pi = 25.1327412287183459077f;         // 2 pi * 4
constexpr float kDegToRad = 0.0174532925199432957692f;  // pi / 180

enum Kind { kDiffuse = 0, kGlossy = 3, kPhong = 4, kOrenNayar = 5 };
// Counter slots: examined, in radius, BSDF evaluations by kind (diffuse,
// glossy, phong, oren-nayar), accepted.
enum Slot { kExamined, kInRadius, kBsdf0, kAccepted = kBsdf0 + 4, kSlots };

struct NoWork {
  __device__ __forceinline__ void add(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

struct Work {
  unsigned int n[kSlots] = {};
  __device__ __forceinline__ void add(int s) { ++n[s]; }
  __device__ __forceinline__ void flush(unsigned long long* out) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (n[i]) atomicAdd(out + i, (unsigned long long)n[i]);
  }
};

// First index in keys[lo, hi) whose key is >= k (hi if none).
__device__ __forceinline__ int lower_bound(const int* keys, int lo, int hi,
                                           int k) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Query {
  float px, py, pz, tx, ty, tz, bx, by, bz, nx, ny, nz, gx, gy, gz;
  float lox, loy, loz, s_o, dvcm, dvm, ns, kdx, kdy, kdz, ksx, ksy, ksz;
};

// One staged photon tile: its keys and positions.
struct Tile {
  int key[kPT];
  float pos[3][kPT];
};

// Stage photon tile t: 4 rows of 64 copies of 16 bytes.
__device__ __forceinline__ void stage_tile(Tile& s, int t,
                                           const int* __restrict__ keys,
                                           const float* __restrict__ tiles) {
  for (int q = threadIdx.x; q < 4 * (kPT / 4); q += kQB) {
    const int r = q / (kPT / 4), seg = (q % (kPT / 4)) * 4;
    if (r == 0)
      cp_async16(&s.key[seg], keys + (size_t)t * kPT + seg);
    else
      cp_async16(&s.pos[r - 1][seg],
                 tiles + ((size_t)t * kRows + r - 1) * kPT + seg);
  }
}

template <class W>
__global__ void __launch_bounds__(kQB)
merge_kernel(const float* __restrict__ qrec, int num_q,
             const int* __restrict__ keys, int num_p,
             const float* __restrict__ tiles, const float* __restrict__ scal,
             int ppm, int kind_mask, const long long* __restrict__ perm,
             float* __restrict__ out,
             unsigned long long* __restrict__ work_out) {
  __shared__ __align__(16) Tile stage[kStages];
  __shared__ int s_kmin[4], s_kmax[4], s_iv[4][2], s_niv;
  const int qi = blockIdx.x * kQB + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const float* row = qrec + (size_t)min(qi, num_q - 1) * kQW;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  W work;

  const int kind = (int)row[21];
  const bool live = qi < num_q && row[33] > 0.5f && kind >= 0 && kind < 32 &&
                    ((kind_mask >> kind) & 1);
  int kc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float kf = row[29 + c];
    kc[c] = live && kf >= 0.0f ? (int)kf : -1;
  }

  // The block's span of each combo, [lo_c, hi_c): the photons whose keys
  // lie in [min_c k, max_c k + 2) over its live queries; then the union of
  // the spans' tile intervals, ascending and disjoint.
  if (threadIdx.x < 4) {
    s_kmin[threadIdx.x] = 0x7fffffff;
    s_kmax[threadIdx.x] = -1;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int lo = __reduce_min_sync(0xffffffffu,
                                     kc[c] >= 0 ? kc[c] : 0x7fffffff);
    const int hi = __reduce_max_sync(0xffffffffu, kc[c]);
    if (lane == 0 && hi >= 0) {
      atomicMin(&s_kmin[c], lo);
      atomicMax(&s_kmax[c], hi);
    }
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    const int c = threadIdx.x >> 1, end = threadIdx.x & 1;
    s_iv[c][end] = s_kmax[c] < 0 ? 0
                   : lower_bound(keys, 0, num_p,
                                 end ? s_kmax[c] + 2 : s_kmin[c]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a[4], b[4], n = 0;
    for (int c = 0; c < 4; ++c) {
      if (s_iv[c][0] >= s_iv[c][1]) continue;
      int i = n++;
      const int t0 = s_iv[c][0] / kPT, t1 = (s_iv[c][1] - 1) / kPT + 1;
      for (; i > 0 && a[i - 1] > t0; --i) {
        a[i] = a[i - 1];
        b[i] = b[i - 1];
      }
      a[i] = t0;
      b[i] = t1;
    }
    int m = 0;
    for (int i = 0; i < n; ++i) {
      if (m > 0 && a[i] <= s_iv[m - 1][1]) {
        s_iv[m - 1][1] = max(s_iv[m - 1][1], b[i]);
      } else {
        s_iv[m][0] = a[i];
        s_iv[m][1] = b[i];
        ++m;
      }
    }
    s_niv = m;
  }
  __syncthreads();

  // The next tile of the union that some thread's range meets (-1 when
  // none is left).  The block votes on up to 32 tiles of an interval at
  // once, by each tile's first and last key against each thread's ranges,
  // into a mask of the tiles it needs; every thread takes the same steps,
  // as the values come from shared memory.
  __shared__ int s_edge[2][32];
  __shared__ unsigned s_need;
  int iv = 0, next_t = s_niv > 0 ? s_iv[0][0] : 0, base = 0;
  unsigned need = 0;
  auto next_needed = [&]() {
    while (!need) {
      if (iv >= s_niv) return -1;
      if (next_t >= s_iv[iv][1]) {
        if (++iv < s_niv) next_t = s_iv[iv][0];
        continue;
      }
      base = next_t;
      const int n = min(32, s_iv[iv][1] - base);
      next_t = base + n;
      __syncthreads();                // the last vote's mask is read
      if (threadIdx.x < 2 * n) {
        const int i = threadIdx.x >> 1, end = threadIdx.x & 1;
        s_edge[end][i] = __ldg(keys + (size_t)(base + i) * kPT +
                               (end ? kPT - 1 : 0));
      }
      if (threadIdx.x == 0) s_need = 0;
      __syncthreads();
      unsigned mine = 0;
      for (int i = 0; i < n; ++i) {
        const int first = s_edge[0][i], last = s_edge[1][i];
        bool meet = false;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          meet |= kc[c] >= 0 && first < kc[c] + 2 && last >= kc[c];
        mine |= (unsigned)meet << i;
      }
      mine = __reduce_or_sync(0xffffffffu, mine);
      if (lane == 0 && mine) atomicOr(&s_need, mine);
      __syncthreads();
      need = s_need;
    }
    const int t = base + __ffs(need) - 1;
    need &= need - 1;
    return t;
  };

  const float r2 = scal[0];
  const float eta_vc = scal[1];
  const float inv_r2 = 1.0f / fmaxf(r2, 1e-30f);
  Query q;
  q.px = row[0]; q.py = row[1]; q.pz = row[2];
  q.tx = row[3]; q.ty = row[4]; q.tz = row[5];
  q.bx = row[6]; q.by = row[7]; q.bz = row[8];
  q.nx = row[9]; q.ny = row[10]; q.nz = row[11];
  q.gx = row[12]; q.gy = row[13]; q.gz = row[14];
  q.lox = row[15]; q.loy = row[16]; q.loz = row[17];
  q.s_o = row[18]; q.dvcm = row[19]; q.dvm = row[20];
  q.kdx = row[22]; q.kdy = row[23]; q.kdz = row[24];
  q.ksx = row[25]; q.ksy = row[26]; q.ksz = row[27];
  q.ns = row[28];
  const float abs_loz = fabsf(q.loz);
  const float pdf_cos_rev = abs_loz * kInvPi;
  const float ns = q.ns;

  // kStages - 1 tiles in flight: one cp.async group a tile (empty past
  // the last), the tile of slot i in tile_of[i].
  int tile_of[kStages];
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    tile_of[i] = next_needed();
    if (tile_of[i] >= 0) stage_tile(stage[i], tile_of[i], keys, tiles);
    cp_async_commit();
  }
  for (int it = 0;; ++it) {
    const int slot = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // slot's tile landed; slot - 1 is free
    const int refill = (it + kStages - 1) % kStages;
    tile_of[refill] = tile_of[slot] < 0 ? -1 : next_needed();
    if (tile_of[refill] >= 0)
      stage_tile(stage[refill], tile_of[refill], keys, tiles);
    cp_async_commit();
    const int t = tile_of[slot];
    if (t < 0) break;
    const Tile& s = stage[slot];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = kc[c];
      if (k < 0 || !(s.key[0] < k + 2 && s.key[kPT - 1] >= k)) continue;
      const int j0 = lower_bound(s.key, 0, kPT, k);
      const int j1 = lower_bound(s.key, j0, kPT, k + 2);
      const float* p = tiles + (size_t)t * kRows * kPT;   // row r at r * kPT
      for (int j = j0; j < j1; ++j) {
        work.add(kExamined);
        const float dxx = s.pos[0][j] - q.px;
        const float dyy = s.pos[1][j] - q.py;
        const float dzz = s.pos[2][j] - q.pz;
        const float d2 = dxx * dxx + dyy * dyy + dzz * dzz;
        if (!(d2 <= r2)) continue;
        work.add(kInRadius);

        const float wix = __ldg(p + 4 * kPT + j),
                    wiy = __ldg(p + 5 * kPT + j),
                    wiz = __ldg(p + 6 * kPT + j);
        const float li_x = wix * q.tx + wiy * q.ty + wiz * q.tz;
        const float li_y = wix * q.bx + wiy * q.by + wiz * q.bz;
        const float li_z = wix * q.nx + wiy * q.ny + wiz * q.nz;
        const float s_i = wix * q.gx + wiy * q.gy + wiz * q.gz;
        if (!(q.s_o * s_i > 0.0f && q.loz * li_z > 0.0f)) continue;

        const float abs_liz = fabsf(li_z);
        const float pdf_cos_dir = abs_liz * kInvPi;
        float a_term = 0.0f, b_term = 0.0f, pdf_dir = 0.0f, pdf_rev = 0.0f;
        if (kind == kDiffuse) {
          work.add(kBsdf0);
          a_term = kInvPi;
          pdf_dir = pdf_cos_dir;
          pdf_rev = pdf_cos_rev;
        } else if (kind == kGlossy) {
          work.add(kBsdf0 + 1);
          // 0.5 * (Cook-Torrance(ks, conductor Fresnel(1, ns), Blinn ns)
          //        + Lambert(kd))
          const float hx = q.lox + li_x, hy = q.loy + li_y, hz = q.loz + li_z;
          const float h_len = sqrtf(fmaxf(hx * hx + hy * hy + hz * hz,
                                          1e-20f));
          const float hzn = hz / h_len;
          const float o_dot_h = (q.lox * hx + q.loy * hy + q.loz * hz) / h_len;
          const float i_dot_h = (li_x * hx + li_y * hy + li_z * hz) / h_len;
          const float c2 = i_dot_h * i_dot_h;
          const float nn1 = 1.0f + ns * ns;
          const float ekc = nn1 * c2;
          const float two_ec = 2.0f * i_dot_h;
          const float fr = 0.5f * ((ekc - two_ec + 1.0f) / (ekc + two_ec + 1.0f)
                                   + (nn1 - two_ec + c2) / (nn1 + two_ec + c2));
          const float abs_hz = fabsf(hzn);
          const float pow_h = powf(fmaxf(abs_hz, 1e-12f), ns);
          const float d_blinn = (ns + 2.0f) / k2Pi * pow_h;
          const float odh = fmaxf(o_dot_h, 1e-12f);
          const float g = fminf(fminf(2.0f * abs_hz * abs_loz / odh,
                                      2.0f * abs_hz * abs_liz / odh), 1.0f);
          const float ct = (d_blinn * g * fr) /
                           (4.0f * fmaxf(abs_liz * abs_loz, 1e-12f));
          const float pdf_h =
              o_dot_h > 0.0f ? (ns + 1.0f) * pow_h / (k8Pi * odh) : 0.0f;
          const float idh = fmaxf(i_dot_h, 1e-12f);
          const float pdf_h_rev =
              i_dot_h > 0.0f ? (ns + 1.0f) * pow_h / (k8Pi * idh) : 0.0f;
          a_term = 0.5f * kInvPi;
          b_term = 0.5f * ct;
          pdf_dir = 0.5f * (pdf_h + pdf_cos_dir);
          pdf_rev = 0.5f * (pdf_h_rev + pdf_cos_rev);
        } else if (kind == kPhong) {
          work.add(kBsdf0 + 2);
          // (ns+2)/2pi ks cos^ns about the mirror direction; the
          // power-cosine pdf is symmetric in (lo, li).
          const float cos_ro = fminf(fmaxf(
              -li_x * q.lox - li_y * q.loy + li_z * q.loz, 0.0f), 1.0f);
          const float powc = powf(cos_ro, ns);
          b_term = (ns + 2.0f) / k2Pi * powc;
          pdf_dir = pdf_rev = (ns + 1.0f) / k2Pi * powc;
        } else if (kind == kOrenNayar) {
          work.add(kBsdf0 + 3);
          // Oren-Nayar rough diffuse; sigma (degrees) rides in ns.
          const float sigma = ns * kDegToRad;
          const float s2 = sigma * sigma;
          const float a_on = 1.0f - s2 / (2.0f * (s2 + 0.33f));
          const float b_on = 0.45f * s2 / (s2 + 0.09f);
          const float st_i = sqrtf(fmaxf(1.0f - li_z * li_z, 0.0f));
          const float st_o = sqrtf(fmaxf(1.0f - q.loz * q.loz, 0.0f));
          const float denom = fmaxf(st_i * st_o, 1e-6f);
          const float cos_dphi = (li_x * q.lox + li_y * q.loy) / denom;
          const float max_cos =
              (st_i > 1e-4f && st_o > 1e-4f) ? fmaxf(cos_dphi, 0.0f) : 0.0f;
          const bool big_i = abs_liz > abs_loz;
          const float sin_alpha = big_i ? st_o : st_i;
          const float tan_beta = big_i ? st_i / fmaxf(abs_liz, 1e-6f)
                                       : st_o / fmaxf(abs_loz, 1e-6f);
          a_term = kInvPi * (a_on + b_on * max_cos * sin_alpha * tan_beta);
          pdf_dir = pdf_cos_dir;
          pdf_rev = pdf_cos_rev;
        }
        const float fx = q.kdx * a_term + q.ksx * b_term;
        const float fy = q.kdy * a_term + q.ksy * b_term;
        const float fz = q.kdz * a_term + q.ksz * b_term;
        if (!(pdf_dir > 0.0f && pdf_rev > 0.0f &&
              (fx != 0.0f || fy != 0.0f || fz != 0.0f)))
          continue;
        work.add(kAccepted);

        float w = 1.0f;
        if (!ppm) {
          const float w_light = __ldg(p + 10 * kPT + j) * eta_vc +
                                __ldg(p + 11 * kPT + j) * pdf_dir;
          const float w_cam = q.dvcm * eta_vc + q.dvm * pdf_rev;
          w = 1.0f / (w_light + 1.0f + w_cam);
        }
        const float epan = fmaxf(1.0f - d2 * inv_r2, 0.0f);
        const float wk = w * epan;
        ax += __ldg(p + 7 * kPT + j) * fx * wk;
        ay += __ldg(p + 8 * kPT + j) * fy * wk;
        az += __ldg(p + 9 * kPT + j) * fz * wk;
      }
    }
  }
  cp_async_wait<0>();

  work.flush(work_out);
  if (qi >= num_q) return;
  float* o = out + (size_t)(perm ? perm[qi] : qi) * 8;
  o[0] = ax; o[1] = ay; o[2] = az;
  o[3] = o[4] = o[5] = o[6] = o[7] = 0.0f;
}

// --------------------------------------------------------------------------
// Query preparation
// --------------------------------------------------------------------------

// Cell coordinate of x on one axis, floor((x - lo) * inv_cell - 0.5),
// saturated to [-1, kGrid] before the cast, as ops/merge._to_cells.
__device__ __forceinline__ int anchor_cell(float x, float lo, float ic) {
  const float f = floorf((x - lo) * ic - 0.5f);
  return (int)fminf(fmaxf(f, -1.0f), (float)kGrid);
}

__device__ __forceinline__ int clamp_cell(int m) {
  return min(max(m, 0), kGrid - 1);
}

// The four combo keys of ops/merge.combo_keys (of an active query).
__device__ __forceinline__ void combo_keys(const float* p, const float* lo,
                                           float ic, int* k) {
  const int mx = anchor_cell(p[0], lo[0], ic);
  const int my = anchor_cell(p[1], lo[1], ic);
  const int mz = anchor_cell(p[2], lo[2], ic);
  const int x0 = clamp_cell(mx), y0 = clamp_cell(my), z0 = clamp_cell(mz);
  const int x1 = clamp_cell(mx + 1), y1 = clamp_cell(my + 1);
  const bool same_x = x1 == x0, same_y = y1 == y0;
  k[0] = (x0 * kGrid + y0) * kGrid + z0;
  k[1] = same_y ? kInvalid : (x0 * kGrid + y1) * kGrid + z0;
  k[2] = same_x ? kInvalid : (x1 * kGrid + y0) * kGrid + z0;
  k[3] = same_x || same_y ? kInvalid : (x1 * kGrid + y1) * kGrid + z0;
}

__global__ void __launch_bounds__(kQB)
merge_sort_key_kernel(const float* __restrict__ qpos,
                      const unsigned char* __restrict__ active,
                      const float* __restrict__ bbox_min,
                      const float* __restrict__ inv_cell, int num_q,
                      int* __restrict__ sort_key) {
  const int q = blockIdx.x * kQB + threadIdx.x;
  if (q >= num_q) return;
  int k[4];
  combo_keys(qpos + (size_t)q * 3, bbox_min, *inv_cell, k);
  sort_key[q] = active[q] ? k[0] : 1 << 30;
}

constexpr int kInvB = 256;

__global__ void __launch_bounds__(kInvB)
merge_inverse_kernel(const long long* __restrict__ perm, int num_q,
                     int* __restrict__ inv) {
  const int i = blockIdx.x * kInvB + threadIdx.x;
  if (i < num_q) inv[perm[i]] = i;
}

__device__ __forceinline__ float dot3(const float* v, const float* a) {
  return v[0] * a[0] + v[1] * a[1] + v[2] * a[2];
}

// The preparation's per-query input columns (contiguous; kind int32, the
// vectors (Q, 3) f32, the scalars (Q,) f32, active bool).
struct QueryCols {
  const float* __restrict__ qpos;
  const float* __restrict__ normal;
  const float* __restrict__ gn;
  const float* __restrict__ w_out;
  const int* __restrict__ kind;
  const float* __restrict__ kd;
  const float* __restrict__ ks;
  const float* __restrict__ ns;
  const float* __restrict__ d_vcm;
  const float* __restrict__ d_vm;
  const unsigned char* __restrict__ active;
};

// Query q's (40,) row r (words 34:40 zero): its inputs are all loaded
// before any is used.
__device__ __forceinline__ void query_row(const QueryCols& in, size_t q,
                                          const float* lo, float ic,
                                          float* r) {
  float p[3], n[3], g[3], w[3], kd[3], ks[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[c] = in.qpos[q * 3 + c];
    n[c] = in.normal[q * 3 + c];
    g[c] = in.gn[q * 3 + c];
    w[c] = in.w_out[q * 3 + c];
    kd[c] = in.kd[q * 3 + c];
    ks[c] = in.ks[q * 3 + c];
  }
  const int kind = in.kind[q];
  const float ns = in.ns[q], d_vcm = in.d_vcm[q], d_vm = in.d_vm[q];
  const bool act = in.active[q] != 0;
  // local_coordinates (core/sampling.py): the branchless ONB.
  const float s = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + n[2]);
  const float b = n[0] * n[1] * a;
  const float t[3] = {1.0f + s * n[0] * n[0] * a, s * b, -s * n[0]};
  const float bt[3] = {b, s + n[1] * n[1] * a, -n[1]};
  int k[4] = {kInvalid, kInvalid, kInvalid, kInvalid};
  if (act) combo_keys(p, lo, ic, k);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[c] = p[c];
    r[3 + c] = t[c];
    r[6 + c] = bt[c];
    r[9 + c] = n[c];
    r[12 + c] = g[c];
    r[22 + c] = kd[c];
    r[25 + c] = ks[c];
  }
  r[15] = dot3(w, t);
  r[16] = dot3(w, bt);
  r[17] = dot3(w, n);
  r[18] = dot3(w, g);
  r[19] = d_vcm;
  r[20] = d_vm;
  r[21] = (float)kind;
  r[28] = ns;
#pragma unroll
  for (int c = 0; c < 4; ++c) r[29 + c] = (float)k[c];
  r[33] = act ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 34; c < kQW; ++c) r[c] = 0.0f;
}

constexpr int kRowB = 256;            // threads a rows block: 2 a query
constexpr int kRowQ = kRowB / 2;      // queries a rows block

// Two threads a query q, in query order; thread h writes the 16-byte
// words 2j + h (j < 5) of row inv[q], so the pair writes each 32-byte
// sector of the row whole.
__global__ void __launch_bounds__(kRowB)
merge_query_rows_kernel(const int* __restrict__ inv, QueryCols in,
                        const float* __restrict__ bbox_min,
                        const float* __restrict__ inv_cell, int num_q,
                        float4* __restrict__ qrec) {
  const int h = threadIdx.x & 1;
  const int q = blockIdx.x * kRowQ + (threadIdx.x >> 1);
  if (q >= num_q) return;
  const int row = inv[q];
  const float lo[3] = {bbox_min[0], bbox_min[1], bbox_min[2]};
  float r[kQW];
  query_row(in, q, lo, *inv_cell, r);
  float4* o = qrec + (size_t)row * (kQW / 4);
#pragma unroll
  for (int j = 0; j < kQW / 8; ++j) {
    const float4 lo4 = make_float4(r[8 * j], r[8 * j + 1], r[8 * j + 2],
                                   r[8 * j + 3]);
    const float4 hi4 = make_float4(r[8 * j + 4], r[8 * j + 5],
                                   r[8 * j + 6], r[8 * j + 7]);
    o[2 * j + h] = h ? hi4 : lo4;
  }
}

inline int blocks_for(int n) { return (n + kQB - 1) / kQB; }

}  // namespace

// C entry points.  Each launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch (0 on
// success).

// The gather: qrec (num_q, 40) sorted rows -> out (num_q, 8) rows, row
// perm[i] (int64; i when perm is null) for query i.  With `work` null it
// launches the renderer's kernel; otherwise the counting instantiation,
// which adds its 7 tallies (examined, in radius, BSDF evaluations for
// diffuse / glossy / phong / oren-nayar, accepted) to the zero-initialised
// uint64 array `work`.
extern "C" int imba_merge(const void* qrec, int num_q, const void* keys,
                          int num_p, const void* tiles, const void* scal,
                          int ppm, int kind_mask, const void* perm, void* out,
                          void* work, void* stream) {
  if (num_q > 0) {
    auto* k = work ? merge_kernel<Work> : merge_kernel<NoWork>;
    k<<<blocks_for(num_q), kQB, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qrec), num_q,
        static_cast<const int*>(keys), num_p,
        static_cast<const float*>(tiles), static_cast<const float*>(scal),
        ppm, kind_mask, static_cast<const long long*>(perm),
        static_cast<float*>(out), static_cast<unsigned long long*>(work));
  }
  return static_cast<int>(cudaGetLastError());
}

// Preparation, step 1: sort_key (num_q,) int32 of qpos (num_q, 3) f32,
// active (num_q,) bool, the grid's bbox_min (3,) f32 and inv_cell () f32.
extern "C" int imba_merge_sort_keys(const void* qpos, const void* active,
                                    const void* bbox_min,
                                    const void* inv_cell, int num_q,
                                    void* sort_key, void* stream) {
  if (num_q > 0)
    merge_sort_key_kernel<<<blocks_for(num_q), kQB, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qpos),
        static_cast<const unsigned char*>(active),
        static_cast<const float*>(bbox_min),
        static_cast<const float*>(inv_cell), num_q,
        static_cast<int*>(sort_key));
  return static_cast<int>(cudaGetLastError());
}

// Preparation, step 2 (after the caller's stable sort of the keys):
// inv (num_q,) int32, inv[perm[i]] = i, of perm (num_q,) int64.
extern "C" int imba_merge_inverse(const void* perm, int num_q, void* inv,
                                  void* stream) {
  if (num_q > 0)
    merge_inverse_kernel<<<(num_q + kInvB - 1) / kInvB, kInvB, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(perm), num_q, static_cast<int*>(inv));
  return static_cast<int>(cudaGetLastError());
}

// Preparation, step 3: qrec (num_q, 40) f32 (16-byte aligned), query q's
// row at row inv[q] (int32), from the caller's arrays (contiguous; kind
// int32, the vectors (num_q, 3) f32, the scalars (num_q,) f32, active
// bool).
extern "C" int imba_merge_query_rows(
    const void* inv, const void* qpos, const void* normal, const void* gn,
    const void* w_out, const void* kind, const void* kd, const void* ks,
    const void* ns, const void* d_vcm, const void* d_vm, const void* active,
    const void* bbox_min, const void* inv_cell, int num_q, void* qrec,
    void* stream) {
  if (num_q > 0) {
    const QueryCols in{
        static_cast<const float*>(qpos), static_cast<const float*>(normal),
        static_cast<const float*>(gn), static_cast<const float*>(w_out),
        static_cast<const int*>(kind), static_cast<const float*>(kd),
        static_cast<const float*>(ks), static_cast<const float*>(ns),
        static_cast<const float*>(d_vcm), static_cast<const float*>(d_vm),
        static_cast<const unsigned char*>(active)};
    merge_query_rows_kernel<<<(num_q + kRowQ - 1) / kRowQ, kRowB, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(inv), in,
        static_cast<const float*>(bbox_min),
        static_cast<const float*>(inv_cell), num_q,
        static_cast<float4*>(qrec));
  }
  return static_cast<int>(cudaGetLastError());
}

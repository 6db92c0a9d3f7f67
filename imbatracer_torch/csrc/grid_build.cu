// The photon grid's build, for NVIDIA Hopper (sm_90a).
//
// No Pallas kernel stands behind this file: it is the card's counterpart
// of JAX's jitted build_merge_grid (imbatracer_tpu/ops/pallas_merge.py
// :135), which XLA compiles once a frame around one library sort; the
// Pallas merge kernel (:205, here csrc/merge_kernel.cu) reads what it
// builds.  The photons are the working cache's valid rows, the first
// `count` of its packed (P, 24) rows (render/light_cache.py):
//
//   grid_keys_kernel   the head (:143-166): the grid's bbox_min and
//                      inv_cell from the kept photons' box that the
//                      selection's gather reduced (csrc/select.cu), with
//                      the plain version's roundings (ops/merge.py
//                      grid_keys_plain), and each photon's linear cell
//                      key from the position column that the gather
//                      writes, PAD_KEY for an invalid one; block 0
//                      writes the scalars;
//   grid_tiles_kernel  the tail (:171-198): after the library's stable
//                      sort of the keys, the (T, 16, PT) component-major
//                      tiles and the padded keys in one pass, straight
//                      from the sorted order (no concatenation, gathers
//                      or transposition).
//
// What bounds them: bytes.  The keys read each photon's pos and write
// 4 B.  Redesigned for Hopper: pos comes from the gather's (rows, 4)
// position column, one coalesced 16-byte load a photon, issued before
// anything else; read from the 96-byte rows, its 12 B cost at least a
// 64-byte DRAM read a photon, ~3x the bytes the function needs.  The grid's
// scalars, the same for every photon (six loads of the box, three
// float64 multiply-subtracts, an IEEE division), are computed once a
// block by its thread 0 into shared memory while the block's loads are
// in flight, not once a thread.  The tiles read each photon's order entry,
// key and 12 of its row's floats (five 16-byte words of six) and write
// 64 B of tiles and 4 B of keys; one thread a photon, a block a tile, so
// each of the 16 writes of a warp covers 32 neighbouring floats.
//
// Numerics: the scalars mimic torch's CUDA ops on float32 as
// tools/cuda_op_probe.py prints them: `x * 1.01` and `x - 1e-6` take the
// Python float as a float32 operand, `x / 256` multiplies by the double
// reciprocal cast to float32 (exact here), `1.0 / x` is an IEEE division;
// `(b.double() - e.double() * eps).float()` is two double operations
// (no fused multiply-add: --fmad=false) and one rounding.  The keys are
// floors and integer arithmetic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRecW = 24;                 // render/light_cache.py REC_W
constexpr int kWords = kRecW / 4;         // float4 words a row
constexpr int kGrid = 256;                // ops/merge.py GRID
constexpr int kPadKey = 1 << 25;          // ops/merge.py PAD_KEY
constexpr int kPT = 256;                  // ops/merge.py PT (photons a tile)
constexpr int kRows = 16;                 // ops/merge.py PREC_ROWS
constexpr float kBig = 1e30f;             // ops/merge.py BIG
constexpr int kBlk = 256;

// The float of csrc/select.cu's order-preserving bits.
__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Grid scalars: bbox_min[3], inv_cell, radius_sqr.
struct Scalars {
  float bmin[3];
  float inv_cell;
  float r2;
};

// build_merge_grid's head on the box: `box` (6,) the selection's slots
// (min complemented, 0 = no photon), `count` valid photons of `rows`.
__device__ Scalars grid_scalars(const unsigned* box, int count, int64_t rows,
                                float radius) {
  float lo[3], hi[3];
  for (int k = 0; k < 3; ++k) {
    // where(valid, pos, BIG).amin(0): the invalid rows add BIG.
    lo[k] = box[k] ? unordered(~box[k]) : __int_as_float(0x7f800000);
    hi[k] = box[3 + k] ? unordered(box[3 + k]) : -__int_as_float(0x7f800000);
    if (count < rows) {
      lo[k] = fminf(lo[k], kBig);
      hi[k] = fmaxf(hi[k], -kBig);
    }
    if (count <= 0) {            // any_valid false
      lo[k] = 0.f;
      hi[k] = 1.f;
    }
  }
  // torch.tensor(1e-3, dtype=float32).item(): float32's 1e-3 as a double.
  const double eps = static_cast<double>(1e-3f);
  Scalars s;
  float ext_max = 0.f;
  for (int k = 0; k < 3; ++k) {
    const float ext = __fsub_rn(hi[k], lo[k]);
    const double b = __dsub_rn(static_cast<double>(lo[k]),
                               __dmul_rn(static_cast<double>(ext), eps));
    s.bmin[k] = __fsub_rn(__double2float_rn(b), 1e-6f);
    ext_max = k == 0 ? ext : fmaxf(ext_max, ext);
  }
  const float cell = fmaxf(__fmul_rn(2.0f, radius),
                           __fmul_rn(__fmul_rn(ext_max, 1.01f),
                                     1.0f / kGrid));
  s.inv_cell = __fdiv_rn(1.0f, fmaxf(cell, 1e-12f));
  s.r2 = __fmul_rn(radius, radius);
  return s;
}

// floor((p - bmin) * inv_cell) saturated to [-1, GRID], cast, clamped to
// [0, GRID - 1] (ops/merge.py _clamp_cells; NaN -> 0).
__device__ __forceinline__ int cell_of(float p, float bmin, float inv) {
  const float f = floorf(__fmul_rn(__fsub_rn(p, bmin), inv));
  const int c = isnan(f) ? 0 : static_cast<int>(fminf(fmaxf(f, -1.f),
                                                       static_cast<float>(
                                                           kGrid)));
  return min(max(c, 0), kGrid - 1);
}

__global__ void __launch_bounds__(kBlk)
    grid_keys_kernel(const float4* pos, const int* count,
                     const unsigned* box, const float* radius, int64_t rows,
                     int* keys, float* scal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  // The photon's load first: it waits for nothing.  Rows past the count
  // are zero in the column, and their keys PAD_KEY.
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < rows) p = pos[i];
  __shared__ Scalars sh;
  __shared__ int sh_count;
  if (threadIdx.x == 0) {
    const int cnt = *count;
    sh = grid_scalars(box, cnt, rows, *radius);
    sh_count = cnt;
    if (blockIdx.x == 0) {
      for (int k = 0; k < 3; ++k) scal[k] = sh.bmin[k];
      scal[3] = sh.inv_cell;
      scal[4] = sh.r2;
    }
  }
  __syncthreads();
  if (i >= rows) return;
  if (i >= sh_count) {
    keys[i] = kPadKey;
    return;
  }
  const int cx = cell_of(p.x, sh.bmin[0], sh.inv_cell);
  const int cy = cell_of(p.y, sh.bmin[1], sh.inv_cell);
  const int cz = cell_of(p.z, sh.bmin[2], sh.inv_cell);
  keys[i] = (cx * kGrid + cy) * kGrid + cz;
}

__global__ void grid_tiles_kernel(const float4* rec, const int* count,
                                  const int* sorted_keys,
                                  const int64_t* order, int64_t rows,
                                  float* tiles, int* keys) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t i = t * kPT + j;
  float v[kRows];
  for (int r = 0; r < kRows; ++r) v[r] = 0.f;
  int key = kPadKey;
  if (i < rows) {
    const int64_t src = order[i];
    key = sorted_keys[i];
    const float4* row = rec + src * kWords;
    const float4 w0 = row[0], w1 = row[1], w3 = row[3], w4 = row[4],
                 w5 = row[5];
    const bool valid = src < *count;
    v[0] = valid ? w0.x : kBig;
    v[1] = valid ? w0.y : kBig;
    v[2] = valid ? w0.z : kBig;
    v[4] = w0.w;                 // w_out, columns 3:6
    v[5] = w1.x;
    v[6] = w1.y;
    v[7] = w3.w;                 // throughput, columns 15:18
    v[8] = w4.x;
    v[9] = w4.y;
    v[10] = w4.w;                // d_vcm, column 19
    v[11] = w5.x;                // d_vm, column 20
  } else {
    v[0] = v[1] = v[2] = kBig;
  }
  v[3] = static_cast<float>(key);
  float* tile = tiles + t * kRows * kPT + j;
  for (int r = 0; r < kRows; ++r) tile[r * kPT] = v[r];
  keys[i] = key;
}

}  // namespace

// grid_keys_kernel on the current stream: pos (rows, 4) f32, 16-byte
// aligned, the selection's position column (csrc/select.cu), zero past
// the count; count 0-d i32; box (6,) u32 (csrc/select.cu); radius 0-d
// f32; keys (rows,) i32; scal (5,) f32: bbox_min[3], inv_cell,
// radius_sqr.  Returns a CUDA error.
extern "C" int imba_grid_keys(const void* pos, const void* count,
                              const void* box, const void* radius,
                              int64_t rows, void* keys, void* scal,
                              void* stream) {
  const int64_t n = rows > 0 ? rows : 1;     // block 0 writes the scalars
  grid_keys_kernel<<<static_cast<unsigned>((n + kBlk - 1) / kBlk), kBlk, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos), static_cast<const int*>(count),
      static_cast<const unsigned*>(box), static_cast<const float*>(radius),
      rows, static_cast<int*>(keys), static_cast<float*>(scal));
  return static_cast<int>(cudaGetLastError());
}

// grid_tiles_kernel on the current stream: rec (rows, 24) f32, 16-byte
// aligned; count 0-d i32; sorted_keys (rows,) i32 and order (rows,) i64,
// the stable sort of grid_keys_kernel's keys; tiles (T, 16, PT) f32 and
// keys (T * PT,) i32, T = ceil(rows / PT).  Returns a CUDA error.
extern "C" int imba_grid_tiles(const void* rec, const void* count,
                               const void* sorted_keys, const void* order,
                               int64_t rows, void* tiles, void* keys,
                               void* stream) {
  const int64_t num_t = (rows + kPT - 1) / kPT;
  if (num_t > 0)
    grid_tiles_kernel<<<static_cast<unsigned>(num_t), kPT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rec), static_cast<const int*>(count),
        static_cast<const int*>(sorted_keys),
        static_cast<const int64_t*>(order), rows,
        static_cast<float*>(tiles), static_cast<int*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// Resources of kernel `which` (0 keys, 1 tiles): out[0] registers, out[1]
// static shared bytes, out[2] dynamic shared bytes, out[3] local (spill)
// bytes a thread, out[4] resident blocks an SM.  Returns a CUDA error.
extern "C" int imba_grid_resources(int which, int* out) {
  const void* fns[] = {reinterpret_cast<const void*>(grid_keys_kernel),
                       reinterpret_cast<const void*>(grid_tiles_kernel)};
  if (which < 0 || which > 1) return static_cast<int>(cudaErrorInvalidValue);
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

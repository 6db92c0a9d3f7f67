// Tests shared by the port's traversal kernels (stream_traverse.cu,
// khit_traverse.cu, pairs_kernel.cu): the slab test of a super-chunk or
// chunk box, the feature-dot Moller-Trumbore test of one triangle slot and
// the instance transform of a ray, over the (sbox, tiles[, inst]) layout
// documented in imbatracer_torch/ops/stream_traverse.py.
//
// Numerics: the kernels are built with --fmad=false; every product and
// sum below is rounded on its own, in the order the plain PyTorch
// version (stream_traverse._slab / _mt) uses, and division is IEEE, so
// both kernels compute t/u/v bit for bit as the plain version does.
// Comparisons are strict (t > tmin, t < limit); |det| < 1e-12 rejects.
//
// Work counting: each kernel is a template over a counter type.  The
// launch the renderer uses takes NoWork, whose calls compile to nothing;
// the counting launch takes Work, which tallies per thread the slab tests
// and how far each Moller-Trumbore test got (the stage it returned at),
// and adds the tallies to a global array of kWorkSlots counters at exit.

#pragma once

#include <cuda_runtime.h>

namespace imba {

constexpr int kTileRows = 24;
constexpr int kTriRows = 1024;
constexpr int kSuper = 64;
constexpr int kChunk = 16;
constexpr float kBig = 1e30f;

// Moller-Trumbore stages, in test order: empty slot, |det| rejected, t
// rejected, u rejected, v rejected, hit.
enum MtStage { kEmpty, kDet, kT, kU, kV, kHit, kStages };
// Counter slots: slab tests, then one per MtStage.
constexpr int kWorkSlots = 1 + kStages;

struct NoWork {
  __device__ __forceinline__ void slab() {}
  __device__ __forceinline__ void mt(MtStage) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

struct Work {
  unsigned int n[kWorkSlots] = {};
  __device__ __forceinline__ void slab() { ++n[0]; }
  __device__ __forceinline__ void mt(MtStage s) { ++n[1 + s]; }
  __device__ __forceinline__ void flush(unsigned long long* out) {
#pragma unroll
    for (int i = 0; i < kWorkSlots; ++i)
      if (n[i]) atomicAdd(out + i, (unsigned long long)n[i]);
  }
};

__device__ __forceinline__ float safe_inv(float x) {
  const float s = x >= 0.0f ? 1.0f : -1.0f;
  return s / fmaxf(fabsf(x), 1e-12f);
}

// One ray in registers: origin, direction, their reciprocal and o x d.
struct Ray {
  float ox, oy, oz, tmin, dx, dy, dz, tmax;
  float ix, iy, iz, cx, cy, cz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float tmin, float dx, float dy,
                                        float dz, float tmax) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz; r.tmin = tmin;
  r.dx = dx; r.dy = dy; r.dz = dz; r.tmax = tmax;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  r.cx = oy * dz - oz * dy;
  r.cy = oz * dx - ox * dz;
  r.cz = ox * dy - oy * dx;
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ row) {
  return make_ray(row[0], row[1], row[2], row[3], row[4], row[5], row[6],
                  row[7]);
}

// Two-level instancing: the ray in the mesh space of an instance whose
// world->mesh 3x4 affine is m[0..11] (row-major), each product and sum
// rounded on its own, left to right, as the plain version
// (stream_traverse.instance_ray) computes it.  The direction stays
// unnormalised, so t is the same in both spaces and a best t found in
// one instance bounds the others.
__device__ __forceinline__ Ray instance_ray(const Ray& w,
                                            const float* __restrict__ m) {
  return make_ray(
      __ldg(m + 0) * w.ox + __ldg(m + 1) * w.oy + __ldg(m + 2) * w.oz +
          __ldg(m + 3),
      __ldg(m + 4) * w.ox + __ldg(m + 5) * w.oy + __ldg(m + 6) * w.oz +
          __ldg(m + 7),
      __ldg(m + 8) * w.ox + __ldg(m + 9) * w.oy + __ldg(m + 10) * w.oz +
          __ldg(m + 11),
      w.tmin,
      __ldg(m + 0) * w.dx + __ldg(m + 1) * w.dy + __ldg(m + 2) * w.dz,
      __ldg(m + 4) * w.dx + __ldg(m + 5) * w.dy + __ldg(m + 6) * w.dz,
      __ldg(m + 8) * w.dx + __ldg(m + 9) * w.dy + __ldg(m + 10) * w.dz,
      w.tmax);
}

// Slab test: true when the ray's [tmin, limit] interval enters the box.
__device__ __forceinline__ bool enters(float lox, float loy, float loz,
                                       float hix, float hiy, float hiz,
                                       const Ray& r, float limit) {
  const float tx0 = (lox - r.ox) * r.ix, tx1 = (hix - r.ox) * r.ix;
  const float ty0 = (loy - r.oy) * r.iy, ty1 = (hiy - r.oy) * r.iy;
  const float tz0 = (loz - r.oz) * r.iz, tz1 = (hiz - r.oz) * r.iz;
  const float tn =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return (tn <= tf) && (tf >= r.tmin) && (tn <= limit);
}

__device__ __forceinline__ float tile_row(const float* __restrict__ T,
                                          int row, int lane) {
  return __ldg(T + row * kTriRows + lane);
}

__device__ __forceinline__ bool enters_superchunk(
    const float* __restrict__ sb, const Ray& r, float limit) {
  return enters(sb[0], sb[1], sb[2], sb[3], sb[4], sb[5], r, limit);
}

// Chunk c's box sits in lane c of tile rows 6, 7, 14 (lo) and 15, 22, 23
// (hi).
__device__ __forceinline__ bool enters_chunk(const float* __restrict__ T,
                                             int c, const Ray& r,
                                             float limit) {
  return enters(tile_row(T, 6, c), tile_row(T, 7, c), tile_row(T, 14, c),
                tile_row(T, 15, c), tile_row(T, 22, c), tile_row(T, 23, c),
                r, limit);
}

// Moller-Trumbore in feature-dot form against triangle slot j of tile T:
// true, with (t, u, v, id), when the ray hits it at tmin < t < limit.
template <class W>
__device__ __forceinline__ bool hit_slot(const float* __restrict__ T, int j,
                                         const Ray& r, float limit, float& t,
                                         float& u, float& v, float& id,
                                         W& work) {
  id = tile_row(T, 4, j);
  if (!(id >= 0.0f)) { work.mt(kEmpty); return false; }
  const float nx = tile_row(T, 0, j), ny = tile_row(T, 1, j),
              nz = tile_row(T, 2, j);
  const float det = -(r.dx * nx + r.dy * ny + r.dz * nz);
  const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
  if (inv_det == 0.0f) { work.mt(kDet); return false; }
  t = (r.ox * nx + r.oy * ny + r.oz * nz - tile_row(T, 3, j)) * inv_det;
  if (!(t > r.tmin && t < limit)) { work.mt(kT); return false; }
  const float u_num = r.cx * tile_row(T, 11, j) + r.cy * tile_row(T, 12, j) +
                      r.cz * tile_row(T, 13, j) + r.dx * tile_row(T, 8, j) +
                      r.dy * tile_row(T, 9, j) + r.dz * tile_row(T, 10, j);
  u = u_num * inv_det;
  if (!(u >= 0.0f)) { work.mt(kU); return false; }
  const float v_num = r.cx * tile_row(T, 19, j) + r.cy * tile_row(T, 20, j) +
                      r.cz * tile_row(T, 21, j) + r.dx * tile_row(T, 16, j) +
                      r.dy * tile_row(T, 17, j) + r.dz * tile_row(T, 18, j);
  v = v_num * inv_det;
  if (!(v >= 0.0f && u + v <= 1.0f)) { work.mt(kV); return false; }
  work.mt(kHit);
  return true;
}

}  // namespace imba

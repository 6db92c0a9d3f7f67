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
// Design: one thread per sorted query.  The thread finds, by binary
// search on `keys`, the photon index range [lo, hi) of each of its valid
// combo key pairs {k, k + 1} (keys k <= key < k + 2), and walks the four
// ranges in combo order, i.e. in ascending photon index, accumulating in
// registers.  That is exactly the set of photons the Pallas kernel's
// union walk pairs with the query.  The Pallas kernel's per-block union
// of tile spans, its SMEM span scalars, the component-major DMA double
// buffer and the pair test by key comparison exist because Mosaic cannot
// gather per lane; a Hopper thread can.  The queries stay sorted by
// anchor key so that neighbouring threads walk neighbouring photon runs
// (their tile rows come from L2 together).  The material kinds are a
// runtime mask (diffuse always on): a query's kind picks one BSDF block,
// the same function as the Pallas kernel's compiled-out kinds.
//
// What bounds it: the loads of photon rows, 10 of the 16 rows per photon
// examined, from L2 (the still-life frame's ~134 MB of tiles exceed the
// 50 MB L2, but a block's queries share cells), and warp divergence,
// since run lengths and kinds differ between the queries of a warp.  The
// arithmetic per accepted pair (~100 float instructions for glossy) is
// far from the compute bound.  Shared-memory staging of the runs a block
// shares is later work.
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

// First index in keys[0, n) whose key is >= k.
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Query {
  float px, py, pz, tx, ty, tz, bx, by, bz, nx, ny, nz, gx, gy, gz;
  float lox, loy, loz, s_o, dvcm, dvm, ns, kdx, kdy, kdz, ksx, ksy, ksz;
};

template <class W>
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ qrec, int num_q,
             const int* __restrict__ keys, int num_p,
             const float* __restrict__ tiles, const float* __restrict__ scal,
             int ppm, int kind_mask, float* __restrict__ out,
             unsigned long long* __restrict__ work_out) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= num_q) return;
  const float* row = qrec + (size_t)qi * kQW;
  float* o = out + (size_t)qi * 8;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  W work;

  const int kind = (int)row[21];
  const bool live = row[33] > 0.5f && kind >= 0 && kind < 32 &&
                    ((kind_mask >> kind) & 1);
  if (live) {
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
    const float r2 = scal[0];
    const float eta_vc = scal[1];
    const float inv_r2 = 1.0f / fmaxf(r2, 1e-30f);
    const float abs_loz = fabsf(q.loz);
    const float pdf_cos_rev = abs_loz * kInvPi;
    const float ns = q.ns;

    for (int c = 0; c < 4; ++c) {
      const float kf = row[29 + c];
      if (!(kf >= 0.0f)) continue;
      const int k = (int)kf;
      const int lo = lower_bound(keys, num_p, k);
      const int hi = lower_bound(keys, num_p, k + 2);
      for (int i = lo; i < hi; ++i) {
        const float* p = tiles + (size_t)(i / kPT) * kRows * kPT + (i % kPT);
        work.add(kExamined);
        const float dxx = __ldg(p) - q.px;
        const float dyy = __ldg(p + kPT) - q.py;
        const float dzz = __ldg(p + 2 * kPT) - q.pz;
        const float d2 = dxx * dxx + dyy * dyy + dzz * dzz;
        if (!(d2 <= r2)) continue;
        work.add(kInRadius);

        const float wix = __ldg(p + 4 * kPT), wiy = __ldg(p + 5 * kPT),
                    wiz = __ldg(p + 6 * kPT);
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
          const float w_light = __ldg(p + 10 * kPT) * eta_vc +
                                __ldg(p + 11 * kPT) * pdf_dir;
          const float w_cam = q.dvcm * eta_vc + q.dvm * pdf_rev;
          w = 1.0f / (w_light + 1.0f + w_cam);
        }
        const float epan = fmaxf(1.0f - d2 * inv_r2, 0.0f);
        const float wk = w * epan;
        ax += __ldg(p + 7 * kPT) * fx * wk;
        ay += __ldg(p + 8 * kPT) * fy * wk;
        az += __ldg(p + 9 * kPT) * fz * wk;
      }
    }
  }

  work.flush(work_out);
  o[0] = ax; o[1] = ay; o[2] = az;
  o[3] = o[4] = o[5] = o[6] = o[7] = 0.0f;
}

}  // namespace

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch (0 on success).
// With `work` null it launches the renderer's kernel; otherwise the
// counting instantiation, which adds its 7 tallies (examined, in radius,
// BSDF evaluations for diffuse / glossy / phong / oren-nayar, accepted) to
// the zero-initialised uint64 array `work`.
extern "C" int imba_merge(const void* qrec, int num_q, const void* keys,
                          int num_p, const void* tiles, const void* scal,
                          int ppm, int kind_mask, void* out, void* work,
                          void* stream) {
  const int blocks = (num_q + 127) / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    auto* q = static_cast<const float*>(qrec);
    auto* k = static_cast<const int*>(keys);
    auto* t = static_cast<const float*>(tiles);
    auto* sc = static_cast<const float*>(scal);
    auto* o = static_cast<float*>(out);
    auto* w = static_cast<unsigned long long*>(work);
    if (w)
      merge_kernel<Work><<<blocks, 128, 0, s>>>(q, num_q, k, num_p, t, sc,
                                                ppm, kind_mask, o, w);
    else
      merge_kernel<NoWork><<<blocks, 128, 0, s>>>(q, num_q, k, num_p, t, sc,
                                                  ppm, kind_mask, o, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sphere megakernel: forward path tracing of a sphere scene (at most 128
// spheres) under a gradient or constant sky, one thread per pixel.
//
// Replaces opencl_ray_tracer_tpu/kernels/megakernel.py::_make_kernel, the
// Pallas TPU kernel that runs the same wavefront loop over (64,128)-pixel
// tiles held in VMEM.
//
// What bounds it: FP32 ALU work.  Every bounce of every path tests every
// sphere: about 25 FLOPs and one sqrtf per test, so the work is
// pixels x spp x mean bounces per sample x n_spheres tests, plus a scatter
// (sinf, cosf, sqrtf, a pcg4d hash pair) per bounce.  The only traffic to
// device memory is the tables, read once per block, and three floats
// written per pixel.
//
// What the design does about it: the sphere table (13 fields x n) and the
// camera slots are staged in shared memory once per block, and all the
// threads of a warp read the same sphere at the same time, a broadcast.  A
// sphere whose discriminant is negative costs no divide and no sqrtf.  A
// path that ends is replaced at once by the pixel's next sample in the same
// loop (path regeneration), so a thread idles only after its last sample,
// and samples still finish in order per pixel, which keeps the running-sum
// NaN policy exact.  Left for later work: warp divergence from heavy-tailed
// path lengths, register pressure, persistent or compacted scheduling.
//
// The arithmetic follows the plain PyTorch tracer op for op: divisions
// where it divides, a division by sqrtf(a) rather than rsqrtf, IEEE sqrtf,
// sinf and cosf, and fmaf exactly where the plain tracer fuses a
// multiply-add (dot products as fma chains, the discriminant, the hit
// point, the camera ray, reflect and refract; see _fp.py).  The library is
// built with --fmad=false so that nvcc fuses nothing else.  On the card the
// kernel and the plain version then round alike, apart from cbrtf against
// the plain version's pow(x, 1/3) (PyTorch has no cube root) and the plain
// version's fma, which rounds through float64.  This matters because the
// large ground spheres make |oc|^2 - r^2 cancel: a one-ulp difference
// anywhere moves the self-intersection test of grazing rays near t_min and
// so flips whole samples.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSpheres = 128;
constexpr int kFields = 13;
constexpr int kCamSlots = 22;
constexpr float kBig = 3.4e38f;
constexpr float kTwoPi = 6.283185307179586f;

// Sphere-table rows (kernels/megakernel.py F_*).
enum Field {
  F_CX, F_CY, F_CZ, F_R, F_ALR, F_ALG, F_ALB, F_FUZZ, F_IOR, F_TYPE,
  F_R2, F_INVR, F_INVIOR
};
// Camera-table slots (kernels/megakernel.py C_*): origin, horizontal,
// vertical, lower-left corner, defocus u, defocus v, aperture, sky colour.
enum CamSlot {
  C_O = 0, C_H = 3, C_V = 6, C_L = 9, C_DU = 12, C_DV = 15, C_APERTURE = 18,
  C_SKY = 19
};
enum Material { LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, EMISSIVE = 3 };
// Flag bits (kernels/megakernel.py FLAG_*).
enum Flag {
  HAS_METAL = 1, HAS_DIEL = 2, HAS_EMIT = 4, HAS_FUZZ = 8,
  HAS_APERTURE = 16, CLAMP = 32, NAN_RUNNING_SUM = 64, SKY_CONST = 128
};

struct Params {
  const float* cam;
  const float* sph;
  float* out_r;
  float* out_g;
  float* out_b;
  unsigned long long* bounces;
  int tab_w;
  int n_spheres;
  int n_pix;
  int pix_offset;
  uint32_t seed;
  uint32_t sample_base;
  int width;
  int height;
  int spp;
  int max_depth;
  float t_min;
  int flags;
};

// pcg4d (Jarzynski & Olano 2020), the hash of rng/__init__.py.
__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
}

__device__ __forceinline__ float unit_float(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// Four uniforms for counter (pixel, sample, slot); slot 0 is the camera,
// slots 4 + 2*depth and the one after it are a bounce.
__device__ __forceinline__ void uniform4(uint32_t seed, uint32_t pix,
                                         uint32_t sample, uint32_t slot,
                                         float u[4]) {
  uint32_t a = pix, b = sample, c = slot, d = seed;
  pcg4d(a, b, c, d);
  u[0] = unit_float(a);
  u[1] = unit_float(b);
  u[2] = unit_float(c);
  u[3] = unit_float(d);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0]));
}

// Clamp to [0, 1] that lets NaN through, as the reference's compares do.
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

// GetRay (gpu_kernel.cl:559-578) for one pixel and sample.
__device__ __forceinline__ void camera_ray(const float* cam, const Params& p,
                                           uint32_t pix, uint32_t sample,
                                           float px, float py, float o[3],
                                           float d[3]) {
  float u[4];
  uniform4(p.seed, pix, sample, 0u, u);
  const float uu = (px + u[0]) / (float)p.width;
  const float vv = (py + u[1]) / (float)p.height;
  for (int k = 0; k < 3; ++k) o[k] = cam[C_O + k];
  if (p.flags & HAS_APERTURE) {
    const float r = sqrtf(u[2]);
    const float th = kTwoPi * u[3];
    const float lx = r * cosf(th);
    const float ly = r * sinf(th);
    for (int k = 0; k < 3; ++k)
      o[k] = cam[C_O + k] + fmaf(cam[C_DV + k], ly, cam[C_DU + k] * lx);
  }
  for (int k = 0; k < 3; ++k)
    d[k] = fmaf(cam[C_V + k], vv, fmaf(cam[C_H + k], uu, cam[C_L + k])) - o[k];
}

__global__ void __launch_bounds__(kThreads)
sphere_megakernel(const Params p) {
  __shared__ float s_sph[kFields * kMaxSpheres];
  __shared__ float s_cam[kCamSlots];
  const int n = p.n_spheres;
  for (int k = threadIdx.x; k < kFields * n; k += blockDim.x)
    s_sph[(k / n) * kMaxSpheres + k % n] = p.sph[(k / n) * p.tab_w + k % n];
  if (threadIdx.x < kCamSlots) s_cam[threadIdx.x] = p.cam[threadIdx.x];
  __syncthreads();
#define SPH(field, i) s_sph[(field) * kMaxSpheres + (i)]

  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = local < p.n_pix;
  const int lin = p.pix_offset + local;
  const uint32_t pix = (uint32_t)lin;
  const float px = (float)(lin % p.width);
  const float py = (float)(lin / p.width);
  const int flags = p.flags;

  float o[3], d[3];
  float thr[3] = {1.f, 1.f, 1.f};
  float acc[3] = {0.f, 0.f, 0.f};
  int sample = 0;
  int depth = 0;
  unsigned int n_bounce = 0;
  if (valid) camera_ray(s_cam, p, pix, p.sample_base, px, py, o, d);

  const int max_iters = p.spp * p.max_depth + 1;
  for (int it = 0; valid && sample < p.spp && it < max_iters; ++it) {
    ++n_bounce;
    const uint32_t sid = p.sample_base + (uint32_t)sample;
    const float a = dot3(d, d);

    // Closest sphere (HitSphere, gpu_kernel.cl:455-487): the first index
    // of the smallest t wins.
    float best_t = kBig;
    int best_i = 0;
    for (int i = 0; i < n; ++i) {
      const float oc[3] = {o[0] - SPH(F_CX, i), o[1] - SPH(F_CY, i),
                           o[2] - SPH(F_CZ, i)};
      const float half_b = dot3(oc, d);
      const float c = dot3(oc, oc) - SPH(F_R2, i);
      const float disc = fmaf(half_b, half_b, -(a * c));
      if (disc >= 0.f) {
        const float sq = sqrtf(fmaxf(disc, 1e-30f));
        float t = (-half_b - sq) / a;
        if (!(t >= p.t_min)) {
          t = (-half_b + sq) / a;
          if (!(t >= p.t_min)) t = kBig;
        }
        if (t < best_t) {
          best_t = t;
          best_i = i;
        }
      }
    }

    bool term = true;
    float c[3] = {0.f, 0.f, 0.f};
    if (!(best_t < kBig)) {
      // miss: throughput times the sky (gpu_kernel.cl:342-347)
      if (flags & SKY_CONST) {
        for (int k = 0; k < 3; ++k) c[k] = thr[k] * s_cam[C_SKY + k];
      } else {
        const float t = 0.5f * (d[1] / sqrtf(a) + 1.f);
        c[0] = thr[0] * fmaf(t, 0.5f, 1.f - t);
        c[1] = thr[1] * fmaf(t, 0.7f, 1.f - t);
        c[2] = thr[2] * fmaf(t, 1.f, 1.f - t);
      }
    } else {
      const int bi = best_i;
      float h[3], nrm[3];
      for (int k = 0; k < 3; ++k) h[k] = fmaf(best_t, d[k], o[k]);
      for (int k = 0; k < 3; ++k)
        nrm[k] = (h[k] - SPH(F_CX + k, bi)) / SPH(F_R, bi);
      const bool front = dot3(d, nrm) < 0.f;
      if (!front)
        for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
      const float alb[3] = {SPH(F_ALR, bi), SPH(F_ALG, bi), SPH(F_ALB, bi)};
      const int mt = (int)SPH(F_TYPE, bi);

      float ua[4], ub[4];
      uniform4(p.seed, pix, sid, 4u + 2u * (uint32_t)depth, ua);

      // Lambertian (gpu_kernel.cl:398-413)
      const float zu = 2.f * ua[0] - 1.f;
      const float phi = kTwoPi * ua[1];
      const float ru = sqrtf(fmaxf(0.f, fmaf(-zu, zu, 1.f)));
      float dir[3] = {nrm[0] + ru * cosf(phi), nrm[1] + ru * sinf(phi),
                      nrm[2] + zu};
      if (fabsf(dir[0]) < 1e-8f && fabsf(dir[1]) < 1e-8f &&
          fabsf(dir[2]) < 1e-8f)
        for (int k = 0; k < 3; ++k) dir[k] = nrm[k];
      float att[3] = {alb[0], alb[1], alb[2]};
      bool absorbed = false;
      const bool is_metal = (flags & HAS_METAL) && mt == METAL;
      const bool is_diel = (flags & HAS_DIEL) && mt == DIELECTRIC;
      const bool emitted = (flags & HAS_EMIT) && mt == EMISSIVE;

      if (is_metal || is_diel) {
        const float len = sqrtf(a);
        const float ud[3] = {d[0] / len, d[1] / len, d[2] / len};
        const float dn = dot3(ud, nrm);
        float ref[3];
        for (int k = 0; k < 3; ++k) ref[k] = fmaf(-nrm[k], 2.f * dn, ud[k]);
        if (is_metal) {
          // MetalScatter (gpu_kernel.cl:415-423)
          for (int k = 0; k < 3; ++k) dir[k] = ref[k];
          if (flags & HAS_FUZZ) {
            uniform4(p.seed, pix, sid, 5u + 2u * (uint32_t)depth, ub);
            const float zs = 2.f * ua[2] - 1.f;
            const float phs = kTwoPi * ua[3];
            const float rs = sqrtf(fmaxf(0.f, fmaf(-zs, zs, 1.f)));
            const float rad = cbrtf(ub[0]);
            const float fz = SPH(F_FUZZ, bi);
            dir[0] = fmaf((rs * cosf(phs)) * rad, fz, ref[0]);
            dir[1] = fmaf((rs * sinf(phs)) * rad, fz, ref[1]);
            dir[2] = fmaf(zs * rad, fz, ref[2]);
          }
          absorbed = dot3(dir, nrm) <= 0.f;
        } else {
          // TransparentScatter (gpu_kernel.cl:425-451)
          uniform4(p.seed, pix, sid, 5u + 2u * (uint32_t)depth, ub);
          const float ratio = front ? SPH(F_INVIOR, bi) : SPH(F_IOR, bi);
          const float cos_t = fminf(-dn, 1.f);
          const float sin_t = sqrtf(fmaxf(fmaf(-cos_t, cos_t, 1.f), 1e-20f));
          float r0 = (1.f - ratio) / (1.f + ratio);
          r0 = r0 * r0;
          const float x = 1.f - cos_t;
          const float x2 = x * x;
          const float refl = fmaf(1.f - r0, x * (x2 * x2), r0);
          if (ratio * sin_t > 1.f || refl > ub[1]) {
            for (int k = 0; k < 3; ++k) dir[k] = ref[k];
          } else {
            float rp[3];
            for (int k = 0; k < 3; ++k) rp[k] = fmaf(nrm[k], cos_t, ud[k]) * ratio;
            const float par = sqrtf(fmaxf(fabsf(1.f - dot3(rp, rp)), 1e-20f));
            for (int k = 0; k < 3; ++k) dir[k] = rp[k] - nrm[k] * par;
          }
          for (int k = 0; k < 3; ++k) att[k] = 1.f;
        }
      }

      if (emitted) {
        // emissive: throughput times albedo (gpu_kernel.cl:326-329)
        for (int k = 0; k < 3; ++k) c[k] = thr[k] * alb[k];
      } else if (!absorbed && depth + 1 < p.max_depth) {
        // continue; a scatter at depth max_depth-1 ends the path black
        // (gpu_kernel.cl:337-340)
        term = false;
        for (int k = 0; k < 3; ++k) {
          o[k] = h[k];
          d[k] = dir[k];
          thr[k] = thr[k] * att[k];
        }
        ++depth;
      }
    }

    if (term) {
      // clamp-before-average and NaN policy (gpu_kernel.cl:632-642)
      for (int k = 0; k < 3; ++k) {
        float v = (flags & CLAMP) ? clamp01(c[k]) : c[k];
        if (isnan(v)) v = (flags & NAN_RUNNING_SUM) ? acc[k] : 0.f;
        acc[k] = acc[k] + v;
      }
      ++sample;
      if (sample < p.spp) {
        camera_ray(s_cam, p, pix, p.sample_base + (uint32_t)sample, px, py,
                   o, d);
        thr[0] = thr[1] = thr[2] = 1.f;
        depth = 0;
      }
    }
  }
#undef SPH

  if (valid) {
    p.out_r[local] = acc[0] / (float)p.spp;
    p.out_g[local] = acc[1] / (float)p.spp;
    p.out_b[local] = acc[2] / (float)p.spp;
  }
  if (p.bounces != nullptr) {
    const unsigned int warp_sum = __reduce_add_sync(0xffffffffu, n_bounce);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(p.bounces, (unsigned long long)warp_sum);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): nonzero
// when the launch was refused.  Outputs are (n_pix,) float planes; bounces,
// when not null, receives the number of bounces traced.
extern "C" int sphere_megakernel_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    float* out_r, float* out_g, float* out_b, unsigned long long* bounces,
    int n_pix, int pix_offset, unsigned int seed, unsigned int sample_base,
    int width, int height, int spp, int max_depth, float t_min, int flags,
    void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || tab_w < n_spheres ||
      n_pix < 0 || width < 1 || height < 1 || spp < 1 || max_depth < 1)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  Params p;
  p.cam = cam;
  p.sph = sph;
  p.out_r = out_r;
  p.out_g = out_g;
  p.out_b = out_b;
  p.bounces = bounces;
  p.tab_w = tab_w;
  p.n_spheres = n_spheres;
  p.n_pix = n_pix;
  p.pix_offset = pix_offset;
  p.seed = seed;
  p.sample_base = sample_base;
  p.width = width;
  p.height = height;
  p.spp = spp;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.flags = flags;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  sphere_megakernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

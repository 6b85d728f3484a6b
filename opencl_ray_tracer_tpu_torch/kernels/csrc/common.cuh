// Device code shared by the sphere megakernel (megakernel.cu), its backward
// (megagrad.cu) and the mesh megakernel (megamesh.cu): the counter RNG, the
// camera ray, the closest-sphere search, the skies (gradient, constant and
// the HDR image's texel) and the material scatter.
// The backward replays the forward with exactly this code, so both take the
// same discrete decisions (winner, root, front face, absorb, reflect or
// refract) bit for bit.
//
// The arithmetic follows the plain PyTorch tracer op for op: divisions where
// it divides, IEEE sqrtf, sinf and cosf, and fmaf exactly where the plain
// tracer fuses a multiply-add (see _fp.py).  The libraries are built with
// --fmad=false so that nvcc fuses nothing else.
//
// The one exception is the fuzz radius u^(1/3) (fuzz_radius below).  The
// forward kernel takes cbrtf, the faster.  The backward defines
// ORT_FUZZ_POWF and takes powf(u, 1/3), which equals ATen's pow(u, 1/3) on
// the card bit for bit; cbrtf differs from it by an ulp in 21% of the
// draws, and chains of fuzzy-metal bounces amplify that ulp until, at depth
// 50, the gradients of the sphere centres move by 22% against the plain
// version.  So the backward replays the plain version's paths, and where
// cbrtf and powf differ its replay may leave the forward's path; the image
// cotangent it is given is the forward's.

#pragma once

#include <cstdint>

namespace ort {

constexpr int kFields = 13;
constexpr int kCamSlots = 22;
constexpr float kBig = 3.4e38f;
constexpr float kTwoPi = 6.283185307179586f;
// float32 1/(2 pi) and 1/pi, the HDR lookup's factors (scene/sky.py)
constexpr float kInvTwoPi = (float)(0.5 / 3.14159265358979323846);
constexpr float kInvPi = (float)(1.0 / 3.14159265358979323846);

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
  HAS_APERTURE = 16, CLAMP = 32, NAN_RUNNING_SUM = 64, SKY_CONST = 128,
  SKY_HDR = 256, RAW_SUM = 512
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

// The radius of a fuzz draw in the unit ball, u^(1/3) (see the note above).
__device__ __forceinline__ float fuzz_radius(float u) {
#ifdef ORT_FUZZ_POWF
  return powf(u, 1.f / 3.f);
#else
  return cbrtf(u);
#endif
}

// Clamp to [0, 1] that lets NaN through, as the reference's compares do.
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

// The draws of a camera sample that its ray depends on: viewport
// coordinates and the lens offset (zero without an aperture).
struct CamDraw {
  float uu, vv, lx, ly;
};

// GetRay (gpu_kernel.cl:559-578) for one pixel and sample.
__device__ __forceinline__ CamDraw camera_ray(const float* cam, uint32_t seed,
                                              int width, int height,
                                              int flags, uint32_t pix,
                                              uint32_t sample, float px,
                                              float py, float o[3],
                                              float d[3]) {
  float u[4];
  uniform4(seed, pix, sample, 0u, u);
  CamDraw cd;
  cd.uu = (px + u[0]) / (float)width;
  cd.vv = (py + u[1]) / (float)height;
  cd.lx = 0.f;
  cd.ly = 0.f;
  for (int k = 0; k < 3; ++k) o[k] = cam[C_O + k];
  if (flags & HAS_APERTURE) {
    const float r = sqrtf(u[2]);
    const float th = kTwoPi * u[3];
    cd.lx = r * cosf(th);
    cd.ly = r * sinf(th);
    for (int k = 0; k < 3; ++k)
      o[k] = cam[C_O + k] + fmaf(cam[C_DV + k], cd.ly, cam[C_DU + k] * cd.lx);
  }
  for (int k = 0; k < 3; ++k)
    d[k] = fmaf(cam[C_V + k], cd.vv, fmaf(cam[C_H + k], cd.uu, cam[C_L + k]))
           - o[k];
  return cd;
}

// Closest sphere (HitSphere, gpu_kernel.cl:455-487): the first index of the
// smallest t, kBig for a miss.  sph holds the table rows with row stride
// `stride`; a = |d|^2.
__device__ __forceinline__ void closest_sphere(const float* sph, int stride,
                                               int n, const float o[3],
                                               const float d[3], float a,
                                               float t_min, float& best_t,
                                               int& best_i) {
  best_t = kBig;
  best_i = 0;
  for (int i = 0; i < n; ++i) {
    const float oc[3] = {o[0] - sph[F_CX * stride + i],
                         o[1] - sph[F_CY * stride + i],
                         o[2] - sph[F_CZ * stride + i]};
    const float half_b = dot3(oc, d);
    const float c = dot3(oc, oc) - sph[F_R2 * stride + i];
    const float disc = fmaf(half_b, half_b, -(a * c));
    if (disc >= 0.f) {
      const float sq = sqrtf(fmaxf(disc, 1e-30f));
      float t = (-half_b - sq) / a;
      if (!(t >= t_min)) {
        t = (-half_b + sq) / a;
        if (!(t >= t_min)) t = kBig;
      }
      if (t < best_t) {
        best_t = t;
        best_i = i;
      }
    }
  }
}

// The gradient sky (the dead-code vestige at gpu_kernel.cl:268-269) or the
// constant sky colour, for a miss ray d with a = |d|^2.
__device__ __forceinline__ void sky_colour(const float* cam, int flags,
                                           const float d[3], float a,
                                           float sky[3]) {
  if (flags & SKY_CONST) {
    for (int k = 0; k < 3; ++k) sky[k] = cam[C_SKY + k];
  } else {
    const float t = 0.5f * (d[1] / sqrtf(a) + 1.f);
    sky[0] = fmaf(t, 0.5f, 1.f - t);
    sky[1] = fmaf(t, 0.7f, 1.f - t);
    sky[2] = fmaf(t, 1.f, 1.f - t);
  }
}

// An HDR sky: the (h, w, 3) float32 image of its texels, row-major.
struct HdrImage {
  const float* px;
  int w;
  int h;
};

// The texel an HDR sky shows in direction d, with a = |d|^2 (its dot3): the
// equirect lookup of scene/sky.py (Vec3ToUV, gpu_kernel.cl:234-241) in the
// same operations, u = fma(atan2(z, x), 1/(2 pi), 0.5) and
// v = fma(2 atan2(y, 1 + sqrt((1 - y)(1 + y))), -1/pi, 0.5) on the unit
// direction, then x = int(u w), y = int(v h), truncated and clamped to the
// image (gpu_kernel.cl:342-346).  Returns the texel's index y * w + x.
__device__ __forceinline__ int hdr_texel(const HdrImage& im, const float d[3],
                                         float a) {
  const float len = sqrtf(a);
  const float nx = d[0] / len, ny = d[1] / len, nz = d[2] / len;
  const float u = fmaf(atan2f(nz, nx), kInvTwoPi, 0.5f);
  const float y = fminf(fmaxf(ny, -1.f), 1.f);
  const float as = 2.f * atan2f(y, 1.f + sqrtf((1.f - y) * (1.f + y)));
  const float v = fmaf(as, -kInvPi, 0.5f);
  int tx = (int)(u * (float)im.w);
  int ty = (int)(v * (float)im.h);
  tx = tx < 0 ? 0 : (tx > im.w - 1 ? im.w - 1 : tx);
  ty = ty < 0 ? 0 : (ty > im.h - 1 ? im.h - 1 : ty);
  return ty * im.w + tx;
}

// The sky of sky_colour above, or with SKY_HDR in flags the texel of the
// HDR image im, read through the read-only cache.
__device__ __forceinline__ void sky_colour(const float* cam, int flags,
                                           const HdrImage& im,
                                           const float d[3], float a,
                                           float sky[3]) {
  if (flags & SKY_HDR) {
    const float* t = im.px + 3 * hdr_texel(im, d, a);
    for (int k = 0; k < 3; ++k) sky[k] = __ldg(t + k);
  } else {
    sky_colour(cam, flags, d, a, sky);
  }
}

// Scatter at a hit: the new direction, the attenuation, and whether a metal
// absorbs or an emissive surface ends the path.  nrm is the front-facing
// normal; a = |d|^2.
struct Scatter {
  float dir[3];
  float att[3];
  bool absorbed;
  bool emitted;
};

// The material of sphere bi, read from the sphere table with row stride
// `stride`.
struct SphereMaterial {
  const float* sph;
  int stride;
  int bi;
  __device__ __forceinline__ float albedo(int k) const {
    return sph[(F_ALR + k) * stride + bi];
  }
  __device__ __forceinline__ int type() const {
    return (int)sph[F_TYPE * stride + bi];
  }
  __device__ __forceinline__ float fuzz() const {
    return sph[F_FUZZ * stride + bi];
  }
  __device__ __forceinline__ float ior() const {
    return sph[F_IOR * stride + bi];
  }
  __device__ __forceinline__ float inv_ior() const {
    return sph[F_INVIOR * stride + bi];
  }
};

// Scatter with the material m (a SphereMaterial, or megamesh.cu's uniform
// mesh material).
template <class Material>
__device__ __forceinline__ Scatter scatter_material(const Material& m,
                                                    int flags, uint32_t seed,
                                                    uint32_t pix, uint32_t sid,
                                                    int depth,
                                                    const float d[3], float a,
                                                    const float nrm[3],
                                                    bool front) {
  Scatter s;
  const float alb[3] = {m.albedo(0), m.albedo(1), m.albedo(2)};
  const int mt = m.type();

  float ua[4], ub[4];
  uniform4(seed, pix, sid, 4u + 2u * (uint32_t)depth, ua);

  // Lambertian (gpu_kernel.cl:398-413)
  const float zu = 2.f * ua[0] - 1.f;
  const float phi = kTwoPi * ua[1];
  const float ru = sqrtf(fmaxf(0.f, fmaf(-zu, zu, 1.f)));
  s.dir[0] = nrm[0] + ru * cosf(phi);
  s.dir[1] = nrm[1] + ru * sinf(phi);
  s.dir[2] = nrm[2] + zu;
  if (fabsf(s.dir[0]) < 1e-8f && fabsf(s.dir[1]) < 1e-8f &&
      fabsf(s.dir[2]) < 1e-8f)
    for (int k = 0; k < 3; ++k) s.dir[k] = nrm[k];
  for (int k = 0; k < 3; ++k) s.att[k] = alb[k];
  s.absorbed = false;
  const bool is_metal = (flags & HAS_METAL) && mt == METAL;
  const bool is_diel = (flags & HAS_DIEL) && mt == DIELECTRIC;
  s.emitted = (flags & HAS_EMIT) && mt == EMISSIVE;

  if (is_metal || is_diel) {
    const float len = sqrtf(a);
    const float ud[3] = {d[0] / len, d[1] / len, d[2] / len};
    const float dn = dot3(ud, nrm);
    float ref[3];
    for (int k = 0; k < 3; ++k) ref[k] = fmaf(-nrm[k], 2.f * dn, ud[k]);
    if (is_metal) {
      // MetalScatter (gpu_kernel.cl:415-423)
      for (int k = 0; k < 3; ++k) s.dir[k] = ref[k];
      if (flags & HAS_FUZZ) {
        uniform4(seed, pix, sid, 5u + 2u * (uint32_t)depth, ub);
        const float zs = 2.f * ua[2] - 1.f;
        const float phs = kTwoPi * ua[3];
        const float rs = sqrtf(fmaxf(0.f, fmaf(-zs, zs, 1.f)));
        const float rad = fuzz_radius(ub[0]);
        const float fz = m.fuzz();
        s.dir[0] = fmaf((rs * cosf(phs)) * rad, fz, ref[0]);
        s.dir[1] = fmaf((rs * sinf(phs)) * rad, fz, ref[1]);
        s.dir[2] = fmaf(zs * rad, fz, ref[2]);
      }
      s.absorbed = dot3(s.dir, nrm) <= 0.f;
    } else {
      // TransparentScatter (gpu_kernel.cl:425-451)
      uniform4(seed, pix, sid, 5u + 2u * (uint32_t)depth, ub);
      const float ratio = front ? m.inv_ior() : m.ior();
      const float cos_t = fminf(-dn, 1.f);
      const float sin_t = sqrtf(fmaxf(fmaf(-cos_t, cos_t, 1.f), 1e-20f));
      float r0 = (1.f - ratio) / (1.f + ratio);
      r0 = r0 * r0;
      const float x = 1.f - cos_t;
      const float x2 = x * x;
      const float refl = fmaf(1.f - r0, x * (x2 * x2), r0);
      if (ratio * sin_t > 1.f || refl > ub[1]) {
        for (int k = 0; k < 3; ++k) s.dir[k] = ref[k];
      } else {
        float rp[3];
        for (int k = 0; k < 3; ++k)
          rp[k] = fmaf(nrm[k], cos_t, ud[k]) * ratio;
        const float par = sqrtf(fmaxf(fabsf(1.f - dot3(rp, rp)), 1e-20f));
        for (int k = 0; k < 3; ++k) s.dir[k] = rp[k] - nrm[k] * par;
      }
      for (int k = 0; k < 3; ++k) s.att[k] = 1.f;
    }
  }
  return s;
}

// Scatter at a hit of sphere bi of the table sph (row stride `stride`).
__device__ __forceinline__ Scatter scatter_hit(const float* sph, int stride,
                                               int bi, int flags,
                                               uint32_t seed, uint32_t pix,
                                               uint32_t sid, int depth,
                                               const float d[3], float a,
                                               const float nrm[3],
                                               bool front) {
  return scatter_material(SphereMaterial{sph, stride, bi}, flags, seed, pix,
                          sid, depth, d, a, nrm, front);
}

}  // namespace ort

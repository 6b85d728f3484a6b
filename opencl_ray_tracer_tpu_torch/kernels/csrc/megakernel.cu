// Sphere megakernel: forward path tracing of a sphere scene (at most 128
// spheres) under a gradient or constant sky, one thread per pixel.
//
// Replaces opencl_ray_tracer_tpu/kernels/megakernel.py::_make_kernel, the
// Pallas TPU kernel that runs the same wavefront loop over (64,128)-pixel
// tiles held in VMEM.
//
// What bounds it: FP32 ALU work.  Every bounce of every path tests every
// sphere: 17 FLOPs per test, 4 to 6 more for a hit, so the work is
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
// Sample windows (checkpointed renders): with acc0 a thread starts its sum
// from the pixel's sum over the samples before sample_base, so the NaN
// running-sum policy sees every earlier sample (gpu_kernel.cl:640-642), and
// with RAW_SUM it stores the sum instead of the mean.  Its samples still
// add in order, so windows that tile [0, spp) give the monolithic sum bit
// for bit.  A launch with neither runs the instance without this code
// (kWindow false), so a monolithic render reads no plane and keeps its
// code.
//
// The arithmetic follows the plain PyTorch tracer op for op: divisions
// where it divides, a division by sqrtf(a) rather than rsqrtf, IEEE sqrtf,
// sinf and cosf, and fmaf exactly where the plain tracer fuses a
// multiply-add (dot products as fma chains, the discriminant, the hit
// point, the camera ray, reflect and refract; see _fp.py and common.cuh,
// which holds the device code shared with the backward kernel).  The
// library is built with --fmad=false so that nvcc fuses nothing else.  On
// the card the kernel and the plain version then round alike, apart from
// cbrtf against the plain version's pow(u, 1/3) for the fuzz radius and
// the plain version's fma, which rounds through float64.  This matters
// because the large ground spheres make |oc|^2 - r^2 cancel: a one-ulp
// difference anywhere moves the self-intersection test of grazing rays
// near t_min and so flips whole samples.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace ort;

constexpr int kThreads = 128;
constexpr int kMaxSpheres = 128;

struct Params {
  const float* cam;
  const float* sph;
  float* out_r;
  float* out_g;
  float* out_b;
  const float* acc0;            // (3, n_pix) sums to start from, or null
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

// kWindow: a sample window (acc0 or RAW_SUM); the monolithic instance
// has no code for either.
template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
sphere_megakernel(const Params p) {
  __shared__ float s_sph[kFields * kMaxSpheres];
  __shared__ float s_cam[kCamSlots];
  const int n = p.n_spheres;
  for (int k = threadIdx.x; k < kFields * n; k += blockDim.x)
    s_sph[(k / n) * kMaxSpheres + k % n] = p.sph[(k / n) * p.tab_w + k % n];
  for (int k = threadIdx.x; k < kCamSlots; k += blockDim.x)
    s_cam[k] = p.cam[k];
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
  if (kWindow && valid && p.acc0 != nullptr)
    for (int k = 0; k < 3; ++k) acc[k] = p.acc0[k * p.n_pix + local];
  int sample = 0;
  int depth = 0;
  unsigned int n_bounce = 0;
  if (valid)
    camera_ray(s_cam, p.seed, p.width, p.height, flags, pix, p.sample_base,
               px, py, o, d);

  const int max_iters = p.spp * p.max_depth + 1;
  for (int it = 0; valid && sample < p.spp && it < max_iters; ++it) {
    ++n_bounce;
    const uint32_t sid = p.sample_base + (uint32_t)sample;
    const float a = dot3(d, d);
    float best_t;
    int best_i;
    closest_sphere(s_sph, kMaxSpheres, n, o, d, a, p.t_min, best_t, best_i);

    bool term = true;
    float c[3] = {0.f, 0.f, 0.f};
    if (!(best_t < kBig)) {
      // miss: throughput times the sky (gpu_kernel.cl:342-347)
      float sky[3];
      sky_colour(s_cam, flags, d, a, sky);
      for (int k = 0; k < 3; ++k) c[k] = thr[k] * sky[k];
    } else {
      const int bi = best_i;
      float h[3], nrm[3];
      for (int k = 0; k < 3; ++k) h[k] = fmaf(best_t, d[k], o[k]);
      for (int k = 0; k < 3; ++k)
        nrm[k] = (h[k] - SPH(F_CX + k, bi)) / SPH(F_R, bi);
      const bool front = dot3(d, nrm) < 0.f;
      if (!front)
        for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
      const Scatter sc = scatter_hit(s_sph, kMaxSpheres, bi, flags, p.seed,
                                     pix, sid, depth, d, a, nrm, front);

      if (sc.emitted) {
        // emissive: throughput times albedo (gpu_kernel.cl:326-329)
        for (int k = 0; k < 3; ++k) c[k] = thr[k] * SPH(F_ALR + k, bi);
      } else if (!sc.absorbed && depth + 1 < p.max_depth) {
        // continue; a scatter at depth max_depth-1 ends the path black
        // (gpu_kernel.cl:337-340)
        term = false;
        for (int k = 0; k < 3; ++k) {
          o[k] = h[k];
          d[k] = sc.dir[k];
          thr[k] = thr[k] * sc.att[k];
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
        camera_ray(s_cam, p.seed, p.width, p.height, flags, pix,
                   p.sample_base + (uint32_t)sample, px, py, o, d);
        thr[0] = thr[1] = thr[2] = 1.f;
        depth = 0;
      }
    }
  }
#undef SPH

  if (valid) {
    // the mean (gpu_kernel.cl:647), or the raw sum of a sample window
    const bool raw = kWindow && (flags & RAW_SUM) != 0;
    p.out_r[local] = raw ? acc[0] : acc[0] / (float)p.spp;
    p.out_g[local] = raw ? acc[1] : acc[1] / (float)p.spp;
    p.out_b[local] = raw ? acc[2] : acc[2] / (float)p.spp;
  }
  if (p.bounces != nullptr) {
    const unsigned int warp_sum = __reduce_add_sync(0xffffffffu, n_bounce);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(p.bounces, (unsigned long long)warp_sum);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): nonzero
// when the launch was refused.  Outputs are (n_pix,) float planes: the mean
// over the spp samples from sample_base, or with RAW_SUM in flags their sum.
// acc0, when not null, is (3, n_pix) floats, the sums of the samples before
// sample_base that each pixel's sum starts from (a sample window).  bounces,
// when not null, receives the number of bounces traced.
extern "C" int sphere_megakernel_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    float* out_r, float* out_g, float* out_b, const float* acc0,
    unsigned long long* bounces,
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
  p.acc0 = acc0;
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
  if (acc0 != nullptr || (flags & RAW_SUM))
    sphere_megakernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    sphere_megakernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Sphere megakernel: forward path tracing of a sphere scene (at most 128
// spheres) under a gradient or constant sky.
//
// Replaces opencl_ray_tracer_tpu/kernels/megakernel.py::_make_kernel, the
// Pallas TPU kernel that runs the same wavefront loop over (64,128)-pixel
// tiles held in VMEM.
//
// What bounds it: FP32 ALU work.  Every bounce of every path tests every
// sphere: 17 FLOPs per test, 4 to 6 more for a hit, so the work is
// pixels x spp x mean bounces per sample x n_spheres tests, plus a scatter
// (sinf, cosf, sqrtf, a pcg4d hash pair) per bounce and a camera ray per
// sample.  The only traffic to device memory is the tables, read once per
// block, and three floats written per pixel.
//
// What the design does about it: the sphere table (13 fields x n) and the
// camera slots are staged in shared memory once per block, and all the
// threads of a warp read the same sphere at the same time, a broadcast.  A
// sphere whose discriminant is negative costs no divide and no sqrtf.  Each
// lane runs one path at a time: a path that ends is replaced at once by the
// pixel's next sample in the same loop (path regeneration), and a pixel
// that ends by the next pixel of a work counter (persistent blocks, one per
// resident slot: a lane idles only when no pixel is left).  Per loop
// iteration a lane draws once, with per-lane arguments: the next sample's
// camera draw (slot 0) or the bounce's (slot 4 + 2 depth), then one square
// root and one sinf/cosf pair (the aperture's radius and angle, the
// Lambertian's, or a fuzzy metal's fuzz direction, which reads the same
// draw), so the lanes that end a sample and those that scatter run the
// hash and the transcendentals together instead of one branch after the
// other; likewise one square root of |d|^2 and one set of three divisions
// per lane give a hit's normal or a miss's unit direction.  Only the
// second draw of fuzzy metal and dielectric lanes (the fuzz radius, the
// Fresnel draw), their reflection and refraction, and the camera ray after
// a metal absorbs stay divergent.  PERF.md holds the measured split this
// design answers (chip_smoke.py phase 6e).
//
// One pixel's samples stay in one lane and add in order, which keeps the
// running-sum NaN policy exact.  Sample windows (checkpointed renders):
// with acc0 a lane starts a pixel's sum from the pixel's sum over the
// samples before sample_base, so the NaN running-sum policy sees every
// earlier sample (gpu_kernel.cl:640-642), and with RAW_SUM it stores the
// sum instead of the mean.  So windows that tile [0, spp) give the
// monolithic sum bit for bit.  A launch with neither runs the instance
// without this code (kWindow false), so a monolithic render reads no plane
// and keeps its code.
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
// near t_min and so flips whole samples.  The merged draw keeps each
// lane's operations: the image equals the earlier one-pixel-per-thread
// design's (ORT_K1_VARIANTS below) bit for bit.

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
  unsigned long long* counts;   // bounces (the SIMT instances: kCounts)
  int* work;                    // pixels taken after the first, zeroed
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
  uint32_t zero;                // 0; the measurement cuts' perturbation
};

// Sections of the loop whose SIMT efficiency the measurement instances
// count (counts[1 + 2s] lane steps, counts[2 + 2s] warp passes): the
// sphere tests (every iteration, so 1 - its efficiency is the idle share),
// the sky, the bounce's draw and Lambertian direction, the metal and
// dielectric branches, the camera ray of the next sample, and the merged
// draw.
enum Section { kSecSphere, kSecSky, kSecLambert, kSecMetal, kSecDiel,
               kSecCamera, kSecDraw, kSections };
constexpr int kCounts = 1 + 2 * kSections + 1;

template <bool kOn>
struct Simt {
  __device__ __forceinline__ void at(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

template <>
struct Simt<true> {
  unsigned int lane[kSections] = {};
  unsigned int warp[kSections] = {};
  __device__ __forceinline__ void at(int s) {
    ++lane[s];
    if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) ++warp[s];
  }
  // All 32 lanes of the warp call this.
  __device__ __forceinline__ void flush(unsigned long long* c) {
    for (int s = 0; s < kSections; ++s) {
      const unsigned int l = __reduce_add_sync(0xffffffffu, lane[s]);
      const unsigned int w = __reduce_add_sync(0xffffffffu, warp[s]);
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(c + 1 + 2 * s, (unsigned long long)l);
        atomicAdd(c + 2 + 2 * s, (unsigned long long)w);
      }
    }
  }
};

__device__ __forceinline__ void stage_tables(const Params& p, float* s_sph,
                                             float* s_cam) {
  const int n = p.n_spheres;
  for (int k = threadIdx.x; k < kFields * n; k += blockDim.x)
    s_sph[(k / n) * kMaxSpheres + k % n] = p.sph[(k / n) * p.tab_w + k % n];
  for (int k = threadIdx.x; k < kCamSlots; k += blockDim.x)
    s_cam[k] = p.cam[k];
  __syncthreads();
}

// Clamp-before-average and NaN policy (gpu_kernel.cl:632-642): sample
// value c added to the pixel's sum.
__device__ __forceinline__ void accumulate(int flags, const float c[3],
                                           float acc[3]) {
  for (int k = 0; k < 3; ++k) {
    float v = (flags & CLAMP) ? clamp01(c[k]) : c[k];
    if (isnan(v)) v = (flags & NAN_RUNNING_SUM) ? acc[k] : 0.f;
    acc[k] = acc[k] + v;
  }
}

// The mean (gpu_kernel.cl:647), or the raw sum of a sample window.
template <bool kWindow>
__device__ __forceinline__ void store_pixel(const Params& p, int local,
                                            const float acc[3]) {
  const bool raw = kWindow && (p.flags & RAW_SUM) != 0;
  p.out_r[local] = raw ? acc[0] : acc[0] / (float)p.spp;
  p.out_g[local] = raw ? acc[1] : acc[1] / (float)p.spp;
  p.out_b[local] = raw ? acc[2] : acc[2] / (float)p.spp;
}

// One lane's pixel: its index, the counter of its RNG and its coordinates,
// and the sum it starts from.
struct PixelState {
  int local;
  uint32_t pix;
  float px, py;
};

template <bool kWindow>
__device__ __forceinline__ PixelState start_pixel(const Params& p, int local,
                                                  float acc[3]) {
  const int lin = p.pix_offset + local;
  for (int k = 0; k < 3; ++k)
    acc[k] = (kWindow && p.acc0 != nullptr) ? p.acc0[k * p.n_pix + local]
                                            : 0.f;
  return PixelState{local, (uint32_t)lin, (float)(lin % p.width),
                    (float)(lin / p.width)};
}

// The camera ray of common.cuh::camera_ray from its draw u, with the lens
// offset (lx, ly) = r (cos th, sin th) already formed (zero without an
// aperture): the same operations.
__device__ __forceinline__ void camera_from_draw(const float* cam, int flags,
                                                 const float u[4], float lx,
                                                 float ly, float px, float py,
                                                 int width, int height,
                                                 float o[3], float d[3]) {
  const float uu = (px + u[0]) / (float)width;
  const float vv = (py + u[1]) / (float)height;
  for (int k = 0; k < 3; ++k) o[k] = cam[C_O + k];
  if (flags & HAS_APERTURE)
    for (int k = 0; k < 3; ++k)
      o[k] = cam[C_O + k] + fmaf(cam[C_DV + k], ly, cam[C_DU + k] * lx);
  for (int k = 0; k < 3; ++k)
    d[k] = fmaf(cam[C_V + k], vv, fmaf(cam[C_H + k], uu, cam[C_L + k])) -
           o[k];
}

// kWindow: a sample window (acc0 or RAW_SUM); the monolithic instance has
// no code for either.  kPersistent: a lane that ends its pixel takes the
// next one from p.work (the grid holds one block per resident slot), as the
// entry point launches it; else each lane renders one pixel (a measurement
// instance).  kSimt: count the sections' SIMT efficiency.
template <bool kWindow, bool kPersistent = true, bool kSimt = false>
__global__ void __launch_bounds__(kThreads)
sphere_megakernel(const Params p) {
  __shared__ float s_sph[kFields * kMaxSpheres];
  __shared__ float s_cam[kCamSlots];
  stage_tables(p, s_sph, s_cam);
#define SPH(field, i) s_sph[(field) * kMaxSpheres + (i)]
  const int n = p.n_spheres;
  const int flags = p.flags;
  const int n_lanes = gridDim.x * kThreads;
  Simt<kSimt> simt;
  unsigned int n_bounce = 0;

  float o[3], d[3];
  float thr[3] = {1.f, 1.f, 1.f};
  float acc[3];
  int sample = 0;
  int depth = 0;
  PixelState px = {(int)(blockIdx.x * kThreads + threadIdx.x), 0u, 0.f,
                   0.f};
  bool live = px.local < p.n_pix;
  if (live) {
    px = start_pixel<kWindow>(p, px.local, acc);
    camera_ray(s_cam, p.seed, p.width, p.height, flags, px.pix,
               p.sample_base, px.px, px.py, o, d);
  }

  // Ends the lane's sample with value c: its sum, the next sample or the
  // next pixel; false when the lane has no work left.  Every sample takes
  // at most max_depth iterations, so the loop ends.
  auto end_sample = [&](const float c[3]) -> bool {
    accumulate(flags, c, acc);
    thr[0] = thr[1] = thr[2] = 1.f;
    depth = 0;
    if (++sample < p.spp) return true;
    store_pixel<kWindow>(p, px.local, acc);
    sample = 0;
    if (!kPersistent) return false;
    const int next = n_lanes + atomicAdd(p.work, 1);
    if (next >= p.n_pix) return false;
    px = start_pixel<kWindow>(p, next, acc);
    return true;
  };

  while (live) {
    ++n_bounce;
    simt.at(kSecSphere);
    const uint32_t sid = p.sample_base + (uint32_t)sample;
    const float a = dot3(d, d);
    float best_t;
    int bi;
    closest_sphere(s_sph, kMaxSpheres, n, o, d, a, p.t_min, best_t, bi);

    float c[3] = {0.f, 0.f, 0.f};
    float h[3], nrm[3];
    bool scatter = false;
    bool front = false;
    int mt = LAMBERTIAN;
    const bool hit = best_t < kBig;
    // Every lane takes |d|, and one set of three divisions gives a hit's
    // normal, (h - c) / r, or a miss's unit direction, d / |d|, which the
    // sky reads (the metal and dielectric branches reuse |d|).
    const float len = sqrtf(a);
    float den = len;
    for (int k = 0; k < 3; ++k) nrm[k] = d[k];
    if (hit) {
      for (int k = 0; k < 3; ++k) h[k] = fmaf(best_t, d[k], o[k]);
      for (int k = 0; k < 3; ++k) nrm[k] = h[k] - SPH(F_CX + k, bi);
      den = SPH(F_R, bi);
    }
    for (int k = 0; k < 3; ++k) nrm[k] = nrm[k] / den;
    if (!hit) {
      // miss: throughput times the sky (gpu_kernel.cl:342-347), as
      // common.cuh::sky_colour with d[1] / sqrtf(a) taken above
      simt.at(kSecSky);
      float sky[3];
      if (flags & SKY_CONST) {
        for (int k = 0; k < 3; ++k) sky[k] = s_cam[C_SKY + k];
      } else {
        const float t = 0.5f * (nrm[1] + 1.f);
        sky[0] = fmaf(t, 0.5f, 1.f - t);
        sky[1] = fmaf(t, 0.7f, 1.f - t);
        sky[2] = fmaf(t, 1.f, 1.f - t);
      }
      for (int k = 0; k < 3; ++k) c[k] = thr[k] * sky[k];
    } else {
      front = dot3(d, nrm) < 0.f;
      if (!front)
        for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
      mt = (int)SPH(F_TYPE, bi);
      if ((flags & HAS_EMIT) && mt == EMISSIVE) {
        // emissive: throughput times albedo (gpu_kernel.cl:326-329)
        for (int k = 0; k < 3; ++k) c[k] = thr[k] * SPH(F_ALR + k, bi);
      } else {
        // a scatter at depth max_depth-1 ends the path black
        // (gpu_kernel.cl:337-340), so it draws nothing
        scatter = depth + 1 < p.max_depth;
      }
    }
    if (!scatter) {
      live = end_sample(c);
      if (!live) break;
    }

    // The lane's one draw: the bounce's (slot 4 + 2 depth), or the camera
    // draw (slot 0) of the sample that now starts; then one square root
    // and one angle: the aperture's (sqrt u2, 2 pi u3), a fuzzy metal's
    // (the unit-sphere radius of zs = 2 u2 - 1, 2 pi u3), or the
    // Lambertian's (that of zu = 2 u0 - 1, 2 pi u1).
    simt.at(kSecDraw);
    const bool is_metal = scatter && (flags & HAS_METAL) && mt == METAL;
    const bool is_diel = scatter && (flags & HAS_DIEL) && mt == DIELECTRIC;
    const bool fuzz_in_draw = is_metal && (flags & HAS_FUZZ);
    float u[4];
    uniform4(p.seed, px.pix, scatter ? sid : p.sample_base + (uint32_t)sample,
             scatter ? 4u + 2u * (uint32_t)depth : 0u, u);
    const float zu = 2.f * u[0] - 1.f;
    const float zs = 2.f * u[2] - 1.f;
    float root = 0.f, cs = 0.f, sn = 0.f;
    if (scatter || (flags & HAS_APERTURE)) {
      const float z = fuzz_in_draw ? zs : zu;
      root = sqrtf(scatter ? fmaxf(0.f, fmaf(-z, z, 1.f)) : u[2]);
      const float ang =
          kTwoPi * ((scatter && !fuzz_in_draw) ? u[1] : u[3]);
      cs = cosf(ang);
      sn = sinf(ang);
    }
    if (!scatter) {
      simt.at(kSecCamera);
      camera_from_draw(s_cam, flags, u, root * cs, root * sn, px.px, px.py,
                       p.width, p.height, o, d);
      continue;
    }

    // the scatter of common.cuh::scatter_material, whose Lambertian
    // direction metal and dielectric lanes overwrite
    float dir[3];
    float att[3] = {SPH(F_ALR, bi), SPH(F_ALG, bi), SPH(F_ALB, bi)};
    bool absorbed = false;
    if (!is_metal && !is_diel) {
      // Lambertian (gpu_kernel.cl:398-413)
      simt.at(kSecLambert);
      dir[0] = nrm[0] + root * cs;
      dir[1] = nrm[1] + root * sn;
      dir[2] = nrm[2] + zu;
      if (fabsf(dir[0]) < 1e-8f && fabsf(dir[1]) < 1e-8f &&
          fabsf(dir[2]) < 1e-8f)
        for (int k = 0; k < 3; ++k) dir[k] = nrm[k];
    } else {
      const float ud[3] = {d[0] / len, d[1] / len, d[2] / len};
      const float dn = dot3(ud, nrm);
      float ref[3];
      for (int k = 0; k < 3; ++k) ref[k] = fmaf(-nrm[k], 2.f * dn, ud[k]);
      // the second draw, which fuzzy metal and dielectric lanes share
      float ub[4];
      if (is_diel || (flags & HAS_FUZZ))
        uniform4(p.seed, px.pix, sid, 5u + 2u * (uint32_t)depth, ub);
      if (is_metal) {
        // MetalScatter (gpu_kernel.cl:415-423)
        simt.at(kSecMetal);
        for (int k = 0; k < 3; ++k) dir[k] = ref[k];
        if (flags & HAS_FUZZ) {
          // root, cs and sn are the fuzz's (the merged slot above)
          const float rad = fuzz_radius(ub[0]);
          const float fz = SPH(F_FUZZ, bi);
          dir[0] = fmaf((root * cs) * rad, fz, ref[0]);
          dir[1] = fmaf((root * sn) * rad, fz, ref[1]);
          dir[2] = fmaf(zs * rad, fz, ref[2]);
        }
        absorbed = dot3(dir, nrm) <= 0.f;
      } else {
        // TransparentScatter (gpu_kernel.cl:425-451)
        simt.at(kSecDiel);
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
          for (int k = 0; k < 3; ++k)
            rp[k] = fmaf(nrm[k], cos_t, ud[k]) * ratio;
          const float par = sqrtf(fmaxf(fabsf(1.f - dot3(rp, rp)), 1e-20f));
          for (int k = 0; k < 3; ++k) dir[k] = rp[k] - nrm[k] * par;
        }
        for (int k = 0; k < 3; ++k) att[k] = 1.f;
      }
    }
    if (absorbed) {
      // a metal that absorbs ends the sample black; the next sample's
      // camera ray takes its own draw
      live = end_sample(c);
      if (live) {
        simt.at(kSecCamera);
        camera_ray(s_cam, p.seed, p.width, p.height, flags, px.pix,
                   p.sample_base + (uint32_t)sample, px.px, px.py, o, d);
      }
      continue;
    }
    for (int k = 0; k < 3; ++k) {
      o[k] = h[k];
      d[k] = dir[k];
      thr[k] = thr[k] * att[k];
    }
    ++depth;
  }
#undef SPH

  if (p.counts != nullptr) {
    const unsigned int warp_sum = __reduce_add_sync(0xffffffffu, n_bounce);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(p.counts, (unsigned long long)warp_sum);
    simt.flush(p.counts);
  }
}

// The launch's parameters; false when an argument is out of range.
bool sphere_params(Params& p, const float* cam, const float* sph, int tab_w,
                   int n_spheres, float* out_r, float* out_g, float* out_b,
                   const float* acc0, unsigned long long* counts, int* work,
                   int n_pix, int pix_offset, unsigned int seed,
                   unsigned int sample_base, int width, int height, int spp,
                   int max_depth, float t_min, int flags) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || tab_w < n_spheres ||
      n_pix < 0 || width < 1 || height < 1 || spp < 1 || max_depth < 1 ||
      work == nullptr)
    return false;
  p.cam = cam;
  p.sph = sph;
  p.out_r = out_r;
  p.out_g = out_g;
  p.out_b = out_b;
  p.acc0 = acc0;
  p.counts = counts;
  p.work = work;
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
  p.zero = 0;
  return true;
}

// Blocks of a launch of kernel fn over n_pix pixels: one per resident slot
// when persistent, at most one per kThreads pixels; 0 when the occupancy
// query fails.
int grid_blocks(const void* fn, bool persistent, int n_pix) {
  const int per_pixel = (n_pix + kThreads - 1) / kThreads;
  if (!persistent) return per_pixel;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    return 0;
  return per_pixel < sms * per_sm ? per_pixel : sms * per_sm;
}

template <bool kWindow>
int launch(const Params& p, cudaStream_t stream) {
  const auto fn = sphere_megakernel<kWindow>;
  const int blocks = grid_blocks((const void*)fn, true, p.n_pix);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  fn<<<blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): nonzero
// when the launch was refused.  Outputs are (n_pix,) float planes: the mean
// over the spp samples from sample_base, or with RAW_SUM in flags their sum.
// acc0, when not null, is (3, n_pix) floats, the sums of the samples before
// sample_base that each pixel's sum starts from (a sample window).  bounces,
// when not null, receives the number of bounces traced.  work: one int,
// zero on the stream, that the lanes count the pixels they take on.
extern "C" int sphere_megakernel_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    float* out_r, float* out_g, float* out_b, const float* acc0,
    unsigned long long* bounces, int* work,
    int n_pix, int pix_offset, unsigned int seed, unsigned int sample_base,
    int width, int height, int spp, int max_depth, float t_min, int flags,
    void* stream) {
  Params p;
  if (!sphere_params(p, cam, sph, tab_w, n_spheres, out_r, out_g, out_b,
                     acc0, bounces, work, n_pix, pix_offset, seed,
                     sample_base, width, height, spp, max_depth, t_min,
                     flags))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  if (acc0 != nullptr || (flags & RAW_SUM))
    return launch<true>(p, (cudaStream_t)stream);
  return launch<false>(p, (cudaStream_t)stream);
}

#ifdef ORT_K1_VARIANTS
// The measurement build: the earlier design and its timing cuts, and the
// kernel's options, which chip_smoke.py's split of K1 launches (no entry
// point launches them).
namespace {

// The earlier design (one pixel per thread, 128-thread blocks; a lane
// whose pixel ends idles until its warp's last pixel ends; each branch
// draws on its own) and its cuts: kSimtOld counts the sections' SIMT
// efficiency; kTwice* run one section a second time, from inputs xor
// p.zero (the same values: zero is 0) with the result kept alive, so that
// the difference from the earlier design is that section's time without
// changing any path.  The metal and dielectric branches are kTwiceScatter
// less kTwiceLambert.
enum Cut { kCutNone, kSimtOld, kTwiceSphere, kTwiceSky, kTwiceLambert,
           kTwiceScatter, kTwiceCamera };

__device__ __forceinline__ float perturb(float x, uint32_t z) {
  return __uint_as_float(__float_as_uint(x) ^ z);
}

template <int kCut>
__global__ void __launch_bounds__(kThreads)
sphere_megakernel_earlier(const Params p) {
  __shared__ float s_sph[kFields * kMaxSpheres];
  __shared__ float s_cam[kCamSlots];
  stage_tables(p, s_sph, s_cam);
#define SPH(field, i) s_sph[(field) * kMaxSpheres + (i)]
  const int n = p.n_spheres;
  const uint32_t z = p.zero;
  Simt<kCut == kSimtOld> simt;
  uint32_t sink = 0;

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
  if (valid)
    camera_ray(s_cam, p.seed, p.width, p.height, flags, pix, p.sample_base,
               px, py, o, d);

  const int max_iters = p.spp * p.max_depth + 1;
  for (int it = 0; valid && sample < p.spp && it < max_iters; ++it) {
    ++n_bounce;
    simt.at(kSecSphere);
    const uint32_t sid = p.sample_base + (uint32_t)sample;
    const float a = dot3(d, d);
    float best_t;
    int best_i;
    closest_sphere(s_sph, kMaxSpheres, n, o, d, a, p.t_min, best_t, best_i);
    if constexpr (kCut == kTwiceSphere) {
      const float o2[3] = {perturb(o[0], z), perturb(o[1], z),
                           perturb(o[2], z)};
      float t2;
      int i2;
      closest_sphere(s_sph, kMaxSpheres, n, o2, d, a, p.t_min, t2, i2);
      sink ^= __float_as_uint(t2) ^ (uint32_t)i2;
    }

    bool term = true;
    float c[3] = {0.f, 0.f, 0.f};
    if (!(best_t < kBig)) {
      simt.at(kSecSky);
      float sky[3];
      sky_colour(s_cam, flags, d, a, sky);
      if constexpr (kCut == kTwiceSky) {
        const float d2[3] = {perturb(d[0], z), perturb(d[1], z),
                             perturb(d[2], z)};
        float sky2[3];
        sky_colour(s_cam, flags, d2, a, sky2);
        sink ^= __float_as_uint(sky2[0]) ^ __float_as_uint(sky2[2]);
      }
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
      simt.at(kSecLambert);
      if constexpr (kCut == kSimtOld) {
        const int mt = (int)SPH(F_TYPE, bi);
        if ((flags & HAS_METAL) && mt == METAL) simt.at(kSecMetal);
        if ((flags & HAS_DIEL) && mt == DIELECTRIC) simt.at(kSecDiel);
      }
      const Scatter sc = scatter_hit(s_sph, kMaxSpheres, bi, flags, p.seed,
                                     pix, sid, depth, d, a, nrm, front);
      if constexpr (kCut == kTwiceLambert) {
        // the draw and direction every hit takes first
        float ua[4];
        uniform4(p.seed ^ z, pix, sid, 4u + 2u * (uint32_t)depth, ua);
        const float zu = 2.f * ua[0] - 1.f;
        const float phi = kTwoPi * ua[1];
        const float ru = sqrtf(fmaxf(0.f, fmaf(-zu, zu, 1.f)));
        sink ^= __float_as_uint(nrm[0] + ru * cosf(phi)) ^
                __float_as_uint(nrm[1] + ru * sinf(phi));
      }
      if constexpr (kCut == kTwiceScatter) {
        const float d2[3] = {perturb(d[0], z), perturb(d[1], z),
                             perturb(d[2], z)};
        const float n2[3] = {perturb(nrm[0], z), perturb(nrm[1], z),
                             perturb(nrm[2], z)};
        const Scatter s2 = scatter_hit(s_sph, kMaxSpheres, bi, flags,
                                       p.seed ^ z, pix, sid, depth, d2, a,
                                       n2, front);
        sink ^= __float_as_uint(s2.dir[0]) ^ __float_as_uint(s2.dir[1]) ^
                __float_as_uint(s2.dir[2]) ^ (uint32_t)s2.absorbed;
      }

      if (sc.emitted) {
        for (int k = 0; k < 3; ++k) c[k] = thr[k] * SPH(F_ALR + k, bi);
      } else if (!sc.absorbed && depth + 1 < p.max_depth) {
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
      accumulate(flags, c, acc);
      ++sample;
      if (sample < p.spp) {
        simt.at(kSecCamera);
        camera_ray(s_cam, p.seed, p.width, p.height, flags, pix,
                   p.sample_base + (uint32_t)sample, px, py, o, d);
        if constexpr (kCut == kTwiceCamera) {
          float o2[3], d2[3];
          camera_ray(s_cam, p.seed ^ z, p.width, p.height, flags, pix,
                     p.sample_base + (uint32_t)sample, px, py, o2, d2);
          sink ^= __float_as_uint(d2[0]) ^ __float_as_uint(d2[1]) ^
                  __float_as_uint(o2[0]);
        }
        thr[0] = thr[1] = thr[2] = 1.f;
        depth = 0;
      }
    }
  }
#undef SPH

  if (valid) store_pixel<false>(p, local, acc);
  if (p.counts != nullptr) {
    const unsigned int warp_sum = __reduce_add_sync(0xffffffffu, n_bounce);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(p.counts, (unsigned long long)warp_sum);
    simt.flush(p.counts);
    // a cut's kept-alive result, which no run expects to meet
    if (sink == 0x9e3779b9u) atomicAdd(p.counts + kCounts - 1, 1ull);
  }
}

struct VariantFn {
  void (*fn)(const Params);
  bool persistent;
};

// chip_smoke.py's K1_VARIANTS names these in this order.
const VariantFn kVariants[] = {
    {sphere_megakernel_earlier<kCutNone>, false},
    {sphere_megakernel_earlier<kSimtOld>, false},
    {sphere_megakernel_earlier<kTwiceSphere>, false},
    {sphere_megakernel_earlier<kTwiceSky>, false},
    {sphere_megakernel_earlier<kTwiceLambert>, false},
    {sphere_megakernel_earlier<kTwiceScatter>, false},
    {sphere_megakernel_earlier<kTwiceCamera>, false},
    // the kernel with one pixel per thread (no work counter)
    {sphere_megakernel<false, false>, false},
    // the kernel counting its sections' SIMT efficiency
    {sphere_megakernel<false, true, true>, true},
};
constexpr int kEarlierVariants = 7;  // the earlier design and its cuts
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

// Launches variant v as sphere_megakernel_launch (no window), counts, when
// not null, holding kCounts entries (the SIMT instances fill counts[1..]).
// The earlier design and its cuts read no work counter.
extern "C" int sphere_megakernel_variant_launch(
    int v, const float* cam, const float* sph, int tab_w, int n_spheres,
    float* out_r, float* out_g, float* out_b, unsigned long long* counts,
    int* work, int n_pix, unsigned int seed, int width, int height, int spp,
    int max_depth, float t_min, int flags, void* stream) {
  Params p;
  if (v < 0 || v >= kNumVariants || (flags & RAW_SUM) ||
      !sphere_params(p, cam, sph, tab_w, n_spheres, out_r, out_g, out_b,
                     nullptr, counts, work, n_pix, 0, seed, 0, width, height,
                     spp, max_depth, t_min, flags))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  const VariantFn& vf = kVariants[v];
  const int blocks = grid_blocks((const void*)vf.fn, vf.persistent, n_pix);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  // the earlier design's cuts run at its blocks an SM: unused dynamic
  // shared memory holds a cut that needs fewer registers to them
  size_t smem = 0;
  if (v < kEarlierVariants) {
    int base = 0, own = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &base, (const void*)kVariants[0].fn, kThreads, 0) != cudaSuccess)
      return (int)cudaErrorInvalidConfiguration;
    while (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &own, (const void*)vf.fn, kThreads, smem) == cudaSuccess &&
           own > base && smem < 48 * 1024)
      smem += 1024;
  }
  vf.fn<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The number of counts of sphere_megakernel_variant_launch.
extern "C" int sphere_megakernel_variant_counts() { return kCounts; }
#endif

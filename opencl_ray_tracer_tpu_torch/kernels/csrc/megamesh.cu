// Mesh megakernel: forward path tracing of a scene of at most 128 spheres
// and one uniform-material triangle mesh in gating boxes, under a gradient or
// constant sky, or of at most 128 spheres and no or such a mesh under an HDR
// sky, one thread per pixel.
//
// Replaces opencl_ray_tracer_tpu/kernels/megamesh.py::_make_kernel, its mesh
// body and its HDR body: the Pallas TPU kernel that intersects tiles of
// pixel rows with triangle chunks on the MXU, wavefront by wavefront, with
// multi-round tail compaction.  The compaction ladder, its overflow
// re-render and the row batching are TPU scheduling and stay there.  So do
// the HDR records: a TPU lane cannot gather from an image in VMEM, so the
// Pallas kernel writes each miss's throughput and direction and XLA looks
// the texels up afterwards.  A thread here reads the texel where its ray
// misses (common.cuh::hdr_texel; a 1024x512 image is 6.3 MB and stays in
// L2) and clamps the sample's term before the average as for any sky, so
// it takes texels and albedos above 1, which the Pallas kernel's deferred
// sum (past the clamp) cannot.
//
// The per-pixel estimator is the sphere megakernel's (megakernel.cu),
// unchanged: path regeneration, the same pcg4d slots, clamp-before-average,
// the NaN running sum, black on depth exhaustion, and its sample windows
// (acc0, RAW_SUM).  JAX's compaction ladder sums a window's samples out of
// order; a thread here sums them in order, so windows give the monolithic
// sum bit for bit.  Each bounce finds the
// closest sphere (common.cuh) and then the closest triangle nearer than it
// (mesh.cuh, the test the closest-triangle kernel runs); a sphere wins a
// tie.  A triangle hit takes the table's unit normal and the mesh material
// of the camera table's slots C_MA.. (kernels/megamesh.py).
//
// What bounds it: FP32 work, in the triangle tests (38 FLOPs each) and the
// sphere tests (17 each), plus the slab tests that cull; device memory
// holds only the tables and an HDR sky's image, read through the caches
// (one texel of 12 bytes per miss), and three floats written per pixel.
//
// What the design does about it: the culling of mesh.cuh, per ray and per
// bounce: the gating boxes first, then the boxes of groups of up to 8
// chunks, then the AABB and sub-boxes of each chunk of a group the ray
// enters, each entered before the nearer of the sphere hit and the triangle
// hit so far (the plan orders chunks front to back from the camera).  A ray
// that hits the ground sphere before the mesh's box tests no triangle.  The
// measured split (PERF.md, chip_smoke.py phase 6f) put the time elsewhere
// than the box slabs: in the triangle tests, whose 19 rows a test reads lie
// in 19 lines of the (22, t_pad) table, and in lanes whose pixel has ended
// while their warp runs on (37% of the bounce loop's lane steps).  So the
// triangle tests read the table's triangle-major copy (five float4 from one
// 96-byte row), and the blocks are persistent: a lane that ends its pixel
// takes the next from a work counter, as the sphere megakernel's do.  Left
// for later work: divergence between the rays of a warp that enter
// different runs (the walk's slabs run at 13-31% SIMT efficiency).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mesh.cuh"

namespace {

using namespace ort;

constexpr int kThreads = 128;
constexpr int kMaxSpheres = 128;

struct Params {
  const float* cam;
  const float* sph;
  int tab_w;
  int n_spheres;
  MeshTables mt;
  int mesh_type;
  float* out_r;
  float* out_g;
  float* out_b;
  const float* acc0;            // (3, n_pix) sums to start from, or null
  unsigned long long* counts;   // bounces, triangle tests
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
  HdrImage sky;
  int* work;                    // kOptPersistent: pixels taken, zeroed
  uint32_t zero;                // 0; the measurement instances' perturbation
};

// The kernel's options (kOpt bits).  kOptMajor: the triangle tests read
// the triangle-major copy of the table (MeshTables::tri_major, five float4
// a test).  kOptPersistent: a lane that ends its pixel takes the next from
// p.work, as megakernel.cu's lanes do (the grid holds one block per
// resident slot).
enum Opt { kOptMajor = 1, kOptPersistent = 2 };
// The options the entry point's kernel takes; the measurement build of the
// earlier walk (ORT_FLAT_WALK) is the earlier kernel, with neither.
constexpr int kOptK2 = kFlatWalk ? 0 : kOptMajor | kOptPersistent;

// The measurement build's instances (ORT_K2_VARIANTS; chip_smoke.py's split
// of the walk), besides the options: the earlier walk and the grouped walk
// counting what they test (WalkCount; counts[2..]), each running its walk a
// second time from the origin xor p.zero (the same rays: zero is 0) with
// the result kept alive, so that the difference from the kernel is the
// walk's time, and the grouped walk running each run's triangle tests
// twice (their time).
enum Variant { kPlain, kCountFlat, kCountGrouped, kTwiceFlat, kTwiceGrouped,
               kTwiceRuns };

// kWindow: a sample window (acc0 or RAW_SUM), as in megakernel.cu.
template <bool kWindow, int kOpt = kOptK2, int kVar = kPlain>
__global__ void __launch_bounds__(kThreads)
mesh_megakernel(const Params p) {
  constexpr bool kPersistent = (kOpt & kOptPersistent) != 0;
  __shared__ float s_sph[kFields * kMaxSpheres];
  __shared__ float s_cam[kMeshCamSlots];
  const int n = p.n_spheres;
  for (int k = threadIdx.x; k < kFields * n; k += blockDim.x)
    s_sph[(k / n) * kMaxSpheres + k % n] = p.sph[(k / n) * p.tab_w + k % n];
  for (int k = threadIdx.x; k < kMeshCamSlots; k += blockDim.x)
    s_cam[k] = p.cam[k];
  __syncthreads();
  const MeshTables& mt = p.mt;
#define SPH(field, i) s_sph[(field) * kMaxSpheres + (i)]
  const int flags = p.flags;
  const int n_lanes = gridDim.x * kThreads;

  // the lane's pixel and its sample's state
  int local = blockIdx.x * kThreads + threadIdx.x;
  bool live = local < p.n_pix;
  uint32_t pix = 0;
  float px = 0.f, py = 0.f;
  float o[3], d[3];
  float thr[3] = {1.f, 1.f, 1.f};
  float acc[3] = {0.f, 0.f, 0.f};
  int sample = 0;
  int depth = 0;
  auto start_pixel = [&]() {
    const int lin = p.pix_offset + local;
    pix = (uint32_t)lin;
    px = (float)(lin % p.width);
    py = (float)(lin / p.width);
    for (int k = 0; k < 3; ++k)
      acc[k] = (kWindow && p.acc0 != nullptr) ? p.acc0[k * p.n_pix + local]
                                              : 0.f;
    camera_ray(s_cam, p.seed, p.width, p.height, flags, pix, p.sample_base,
               px, py, o, d);
  };
  unsigned int n_bounce = 0;
  unsigned int n_tests = 0;
  WalkCount wc;                  // kCountFlat, kCountGrouped
  uint32_t sink = 0;             // kTwice*
  if (live) start_pixel();

  // Every sample takes at most max_depth steps, so the loop ends.
  while (live) {
    ++n_bounce;
    if constexpr (kVar == kCountFlat || kVar == kCountGrouped)
      wc.at(kBounceStep);
    const uint32_t sid = p.sample_base + (uint32_t)sample;
    const float a = dot3(d, d);
    float best_t;
    int best_i;
    closest_sphere(s_sph, kMaxSpheres, n, o, d, a, p.t_min, best_t, best_i);
    float tri_t = kBig;
    int tri_i = 0;
    if constexpr (kVar == kCountFlat) {
      closest_triangle_flat(mt, o, d, p.t_min, best_t, tri_t, tri_i,
                            n_tests, wc);
    } else if constexpr (kVar == kCountGrouped) {
      closest_triangle_grouped(mt, o, d, p.t_min, best_t, tri_t, tri_i,
                               n_tests, wc);
    } else if constexpr (kVar == kTwiceRuns) {
      TwiceRuns tr{p.zero, 0u};
      closest_triangle_grouped(mt, o, d, p.t_min, best_t, tri_t, tri_i,
                               n_tests, tr);
      sink ^= tr.sink;
    } else {
      closest_triangle<(kOpt & kOptMajor) != 0>(mt, o, d, p.t_min, best_t,
                                                tri_t, tri_i, n_tests);
    }
    if constexpr (kVar == kTwiceFlat || kVar == kTwiceGrouped) {
      float o2[3];
      for (int k = 0; k < 3; ++k)
        o2[k] = __uint_as_float(__float_as_uint(o[k]) ^ p.zero);
      float t2 = kBig;
      int i2 = 0;
      unsigned int tests2 = 0;
      NoWalkProbe np;
      if constexpr (kVar == kTwiceFlat)
        closest_triangle_flat(mt, o2, d, p.t_min, best_t, t2, i2, tests2,
                              np);
      else
        closest_triangle_grouped(mt, o2, d, p.t_min, best_t, t2, i2, tests2,
                                 np);
      sink ^= __float_as_uint(t2) ^ (uint32_t)i2 ^ tests2;
    }
    const bool tri_win = tri_t < best_t;
    const float t = tri_win ? tri_t : best_t;

    bool term = true;
    float c[3] = {0.f, 0.f, 0.f};
    if (!(t < kBig)) {
      // miss: throughput times the sky (gpu_kernel.cl:342-347)
      float sky[3];
      sky_colour(s_cam, flags, p.sky, d, a, sky);
      for (int k = 0; k < 3; ++k) c[k] = thr[k] * sky[k];
    } else {
      float h[3], nrm[3];
      for (int k = 0; k < 3; ++k) h[k] = fmaf(t, d[k], o[k]);
      if (tri_win) {
        for (int k = 0; k < 3; ++k)
          nrm[k] = __ldg(p.mt.tri + (T_N + k) * p.mt.t_pad + tri_i);
      } else {
        for (int k = 0; k < 3; ++k)
          nrm[k] = (h[k] - SPH(F_CX + k, best_i)) / SPH(F_R, best_i);
      }
      const bool front = dot3(d, nrm) < 0.f;
      if (!front)
        for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
      const HitMaterial mat =
          tri_win ? mesh_material(s_cam, p.mesh_type)
                  : sphere_material(s_sph, kMaxSpheres, best_i);
      const Scatter sc = scatter_material(mat, flags, p.seed, pix, sid, depth,
                                          d, a, nrm, front);

      if (sc.emitted) {
        // emissive: throughput times albedo (gpu_kernel.cl:326-329)
        for (int k = 0; k < 3; ++k) c[k] = thr[k] * mat.albedo(k);
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
      thr[0] = thr[1] = thr[2] = 1.f;
      depth = 0;
      if (++sample < p.spp) {
        camera_ray(s_cam, p.seed, p.width, p.height, flags, pix,
                   p.sample_base + (uint32_t)sample, px, py, o, d);
        continue;
      }
      // the mean (gpu_kernel.cl:647), or the raw sum of a sample window
      const bool raw = kWindow && (flags & RAW_SUM) != 0;
      p.out_r[local] = raw ? acc[0] : acc[0] / (float)p.spp;
      p.out_g[local] = raw ? acc[1] : acc[1] / (float)p.spp;
      p.out_b[local] = raw ? acc[2] : acc[2] / (float)p.spp;
      sample = 0;
      if constexpr (kPersistent) {
        local = n_lanes + atomicAdd(p.work, 1);
        live = local < p.n_pix;
        if (live) start_pixel();
      } else {
        live = false;
      }
    }
  }
#undef SPH

  if (p.counts != nullptr) {
    const unsigned int bounce_sum = __reduce_add_sync(0xffffffffu, n_bounce);
    const unsigned int test_sum = __reduce_add_sync(0xffffffffu, n_tests);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(p.counts, (unsigned long long)bounce_sum);
      atomicAdd(p.counts + 1, (unsigned long long)test_sum);
    }
    if constexpr (kVar == kCountFlat || kVar == kCountGrouped)
      for (int k = 0; k < kWalkKinds; ++k) {
        const unsigned int lanes = __reduce_add_sync(0xffffffffu, wc.lane[k]);
        const unsigned int warps = __reduce_add_sync(0xffffffffu, wc.warp[k]);
        if ((threadIdx.x & 31) == 0) {
          atomicAdd(p.counts + 2 + k, (unsigned long long)lanes);
          atomicAdd(p.counts + 2 + kWalkKinds + k,
                    (unsigned long long)warps);
        }
      }
    if constexpr (kVar == kTwiceFlat || kVar == kTwiceGrouped ||
                  kVar == kTwiceRuns)
      if (sink == 0x9e3779b9u)
        atomicAdd(p.counts + 2 + 2 * kWalkKinds, 1ull);
  }
}

}  // namespace

// The launch's parameters from the entry point's arguments; false when an
// argument is out of range.
static bool mesh_params(
    Params& p, const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    const float* group, const int* group_end, int n_groups,
    const float* tri_major, int mesh_type, float* out_r, float* out_g,
    float* out_b, const float* acc0,
    unsigned long long* counts, int* work, int n_pix, int pix_offset,
    unsigned int seed,
    unsigned int sample_base, int width, int height, int spp, int max_depth,
    float t_min, int flags, const float* sky, int sky_w, int sky_h) {
  const bool hdr = (flags & SKY_HDR) != 0;
  const bool no_mesh = hdr && n_chunks == 0 && n_boxes == 0;
  if (n_spheres < 0 || n_spheres > kMaxSpheres || tab_w < n_spheres ||
      (!no_mesh && !mesh_args_ok(t_pad, n_chunks, n_boxes, n_groups)) ||
      (no_mesh && n_groups != 0) ||
      (hdr && (sky == nullptr || sky_w < 1 || sky_h < 1)) ||
      n_pix < 0 || width < 1 || height < 1 ||
      spp < 1 || max_depth < 1)
    return false;
  p.cam = cam;
  p.sph = sph;
  p.tab_w = tab_w;
  p.n_spheres = n_spheres;
  p.mt = MeshTables{tri, t_pad, cluster, sub, chunk_box, n_chunks, boxes,
                    n_boxes, group, group_end, n_groups, tri_major};
  p.mesh_type = mesh_type;
  p.out_r = out_r;
  p.out_g = out_g;
  p.out_b = out_b;
  p.acc0 = acc0;
  p.counts = counts;
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
  p.sky = HdrImage{sky, sky_w, sky_h};
  p.work = work;
  p.zero = 0;
  return true;
}

// Launches instance fn (options opt) of the kernel: one block per resident
// slot when persistent (at most one per kThreads pixels).
static int launch_kernel(const void* fn, int opt, const Params& p,
                         cudaStream_t stream) {
  int blocks = (p.n_pix + kThreads - 1) / kThreads;
  if (opt & kOptPersistent) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0) != cudaSuccess ||
        per_sm < 1)
      return (int)cudaErrorInvalidConfiguration;
    if (blocks > sms * per_sm) blocks = sms * per_sm;
  }
  void* args[] = {(void*)&p};
  const cudaError_t rc =
      cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, 0, stream);
  cudaGetLastError();  // the launch's error, which rc carries, cleared
  return (int)rc;
}

#define MESH_ARGS                                                           \
  const float *cam, const float *sph, int tab_w, int n_spheres,             \
      const float *tri, int t_pad, const float *cluster, const float *sub,  \
      const int *chunk_box, int n_chunks, const float *boxes, int n_boxes,  \
      const float *group, const int *group_end, int n_groups,               \
      const float *tri_major, int mesh_type, float *out_r, float *out_g,    \
      float *out_b, const float *acc0, unsigned long long *counts,          \
      int *work, int n_pix, int pix_offset, unsigned int seed,              \
      unsigned int sample_base, int width, int height, int spp,             \
      int max_depth, float t_min, int flags, const float *sky, int sky_w,   \
      int sky_h, void *stream
#define MESH_PARAMS                                                         \
  p, cam, sph, tab_w, n_spheres, tri, t_pad, cluster, sub, chunk_box,       \
      n_chunks, boxes, n_boxes, group, group_end, n_groups, tri_major,      \
      mesh_type, out_r, out_g, out_b, acc0, counts, work, n_pix,            \
      pix_offset, seed, sample_base, width, height, spp, max_depth, t_min,  \
      flags, sky, sky_w, sky_h

// Launches the kernel on `stream` and returns cudaGetLastError(): nonzero
// when the launch was refused.  Outputs are (n_pix,) float planes, the mean
// or with RAW_SUM the sum, from the sums of acc0 when it is not null, as
// sphere_megakernel_launch's (megakernel.cu); counts,
// when not null, receives the bounces traced and the triangle tests run.
// With SKY_HDR in flags, sky is the (sky_h, sky_w, 3) image of an HDR sky
// and the scene may have no triangles (n_chunks, n_boxes and n_groups 0).
// work: one int, zero on the stream, that the lanes count the pixels they
// take on.
extern "C" int mesh_megakernel_launch(MESH_ARGS) {
  Params p;
  if (!mesh_params(MESH_PARAMS) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  const bool window = acc0 != nullptr || (flags & RAW_SUM);
  return launch_kernel(window ? (const void*)mesh_megakernel<true>
                              : (const void*)mesh_megakernel<false>,
                       kOptK2, p, (cudaStream_t)stream);
}

#ifdef ORT_K2_VARIANTS
namespace {

struct VariantFn {
  void (*fn)(const Params);
  int opt;
};

// chip_smoke.py's K2_VARIANTS names these in this order: the counting and
// timing instances, then the kernel without both its options and without
// each.
const VariantFn kVariants[] = {
    {mesh_megakernel<false, 0, kCountFlat>, 0},
    {mesh_megakernel<false, 0, kCountGrouped>, 0},
    {mesh_megakernel<false, 0, kTwiceFlat>, 0},
    {mesh_megakernel<false, 0, kTwiceGrouped>, 0},
    {mesh_megakernel<false, 0, kTwiceRuns>, 0},
    {mesh_megakernel<false, 0>, 0},
    {mesh_megakernel<false, kOptPersistent>, kOptPersistent},
    {mesh_megakernel<false, kOptMajor>, kOptMajor},
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

// The measurement build's instances by index, launched as
// mesh_megakernel_launch (no window) with counts of 2 + 2 * kWalkKinds + 1
// entries.
extern "C" int mesh_megakernel_variant_launch(int v, MESH_ARGS) {
  Params p;
  if (v < 0 || v >= kNumVariants || acc0 != nullptr || (flags & RAW_SUM) ||
      work == nullptr || !mesh_params(MESH_PARAMS))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  return launch_kernel((const void*)kVariants[v].fn, kVariants[v].opt, p,
                       (cudaStream_t)stream);
}
#endif

#undef MESH_ARGS
#undef MESH_PARAMS

namespace {

__global__ void __launch_bounds__(kThreads)
    hdr_texel_kernel(const float* d, int n, HdrImage im, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float di[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  out[i] = hdr_texel(im, di, dot3(di, di));
}

}  // namespace

// The texel index y * w + x that the kernel's HDR lookup gives for each of
// the n directions d (n x 3), into out (n ints): the lookup alone, to hold
// it against scene/sky.py's on the card.  Returns cudaGetLastError().
extern "C" int hdr_texel_launch(const float* d, int n, int sky_w, int sky_h,
                                int* out, void* stream) {
  if (n < 0 || sky_w < 1 || sky_h < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  hdr_texel_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(d, n, HdrImage{nullptr, sky_w,
                                                             sky_h},
                                             out);
  return (int)cudaGetLastError();
}

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
// L2).  That is the same sum: in the scope of kernels/megamesh.py (texels
// and albedos at most 1) a sky term is at most 1, so the clamp before the
// average leaves it as it is.
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
// bounce: the gating boxes first, then each chunk's AABB and sub-boxes,
// entered before the nearer of the sphere hit and the triangle hit so far
// (the plan orders chunks front to back from the camera).  A ray that hits
// the ground sphere before the mesh's box tests no triangle.  The triangle
// table (22 floats per triangle, 1.35 MB for 15,360 triangles) stays in L2;
// the rays of a warp that test the same run read each column as one
// broadcast.  Left for later work: divergence between the rays of a warp
// that enter different runs, and the serial walk over all chunks.

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
};

// kWindow: a sample window (acc0 or RAW_SUM), as in megakernel.cu.
template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
mesh_megakernel(const Params p) {
  __shared__ float s_sph[kFields * kMaxSpheres];
  __shared__ float s_cam[kMeshCamSlots];
  const int n = p.n_spheres;
  for (int k = threadIdx.x; k < kFields * n; k += blockDim.x)
    s_sph[(k / n) * kMaxSpheres + k % n] = p.sph[(k / n) * p.tab_w + k % n];
  for (int k = threadIdx.x; k < kMeshCamSlots; k += blockDim.x)
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
  unsigned int n_tests = 0;
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
    float tri_t = kBig;
    int tri_i = 0;
    closest_triangle(p.mt, o, d, p.t_min, best_t, tri_t, tri_i, n_tests);
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
  if (p.counts != nullptr) {
    const unsigned int bounce_sum = __reduce_add_sync(0xffffffffu, n_bounce);
    const unsigned int test_sum = __reduce_add_sync(0xffffffffu, n_tests);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(p.counts, (unsigned long long)bounce_sum);
      atomicAdd(p.counts + 1, (unsigned long long)test_sum);
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): nonzero
// when the launch was refused.  Outputs are (n_pix,) float planes, the mean
// or with RAW_SUM the sum, from the sums of acc0 when it is not null, as
// sphere_megakernel_launch's (megakernel.cu); counts,
// when not null, receives the bounces traced and the triangle tests run.
// With SKY_HDR in flags, sky is the (sky_h, sky_w, 3) image of an HDR sky
// and the scene may have no triangles (n_chunks and n_boxes 0).
extern "C" int mesh_megakernel_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    int mesh_type, float* out_r, float* out_g, float* out_b,
    const float* acc0,
    unsigned long long* counts, int n_pix, int pix_offset, unsigned int seed,
    unsigned int sample_base, int width, int height, int spp, int max_depth,
    float t_min, int flags, const float* sky, int sky_w, int sky_h,
    void* stream) {
  const bool hdr = (flags & SKY_HDR) != 0;
  const bool no_mesh = hdr && n_chunks == 0 && n_boxes == 0;
  if (n_spheres < 0 || n_spheres > kMaxSpheres || tab_w < n_spheres ||
      (!no_mesh && (n_chunks < 1 || t_pad < n_chunks * kChunk ||
                    n_boxes < 1)) ||
      (hdr && (sky == nullptr || sky_w < 1 || sky_h < 1)) ||
      n_pix < 0 || width < 1 || height < 1 ||
      spp < 1 || max_depth < 1)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  Params p;
  p.cam = cam;
  p.sph = sph;
  p.tab_w = tab_w;
  p.n_spheres = n_spheres;
  p.mt = MeshTables{tri, t_pad, cluster, sub, chunk_box, n_chunks, boxes,
                    n_boxes};
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
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  if (acc0 != nullptr || (flags & RAW_SUM))
    mesh_megakernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    mesh_megakernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

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

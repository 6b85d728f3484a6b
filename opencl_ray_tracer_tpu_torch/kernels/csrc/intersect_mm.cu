// Closest-triangle kernel: for each ray of a batch, the closest triangle of a
// cluster-planned mesh, (t, index).
//
// Replaces opencl_ray_tracer_tpu/kernels/intersect_mm.py::_make_kernel, the
// Pallas TPU kernel that multiplies a tile of 512 rays' features by 2048
// triangles' weight columns on the MXU and skips the chunks no ray of the
// tile can hit.  This kernel takes its semantics, not its matmul: the plain
// tracer's hit function on the card (tracer/render.py: tri_backend "pallas",
// or "auto" from 256 triangles).
//
// What bounds it: FP32 work, 38 FLOPs per triangle test (mesh.cuh), when
// the culling leaves many tests; else the slab tests and the loads of the
// triangle table.  The only traffic to device memory the work needs is the
// rays in, two numbers out and the tables once.
//
// What the design does about it: each ray walks the mesh on its own with
// mesh.cuh's grouped walk, the walk of the mesh megakernel and the
// backward kernels: the gating boxes (the reference's per-ray box gate),
// then in plan order each group's box, its chunks' padded AABBs and their
// sub-boxes, each entered before the best t so far, and the runs of
// triangles behind them, read from the (kTriRows, t_pad) table.  The grid
// holds as many blocks as can be resident; a lane whose ray is done takes
// the next from a work counter, so no lane waits on a warp-mate's longer
// walk for its next ray.  The earlier design (kept in the measurement
// build ORT_K3_VARIANTS below for chip_smoke.py's split) took a block-wide
// vote per chunk and staged every chunk that some ray of the block needed
// in shared memory; it runs the same triangle tests and finds the same
// winners, the first index in plan order of the smallest t.  What the
// measurements chose (chip_smoke.py phase 10b, PERF.md), on the batches of
// the kernel's two callers, the plain tracer's render and the plain
// gradient route's winner search (tracer/diffhit.py): there few rays share
// a chunk (1.6% of chunks staged on the render's busiest batch) and the
// votes took 38% of the time; over all their launches this kernel was
// 1.39x (render) and 1.08x (gradient route) faster than the earlier
// design.  The triangle-major reads were slower there than the row-major
// table, and persistent lanes faster than a thread per ray.  Where many
// rays share chunks (2^20 random rays aimed at the mesh, or a mesh split
// over 40 boxes), batches neither caller makes, the staged table was
// 1.1-1.5x faster.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "mesh.cuh"

namespace {

using namespace ort;

constexpr int kThreads = 128;

struct Params {
  MeshTables mt;
  const float* o;      // (n_rays, 3)
  const float* d;      // (n_rays, 3)
  int n_rays;
  float t_min;
  float* out_t;
  int* out_i;
  unsigned long long* tests;
  int* work;           // rays taken beyond the first a lane, zeroed
  uint32_t zero;       // 0; the measurement instances' perturbation
};

// Adds v, summed over the warp, to *c: one atomic a warp.
__device__ __forceinline__ void count_warp(unsigned long long* c,
                                           unsigned int v) {
  const unsigned int w = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicAdd(c, (unsigned long long)w);
}

// Ray r's closest triangle into out_t and out_i, through the grouped walk
// with probe pr; tests counts the triangle tests.
template <class Probe>
__device__ __forceinline__ void closest_of_ray(const Params& p, int r,
                                               unsigned int& tests,
                                               Probe& pr) {
  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = p.o[3 * r + k];
    d[k] = p.d[3 * r + k];
  }
  float best_t = kBig;
  int best_i = 0;
  closest_triangle_grouped(p.mt, o, d, p.t_min, kBig, best_t, best_i, tests,
                           pr);
  p.out_t[r] = best_t;
  p.out_i[r] = best_i;
}

// The kernel: persistent lanes, each ray's grouped walk.  Its measurement
// instances (kOpt bits): kOptCount counts the walk's slabs and runs per
// lane and per warp pass (WalkCount, at tests[1..12]), kOptTwiceRuns runs
// each run's triangle tests a second time from the same ray (their time).
enum Opt { kOptCount = 1, kOptTwiceRuns = 2 };

template <int kOpt = 0>
__global__ void __launch_bounds__(kThreads) closest_tri_kernel(const Params p) {
  unsigned int tests = 0;
  std::conditional_t<(kOpt & kOptCount) != 0, WalkCount,
                     std::conditional_t<(kOpt & kOptTwiceRuns) != 0,
                                        TwiceRuns, NoWalkProbe>> pr{};
  if constexpr ((kOpt & kOptTwiceRuns) != 0) pr.z = p.zero;
  const int n_lanes = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < p.n_rays;
       r = n_lanes + atomicAdd(p.work, 1))
    closest_of_ray(p, r, tests, pr);
  if (p.tests != nullptr) {
    count_warp(p.tests, tests);
    if constexpr ((kOpt & kOptCount) != 0)
      for (int k = 0; k < kWalkKinds; ++k) {
        count_warp(p.tests + 1 + k, pr.lane[k]);
        count_warp(p.tests + 1 + kWalkKinds + k, pr.warp[k]);
      }
    if constexpr ((kOpt & kOptTwiceRuns) != 0)
      if (pr.sink == 0x7fffffffu) atomicAdd(p.tests, 0ull);
  }
}

bool k3_args_ok(int t_pad, int n_chunks, int n_boxes, int n_groups,
                int n_rays) {
  return n_rays >= 0 && mesh_args_ok(t_pad, n_chunks, n_boxes, n_groups);
}

// p from the entry points' arguments.
Params k3_params(const float* tri, int t_pad, const float* cluster,
                 const float* sub, const int* chunk_box, int n_chunks,
                 const float* boxes, int n_boxes, const float* group,
                 const int* group_end, int n_groups, const float* tri_major,
                 const float* o, const float* d, int n_rays, float t_min,
                 float* out_t, int* out_i, unsigned long long* tests,
                 int* work) {
  Params p{};
  p.mt = MeshTables{tri, t_pad, cluster, sub, chunk_box, n_chunks, boxes,
                    n_boxes, group, group_end, n_groups, tri_major};
  p.o = o;
  p.d = d;
  p.n_rays = n_rays;
  p.t_min = t_min;
  p.out_t = out_t;
  p.out_i = out_i;
  p.tests = tests;
  p.work = work;
  return p;
}

// Launches instance fn: a block per 128 rays, or for the kernel
// (persistent) at most one block per resident slot.
cudaError_t launch_k3(const void* fn, bool persistent, const Params& p,
                      cudaStream_t stream) {
  int blocks = (p.n_rays + kThreads - 1) / kThreads;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0) != cudaSuccess)
      return cudaErrorInvalidConfiguration;
    if (sms * per_sm < blocks) blocks = sms * per_sm;
  }
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, 0, stream);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): nonzero
// when the launch was refused.  Tables as kernels/intersect_mm.py's
// table_args gives every mesh kernel (tri, t_pad, cluster, sub, chunk_box,
// n_chunks, boxes, n_boxes, group, group_end, n_groups, tri_major; this
// kernel does not read tri_major); tests, when not
// null, receives the number of triangle tests run; work: one int, zero on
// the stream, that the lanes count the rays they take on.
extern "C" int closest_tri_launch(
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    const float* group, const int* group_end, int n_groups,
    const float* tri_major, const float* o, const float* d, int n_rays,
    float t_min, float* out_t, int* out_i, unsigned long long* tests,
    int* work, void* stream) {
  if (!k3_args_ok(t_pad, n_chunks, n_boxes, n_groups, n_rays) ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Params p = k3_params(tri, t_pad, cluster, sub, chunk_box, n_chunks,
                             boxes, n_boxes, group, group_end, n_groups,
                             tri_major, o, d, n_rays, t_min, out_t, out_i,
                             tests, work);
  const cudaError_t e = launch_k3((const void*)closest_tri_kernel<>, true, p,
                                  (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

#ifdef ORT_K3_VARIANTS
// The measurement build: the earlier design (a thread per ray, the walk
// over every chunk, each chunk a block-wide vote and, when some ray of the
// block needs it, staged in shared memory) with its timing cuts and
// counts, and the kernel's measurement instances, by index (chip_smoke.py's
// K3_VARIANTS names them in this order).
namespace {

// The earlier design's cuts: the chunk runs read from the table in device
// memory (the vote kept, no staging); no vote and no staging (each ray
// walks every chunk on its own); the chunk gates (gating box and AABB) run
// twice; each run's triangle tests run twice; and the counts (WalkCount
// at tests[1..12], the chunks the blocks staged at tests[13] and the warp
// passes over staged chunks that some lane of the warp tests at tests[14]).
enum Cut { kCutNone, kCutNoStage, kCutNoVote, kCutTwiceGates, kCutTwiceTests,
           kCutCount };

template <int kCut>
__global__ void __launch_bounds__(kThreads) closest_tri_earlier(
    const Params p) {
  constexpr bool kStage = kCut != kCutNoStage && kCut != kCutNoVote;
  __shared__ float s_tri[kTriRows * kChunk];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < p.n_rays;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 1.f};
  if (valid)
    for (int k = 0; k < 3; ++k) {
      o[k] = p.o[3 * r + k];
      d[k] = p.d[3 * r + k];
    }
  float inv[3], m[3];
  ray_features(o, d, inv, m);
  std::conditional_t<kCut == kCutCount, WalkCount,
                     std::conditional_t<kCut == kCutTwiceTests, TwiceRuns,
                                        NoWalkProbe>> pr{};
  if constexpr (kCut == kCutTwiceTests) pr.z = p.zero;
  BoxGate box = valid ? first_box(p.mt, o, inv, pr) : BoxGate{-1, false};
  const bool any_box = box.hit;

  float best_t = kBig;
  int best_i = 0;
  unsigned int tests = 0, staged = 0, warp_tests = 0;
  uint32_t sink = 0;
  for (int ci = 0; ci < p.mt.n_chunks; ++ci) {
    if constexpr (kCut == kCutTwiceGates) {
      // the same gate from the origin xor zero, its state on a copy
      float o2[3];
      for (int k = 0; k < 3; ++k)
        o2[k] = __uint_as_float(__float_as_uint(o[k]) ^ p.zero);
      BoxGate box2 = box;
      if (any_box && chunk_gate(p.mt, ci, box2, o2, inv, best_t))
        sink ^= (uint32_t)ci;
    }
    const bool gate =
        any_box && chunk_gate(p.mt, ci, box, o, inv, best_t, pr);
    if constexpr (kCut == kCutNoVote) {
      if (gate)
        chunk_runs(p.mt, ci, p.mt.tri, p.mt.t_pad, ci * kChunk, o, d, m, inv,
                   p.t_min, kBig, best_t, best_i, tests, pr);
      continue;
    }
    if (!__syncthreads_or(gate)) continue;
    if constexpr (kCut == kCutCount) {
      const bool warp_needs = __any_sync(0xffffffffu, gate);
      if (threadIdx.x == 0) ++staged;
      if ((threadIdx.x & 31) == 0 && warp_needs) ++warp_tests;
    }
    if constexpr (kStage) {
      for (int k = threadIdx.x; k < kTriRows * kChunk; k += blockDim.x)
        s_tri[k] = p.mt.tri[(k / kChunk) * p.mt.t_pad + ci * kChunk +
                            k % kChunk];
      __syncthreads();
      if (gate)
        chunk_runs(p.mt, ci, s_tri, kChunk, 0, o, d, m, inv, p.t_min, kBig,
                   best_t, best_i, tests, pr);
      __syncthreads();
    } else {
      if (gate)
        chunk_runs(p.mt, ci, p.mt.tri, p.mt.t_pad, ci * kChunk, o, d, m, inv,
                   p.t_min, kBig, best_t, best_i, tests, pr);
    }
  }

  if (valid) {
    p.out_t[r] = best_t;
    p.out_i[r] = best_i;
  }
  if (p.tests != nullptr) {
    count_warp(p.tests, tests);
    if constexpr (kCut == kCutCount) {
      for (int k = 0; k < kWalkKinds; ++k) {
        count_warp(p.tests + 1 + k, pr.lane[k]);
        count_warp(p.tests + 1 + kWalkKinds + k, pr.warp[k]);
      }
      count_warp(p.tests + 1 + 2 * kWalkKinds, staged);
      count_warp(p.tests + 2 + 2 * kWalkKinds, warp_tests);
    }
    if constexpr (kCut == kCutTwiceTests)
      if (pr.sink == 0x7fffffffu) atomicAdd(p.tests, 0ull);
    if constexpr (kCut == kCutTwiceGates)
      if (sink == 0x7fffffffu) atomicAdd(p.tests, 0ull);
  }
}

struct Variant {
  const void* fn;
  bool persistent;  // the kernel's instances (p.work needed)
};
const Variant kVariants[] = {
    {(const void*)closest_tri_earlier<kCutNone>, false},
    {(const void*)closest_tri_earlier<kCutNoStage>, false},
    {(const void*)closest_tri_earlier<kCutNoVote>, false},
    {(const void*)closest_tri_earlier<kCutTwiceGates>, false},
    {(const void*)closest_tri_earlier<kCutTwiceTests>, false},
    {(const void*)closest_tri_earlier<kCutCount>, false},
    {(const void*)closest_tri_kernel<kOptCount>, true},
    {(const void*)closest_tri_kernel<kOptTwiceRuns>, true},
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

// Launches instance v as closest_tri_launch; tests, when not null, holds
// 15 counts (the triangle tests first); work, a zeroed int for the
// kernel's instances (unused by the earlier design's).
extern "C" int closest_tri_variant_launch(
    int v, const float* tri, int t_pad, const float* cluster,
    const float* sub, const int* chunk_box, int n_chunks, const float* boxes,
    int n_boxes, const float* group, const int* group_end, int n_groups,
    const float* tri_major, const float* o, const float* d, int n_rays,
    float t_min, float* out_t, int* out_i, unsigned long long* tests,
    int* work, void* stream) {
  if (v < 0 || v >= kNumVariants ||
      !k3_args_ok(t_pad, n_chunks, n_boxes, n_groups, n_rays) ||
      (kVariants[v].persistent && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Params p = k3_params(tri, t_pad, cluster, sub, chunk_box, n_chunks,
                             boxes, n_boxes, group, group_end, n_groups,
                             tri_major, o, d, n_rays, t_min, out_t, out_i,
                             tests, work);
  const cudaError_t e = launch_k3(kVariants[v].fn, kVariants[v].persistent,
                                  p, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
#endif

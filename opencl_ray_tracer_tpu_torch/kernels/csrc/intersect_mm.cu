// Closest-triangle kernel: for each ray of a batch, the closest triangle of a
// cluster-planned mesh, (t, index), one thread per ray.
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
// What the design does about it: each ray first tests the gating boxes
// (the reference's per-ray box gate), then, chunk by chunk in plan order,
// the chunk's padded AABB, entered before its best t so far.  A chunk that
// some ray of the block needs is staged in shared memory by the whole block
// (kTriRows x kChunk floats, 11 KB), and the rays that need it test the runs
// of it whose sub-box they enter, reading each triangle's column as a
// broadcast.  Chunks no ray of the block needs cost one block-wide vote.

#include <cstdint>
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
};

__global__ void __launch_bounds__(kThreads) closest_tri_kernel(const Params p) {
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
  BoxGate box = valid ? first_box(p.mt, o, inv) : BoxGate{-1, false};
  const bool any_box = box.hit;

  float best_t = kBig;
  int best_i = 0;
  unsigned int tests = 0;
  for (int ci = 0; ci < p.mt.n_chunks; ++ci) {
    const bool gate = any_box && chunk_gate(p.mt, ci, box, o, inv, best_t);
    if (!__syncthreads_or(gate)) continue;
    for (int k = threadIdx.x; k < kTriRows * kChunk; k += blockDim.x)
      s_tri[k] = p.mt.tri[(k / kChunk) * p.mt.t_pad + ci * kChunk +
                          k % kChunk];
    __syncthreads();
    if (gate)
      chunk_runs(p.mt, ci, s_tri, kChunk, 0, o, d, m, inv, p.t_min, kBig,
                 best_t, best_i, tests);
    __syncthreads();
  }

  if (valid) {
    p.out_t[r] = best_t;
    p.out_i[r] = best_i;
  }
  if (p.tests != nullptr) {
    const unsigned int warp_sum = __reduce_add_sync(0xffffffffu, tests);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(p.tests, (unsigned long long)warp_sum);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): nonzero
// when the launch was refused.  tests, when not null, receives the number of
// triangle tests run.
extern "C" int closest_tri_launch(
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    const float* o, const float* d, int n_rays, float t_min, float* out_t,
    int* out_i, unsigned long long* tests, void* stream) {
  if (n_rays < 0 || n_chunks < 0 || t_pad < n_chunks * kChunk ||
      n_boxes < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  Params p;
  p.mt = MeshTables{tri, t_pad, cluster, sub, chunk_box, n_chunks, boxes,
                    n_boxes};
  p.o = o;
  p.d = d;
  p.n_rays = n_rays;
  p.t_min = t_min;
  p.out_t = out_t;
  p.out_i = out_i;
  p.tests = tests;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  closest_tri_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Device code shared by the closest-triangle kernel (intersect_mm.cu), the
// mesh megakernel (megamesh.cu) and the mesh variant of the backward kernel
// (megagrad.cu): the slab test, the triangle test, the culled closest
// triangle and the material of a hit, so that all three take the same
// decisions.
//
// The triangle test is the port's one form of Moller-Trumbore (see
// tracer/mesh_accel.py): with ray features d, m = o x d and o, and one column
// per triangle of the triangle table (rows T_*), a, u_num, v_num and t_num
// are fma chains in row order; u, v and t are the numerators times 1/a; a
// triangle is hit when |a| >= 1e-5, 0 <= u <= 1, v >= 0, u + v <= 1 and
// t > t_min (strict).  The plain version, mesh_accel.mm_candidates, does the
// same operations in the same order.
//
// The culling structure is the mesh plan's (tracer/clusters.py): chunks of
// kChunk triangles, each with one gating box, a padded AABB and kSub padded
// sub-boxes over runs of kRun triangles.  A ray tests a run only when it hits
// the run's gating box, the chunk's AABB and the run's sub-box, each entered
// closer than the best hit so far.  The boxes contain their triangles, so the
// culling never changes which triangle wins: the first index, in plan order,
// of the smallest t among the triangles whose gating box the ray hits.

#pragma once

#include <cstdint>

#include "common.cuh"

namespace ort {

constexpr int kChunk = 128;       // triangles per plan chunk (MESH_CHUNK)
constexpr int kSub = 8;           // sub-boxes per chunk (MESH_SUB_BOXES)
constexpr int kRun = kChunk / kSub;
constexpr float kTriEps = 1e-5f;  // gpu_kernel.cl:496

// Rows of the triangle table (tracer/mesh_accel.py T_*): a_col; u_d and e1;
// v_d and -e0; n and the t bias; the unit normal.
enum TriRow { T_A = 0, T_U = 3, T_V = 9, T_T = 15, T_N = 19, kTriRows = 22 };

// The triangles the mesh kernels read: the table (kTriRows, t_pad), the
// chunks' AABBs (n_chunks, 6) and sub-boxes (n_chunks * kSub, 6) as
// [min xyz, max xyz] rows, each chunk's gating box, and the gating boxes.
struct MeshTables {
  const float* tri;
  int t_pad;
  const float* cluster;
  const float* sub;
  const int* chunk_box;
  int n_chunks;
  const float* boxes;
  int n_boxes;
};

// Branchless slab test of box b ([min xyz, max xyz]) for a ray with origin o
// and inverse direction inv (inf where d is 0): hit, and the entry t in lo.
// 1/0 gives inf and 0*inf NaN where the origin lies on a face; fminf and
// fmaxf ignore the NaN, as the reference's OpenCL fmin and fmax do.
__device__ __forceinline__ bool slab(const float* b, const float o[3],
                                     const float inv[3], float& lo) {
  float hi = kBig;
  lo = -kBig;
  for (int k = 0; k < 3; ++k) {
    const float t1 = (b[k] - o[k]) * inv[k];
    const float t2 = (b[3 + k] - o[k]) * inv[k];
    lo = fmaxf(lo, fminf(t1, t2));
    hi = fminf(hi, fmaxf(t1, t2));
  }
  return hi > fmaxf(lo, 0.f);
}

// The triangle test of column j of a table with row stride `stride`: t, or
// kBig for a miss.
__device__ __forceinline__ float tri_candidate(const float* tab, int stride,
                                               int j, const float d[3],
                                               const float m[3],
                                               const float o[3],
                                               float t_min) {
#define W(r) tab[(r) * stride + j]
  const float a = fmaf(d[2], W(T_A + 2), fmaf(d[1], W(T_A + 1),
                                              d[0] * W(T_A)));
  const float u_num =
      fmaf(m[2], W(T_U + 5), fmaf(m[1], W(T_U + 4), fmaf(m[0], W(T_U + 3),
      fmaf(d[2], W(T_U + 2), fmaf(d[1], W(T_U + 1), d[0] * W(T_U))))));
  const float v_num =
      fmaf(m[2], W(T_V + 5), fmaf(m[1], W(T_V + 4), fmaf(m[0], W(T_V + 3),
      fmaf(d[2], W(T_V + 2), fmaf(d[1], W(T_V + 1), d[0] * W(T_V))))));
  const float t_num = fmaf(o[2], W(T_T + 2), fmaf(o[1], W(T_T + 1),
                                                  o[0] * W(T_T)))
                      + W(T_T + 3);
#undef W
  const bool parallel = fabsf(a) < kTriEps;
  const float inv_a = 1.f / (parallel ? 1.f : a);
  const float u = u_num * inv_a;
  const float v = v_num * inv_a;
  const float t = t_num * inv_a;
  const bool ok = !parallel && u >= 0.f && u <= 1.f && v >= 0.f &&
                  u + v <= 1.f && t > t_min;
  return ok ? t : kBig;
}

// Tests the n triangles of columns j0.. of a table (row stride `stride`) and
// keeps the first smallest t: index base + column.
__device__ __forceinline__ void tri_run(const float* tab, int stride, int j0,
                                        int n, int base, const float d[3],
                                        const float m[3], const float o[3],
                                        float t_min, float& best_t,
                                        int& best_i) {
  for (int j = j0; j < j0 + n; ++j) {
    const float t = tri_candidate(tab, stride, j, d, m, o, t_min);
    if (t < best_t) {
      best_t = t;
      best_i = base + j;
    }
  }
}

// Ray features: 1/d and m = o x d.
__device__ __forceinline__ void ray_features(const float o[3],
                                             const float d[3], float inv[3],
                                             float m[3]) {
  for (int k = 0; k < 3; ++k) inv[k] = 1.f / d[k];
  m[0] = fmaf(o[1], d[2], -(o[2] * d[1]));
  m[1] = fmaf(o[2], d[0], -(o[0] * d[2]));
  m[2] = fmaf(o[0], d[1], -(o[1] * d[0]));
}

// The gating box a ray tested last, and whether the ray hits it.  The plan
// groups chunks by box (and orders them front to back), so a run of chunks
// shares one test.
struct BoxGate {
  int id;
  bool hit;
};

// The first gating box the ray hits: hit is false when it hits none, and
// then no triangle is tested (gpu_kernel.cl:374-391).
__device__ __forceinline__ BoxGate first_box(const MeshTables& mt,
                                             const float o[3],
                                             const float inv[3]) {
  float lo;
  for (int b = 0; b < mt.n_boxes; ++b)
    if (slab(mt.boxes + 6 * b, o, inv, lo)) return BoxGate{b, true};
  return BoxGate{-1, false};
}

// Whether the ray may find a triangle in chunk ci nearer than lim: it hits
// the chunk's gating box (tested again only when the box changes), and it
// enters the chunk's AABB before lim.
__device__ __forceinline__ bool chunk_gate(const MeshTables& mt, int ci,
                                           BoxGate& box, const float o[3],
                                           const float inv[3], float lim) {
  float lo;
  const int b = __ldg(mt.chunk_box + ci);
  if (b != box.id) {
    box.id = b;
    box.hit = slab(mt.boxes + 6 * b, o, inv, lo);
  }
  return box.hit && slab(mt.cluster + 6 * ci, o, inv, lo) && lo < lim;
}

// The runs of chunk ci whose sub-box the ray enters before the best t so
// far, tested from the table tab (row stride `stride`, chunk ci starting at
// column j0).
__device__ __forceinline__ void chunk_runs(const MeshTables& mt, int ci,
                                           const float* tab, int stride,
                                           int j0, const float o[3],
                                           const float d[3], const float m[3],
                                           const float inv[3], float t_min,
                                           float lim, float& best_t,
                                           int& best_i, unsigned int& tests) {
  for (int s = 0; s < kSub; ++s) {
    float lo;
    if (slab(mt.sub + 6 * (ci * kSub + s), o, inv, lo) &&
        lo < fminf(lim, best_t)) {
      tri_run(tab, stride, j0 + s * kRun, kRun, ci * kChunk - j0, d, m, o,
              t_min, best_t, best_i);
      tests += kRun;
    }
  }
}

// Camera-table slots of the uniform mesh material (kernels/megamesh.py
// C_MA_R..): albedo, fuzz, ior, 1/ior; the mesh camera table uses 28 slots.
constexpr int C_MA = 22;
constexpr int kMeshCamSlots = 28;

// The material of a hit, a sphere's or the mesh's, as values.
struct HitMaterial {
  float alb[3];
  int mtype;
  float fz, eta, inv_eta;
  __device__ __forceinline__ float albedo(int k) const { return alb[k]; }
  __device__ __forceinline__ int type() const { return mtype; }
  __device__ __forceinline__ float fuzz() const { return fz; }
  __device__ __forceinline__ float ior() const { return eta; }
  __device__ __forceinline__ float inv_ior() const { return inv_eta; }
};

// The uniform mesh material: camera-table slots and the mesh's type.
__device__ __forceinline__ HitMaterial mesh_material(const float* cam,
                                                     int mtype) {
  return HitMaterial{{cam[C_MA], cam[C_MA + 1], cam[C_MA + 2]}, mtype,
                     cam[C_MA + 3], cam[C_MA + 4], cam[C_MA + 5]};
}

__device__ __forceinline__ HitMaterial sphere_material(const float* sph,
                                                       int stride, int bi) {
  const SphereMaterial m{sph, stride, bi};
  return HitMaterial{{m.albedo(0), m.albedo(1), m.albedo(2)}, m.type(),
                     m.fuzz(), m.ior(), m.inv_ior()};
}

// The closest triangle nearer than lim (the sphere hit): t and index in
// plan order, best_t left as it is when no triangle is nearer.
__device__ __forceinline__ void closest_triangle(const MeshTables& mt,
                                                 const float o[3],
                                                 const float d[3],
                                                 float t_min, float lim,
                                                 float& best_t, int& best_i,
                                                 unsigned int& tests) {
  float inv[3], m[3];
  ray_features(o, d, inv, m);
  BoxGate box = first_box(mt, o, inv);
  if (!box.hit) return;
  for (int ci = 0; ci < mt.n_chunks; ++ci)
    if (chunk_gate(mt, ci, box, o, inv, fminf(lim, best_t)))
      chunk_runs(mt, ci, mt.tri, mt.t_pad, ci * kChunk, o, d, m, inv, t_min,
                 lim, best_t, best_i, tests);
}

}  // namespace ort

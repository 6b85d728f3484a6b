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
// sub-boxes over runs of kRun triangles, and over the chunks a second level:
// groups of up to kGroup consecutive chunks in plan order, never two gating
// boxes in one group, each with the union of its chunks' AABBs
// (kernels/intersect_mm.py::group_tables).  A ray tests a run only when it
// hits the run's gating box, the group's box, the chunk's AABB and the run's
// sub-box, each entered closer than the best hit so far.  The boxes contain
// their triangles and the walk keeps plan order with strict compares, so the
// culling never changes which triangle wins: the first index, in plan order,
// of the smallest t among the triangles whose gating box the ray hits.  A
// group's box contains its chunks' boxes, so the group test only culls
// chunks the chunk test would cull: the triangle tests are those of the
// walk over every chunk (closest_triangle_flat, the earlier design, which
// measurement builds take with ORT_FLAT_WALK).  A walk may read the
// triangles from the table's triangle-major copy (MeshTables::tri_major:
// one 96-byte row a triangle, five float4 a test, where the (kTriRows,
// t_pad) table spreads a triangle over 19 rows).

#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace ort {

constexpr int kChunk = 128;       // triangles per plan chunk (MESH_CHUNK)
constexpr int kSub = 8;           // sub-boxes per chunk (MESH_SUB_BOXES)
constexpr int kRun = kChunk / kSub;
constexpr int kGroup = 8;         // chunks per group at most (MESH_GROUP)
constexpr float kTriEps = 1e-5f;  // gpu_kernel.cl:496

// Rows of the triangle table (tracer/mesh_accel.py T_*): a_col; u_d and e1;
// v_d and -e0; n and the t bias; the unit normal.
enum TriRow { T_A = 0, T_U = 3, T_V = 9, T_T = 15, T_N = 19, kTriRows = 22 };

// The triangles the mesh kernels read: the table (kTriRows, t_pad), the
// chunks' AABBs (n_chunks, 6) and sub-boxes (n_chunks * kSub, 6) as
// [min xyz, max xyz] rows, each chunk's gating box, the gating boxes, the
// groups' boxes (n_groups, 6) and each group's end (its last chunk + 1).
struct MeshTables {
  const float* tri;
  int t_pad;
  const float* cluster;
  const float* sub;
  const int* chunk_box;
  int n_chunks;
  const float* boxes;
  int n_boxes;
  const float* group;
  const int* group_end;
  int n_groups;
  // the triangle table triangle by triangle: (t_pad, 24) floats, rows 0-21
  // of each column and 2 zeros, 16-byte aligned
  const float* tri_major;
};

// The launchers' check of the tables' sizes: one or more chunks, gating
// boxes and groups, and a triangle table that holds every chunk.
inline bool mesh_args_ok(int t_pad, int n_chunks, int n_boxes,
                         int n_groups) {
  return n_chunks >= 1 && t_pad >= n_chunks * kChunk && n_boxes >= 1 &&
         n_groups >= 1 && n_groups <= n_chunks;
}

// What a walk tested, for the measurement builds' counts (WalkCount); the
// kernels take NoWalkProbe, which counts nothing.
// kBounceStep counts the bounce loop's steps (its SIMT efficiency is 1 - the
// share of lanes whose pixel has ended).
enum WalkSlab { kSlabBox, kSlabGroup, kSlabChunk, kSlabSub, kRunEntered,
                kBounceStep, kWalkKinds };
struct NoWalkProbe {
  static constexpr bool kRunsTwice = false;
  __device__ __forceinline__ void at(int) {}
};

// A measurement probe: the slabs and runs a walk tested, per lane, and the
// warp passes at each (the lane that is first in __activemask counts one):
// SIMT efficiency is lane steps over (warp passes x 32).
struct WalkCount {
  static constexpr bool kRunsTwice = false;
  unsigned int lane[kWalkKinds] = {};
  unsigned int warp[kWalkKinds] = {};
  __device__ __forceinline__ void at(int k) {
    ++lane[k];
    if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) ++warp[k];
  }
};

// A measurement probe: each run's triangle tests run a second time, from
// the origin xor z (the same ray: z is 0), the result kept in sink.
struct TwiceRuns {
  static constexpr bool kRunsTwice = true;
  uint32_t z;
  uint32_t sink;
  __device__ __forceinline__ void at(int) {}
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

// tri_candidate on a triangle-major table (MeshTables::tri_major): triangle
// j's rows 0-19 read as five float4, the same operations.
__device__ __forceinline__ float tri_candidate_major(const float* tab, int j,
                                                     const float d[3],
                                                     const float m[3],
                                                     const float o[3],
                                                     float t_min) {
  const float4* r = reinterpret_cast<const float4*>(tab) + 6 * j;
  float w[20];
  for (int q = 0; q < 5; ++q) {
    const float4 v = __ldg(r + q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  return tri_candidate(w, 1, 0, d, m, o, t_min);
}

// Tests the n triangles of columns j0.. of a table (row stride `stride`; or
// kMajor, a triangle-major table) and keeps the first smallest t: index
// base + column.
template <bool kMajor = false>
__device__ __forceinline__ void tri_run(const float* tab, int stride, int j0,
                                        int n, int base, const float d[3],
                                        const float m[3], const float o[3],
                                        float t_min, float& best_t,
                                        int& best_i) {
  if constexpr (kMajor) {
    // not unrolled: the unrolled run's hoisted float4 loads spilled
#pragma unroll 1
    for (int j = j0; j < j0 + n; ++j) {
      const float t = tri_candidate_major(tab, j, d, m, o, t_min);
      if (t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
    return;
  }
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
template <class Probe = NoWalkProbe>
__device__ __forceinline__ BoxGate first_box(const MeshTables& mt,
                                             const float o[3],
                                             const float inv[3],
                                             Probe&& pr = Probe()) {
  float lo;
  for (int b = 0; b < mt.n_boxes; ++b) {
    pr.at(kSlabBox);
    if (slab(mt.boxes + 6 * b, o, inv, lo)) return BoxGate{b, true};
  }
  return BoxGate{-1, false};
}

// The gating box b's test, run only when the box changes along the walk.
template <class Probe>
__device__ __forceinline__ void gate_box(const MeshTables& mt, int b,
                                         BoxGate& box, const float o[3],
                                         const float inv[3], Probe& pr) {
  if (b != box.id) {
    float lo;
    pr.at(kSlabBox);
    box.id = b;
    box.hit = slab(mt.boxes + 6 * b, o, inv, lo);
  }
}

// Whether the ray enters box b ([min xyz, max xyz]) before lim.
template <class Probe>
__device__ __forceinline__ bool enters(const float* b, int kind,
                                       const float o[3], const float inv[3],
                                       float lim, Probe& pr) {
  float lo;
  pr.at(kind);
  return slab(b, o, inv, lo) && lo < lim;
}

// Whether the ray may find a triangle in chunk ci nearer than lim: it hits
// the chunk's gating box (tested again only when the box changes), and it
// enters the chunk's AABB before lim.
template <class Probe = NoWalkProbe>
__device__ __forceinline__ bool chunk_gate(const MeshTables& mt, int ci,
                                           BoxGate& box, const float o[3],
                                           const float inv[3], float lim,
                                           Probe&& pr = Probe()) {
  gate_box(mt, __ldg(mt.chunk_box + ci), box, o, inv, pr);
  return box.hit &&
         enters(mt.cluster + 6 * ci, kSlabChunk, o, inv, lim, pr);
}

// The runs of chunk ci whose sub-box the ray enters before the best t so
// far, tested from the table tab (row stride `stride`, chunk ci starting at
// column j0; kMajor: mt.tri_major).
template <bool kMajor = false, class Probe = NoWalkProbe>
__device__ __forceinline__ void chunk_runs(const MeshTables& mt, int ci,
                                           const float* tab, int stride,
                                           int j0, const float o[3],
                                           const float d[3], const float m[3],
                                           const float inv[3], float t_min,
                                           float lim, float& best_t,
                                           int& best_i, unsigned int& tests,
                                           Probe&& pr = Probe()) {
  for (int s = 0; s < kSub; ++s) {
    if (enters(mt.sub + 6 * (ci * kSub + s), kSlabSub, o, inv,
               fminf(lim, best_t), pr)) {
      pr.at(kRunEntered);
      if constexpr (std::decay_t<Probe>::kRunsTwice) {
        float o2[3];
        for (int k = 0; k < 3; ++k)
          o2[k] = __uint_as_float(__float_as_uint(o[k]) ^ pr.z);
        float t2 = best_t;
        int i2 = best_i;
        tri_run<kMajor>(kMajor ? mt.tri_major : tab, stride, j0 + s * kRun,
                        kRun, ci * kChunk - j0, d, m, o2, t_min, t2, i2);
        pr.sink ^= __float_as_uint(t2) ^ (uint32_t)i2;
      }
      tri_run<kMajor>(kMajor ? mt.tri_major : tab, stride, j0 + s * kRun,
                      kRun, ci * kChunk - j0, d, m, o, t_min, best_t, best_i);
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
// plan order, best_t left as it is when no triangle is nearer.  The walk
// over the groups: a group's chunks are tested only when the ray enters
// the group's box before the best t so far.  kMajor: the triangles from
// mt.tri_major.
template <class Probe, bool kMajor = false>
__device__ __forceinline__ void closest_triangle_grouped(
    const MeshTables& mt, const float o[3], const float d[3], float t_min,
    float lim, float& best_t, int& best_i, unsigned int& tests, Probe& pr) {
  float inv[3], m[3];
  ray_features(o, d, inv, m);
  BoxGate box = first_box(mt, o, inv, pr);
  if (!box.hit) return;
  int c0 = 0;
  for (int g = 0; g < mt.n_groups; ++g) {
    const int c1 = __ldg(mt.group_end + g);
    gate_box(mt, __ldg(mt.chunk_box + c0), box, o, inv, pr);
    if (box.hit &&
        enters(mt.group + 6 * g, kSlabGroup, o, inv, fminf(lim, best_t), pr))
      for (int ci = c0; ci < c1; ++ci)
        if (enters(mt.cluster + 6 * ci, kSlabChunk, o, inv,
                   fminf(lim, best_t), pr))
          chunk_runs<kMajor>(mt, ci, mt.tri, mt.t_pad, ci * kChunk, o, d, m,
                             inv, t_min, lim, best_t, best_i, tests, pr);
    c0 = c1;
  }
}

// The earlier walk, over every chunk in plan order (its gating box tested
// again when the box changes, then its AABB): the same triangle tests as
// closest_triangle_grouped, with a chunk slab for every chunk.
template <class Probe>
__device__ __forceinline__ void closest_triangle_flat(
    const MeshTables& mt, const float o[3], const float d[3], float t_min,
    float lim, float& best_t, int& best_i, unsigned int& tests, Probe& pr) {
  float inv[3], m[3];
  ray_features(o, d, inv, m);
  BoxGate box = first_box(mt, o, inv, pr);
  if (!box.hit) return;
  for (int ci = 0; ci < mt.n_chunks; ++ci)
    if (chunk_gate(mt, ci, box, o, inv, fminf(lim, best_t), pr))
      chunk_runs(mt, ci, mt.tri, mt.t_pad, ci * kChunk, o, d, m, inv, t_min,
                 lim, best_t, best_i, tests, pr);
}

// Whether this build walks every chunk (ORT_FLAT_WALK, a measurement build
// of the earlier walk).
#ifdef ORT_FLAT_WALK
constexpr bool kFlatWalk = true;
#else
constexpr bool kFlatWalk = false;
#endif

// The walk the kernels take: over the groups (kMajor: reading
// mt.tri_major), or with ORT_FLAT_WALK the earlier walk over every chunk.
template <bool kMajor = false>
__device__ __forceinline__ void closest_triangle(const MeshTables& mt,
                                                 const float o[3],
                                                 const float d[3],
                                                 float t_min, float lim,
                                                 float& best_t, int& best_i,
                                                 unsigned int& tests) {
  NoWalkProbe pr;
  if constexpr (kFlatWalk)
    closest_triangle_flat(mt, o, d, t_min, lim, best_t, best_i, tests, pr);
  else
    closest_triangle_grouped<NoWalkProbe, kMajor>(mt, o, d, t_min, lim,
                                                  best_t, best_i, tests, pr);
}

}  // namespace ort

// Backward megakernels: the cotangents of the scene tables for an image
// cotangent.  Each replaces an instance of opencl_ray_tracer_tpu/kernels/
// megagrad.py::_make_grad_kernel:
//
// - sphere_megagrad (K4): sphere scenes (mesh=None, hdr_mode=None), a
//   kernel of its own with a flat loop per lane over work items (see the
//   note above it).
// - mesh_megagrad<kSkyComputed> (K5): spheres and one uniform-material
//   triangle mesh in gating boxes (mesh=(n_chunks, chunk, chunk_box_ids,
//   n_boxes, m_type), through _grad_tables_mesh_inner and its ladder), a
//   kernel of its own with K4's flat loop (see the note above it).
// - hdr_emit (K6): the HDR backward's first pass (hdr_mode="emit", through
//   _hdr_emit_window and its ladder), on the scenes of the mesh megakernel's
//   HDR scope, with or without triangles: the megagrad template's mesh
//   replay alone (one thread per pixel), which writes each sample's miss
//   direction and throughput ((0, 0, 1) and 0 for a sample that did not
//   miss) and each pixel's sum of the sample contributions that are not sky
//   (emitters, clamped, NaN as 0).  The caller looks the texels up and
//   rebuilds the image from these; the lookup stays a torch op, as it
//   stays an XLA op in the JAX package, since the image's cotangent is a
//   scatter over the same texels.
// - mesh_megagrad<kSkyConsume> (K7): the second pass (hdr_mode="consume",
//   through _hdr_consume_window and its ladder): K5 with each miss's sky
//   value read from the caller's (3, n_samples, n_pix) rows instead of
//   computed.  The nearest-texel lookup is constant in the direction, so a
//   miss seeds the throughput's adjoint alone.  K6 and K7 replay with the
//   same device code, so their directions agree bit for bit.  A scene
//   without triangles runs with no chunk and no gating box: no triangle is
//   tested.
//
// The megagrad template, one thread per pixel, is also the earlier design
// of K4, K5 and K7, which the measurement builds (ORT_K4_VARIANTS,
// ORT_K5_VARIANTS) keep beside their timing cuts for chip_smoke.py's
// splits; no entry point launches it but as K6.
//
// The Pallas TPU kernels replay paths into a VMEM record ring and walk it
// back with adjoints that jax.vjp derived at trace time.  Here the adjoints
// are derived by hand (scatter_adjoint, bounce_adjoint and tri_adjoint
// below) and checked against torch.autograd of the plain tracer.  The
// ring, the tiles, the row batching, the tail-compaction ladder and its
// constants, and the HDR passes' sample windows (GRAD_HDR_SPP_CHUNK, a bound
// of VMEM) are TPU scheduling and stay there: K6 and K7 take every sample
// in one launch.
//
// What it computes: for g = dL/d(pixel) / n_samples, the sum over pixels
// and samples of g . d(sample contribution)/d(table) with the estimator of
// the forward kernel under the order-invariant "zero" NaN policy and the
// clamp-before-average (its subgradient is 1 inside (0, 1), 1/2 at 0 and
// at 1, as jnp.clip's).  The winner of every bounce is discrete: gradients
// flow through the winning sphere or triangle only.  Rows written: the 11
// DIFF_FIELDS of the sphere table (centre, r^2, 1/r, albedo, fuzz, ior,
// 1/ior) and the 21 CAM_SLOTS of the camera table; the mesh variant also
// writes gtri (10 x t_pad, plan order): the cotangents of each triangle's
// raw normal n = (p1 - p0) x (p2 - p0) and plane constant c = n . p0
// (rows 0-3), and of its albedo, fuzz, ior and 1/ior (rows 4-9).  The mesh
// material slots of the camera table get none: the material's cotangents
// are the triangles' own.  The chain to the scene's radius, camera and
// vertices happens outside, in kernels/megagrad.py.
//
// Design, per pixel sample (K4, K5 and K7 take these steps in a flat loop
// per lane, the megagrad template in a loop per pixel):
// 1. Forward replay with the forward kernels' own device code (common.cuh,
//    and mesh.cuh's culled triangle hit for the mesh), so every discrete
//    decision is the forward's, but for the fuzz radius, which follows the
//    plain version (see common.cuh).  Each bounce that goes on stores its
//    state (origin, direction, throughput, winner code: a sphere index, or
//    n_spheres for a triangle; the mesh kernels add the hit t and the
//    triangle's plan-order id) in a global scratch buffer: K4, K5 and K7
//    three float4 at (depth * n_threads + thread), so a lane's record is
//    two sectors whatever depth its neighbours are at; the megagrad
//    template one column per thread.
// 2. A sample that ends black (absorbed, or out of depth) contributes
//    nothing and is skipped.  A miss or an emissive hit seeds the adjoint of
//    the throughput (and of the direction, through the gradient sky).
// 3. The stored bounces are walked back, each one recomputed from its
//    record (the random draws from the counters again) and its adjoint
//    applied; at depth 0 the adjoint goes into the camera slots through
//    the camera ray.  A triangle bounce differentiates the ray-plane
//    intersection, t(o, d) = t_rec + t_plane - sg(t_plane) with
//    t_plane = (c - n.o) / (n.d), the interior derivative of
//    Moller-Trumbore for a fixed triangle; its shading normal is
//    n / max(|n|, 1e-20).
// 4. Sphere cotangents are summed in shared memory per block (K4, K5 and
//    K7 first sum a bounce's over the lanes of the warp that hit the same
//    sphere, add_rows_aggregated; the megagrad template adds each lane's
//    with a shared atomic) and flushed with one global atomicAdd per entry
//    and block; triangle cotangents go to gtri with one global atomicAdd
//    per row and bounce.  The order of those float sums varies from run to
//    run.  Camera cotangents are summed per thread in the order of its
//    items (K4, K5, K7: in shared memory, a column per thread), then over
//    the block in a fixed order, and each block writes its row of sums
//    (cam_part), which the wrapper adds up: they come out the same in
//    every run.  That matters where they cancel: a pinhole camera's
//    focus-distance gradient is exactly zero, and what is left of it is
//    rounding.
//
// What bounds it: FP32 work, as the forward: the replay tests every sphere
// at every bounce (17 FLOPs a test, 4 to 6 more for a hit) and the
// triangles the culling lets through (38 FLOPs a test); the reverse costs
// 132 FLOPs for a Lambertian sphere bounce, 89 for a Lambertian triangle
// bounce and 72 more for a fuzzy-metal one (counted operation by
// operation in chip_smoke.py).  Device memory carries the tables, the
// cotangent planes and the records (48 bytes a bounce, written once and
// read once, mostly from L2).  What held the earlier one-pixel-per-thread
// design back, measured by chip_smoke.py's splits (PERF.md): the replay
// and the walk back each waiting for the warp's deepest lane (29% of
// lanes busy in the mesh replay, 23% in the sphere one), and
// the shared-memory atomics of the sphere cotangents (half of K4's time, a
// seventh of K5's at 576 triangles); the records and the triangle atomics
// cost little.  The flat loop and the aggregated atomics answer both; the
// walk back's own SIMT efficiency falls under the flat loop (48% -> 28%
// in K5 and K7), which the replay's gain outweighs.

#include <cstdint>
#include <cuda_runtime.h>

// the fuzz radius as the plain version computes it (see common.cuh)
#define ORT_FUZZ_POWF
#include "common.cuh"
#include "mesh.cuh"

namespace {

using namespace ort;

constexpr int kThreads = 128;
constexpr int kMaxSpheres = 256;
// spheres the mesh variant takes (the mesh megakernel's limit)
constexpr int kMaxMeshSpheres = 128;

// Accumulator rows: the order of DIFF_FIELDS in kernels/megagrad.py.
enum GradRow {
  G_CX, G_CY, G_CZ, G_R2, G_INVR, G_ALR, G_ALG, G_ALB, G_FUZZ, G_IOR,
  G_INVIOR, kGradRows
};
__constant__ int kGradField[kGradRows] = {
    F_CX, F_CY, F_CZ, F_R2, F_INVR, F_ALR, F_ALG, F_ALB, F_FUZZ, F_IOR,
    F_INVIOR};
// gtri rows: n (3) and c, then the material rows in the order of the
// accumulator rows G_ALR .. G_INVIOR.
enum GtriRow { GT_N = 0, GT_C = 3, GT_MAT = 4, kGtriRows = 10 };

// Record of one bounce that goes on: its origin, direction, throughput and
// winner code (an exact small integer as a float); the mesh variant adds
// the hit t and the triangle's plan-order id.
enum Rec {
  R_OX, R_OY, R_OZ, R_DX, R_DY, R_DZ, R_TR, R_TG, R_TB, R_WIN, kRec,
  R_T = kRec, R_TID, kRecMesh
};

enum Ending { END_BLACK, END_MISS, END_EMIT };

// The sky of an instance: computed (K4, K5), emitted (K6) or consumed (K7).
enum SkyMode { kSkyComputed = 0, kSkyEmit = 1, kSkyConsume = 2 };
// Rows of K6's per-sample output: the miss direction and throughput.
enum EmitRow { E_DX, E_DY, E_DZ, E_TR, E_TG, E_TB, kEmitRows };

struct Params {
  const float* cam;
  const float* sph;
  const float* g_r;
  const float* g_g;
  const float* g_b;
  float* cam_part;
  float* gsph;
  float* rec;
  unsigned long long* counts;
  int tab_w;
  int n_spheres;
  int n_pix;
  int pix_offset;
  int n_threads;
  uint32_t seed;
  uint32_t sample_base;
  int n_samples;
  int width;
  int height;
  int max_depth;
  float t_min;
  int flags;
  // mesh variant
  MeshTables mt;
  int mesh_type;
  float* gtri;
  // HDR passes: K6's outputs, (kEmitRows, n_samples, n_pix) and (3, n_pix);
  // K7's sky values, (3, n_samples, n_pix)
  float* emit;
  float* emis;
  const float* sky_rows;
};

// Subgradient of the clamp to [0, 1] at x, as jnp.clip's (min of max):
// ties at 0 and at 1 take half.
__device__ __forceinline__ float clamp01_grad(float x) {
  if (x > 0.f && x < 1.f) return 1.f;
  if (x == 0.f || x == 1.f) return 0.5f;
  return 0.f;
}

// The winner's material as the reverse reads it.
struct AdjMat {
  float alb[3];
  bool is_metal;
  bool is_diel;
  float ior;
  float inv_ior;
};

// Cotangents of sphere bi: the shared accumulator acc (rows of `stride`),
// column bi.
struct SphereSink {
  float* acc;
  int stride;
  int bi;
  __device__ __forceinline__ void add(int row, float v) {
    atomicAdd(&acc[row * stride + bi], v);
  }
};

// One bounce's sphere cotangents, row by row, in registers (every row
// index is a constant once inlined); K4 sums them over the warp before its
// atomics (add_rows_aggregated).
struct RowSink {
  float v[kGradRows];
  __device__ __forceinline__ void add(int row, float x) { v[row] += x; }
};

// Timing only: plain adds into one lane-private sum instead of the shared
// atomics (its results are wrong on purpose).
struct LaneSink {
  float sum;
  __device__ __forceinline__ void add(int, float x) { sum += x; }
};

// Material cotangents of a triangle, into its gtri rows (gt, kGtriRows).
struct TriSink {
  float* g;
  __device__ __forceinline__ void add(int row, float v) {
    g[GT_MAT + row - G_ALR] += v;
  }
};

// Adjoint of the scatter at a hit that went on: direction d (a = |d|^2) into
// the front-facing normal nrm, throughput T, material m.  On entry gd and gT
// hold the adjoints of the new direction and the new throughput; on return
// gT holds that of T, gn that of nrm, and gdd that of d.  Material
// cotangents go to sink.
template <class Sink>
__device__ __forceinline__ void scatter_adjoint(
    const AdjMat& m, Sink& sink, int flags, uint32_t seed, uint32_t pix,
    uint32_t sid, int depth, const float d[3], float a, const float nrm[3],
    bool front, const float T[3], const float gd[3], float gT[3],
    float gn[3], float gdd[3]) {
  // ---- throughput: T' = T * attenuation (albedo, or 1 for glass) ----
  if (!m.is_diel) {
    for (int k = 0; k < 3; ++k) {
      sink.add(G_ALR + k, gT[k] * T[k]);
      gT[k] = gT[k] * m.alb[k];
    }
  }

  // ---- direction ----
  for (int k = 0; k < 3; ++k) {
    gn[k] = 0.f;
    gdd[k] = 0.f;
  }
  if (!m.is_metal && !m.is_diel) {
    // Lambertian: dir = n + unit draw, or n when that is near zero
    for (int k = 0; k < 3; ++k) gn[k] = gd[k];
    return;
  }
  const float len = sqrtf(a);
  const float ud[3] = {d[0] / len, d[1] / len, d[2] / len};
  const float dn = dot3(ud, nrm);
  float gud[3] = {0.f, 0.f, 0.f};
  float gref[3] = {0.f, 0.f, 0.f};
  bool reflected = true;
  float ua[4], ub[4];
  uniform4(seed, pix, sid, 5u + 2u * (uint32_t)depth, ub);
  if (m.is_metal) {
    // dir = reflect(ud, n) + fuzz * ball; the fuzz cotangent is the ball's
    // projection, also where the forward left the ball out (no metal with
    // fuzz > 0: it added fuzz * ball = 0)
    uniform4(seed, pix, sid, 4u + 2u * (uint32_t)depth, ua);
    const float zs = 2.f * ua[2] - 1.f;
    const float phs = kTwoPi * ua[3];
    const float rs = sqrtf(fmaxf(0.f, fmaf(-zs, zs, 1.f)));
    const float rad = fuzz_radius(ub[0]);
    const float ball[3] = {(rs * cosf(phs)) * rad, (rs * sinf(phs)) * rad,
                           zs * rad};
    sink.add(G_FUZZ, dot3(gd, ball));
    for (int k = 0; k < 3; ++k) gref[k] = gd[k];
  } else {
    // the dielectric's choice, as scatter_material takes it
    const float ratio = front ? m.inv_ior : m.ior;
    const float cos_t = fminf(-dn, 1.f);
    const float sin_t = sqrtf(fmaxf(fmaf(-cos_t, cos_t, 1.f), 1e-20f));
    float r0 = (1.f - ratio) / (1.f + ratio);
    r0 = r0 * r0;
    const float x = 1.f - cos_t;
    const float x2 = x * x;
    const float refl = fmaf(1.f - r0, x * (x2 * x2), r0);
    if (ratio * sin_t > 1.f || refl > ub[1]) {
      for (int k = 0; k < 3; ++k) gref[k] = gd[k];
    } else {
      // refract: w = ud + n cos_t, rp = w ratio,
      // par = sqrt(max(|1 - rp.rp|, 1e-20)), dir = rp - n par
      reflected = false;
      float w[3], rp[3];
      for (int k = 0; k < 3; ++k) {
        w[k] = fmaf(nrm[k], cos_t, ud[k]);
        rp[k] = w[k] * ratio;
      }
      const float q = 1.f - dot3(rp, rp);
      const float aq = fabsf(q);
      const float par = sqrtf(fmaxf(aq, 1e-20f));
      const float gpar = -dot3(gd, nrm);
      const float gaq = aq > 1e-20f ? gpar * 0.5f / par : 0.f;
      const float gq = q > 0.f ? gaq : (q < 0.f ? -gaq : 0.f);
      float grp[3], gw[3];
      for (int k = 0; k < 3; ++k) {
        gn[k] += -par * gd[k];
        grp[k] = gd[k] - 2.f * rp[k] * gq;
        gw[k] = ratio * grp[k];
      }
      const float gratio = dot3(grp, w);
      if (front)
        sink.add(G_INVIOR, gratio);
      else
        sink.add(G_IOR, gratio);
      for (int k = 0; k < 3; ++k) {
        gud[k] += gw[k];
        gn[k] += cos_t * gw[k];
      }
      // cos_t = min(-dn, 1)
      const float gcos = dot3(gw, nrm);
      const float mf = -dn < 1.f ? 1.f : (-dn == 1.f ? 0.5f : 0.f);
      const float gdn = -gcos * mf;
      for (int k = 0; k < 3; ++k) {
        gud[k] += gdn * nrm[k];
        gn[k] += gdn * ud[k];
      }
    }
  }
  if (reflected) {
    // ref = ud - 2 (ud . n) n
    const float gdn = -2.f * dot3(gref, nrm);
    for (int k = 0; k < 3; ++k) {
      gud[k] += gref[k] + gdn * nrm[k];
      gn[k] += -2.f * dn * gref[k] + gdn * ud[k];
    }
  }
  // ud = d / |d|
  const float pu = dot3(gud, ud);
  for (int k = 0; k < 3; ++k) gdd[k] += (gud[k] - pu * ud[k]) / len;
}

// Adjoint of one bounce that went on from state (o, d, T) by a hit of
// sphere bi at bounce `depth`, with the sphere table sph (rows of
// `stride`).  On entry go, gd and gT hold the adjoints of the bounce's
// outputs (new origin = hit point, new direction, new throughput); on
// return, those of its inputs.  Sphere bi's cotangents go to sink.
template <class Sink>
__device__ __forceinline__ void bounce_adjoint(
    const float* sph, int stride, int flags, float t_min, uint32_t seed,
    uint32_t pix, uint32_t sid, int depth, const float o[3],
    const float d[3], const float T[3], int bi, float go[3], float gd[3],
    float gT[3], Sink& sink) {
#define SPH(field) sph[(field) * stride + bi]
#define ACC(row, v) sink.add((row), (v))
  // ---- forward recompute (the expressions of closest_sphere) ----
  const float a = dot3(d, d);
  const float c[3] = {SPH(F_CX), SPH(F_CY), SPH(F_CZ)};
  float oc[3];
  for (int k = 0; k < 3; ++k) oc[k] = o[k] - c[k];
  const float hb = dot3(oc, d);
  const float cc = dot3(oc, oc) - SPH(F_R2);
  const float disc = fmaf(hb, hb, -(a * cc));
  const float sq = sqrtf(fmaxf(disc, 1e-30f));
  float t = (-hb - sq) / a;
  float sigma = -1.f;  // the root's sign of sq: t = (-hb + sigma * sq) / a
  if (!(t >= t_min)) {
    t = (-hb + sq) / a;
    sigma = 1.f;
  }
  float h[3], hc[3], nrm[3];
  for (int k = 0; k < 3; ++k) h[k] = fmaf(t, d[k], o[k]);
  for (int k = 0; k < 3; ++k) {
    hc[k] = h[k] - c[k];
    nrm[k] = hc[k] / SPH(F_R);
  }
  const bool front = dot3(d, nrm) < 0.f;
  const float sgn = front ? 1.f : -1.f;
  if (!front)
    for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
  const int mt = (int)SPH(F_TYPE);
  const AdjMat m{{SPH(F_ALR), SPH(F_ALG), SPH(F_ALB)},
                 (flags & HAS_METAL) && mt == METAL,
                 (flags & HAS_DIEL) && mt == DIELECTRIC, SPH(F_IOR),
                 SPH(F_INVIOR)};

  // ---- throughput and direction ----
  float gn[3], gdd[3];
  scatter_adjoint(m, sink, flags, seed, pix, sid, depth, d, a, nrm, front, T,
                  gd, gT, gn, gdd);

  // ---- normal: n = sgn (h - c) / r, taken as sgn (h - c) * (1/r) ----
  const float invr = SPH(F_INVR);
  float gh[3], gc[3];
  float ginvr = 0.f;
  for (int k = 0; k < 3; ++k) {
    const float gno = sgn * gn[k];
    gh[k] = go[k] + invr * gno;
    gc[k] = -invr * gno;
    ginvr += gno * hc[k];
  }
  // ---- hit point: h = o + t d ----
  const float gt = dot3(gh, d);
  for (int k = 0; k < 3; ++k) {
    go[k] = gh[k];
    gdd[k] += t * gh[k];
  }
  // ---- the winner's root: t = (-hb + sigma sq) / a ----
  float ghb = -gt / a;
  const float gsq = sigma * gt / a;
  float ga = -gt * t / a;
  const float gdisc = disc > 1e-30f ? gsq * 0.5f / sq : 0.f;
  ghb += 2.f * hb * gdisc;
  ga += -cc * gdisc;
  const float gcc = -a * gdisc;
  for (int k = 0; k < 3; ++k) {
    const float goc = 2.f * oc[k] * gcc + d[k] * ghb;
    gdd[k] += oc[k] * ghb + 2.f * d[k] * ga;
    go[k] += goc;
    gc[k] -= goc;
    gd[k] = gdd[k];
  }
  ACC(G_CX, gc[0]);
  ACC(G_CY, gc[1]);
  ACC(G_CZ, gc[2]);
  ACC(G_R2, -gcc);
  ACC(G_INVR, ginvr);
#undef ACC
#undef SPH
}

// Adjoint of one bounce that went on from state (o, d, T) by a hit of
// triangle j (plan order) at t_rec, as bounce_adjoint for a sphere.  The
// triangle's raw normal n and plane constant c = -(t bias) come from the
// triangle table; the hit's t is differentiated as the ray-plane
// intersection's.  The cotangents of n, c and the triangle's material (the
// rows of column j of gtri) are returned in rows.
__device__ __forceinline__ void tri_adjoint(
    const MeshTables& mt, const float* cam, int mesh_type, int flags,
    uint32_t seed, uint32_t pix, uint32_t sid, int depth, const float o[3],
    const float d[3], const float T[3], int j, float t_rec, float go[3],
    float gd[3], float gT[3], float (&rows)[kGtriRows]) {
  const int tp = mt.t_pad;
  const float a = dot3(d, d);
  float n[3], unit[3], nrm[3];
  for (int k = 0; k < 3; ++k) {
    n[k] = __ldg(mt.tri + (T_T + k) * tp + j);
    unit[k] = __ldg(mt.tri + (T_N + k) * tp + j);
  }
  const float c = -__ldg(mt.tri + (T_T + 3) * tp + j);
  // the forward's front face, from the table's unit normal
  const bool front = dot3(d, unit) < 0.f;
  const float sgn = front ? 1.f : -1.f;
  for (int k = 0; k < 3; ++k) nrm[k] = front ? unit[k] : -unit[k];
  const AdjMat m{{cam[C_MA], cam[C_MA + 1], cam[C_MA + 2]},
                 (flags & HAS_METAL) && mesh_type == METAL,
                 (flags & HAS_DIEL) && mesh_type == DIELECTRIC,
                 cam[C_MA + 4], cam[C_MA + 5]};

  // ---- throughput and direction ----
  for (int r = 0; r < kGtriRows; ++r) rows[r] = 0.f;
  TriSink sink{rows};
  float gn[3], gdd[3];
  scatter_adjoint(m, sink, flags, seed, pix, sid, depth, d, a, nrm, front, T,
                  gd, gT, gn, gdd);

  // ---- normal: nrm = sgn n / max(|n|, 1e-20) ----
  float gnr[3] = {0.f, 0.f, 0.f};  // adjoint of the raw normal n
  const float len = sqrtf(dot3(n, n));
  if (len > 1e-20f) {
    float gu[3];
    for (int k = 0; k < 3; ++k) gu[k] = sgn * gn[k];
    const float pu = dot3(gu, unit);
    for (int k = 0; k < 3; ++k) gnr[k] = (gu[k] - pu * unit[k]) / len;
  }
  // ---- hit point: h = o + t d (the normal does not depend on it) ----
  const float gt = dot3(go, d);
  for (int k = 0; k < 3; ++k) gdd[k] += t_rec * go[k];
  // ---- t = t_rec + t_plane - sg(t_plane), t_plane = (c - n.o) / (n.d) ----
  const float nd = dot3(n, d);
  const float t_plane = (c - dot3(n, o)) / nd;
  const float gq = gt / nd;                // adjoint of c - n.o
  const float gnd = -gt * t_plane / nd;    // adjoint of n.d
  for (int k = 0; k < 3; ++k) {
    go[k] += -gq * n[k];
    gnr[k] += -gq * o[k] + gnd * d[k];
    gdd[k] += gnd * n[k];
    gd[k] = gdd[k];
  }
  for (int k = 0; k < 3; ++k) rows[GT_N + k] = gnr[k];
  rows[GT_C] = gq;
}

// Adds one bounce's triangle cotangents gt to column j of gtri (rows of
// tp), one global atomic per row (the material rows when nonzero).
__device__ __forceinline__ void add_tri_rows(float* gtri, int tp, int j,
                                             const float (&gt)[kGtriRows]) {
  for (int r = 0; r < kGtriRows; ++r)
    if (r < GT_MAT || gt[r] != 0.f) atomicAdd(&gtri[r * tp + j], gt[r]);
}

// Timing-only cuts of the earlier design, which chip_smoke.py's splits of
// K4's and of K5's and K7's time launch (the measurement builds
// ORT_K4_VARIANTS and ORT_K5_VARIANTS; no entry point launches them): the
// replay alone (no record written, no walk back), the replay with its
// record writes, the whole kernel with plain adds into a lane-private sum
// instead of the shared atomics of the sphere cotangents, or (the mesh
// variant) instead of the global atomics of the triangle cotangents (the
// results of both are wrong on purpose), and the whole kernel counting its
// SIMT efficiency (counts[2..4], the mesh variant's counts[4..6]: the warp
// iterations of the replay, the lane steps of the walk back and its warp
// iterations).
enum Cut {
  kCutNone, kCutReplay, kCutRecords, kCutAtomics, kCutTriAtomics, kCutSimt
};

template <bool kMesh, int kSky, int kCut = kCutNone>
__global__ void __launch_bounds__(kThreads) megagrad(const Params p) {
  constexpr bool kEmit = kSky == kSkyEmit;
  constexpr int kR = kMesh ? kRecMesh : kRec;
  constexpr int kCamLoad = kMesh ? kMeshCamSlots : kCamSlots;
  __shared__ float s_sph[kFields * kMaxSpheres];
  __shared__ float s_acc[kEmit ? 1 : kGradRows * kMaxSpheres];
  __shared__ float s_cam[kCamLoad];
  __shared__ float s_gcam[kThreads / 32][kCamSlots];
  const int n = p.n_spheres;
  for (int k = threadIdx.x; k < kFields * n; k += blockDim.x)
    s_sph[(k / n) * kMaxSpheres + k % n] = p.sph[(k / n) * p.tab_w + k % n];
  if constexpr (!kEmit)
    for (int k = threadIdx.x; k < kGradRows * n; k += blockDim.x)
      s_acc[(k / n) * kMaxSpheres + k % n] = 0.f;
  for (int k = threadIdx.x; k < kCamLoad; k += blockDim.x)
    s_cam[k] = p.cam[k];
  __syncthreads();

  const int flags = p.flags;
  const bool lens = (flags & HAS_APERTURE) && s_cam[C_APERTURE] > 0.f;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int rs = p.n_threads;          // record stride
  float* const rec = p.rec + tid;      // rec[(depth * kR + field) * rs]
  float gcam[kCamSlots];               // this thread's camera cotangents
  for (int k = 0; k < kCamSlots; ++k) gcam[k] = 0.f;
  unsigned int n_replay = 0, n_reverse = 0, n_tests = 0, n_reverse_tri = 0;
  unsigned int w_replay = 0, n_back = 0, w_back = 0;  // kCutSimt
  LaneSink lane_sink{0.f};                           // the cuts' sink

  for (int local = tid; local < p.n_pix; local += p.n_threads) {
    float g[3] = {0.f, 0.f, 0.f};
    if constexpr (!kEmit) {
      g[0] = p.g_r[local];
      g[1] = p.g_g[local];
      g[2] = p.g_b[local];
      if (g[0] == 0.f && g[1] == 0.f && g[2] == 0.f) continue;
    }
    float emis[3] = {0.f, 0.f, 0.f};  // K6: the non-sky sum
    const int lin = p.pix_offset + local;
    const uint32_t pix = (uint32_t)lin;
    const float px = (float)(lin % p.width);
    const float py = (float)(lin / p.width);

    for (int s = 0; s < p.n_samples; ++s) {
      const uint32_t sid = p.sample_base + (uint32_t)s;
      // ---- 1. forward replay ----
      float o[3], d[3];
      float T[3] = {1.f, 1.f, 1.f};
      const CamDraw cd = camera_ray(s_cam, p.seed, p.width, p.height, flags,
                                    pix, sid, px, py, o, d);
      int depth = 0;
      int ending = END_BLACK;
      int win = 0;          // the emitter: a sphere, or a triangle's id
      bool win_tri = false;
      for (;;) {
        ++n_replay;
        if constexpr (kCut == kCutSimt)
          if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) ++w_replay;
        const float a = dot3(d, d);
        float best_t;
        int bi;
        closest_sphere(s_sph, kMaxSpheres, n, o, d, a, p.t_min, best_t, bi);
        bool tri_win = false;
        int ti = 0;
        if constexpr (kMesh) {
          float tri_t = kBig;
          closest_triangle(p.mt, o, d, p.t_min, best_t, tri_t, ti, n_tests);
          tri_win = tri_t < best_t;
          if (tri_win) best_t = tri_t;
        }
        if (!(best_t < kBig)) {
          ending = END_MISS;
          break;
        }
        float h[3], nrm[3];
        for (int k = 0; k < 3; ++k) h[k] = fmaf(best_t, d[k], o[k]);
        if (tri_win) {
          for (int k = 0; k < 3; ++k)
            nrm[k] = __ldg(p.mt.tri + (T_N + k) * p.mt.t_pad + ti);
        } else {
          for (int k = 0; k < 3; ++k)
            nrm[k] = (h[k] - s_sph[(F_CX + k) * kMaxSpheres + bi]) /
                     s_sph[F_R * kMaxSpheres + bi];
        }
        const bool front = dot3(d, nrm) < 0.f;
        if (!front)
          for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
        Scatter sc;
        if constexpr (kMesh) {
          const HitMaterial mat =
              tri_win ? mesh_material(s_cam, p.mesh_type)
                      : sphere_material(s_sph, kMaxSpheres, bi);
          sc = scatter_material(mat, flags, p.seed, pix, sid, depth, d, a,
                                nrm, front);
        } else {
          sc = scatter_hit(s_sph, kMaxSpheres, bi, flags, p.seed, pix, sid,
                           depth, d, a, nrm, front);
        }
        if (sc.emitted) {
          ending = END_EMIT;
          win = tri_win ? ti : bi;
          win_tri = tri_win;
          break;
        }
        if (sc.absorbed || depth + 1 >= p.max_depth) break;  // black
        if constexpr (!kEmit && kCut != kCutReplay) {
          float* r = rec + (size_t)depth * kR * rs;
          r[R_OX * rs] = o[0];
          r[R_OY * rs] = o[1];
          r[R_OZ * rs] = o[2];
          r[R_DX * rs] = d[0];
          r[R_DY * rs] = d[1];
          r[R_DZ * rs] = d[2];
          r[R_TR * rs] = T[0];
          r[R_TG * rs] = T[1];
          r[R_TB * rs] = T[2];
          r[R_WIN * rs] = (float)(tri_win ? n : bi);
          if constexpr (kMesh) {
            r[R_T * rs] = best_t;
            r[R_TID * rs] = (float)ti;
          }
        }
        for (int k = 0; k < 3; ++k) {
          o[k] = h[k];
          d[k] = sc.dir[k];
          T[k] = T[k] * sc.att[k];
        }
        ++depth;
      }
      if constexpr (kEmit) {
        // ---- K6: the miss record, and an emitter's contribution ----
        const bool miss = ending == END_MISS;
        const size_t plane = (size_t)p.n_samples * p.n_pix;
        float* e = p.emit + (size_t)s * p.n_pix + local;
        e[E_DX * plane] = miss ? d[0] : 0.f;
        e[E_DY * plane] = miss ? d[1] : 0.f;
        e[E_DZ * plane] = miss ? d[2] : 1.f;
        e[E_TR * plane] = miss ? T[0] : 0.f;
        e[E_TG * plane] = miss ? T[1] : 0.f;
        e[E_TB * plane] = miss ? T[2] : 0.f;
        if (ending == END_EMIT) {
          for (int k = 0; k < 3; ++k) {
            const float alb = win_tri
                                  ? s_cam[C_MA + k]
                                  : s_sph[(F_ALR + k) * kMaxSpheres + win];
            float v = T[k] * alb;
            if (flags & CLAMP) v = clamp01(v);
            emis[k] = emis[k] + (isnan(v) ? 0.f : v);
          }
        }
        continue;
      }
      if constexpr (kCut == kCutReplay || kCut == kCutRecords) {
        lane_sink.add(0, T[0] + d[0]);
        continue;
      }
      if (ending == END_BLACK) continue;

      // ---- 2. seed: c = T * src, clamped, NaN -> 0 ----
      float src[3];
      if (ending == END_MISS) {
        if constexpr (kSky == kSkyConsume) {
          // the sky value K6's lookup gave this sample
          for (int k = 0; k < 3; ++k)
            src[k] = p.sky_rows[((size_t)k * p.n_samples + s) * p.n_pix +
                                local];
        } else {
          sky_colour(s_cam, flags, d, dot3(d, d), src);
        }
      } else if (win_tri)
        for (int k = 0; k < 3; ++k) src[k] = s_cam[C_MA + k];
      else
        for (int k = 0; k < 3; ++k)
          src[k] = s_sph[(F_ALR + k) * kMaxSpheres + win];
      float gcv[3];
      bool any = false;
      for (int k = 0; k < 3; ++k) {
        const float cv = T[k] * src[k];
        const float cg = (flags & CLAMP) ? clamp01_grad(cv) : 1.f;
        gcv[k] = isnan(cv) ? 0.f : g[k] * cg;
        any = any || gcv[k] != 0.f;
      }
      if (!any) continue;
      // the sphere variant counts the seed too; the mesh variant counts
      // the bounces walked back alone
      n_reverse += (unsigned int)depth + (kMesh ? 0u : 1u);
      float go[3] = {0.f, 0.f, 0.f}, gd[3] = {0.f, 0.f, 0.f}, gT[3];
      for (int k = 0; k < 3; ++k) gT[k] = gcv[k] * src[k];
      if (ending == END_EMIT) {
        if (win_tri) {
          for (int k = 0; k < 3; ++k) {
            if constexpr (kCut == kCutTriAtomics)
              lane_sink.add(0, gcv[k] * T[k]);
            else
              atomicAdd(&p.gtri[(GT_MAT + k) * p.mt.t_pad + win],
                        gcv[k] * T[k]);
          }
        } else {
          for (int k = 0; k < 3; ++k) {
            if constexpr (kCut == kCutAtomics)
              lane_sink.add(0, gcv[k] * T[k]);
            else
              atomicAdd(&s_acc[(G_ALR + k) * kMaxSpheres + win],
                        gcv[k] * T[k]);
          }
        }
      } else if constexpr (kSky == kSkyConsume) {
        // a constant sky value: no adjoint of the direction (the texel's
        // cotangent is the caller's)
      } else if (flags & SKY_CONST) {
        for (int k = 0; k < 3; ++k) gcam[C_SKY + k] += gcv[k] * T[k];
      } else {
        // sky = (1 - t) + t blue, t = (d_y / |d| + 1) / 2
        const float a = dot3(d, d);
        const float len = sqrtf(a);
        const float gtk = gcv[0] * T[0] * (0.5f - 1.f) +
                          gcv[1] * T[1] * (0.7f - 1.f);
        const float gy = 0.5f * gtk;
        for (int k = 0; k < 3; ++k)
          gd[k] = gy * ((k == 1 ? 1.f : 0.f) - d[1] * d[k] / a) / len;
      }

      // ---- 3. reverse walk over the bounces that went on ----
      for (int k = depth - 1; k >= 0; --k) {
        if constexpr (kCut == kCutSimt) {
          ++n_back;
          if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) ++w_back;
        }
        const float* r = rec + (size_t)k * kR * rs;
        const float ok[3] = {r[R_OX * rs], r[R_OY * rs], r[R_OZ * rs]};
        const float dk[3] = {r[R_DX * rs], r[R_DY * rs], r[R_DZ * rs]};
        const float tk[3] = {r[R_TR * rs], r[R_TG * rs], r[R_TB * rs]};
        const int code = (int)r[R_WIN * rs];
        if constexpr (kMesh) {
          if (code == n) {
            ++n_reverse_tri;
            const int j = (int)r[R_TID * rs];
            float gt[kGtriRows];
            tri_adjoint(p.mt, s_cam, p.mesh_type, flags, p.seed, pix, sid, k,
                        ok, dk, tk, j, r[R_T * rs], go, gd, gT, gt);
            if constexpr (kCut == kCutTriAtomics) {
              for (int q = 0; q < kGtriRows; ++q) lane_sink.add(0, gt[q]);
            } else {
              add_tri_rows(p.gtri, p.mt.t_pad, j, gt);
            }
            continue;
          }
        }
        if constexpr (kCut == kCutAtomics) {
          bounce_adjoint(s_sph, kMaxSpheres, flags, p.t_min, p.seed, pix, sid,
                         k, ok, dk, tk, code, go, gd, gT, lane_sink);
        } else {
          SphereSink sink{s_acc, kMaxSpheres, code};
          bounce_adjoint(s_sph, kMaxSpheres, flags, p.t_min, p.seed, pix, sid,
                         k, ok, dk, tk, code, go, gd, gT, sink);
        }
      }

      // ---- camera: d0 = L + H uu + V vv - o0, o0 = O (+ DU lx + DV ly) ----
      for (int k = 0; k < 3; ++k) {
        const float gok = go[k] - gd[k];
        gcam[C_L + k] += gd[k];
        gcam[C_H + k] += cd.uu * gd[k];
        gcam[C_V + k] += cd.vv * gd[k];
        gcam[C_O + k] += gok;
        if (lens) {
          gcam[C_DU + k] += cd.lx * gok;
          gcam[C_DV + k] += cd.ly * gok;
        }
      }
    }
    if constexpr (kEmit)
      for (int k = 0; k < 3; ++k)
        p.emis[(size_t)k * p.n_pix + local] = emis[k];
  }

  if constexpr (kEmit) {
    // K6 counts the bounces replayed and the triangle tests
    if (p.counts != nullptr) {
      const unsigned int w0 = __reduce_add_sync(0xffffffffu, n_replay);
      const unsigned int w1 = __reduce_add_sync(0xffffffffu, n_tests);
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(&p.counts[0], (unsigned long long)w0);
        atomicAdd(&p.counts[1], (unsigned long long)w1);
      }
    }
  } else {
    if constexpr (kCut != kCutNone) gcam[0] += lane_sink.sum;
    // ---- 4. flush: warp sums of the camera cotangents, then the block ----
    for (int k = 0; k < kCamSlots; ++k) {
      float v = gcam[k];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if ((threadIdx.x & 31) == 0) s_gcam[threadIdx.x / 32][k] = v;
    }
    if (p.counts != nullptr) {
      const unsigned int w0 = __reduce_add_sync(0xffffffffu, n_replay);
      const unsigned int w1 = __reduce_add_sync(0xffffffffu, n_reverse);
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(&p.counts[0], (unsigned long long)w0);
        atomicAdd(&p.counts[1], (unsigned long long)w1);
      }
      if constexpr (kCut == kCutSimt) {
        constexpr int c0 = kMesh ? 4 : 2;
        const unsigned int w2 = __reduce_add_sync(0xffffffffu, w_replay);
        const unsigned int w3 = __reduce_add_sync(0xffffffffu, n_back);
        const unsigned int w4 = __reduce_add_sync(0xffffffffu, w_back);
        if ((threadIdx.x & 31) == 0) {
          atomicAdd(&p.counts[c0], (unsigned long long)w2);
          atomicAdd(&p.counts[c0 + 1], (unsigned long long)w3);
          atomicAdd(&p.counts[c0 + 2], (unsigned long long)w4);
        }
      }
      if constexpr (kMesh) {
        const unsigned int w2 = __reduce_add_sync(0xffffffffu, n_tests);
        const unsigned int w3 =
            __reduce_add_sync(0xffffffffu, n_reverse_tri);
        if ((threadIdx.x & 31) == 0) {
          atomicAdd(&p.counts[2], (unsigned long long)w2);
          atomicAdd(&p.counts[3], (unsigned long long)w3);
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kGradRows * n; k += blockDim.x) {
      const float v = s_acc[(k / n) * kMaxSpheres + k % n];
      if (v != 0.f)
        atomicAdd(&p.gsph[kGradField[k / n] * p.tab_w + k % n], v);
    }
    for (int k = threadIdx.x; k < kCamSlots; k += blockDim.x) {
      float v = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) v += s_gcam[w][k];
      p.cam_part[blockIdx.x * kCamSlots + k] = v;
    }
  }
}

// ---- What K4, K5 and K7 share: a flat loop per lane ----
//
// The earlier design (the megagrad template's instances, kept for
// chip_smoke.py's measurements only) ran, per pixel and sample, the replay
// to the path's end and then the walk back over the same depth, so a warp
// waited for its deepest lane twice per sample.  K4, K5 and K7 instead let
// each lane take work items (pixel, sample) from a static map (item i =
// sample * n_pix + pixel, thread t takes t, t + n_threads, ...; Items) and
// run one flat loop over (item, phase, bounce), in the manner of the
// forward kernel's loop: a lane whose sample ends black, whose cotangent is
// zero, or whose walk back reaches the camera takes its next item at once.
// Each iteration steps every live lane by one replay bounce or one bounce
// walked back.  The camera cotangents of a thread are summed in the order
// of its items, in shared memory (a column per thread), so two launches
// give equal camera cotangents.  A bounce's sphere cotangents are summed
// over the warp's lanes that hit the same sphere before the shared atomic
// (add_rows_aggregated).  Records are 12 floats (3 float4) at (depth *
// n_threads + thread), so a lane's record is two sectors whatever depth
// its neighbours are at.
//
// Timing-only cuts (kTime bits), which only chip_smoke.py's splits launch
// (the measurement builds ORT_K4_VARIANTS and ORT_K5_VARIANTS): plain adds
// into a lane-private sum instead of the shared atomics (wrong on purpose),
// the replay alone (no record, no walk back), and the SIMT counts (the
// warp iterations of the replay, the lane steps of the walk back and its
// warp iterations).
enum FlatTime { kTimeNoAtomics = 1, kTimeReplay = 2, kTimeSimt = 4 };
constexpr int kRecAoS = 12;
constexpr unsigned kFullMask = 0xffffffffu;

// Dynamic shared memory of K4, K5 and K7 for n spheres and a camera table
// of cam_slots: the sphere table and the accumulator (kFields and kGradRows
// rows of n), the camera table, and each thread's camera cotangents
// (kCamSlots rows of kThreads).
static size_t flat_smem_bytes(int n, int cam_slots) {
  return sizeof(float) * ((size_t)(kFields + kGradRows) * n + cam_slots +
                          (size_t)kCamSlots * kThreads);
}

// That shared memory, laid out.
struct FlatShared {
  float* sph;   // kFields rows of n
  float* acc;   // kGradRows rows of n
  float* cam;   // the camera table
  float* gcam;  // kCamSlots rows of kThreads
};

// Loads the sphere and camera tables into s and zeroes its sums.  Each
// kernel lays s out itself: with the pointers worked out in here, nvcc
// vectorized K4's camera-table reads and allocated its registers
// otherwise, 3% slower on the book cover (PERF.md).
__device__ __forceinline__ void load_flat_shared(const Params& p,
                                                 const FlatShared& s,
                                                 int cam_slots) {
  const int n = p.n_spheres;
  for (int k = threadIdx.x; k < kFields * n; k += blockDim.x)
    s.sph[k] = p.sph[(k / n) * p.tab_w + k % n];
  for (int k = threadIdx.x; k < kGradRows * n; k += blockDim.x)
    s.acc[k] = 0.f;
  for (int k = threadIdx.x; k < cam_slots; k += blockDim.x)
    s.cam[k] = p.cam[k];
  for (int k = threadIdx.x; k < kCamSlots * kThreads; k += blockDim.x)
    s.gcam[k] = 0.f;
  __syncthreads();
}

// A lane's work item: sample s_item of pixel `local` of the window; the
// thread's first is item tid, and each next n_threads = step_s samples and
// step_pix pixels further.  The sample's counters (pix, sid) are worked out
// from the item where they are used: kept in registers, they spill.
struct Items {
  int step_s, step_pix, s_item, local;

  __device__ __forceinline__ Items(const Params& p, int tid)
      : step_s(p.n_threads / p.n_pix),
        step_pix(p.n_threads % p.n_pix),
        s_item(tid / p.n_pix),
        local(tid % p.n_pix) {}

  __device__ __forceinline__ uint32_t pix(const Params& p) const {
    return (uint32_t)(p.pix_offset + local);
  }
  __device__ __forceinline__ uint32_t sid(const Params& p) const {
    return p.sample_base + (uint32_t)s_item;
  }
  __device__ __forceinline__ void advance(const Params& p) {
    s_item += step_s;
    local += step_pix;
    if (local >= p.n_pix) {
      local -= p.n_pix;
      ++s_item;
    }
  }
  // The item's camera ray (o, d) and the draws it depends on.
  __device__ __forceinline__ CamDraw ray(const Params& p, const float* s_cam,
                                         float (&o)[3], float (&d)[3]) const {
    const int lin = p.pix_offset + local;
    return camera_ray(s_cam, p.seed, p.width, p.height, p.flags, pix(p),
                      sid(p), (float)(lin % p.width), (float)(lin / p.width),
                      o, d);
  }
  // Takes the current item, or the first after it whose pixel has a
  // nonzero cotangent, and casts its camera ray (T = 1); false when none
  // is left.
  __device__ __forceinline__ bool start(const Params& p, const float* s_cam,
                                        float (&o)[3], float (&d)[3],
                                        float (&T)[3]) {
    for (; s_item < p.n_samples; advance(p)) {
      if (p.g_r[local] == 0.f && p.g_g[local] == 0.f && p.g_b[local] == 0.f)
        continue;
      ray(p, s_cam, o, d);
      for (int k = 0; k < 3; ++k) T[k] = 1.f;
      return true;
    }
    return false;
  }
};

// The adjoint of the item's camera ray, d0 = L + H uu + V vv - o0,
// o0 = O (+ DU lx + DV ly), into the thread's camera cotangents (slot k
// at gcam[k * kThreads]).
__device__ __forceinline__ void camera_adjoint(const Items& it,
                                               const Params& p,
                                               const float* s_cam, bool lens,
                                               const float (&go)[3],
                                               const float (&gd)[3],
                                               float* gcam) {
  float o0[3], d0[3];
  const CamDraw cd = it.ray(p, s_cam, o0, d0);
  for (int k = 0; k < 3; ++k) {
    const float gok = go[k] - gd[k];
    gcam[(C_L + k) * kThreads] += gd[k];
    gcam[(C_H + k) * kThreads] += cd.uu * gd[k];
    gcam[(C_V + k) * kThreads] += cd.vv * gd[k];
    gcam[(C_O + k) * kThreads] += gok;
    if (lens) {
      gcam[(C_DU + k) * kThreads] += cd.lx * gok;
      gcam[(C_DV + k) * kThreads] += cd.ly * gok;
    }
  }
}

// Record k of thread tid: three float4 at (k * n_threads + tid).
__device__ __forceinline__ float4* flat_record(const Params& p, int k,
                                               int tid) {
  return reinterpret_cast<float4*>(p.rec +
                                   ((size_t)k * p.n_threads + tid) * kRecAoS);
}

// Adds v, summed over the warp, to *c: one atomic a warp.
__device__ __forceinline__ void count_warp(unsigned long long* c,
                                           unsigned int v) {
  const unsigned int w = __reduce_add_sync(kFullMask, v);
  if ((threadIdx.x & 31) == 0) atomicAdd(c, (unsigned long long)w);
}

// The end of K4, K5 and K7: the block's sphere cotangents into gsph (one
// global atomic per nonzero entry), and its camera cotangents, summed over
// its threads in a fixed order, into the block's row of cam_part.
__device__ __forceinline__ void flush_flat(const Params& p,
                                           const FlatShared& s) {
  const int n = p.n_spheres;
  __syncthreads();
  for (int k = threadIdx.x; k < kGradRows * n; k += blockDim.x) {
    const float v = s.acc[k];
    if (v != 0.f) atomicAdd(&p.gsph[kGradField[k / n] * p.tab_w + k % n], v);
  }
  for (int k = threadIdx.x; k < kCamSlots; k += blockDim.x) {
    float v = 0.f;
    for (int t = 0; t < kThreads; ++t) v += s.gcam[k * kThreads + t];
    p.cam_part[blockIdx.x * kCamSlots + k] = v;
  }
}

// Adds each lane's rows v to column bi of the accumulator acc (rows of
// `stride`), first summed over the lanes of `lanes` (the lanes that make
// this call together) that share bi: a tree over each group's lanes by
// their rank in it (E. Westphal's shuffle reduction over peers), then one
// atomic per group and nonzero row.  Rows that the scene's materials
// cannot reach (fuzz without metal, ior without glass) are skipped.
__device__ __forceinline__ void add_rows_aggregated(unsigned lanes, int bi,
                                                    float (&v)[kGradRows],
                                                    float* acc, int stride,
                                                    int flags) {
  const int lane = threadIdx.x & 31;
  unsigned peers = __match_any_sync(lanes, bi);
  const bool leader = __ffs(peers) - 1 == lane;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= ~((2u << lane) - 1u);  // the peers above this lane
  while (__any_sync(lanes, peers != 0u)) {
    const int next = __ffs(peers) - 1;
    const int src = next < 0 ? lane : next;
    for (int r = 0; r < kGradRows; ++r) {
      if (r == G_FUZZ && !(flags & HAS_METAL)) continue;
      if ((r == G_IOR || r == G_INVIOR) && !(flags & HAS_DIEL)) continue;
      const float t = __shfl_sync(lanes, v[r], src);
      if (next >= 0) v[r] += t;
    }
    peers &= ~__ballot_sync(lanes, rank & 1);
    rank >>= 1;
  }
  if (leader)
    for (int r = 0; r < kGradRows; ++r)
      if (v[r] != 0.f) atomicAdd(&acc[r * stride + bi], v[r]);
}

// ---- K4: the sphere backward ----
//
// The flat loop above with the sphere replay.  The register budget is set
// for 6 blocks an SM (80 registers, no spill).  Its SIMT counts go to
// counts[2..4].
template <int kTime = 0>
__global__ void __launch_bounds__(kThreads, 6)
    sphere_megagrad(const Params p) {
  constexpr bool kNoAtomics = (kTime & kTimeNoAtomics) != 0;
  constexpr bool kReplayOnly = (kTime & kTimeReplay) != 0;
  constexpr bool kSimt = (kTime & kTimeSimt) != 0;
  extern __shared__ float smem[];
  const int n = p.n_spheres;
  float* const s_acc = smem + kFields * n;
  float* const s_tab = s_acc + kGradRows * n;  // the camera table
  const FlatShared sh{smem, s_acc, s_tab, s_tab + kCamSlots};
  load_flat_shared(p, sh, kCamSlots);
  const float* const s_sph = sh.sph;
  // this thread's camera cotangents: slot k at gcam[k * kThreads]
  float* const gcam = sh.gcam + threadIdx.x;

  const int flags = p.flags;
  const bool lens = (flags & HAS_APERTURE) && sh.cam[C_APERTURE] > 0.f;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  unsigned int n_replay = 0, n_reverse = 0;
  unsigned int w_replay = 0, n_back = 0, w_back = 0;  // kTimeSimt
  LaneSink lane_sink{0.f};                           // the timing cuts' sink

  // the lane's item and state: the ray (o, d) and throughput T of the
  // replay, or the record being walked back and the adjoints (go, gd, gT);
  // depth counts the records
  Items it(p, tid);
  int depth = 0;
  bool back = false;
  float o[3], d[3], T[3], go[3], gd[3], gT[3];
  for (int k = 0; k < 3; ++k) go[k] = gd[k] = gT[k] = 0.f;

  bool live = it.start(p, sh.cam, o, d, T);
  while (__any_sync(kFullMask, live)) {
    const bool replay = live && !back;
    const bool reverse = live && back;
    const unsigned rev_lanes = __ballot_sync(kFullMask, reverse);
    if constexpr (kSimt) {
      const unsigned rep_lanes = __ballot_sync(kFullMask, replay);
      if (lane == 0) {
        w_replay += rep_lanes != 0u;
        w_back += rev_lanes != 0u;
      }
    }
    bool done = false;       // the item ends in this iteration
    bool at_camera = false;  // its walk back reaches the camera
    const uint32_t pix = it.pix(p), sid = it.sid(p);

    if (replay) {
      // ---- one bounce of the replay (the forward's device code) ----
      ++n_replay;
      const float a = dot3(d, d);
      float best_t;
      int bi;
      closest_sphere(s_sph, n, n, o, d, a, p.t_min, best_t, bi);
      int ending = END_BLACK;
      if (!(best_t < kBig)) {
        ending = END_MISS;
      } else {
        float h[3], nrm[3];
        for (int k = 0; k < 3; ++k) h[k] = fmaf(best_t, d[k], o[k]);
        for (int k = 0; k < 3; ++k)
          nrm[k] = (h[k] - s_sph[(F_CX + k) * n + bi]) / s_sph[F_R * n + bi];
        const bool front = dot3(d, nrm) < 0.f;
        if (!front)
          for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
        const Scatter sc = scatter_hit(s_sph, n, bi, flags, p.seed, pix, sid,
                                       depth, d, a, nrm, front);
        if (sc.emitted) {
          ending = END_EMIT;
        } else if (sc.absorbed || depth + 1 >= p.max_depth) {
          done = true;  // black
        } else {
          if constexpr (!kReplayOnly) {
            float4* r4 = flat_record(p, depth, tid);
            r4[0] = make_float4(o[0], o[1], o[2], d[0]);
            r4[1] = make_float4(d[1], d[2], T[0], T[1]);
            r4[2] = make_float4(T[2], (float)bi, 0.f, 0.f);
          }
          for (int k = 0; k < 3; ++k) {
            o[k] = h[k];
            d[k] = sc.dir[k];
            T[k] = T[k] * sc.att[k];
          }
          ++depth;
        }
      }
      if (ending != END_BLACK && kReplayOnly) {
        lane_sink.add(0, T[0] + d[0]);
        done = true;
      } else if (ending != END_BLACK) {
        // ---- the seed: c = T * src, clamped, NaN -> 0 ----
        const int local = it.local;
        const float g[3] = {p.g_r[local], p.g_g[local], p.g_b[local]};
        float src[3];
        if (ending == END_MISS)
          sky_colour(sh.cam, flags, d, dot3(d, d), src);
        else
          for (int k = 0; k < 3; ++k) src[k] = s_sph[(F_ALR + k) * n + bi];
        float gcv[3];
        bool any = false;
        for (int k = 0; k < 3; ++k) {
          const float cv = T[k] * src[k];
          const float cg = (flags & CLAMP) ? clamp01_grad(cv) : 1.f;
          gcv[k] = isnan(cv) ? 0.f : g[k] * cg;
          any = any || gcv[k] != 0.f;
        }
        if (!any) {
          done = true;
        } else {
          // the bounces walked back, the seed counted
          n_reverse += (unsigned int)depth + 1u;
          for (int k = 0; k < 3; ++k) {
            go[k] = 0.f;
            gd[k] = 0.f;
            gT[k] = gcv[k] * src[k];
          }
          if (ending == END_EMIT) {
            for (int k = 0; k < 3; ++k) {
              if constexpr (kNoAtomics)
                lane_sink.add(0, gcv[k] * T[k]);
              else
                atomicAdd(&sh.acc[(G_ALR + k) * n + bi], gcv[k] * T[k]);
            }
          } else if (flags & SKY_CONST) {
            for (int k = 0; k < 3; ++k)
              gcam[(C_SKY + k) * kThreads] += gcv[k] * T[k];
          } else {
            // sky = (1 - t) + t blue, t = (d_y / |d| + 1) / 2
            const float a2 = dot3(d, d);
            const float len = sqrtf(a2);
            const float gtk = gcv[0] * T[0] * (0.5f - 1.f) +
                              gcv[1] * T[1] * (0.7f - 1.f);
            const float gy = 0.5f * gtk;
            for (int k = 0; k < 3; ++k)
              gd[k] = gy * ((k == 1 ? 1.f : 0.f) - d[1] * d[k] / a2) / len;
          }
          back = true;
          at_camera = depth == 0;
        }
      }
    }

    if (reverse) {
      // ---- one bounce walked back, from its record ----
      --depth;
      if constexpr (kSimt) ++n_back;
      const float4* r4 = flat_record(p, depth, tid);
      const float4 a = r4[0], b = r4[1], c = r4[2];
      o[0] = a.x; o[1] = a.y; o[2] = a.z;
      d[0] = a.w; d[1] = b.x; d[2] = b.y;
      T[0] = b.z; T[1] = b.w; T[2] = c.x;
      const int bi = (int)c.y;
      if constexpr (kNoAtomics) {
        bounce_adjoint(s_sph, n, flags, p.t_min, p.seed, pix, sid, depth, o,
                       d, T, bi, go, gd, gT, lane_sink);
      } else {
        RowSink rows{};
        bounce_adjoint(s_sph, n, flags, p.t_min, p.seed, pix, sid, depth, o,
                       d, T, bi, go, gd, gT, rows);
        add_rows_aggregated(rev_lanes, bi, rows.v, sh.acc, n, flags);
      }
      at_camera = depth == 0;
    }
    if (at_camera) {
      camera_adjoint(it, p, sh.cam, lens, go, gd, gcam);
      done = true;
    }
    if (done) {
      it.advance(p);
      live = it.start(p, sh.cam, o, d, T);
      depth = 0;
      back = false;
    }
  }

  // ---- flush: the counts, then the block's sums ----
  if constexpr (kNoAtomics || kReplayOnly) gcam[0] += lane_sink.sum;
  if (p.counts != nullptr) {
    count_warp(&p.counts[0], n_replay);
    count_warp(&p.counts[1], n_reverse);
    if constexpr (kSimt) {
      count_warp(&p.counts[3], n_back);
      if (lane == 0) {
        atomicAdd(&p.counts[2], (unsigned long long)w_replay);
        atomicAdd(&p.counts[4], (unsigned long long)w_back);
      }
    }
  }
  flush_flat(p, sh);
}

// ---- K5 and K7: the mesh backward ----
//
// The flat loop above with the mesh's replay and the triangle bounces.  As
// items map neighbouring lanes to neighbouring pixels of one sample, K7's
// reads of sky_rows are neighbouring words.  The replay is the forward's
// device code (closest_sphere, mesh.cuh's closest_triangle,
// scatter_material, camera_ray), the same as K6's, so K7 takes K6's
// discrete decisions bit for bit.  Records hold the origin, direction,
// throughput, winner code, hit t and plan-order triangle id.  A triangle
// bounce adds its cotangents to gtri with a global atomic per row, as the
// earlier design did (summing them over the lanes that hit the same
// triangle first was 2-3% slower: they are few, and the neighbours'
// triangles differ).  What the measurements chose (chip_smoke.py phase 6g,
// PERF.md): the flat loop halves the replay's warp iterations (its SIMT
// efficiency 29% -> 52%), which is most of K5 and K7 at 15,360 triangles,
// and 7 blocks an SM hide the walk's dependent loads (1.5x faster than 5
// spill-free blocks); a walk back run to the camera in the iteration its
// sample's replay ends, the triangle-major table in the replay, and 5, 6
// or 8 blocks an SM were slower.
//
// Timing-only instances besides those above: the triangle atomics as
// plain adds into a lane-private sum (wrong on purpose).  The SIMT counts
// go to counts[4..6], as the earlier design's.
enum MeshTime { kTimeNoTriAtomics = 8 };
// The blocks an SM the register budget is set for: 72 registers, with 58
// bytes spilled (K5 and K7 alike), faster than the 88 spill-free
// registers of 5 blocks an SM (PERF.md).
constexpr int kMeshBlocks = 7;

template <int kSky, int kTime = 0>
__global__ void __launch_bounds__(kThreads, kMeshBlocks)
    mesh_megagrad(const Params p) {
  constexpr bool kNoAtomics = (kTime & kTimeNoAtomics) != 0;
  constexpr bool kNoTriAtomics = (kTime & kTimeNoTriAtomics) != 0;
  constexpr bool kReplayOnly = (kTime & kTimeReplay) != 0;
  constexpr bool kSimt = (kTime & kTimeSimt) != 0;
  extern __shared__ float smem[];
  const int n = p.n_spheres;
  float* const s_acc = smem + kFields * n;
  float* const s_tab = s_acc + kGradRows * n;  // the camera table
  const FlatShared sh{smem, s_acc, s_tab, s_tab + kMeshCamSlots};
  load_flat_shared(p, sh, kMeshCamSlots);
  const float* const s_sph = sh.sph;
  // read through a const pointer from here: through a float*, nvcc
  // spills K5 more
  const float* const s_cam = sh.cam;
  // this thread's camera cotangents: slot k at gcam[k * kThreads]
  float* const gcam = sh.gcam + threadIdx.x;

  const int flags = p.flags;
  const bool lens = (flags & HAS_APERTURE) && s_cam[C_APERTURE] > 0.f;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int tp = p.mt.t_pad;
  unsigned int n_replay = 0, n_reverse = 0, n_tests = 0, n_reverse_tri = 0;
  unsigned int w_replay = 0, n_back = 0, w_back = 0;  // kTimeSimt
  LaneSink lane_sink{0.f};                           // the timing cuts' sink

  // the lane's item and state, as K4's
  Items it(p, tid);
  int depth = 0;
  bool back = false;
  float o[3], d[3], T[3], go[3], gd[3], gT[3];
  for (int k = 0; k < 3; ++k) go[k] = gd[k] = gT[k] = 0.f;

  bool live = it.start(p, s_cam, o, d, T);
  while (__any_sync(kFullMask, live)) {
    const bool replay = live && !back;
    const bool reverse = live && back;
    if constexpr (kSimt) {
      const unsigned rep_lanes = __ballot_sync(kFullMask, replay);
      const unsigned rev_lanes = __ballot_sync(kFullMask, reverse);
      if (lane == 0) {
        w_replay += rep_lanes != 0u;
        w_back += rev_lanes != 0u;
      }
    }
    bool done = false;       // the item ends in this iteration
    bool at_camera = false;  // its walk back reaches the camera
    const uint32_t pix = it.pix(p), sid = it.sid(p);

    if (replay) {
      // ---- one bounce of the replay (the forward's device code) ----
      ++n_replay;
      const float a = dot3(d, d);
      float best_t;
      int bi;
      closest_sphere(s_sph, n, n, o, d, a, p.t_min, best_t, bi);
      float tri_t = kBig;
      int ti = 0;
      closest_triangle(p.mt, o, d, p.t_min, best_t, tri_t, ti, n_tests);
      const bool tri_win = tri_t < best_t;
      if (tri_win) best_t = tri_t;
      int ending = END_BLACK;
      if (!(best_t < kBig)) {
        ending = END_MISS;
      } else {
        float h[3], nrm[3];
        for (int k = 0; k < 3; ++k) h[k] = fmaf(best_t, d[k], o[k]);
        if (tri_win) {
          for (int k = 0; k < 3; ++k)
            nrm[k] = __ldg(p.mt.tri + (T_N + k) * tp + ti);
        } else {
          for (int k = 0; k < 3; ++k)
            nrm[k] =
                (h[k] - s_sph[(F_CX + k) * n + bi]) / s_sph[F_R * n + bi];
        }
        const bool front = dot3(d, nrm) < 0.f;
        if (!front)
          for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
        const HitMaterial mat = tri_win ? mesh_material(s_cam, p.mesh_type)
                                        : sphere_material(s_sph, n, bi);
        const Scatter sc = scatter_material(mat, flags, p.seed, pix, sid,
                                            depth, d, a, nrm, front);
        if (sc.emitted) {
          ending = END_EMIT;
        } else if (sc.absorbed || depth + 1 >= p.max_depth) {
          done = true;  // black
        } else {
          if constexpr (!kReplayOnly) {
            float4* r4 = flat_record(p, depth, tid);
            r4[0] = make_float4(o[0], o[1], o[2], d[0]);
            r4[1] = make_float4(d[1], d[2], T[0], T[1]);
            r4[2] = make_float4(T[2], (float)(tri_win ? n : bi), best_t,
                                (float)ti);
          }
          for (int k = 0; k < 3; ++k) {
            o[k] = h[k];
            d[k] = sc.dir[k];
            T[k] = T[k] * sc.att[k];
          }
          ++depth;
        }
      }
      if (ending != END_BLACK && kReplayOnly) {
        lane_sink.add(0, T[0] + d[0]);
        done = true;
      } else if (ending != END_BLACK) {
        // ---- the seed: c = T * src, clamped, NaN -> 0 ----
        const int local = it.local;
        const float g[3] = {p.g_r[local], p.g_g[local], p.g_b[local]};
        float src[3];
        if (ending == END_MISS) {
          if constexpr (kSky == kSkyConsume) {
            // the sky value K6's lookup gave this sample
            for (int k = 0; k < 3; ++k)
              src[k] = p.sky_rows[((size_t)k * p.n_samples + it.s_item) *
                                      p.n_pix + local];
          } else {
            sky_colour(s_cam, flags, d, dot3(d, d), src);
          }
        } else if (tri_win) {
          for (int k = 0; k < 3; ++k) src[k] = s_cam[C_MA + k];
        } else {
          for (int k = 0; k < 3; ++k) src[k] = s_sph[(F_ALR + k) * n + bi];
        }
        float gcv[3];
        bool any = false;
        for (int k = 0; k < 3; ++k) {
          const float cv = T[k] * src[k];
          const float cg = (flags & CLAMP) ? clamp01_grad(cv) : 1.f;
          gcv[k] = isnan(cv) ? 0.f : g[k] * cg;
          any = any || gcv[k] != 0.f;
        }
        if (!any) {
          done = true;
        } else {
          // the bounces walked back, without the seed
          n_reverse += (unsigned int)depth;
          for (int k = 0; k < 3; ++k) {
            go[k] = 0.f;
            gd[k] = 0.f;
            gT[k] = gcv[k] * src[k];
          }
          if (ending == END_EMIT) {
            for (int k = 0; k < 3; ++k) {
              const float v = gcv[k] * T[k];
              if (tri_win) {
                if constexpr (kNoTriAtomics)
                  lane_sink.add(0, v);
                else
                  atomicAdd(&p.gtri[(GT_MAT + k) * tp + ti], v);
              } else {
                if constexpr (kNoAtomics)
                  lane_sink.add(0, v);
                else
                  atomicAdd(&sh.acc[(G_ALR + k) * n + bi], v);
              }
            }
          } else if constexpr (kSky == kSkyConsume) {
            // a constant sky value: no adjoint of the direction (the
            // texel's cotangent is the caller's)
          } else if (flags & SKY_CONST) {
            for (int k = 0; k < 3; ++k)
              gcam[(C_SKY + k) * kThreads] += gcv[k] * T[k];
          } else {
            // sky = (1 - t) + t blue, t = (d_y / |d| + 1) / 2
            const float a2 = dot3(d, d);
            const float len = sqrtf(a2);
            const float gtk = gcv[0] * T[0] * (0.5f - 1.f) +
                              gcv[1] * T[1] * (0.7f - 1.f);
            const float gy = 0.5f * gtk;
            for (int k = 0; k < 3; ++k)
              gd[k] = gy * ((k == 1 ? 1.f : 0.f) - d[1] * d[k] / a2) / len;
          }
          back = true;
          at_camera = depth == 0;
        }
      }
    }

    // ---- one bounce walked back, from its record (the ballot of the
    // sphere bounces runs on all 32 lanes) ----
    int code = 0, j = 0;
    float t_rec = 0.f;
    if (reverse) {
      --depth;
      if constexpr (kSimt) ++n_back;
      const float4* r4 = flat_record(p, depth, tid);
      const float4 a = r4[0], b = r4[1], c = r4[2];
      o[0] = a.x; o[1] = a.y; o[2] = a.z;
      d[0] = a.w; d[1] = b.x; d[2] = b.y;
      T[0] = b.z; T[1] = b.w; T[2] = c.x;
      code = (int)c.y;
      t_rec = c.z;
      j = (int)c.w;
    }
    const bool tri = reverse && code == n;
    const unsigned sph_lanes = __ballot_sync(kFullMask, reverse && !tri);
    if (tri) {
      ++n_reverse_tri;
      float gt[kGtriRows];
      tri_adjoint(p.mt, s_cam, p.mesh_type, flags, p.seed, pix, sid, depth,
                  o, d, T, j, t_rec, go, gd, gT, gt);
      if constexpr (kNoTriAtomics) {
        for (int r = 0; r < kGtriRows; ++r) lane_sink.add(0, gt[r]);
      } else {
        add_tri_rows(p.gtri, tp, j, gt);
      }
    } else if (reverse) {
      if constexpr (kNoAtomics) {
        bounce_adjoint(s_sph, n, flags, p.t_min, p.seed, pix, sid, depth, o,
                       d, T, code, go, gd, gT, lane_sink);
      } else {
        RowSink rows{};
        bounce_adjoint(s_sph, n, flags, p.t_min, p.seed, pix, sid, depth, o,
                       d, T, code, go, gd, gT, rows);
        add_rows_aggregated(sph_lanes, code, rows.v, sh.acc, n, flags);
      }
    }
    if (reverse && depth == 0) at_camera = true;
    if (at_camera) {
      camera_adjoint(it, p, s_cam, lens, go, gd, gcam);
      done = true;
    }
    if (done) {
      it.advance(p);
      live = it.start(p, s_cam, o, d, T);
      depth = 0;
      back = false;
    }
  }

  // ---- flush: the counts, then the block's sums ----
  if constexpr (kNoAtomics || kNoTriAtomics || kReplayOnly)
    gcam[0] += lane_sink.sum;
  if (p.counts != nullptr) {
    count_warp(&p.counts[0], n_replay);
    count_warp(&p.counts[1], n_reverse);
    count_warp(&p.counts[2], n_tests);
    count_warp(&p.counts[3], n_reverse_tri);
    if constexpr (kSimt) {
      count_warp(&p.counts[5], n_back);
      if (lane == 0) {
        atomicAdd(&p.counts[4], (unsigned long long)w_replay);
        atomicAdd(&p.counts[6], (unsigned long long)w_back);
      }
    }
  }
  flush_flat(p, sh);
}

// Threads to launch for n_work items (pixels, or the pixel samples of K4,
// K5 and K7) of `kernel` with `smem` bytes of dynamic shared memory on the
// current
// device: at most as many as can be resident at once, so that the
// record buffer (n_threads * max_depth * record floats) stays small; -1
// when the query fails.
static int resident_threads(const void* kernel, size_t smem,
                            long long n_work) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  const long long blocks = (n_work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(blocks < cap ? blocks : cap) * kThreads;
}

// K4's arguments (see sphere_megagrad_launch), checked, into p.
static bool sphere_params(Params& p, const float* cam, const float* sph,
                          int tab_w, int n_spheres, const float* g_r,
                          const float* g_g, const float* g_b, float* cam_part,
                          float* gsph, float* rec, int n_threads,
                          unsigned long long* counts, int n_pix,
                          int pix_offset, unsigned int seed,
                          unsigned int sample_base, int n_samples, int width,
                          int height, int max_depth, float t_min, int flags) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || tab_w < n_spheres ||
      n_pix < 0 || width < 1 || height < 1 || n_samples < 0 ||
      max_depth < 1 || n_threads < kThreads || n_threads % kThreads != 0)
    return false;
  p = Params{};
  p.cam = cam;
  p.sph = sph;
  p.g_r = g_r;
  p.g_g = g_g;
  p.g_b = g_b;
  p.cam_part = cam_part;
  p.gsph = gsph;
  p.rec = rec;
  p.counts = counts;
  p.tab_w = tab_w;
  p.n_spheres = n_spheres;
  p.n_pix = n_pix;
  p.pix_offset = pix_offset;
  p.n_threads = n_threads;
  p.seed = seed;
  p.sample_base = sample_base;
  p.n_samples = n_samples;
  p.width = width;
  p.height = height;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.flags = flags;
  return true;
}

}  // namespace

// Threads K4 launches for n_items = pixels x samples with n_spheres
// spheres (its shared memory grows with them).
extern "C" int sphere_megagrad_threads(long long n_items, int n_spheres) {
  return resident_threads(
      (const void*)sphere_megagrad<>,
      flat_smem_bytes(n_spheres, kCamSlots), n_items);
}

// Threads K5 and K7 launch for n_items = pixels x samples with n_spheres
// spheres.
extern "C" int mesh_megagrad_threads(long long n_items, int n_spheres) {
  return resident_threads((const void*)mesh_megagrad<kSkyComputed>,
                          flat_smem_bytes(n_spheres, kMeshCamSlots), n_items);
}

extern "C" int hdr_consume_threads(long long n_items, int n_spheres) {
  return resident_threads((const void*)mesh_megagrad<kSkyConsume>,
                          flat_smem_bytes(n_spheres, kMeshCamSlots), n_items);
}

// Launches K4 on `stream` and returns cudaGetLastError(): nonzero when the
// launch was refused.  g_*: (n_pix,) cotangent planes; cam_part
// (n_threads / 128 x 22) receives each block's camera cotangents (left as
// it is when n_pix or n_samples is 0); gsph (16 x tab_w) is added to; rec:
// n_threads * max_depth * 12 floats of scratch, 16-byte aligned; counts,
// when not null, receives the bounces replayed and the bounces walked back
// (the seed counted).
extern "C" int sphere_megagrad_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* g_r, const float* g_g, const float* g_b, float* cam_part,
    float* gsph, float* rec, int n_threads, unsigned long long* counts,
    int n_pix, int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  Params p;
  if (!sphere_params(p, cam, sph, tab_w, n_spheres, g_r, g_g, g_b, cam_part,
                     gsph, rec, n_threads, counts, n_pix, pix_offset, seed,
                     sample_base, n_samples, width, height, max_depth, t_min,
                     flags))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  sphere_megagrad<>
      <<<n_threads / kThreads, kThreads, flat_smem_bytes(n_spheres, kCamSlots),
         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

#ifdef ORT_K4_VARIANTS
// The measurement build: the instances chip_smoke.py's split of K4 times,
// by index (its K4_VARIANTS names them in this order).  The first five are
// the earlier design (a pixel per thread, the megagrad template's sphere
// instance) and its timing cuts; the rest are K4's timing cuts.
namespace {
using KernelFn = void (*)(const Params);
const KernelFn kVariants[] = {
    megagrad<false, kSkyComputed, kCutNone>,
    megagrad<false, kSkyComputed, kCutReplay>,
    megagrad<false, kSkyComputed, kCutRecords>,
    megagrad<false, kSkyComputed, kCutAtomics>,
    megagrad<false, kSkyComputed, kCutSimt>,
    sphere_megagrad<kTimeNoAtomics>,
    sphere_megagrad<kTimeReplay>,
    sphere_megagrad<kTimeSimt>,
};
constexpr int kOldVariants = 5;
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
}  // namespace

// Threads variant v launches: those of the whole kernel it is cut from
// (per pixel for the earlier design, per pixel sample for K4), so that a
// cut, which needs fewer registers, runs at its whole kernel's occupancy
// and differs from it in work only; -1 for an unknown variant.
extern "C" int sphere_megagrad_variant_threads(int v, int n_pix,
                                               int n_samples, int n_spheres) {
  if (v < 0 || v >= kNumVariants) return -1;
  if (v < kOldVariants)
    return resident_threads((const void*)kVariants[0], 0, n_pix);
  return resident_threads((const void*)sphere_megagrad<>,
                          flat_smem_bytes(n_spheres, kCamSlots),
                          (long long)n_pix * n_samples);
}

// Launches variant v as sphere_megagrad_launch (rec of 12 floats a bounce
// serves all; counts, when not null, holds 5 counts: the SIMT variants
// write counts[2..4]).
extern "C" int sphere_megagrad_variant_launch(
    int v, const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* g_r, const float* g_g, const float* g_b, float* cam_part,
    float* gsph, float* rec, int n_threads, unsigned long long* counts,
    int n_pix, int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  Params p;
  if (v < 0 || v >= kNumVariants ||
      !sphere_params(p, cam, sph, tab_w, n_spheres, g_r, g_g, g_b, cam_part,
                     gsph, rec, n_threads, counts, n_pix, pix_offset, seed,
                     sample_base, n_samples, width, height, max_depth, t_min,
                     flags))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  const size_t smem = v < kOldVariants ? 0 : flat_smem_bytes(n_spheres, kCamSlots);
  kVariants[v]<<<n_threads / kThreads, kThreads, smem,
                 (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
#endif

// Launches K5 (mesh_megagrad) on `stream`, as sphere_megagrad_launch, with
// the mesh tables of the mesh megakernel (tri, cluster, sub, chunk_box,
// boxes, group, group_end, tri_major), the mesh's material type, and gtri
// (10 x t_pad, added to); n_threads from mesh_megagrad_threads;
// n_spheres may be 0; rec holds n_threads * max_depth * 12 floats, 16-byte
// aligned; counts,
// when not null, receives the bounces replayed, the bounces walked back
// (sphere and triangle bounces, without the sphere variant's one more per
// sample), the triangle tests of the replay and the triangle bounces
// walked back.
extern "C" int mesh_megagrad_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    const float* group, const int* group_end, int n_groups,
    const float* tri_major, int mesh_type, const float* g_r,
    const float* g_g, const float* g_b,
    float* cam_part, float* gsph, float* gtri, float* rec, int n_threads,
    unsigned long long* counts, int n_pix, int pix_offset, unsigned int seed,
    unsigned int sample_base, int n_samples, int width, int height,
    int max_depth, float t_min, int flags, void* stream) {
  if (n_spheres < 0 || n_spheres > kMaxMeshSpheres || tab_w < n_spheres ||
      !mesh_args_ok(t_pad, n_chunks, n_boxes, n_groups) ||
      t_pad >= (1 << 24) || n_pix < 0 || width < 1 || height < 1 ||
      n_samples < 0 || max_depth < 1 || n_threads < kThreads ||
      n_threads % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  Params p{};
  p.cam = cam;
  p.sph = sph;
  p.g_r = g_r;
  p.g_g = g_g;
  p.g_b = g_b;
  p.cam_part = cam_part;
  p.gsph = gsph;
  p.rec = rec;
  p.counts = counts;
  p.tab_w = tab_w;
  p.n_spheres = n_spheres;
  p.n_pix = n_pix;
  p.pix_offset = pix_offset;
  p.n_threads = n_threads;
  p.seed = seed;
  p.sample_base = sample_base;
  p.n_samples = n_samples;
  p.width = width;
  p.height = height;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.flags = flags;
  p.mt = MeshTables{tri, t_pad, cluster, sub, chunk_box, n_chunks, boxes,
                    n_boxes, group, group_end, n_groups, tri_major};
  p.mesh_type = mesh_type;
  p.gtri = gtri;
  mesh_megagrad<kSkyComputed>
      <<<n_threads / kThreads, kThreads, flat_smem_bytes(n_spheres, kMeshCamSlots),
         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The argument checks of the HDR passes: the mesh variant's, where the
// scene may have no triangles (n_chunks and n_boxes 0).
static bool hdr_args_ok(int tab_w, int n_spheres, int t_pad, int n_chunks,
                        int n_boxes, int n_groups, int n_pix, int width,
                        int height, int n_samples, int max_depth) {
  const bool no_mesh = n_chunks == 0 && n_boxes == 0 && n_groups == 0;
  return n_spheres >= 0 && n_spheres <= kMaxMeshSpheres &&
         tab_w >= n_spheres &&
         (no_mesh || mesh_args_ok(t_pad, n_chunks, n_boxes, n_groups)) &&
         t_pad < (1 << 24) && n_pix >= 0 && width >= 1 && height >= 1 &&
         n_samples >= 0 && max_depth >= 1;
}

// The parameters both HDR passes take.
static Params hdr_params(const float* cam, const float* sph, int tab_w,
                         int n_spheres, const float* tri, int t_pad,
                         const float* cluster, const float* sub,
                         const int* chunk_box, int n_chunks,
                         const float* boxes, int n_boxes, const float* group,
                         const int* group_end, int n_groups,
                         const float* tri_major, int mesh_type,
                         unsigned long long* counts, int n_pix,
                         int pix_offset, unsigned int seed,
                         unsigned int sample_base, int n_samples, int width,
                         int height, int max_depth, float t_min, int flags) {
  Params p{};
  p.cam = cam;
  p.sph = sph;
  p.counts = counts;
  p.tab_w = tab_w;
  p.n_spheres = n_spheres;
  p.n_pix = n_pix;
  p.pix_offset = pix_offset;
  p.seed = seed;
  p.sample_base = sample_base;
  p.n_samples = n_samples;
  p.width = width;
  p.height = height;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.flags = flags;
  p.mt = MeshTables{tri, t_pad, cluster, sub, chunk_box, n_chunks, boxes,
                    n_boxes, group, group_end, n_groups, tri_major};
  p.mesh_type = mesh_type;
  return p;
}

// Launches K6 on `stream`, one thread per pixel, and returns
// cudaGetLastError().  Tables as mesh_megagrad_launch's
// (n_chunks, n_boxes and n_groups may be 0: no triangles); emit
// (6 x n_samples x n_pix) receives each sample's miss direction and
// throughput, emis (3 x n_pix) each pixel's non-sky sum; counts, when not
// null, receives the bounces replayed and the triangle tests.
extern "C" int hdr_emit_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    const float* group, const int* group_end, int n_groups,
    const float* tri_major, int mesh_type, float* emit, float* emis,
    unsigned long long* counts,
    int n_pix, int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  if (!hdr_args_ok(tab_w, n_spheres, t_pad, n_chunks, n_boxes, n_groups,
                   n_pix, width, height, n_samples, max_depth))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  Params p = hdr_params(cam, sph, tab_w, n_spheres, tri, t_pad, cluster, sub,
                        chunk_box, n_chunks, boxes, n_boxes, group,
                        group_end, n_groups, tri_major, mesh_type,
                        counts, n_pix, pix_offset, seed, sample_base,
                        n_samples, width, height, max_depth, t_min, flags);
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  p.n_threads = blocks * kThreads;
  p.emit = emit;
  p.emis = emis;
  megagrad<true, kSkyEmit><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches K7 on `stream`, as mesh_megagrad_launch (n_chunks, n_boxes and
// n_groups may be 0: no triangles; n_threads from hdr_consume_threads),
// with sky_rows (3 x n_samples x n_pix) the sky value of each sample that
// missed.
extern "C" int hdr_consume_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    const float* group, const int* group_end, int n_groups,
    const float* tri_major, int mesh_type, const float* g_r,
    const float* g_g, const float* g_b,
    const float* sky_rows, float* cam_part, float* gsph, float* gtri,
    float* rec, int n_threads, unsigned long long* counts, int n_pix,
    int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  if (!hdr_args_ok(tab_w, n_spheres, t_pad, n_chunks, n_boxes, n_groups,
                   n_pix, width, height, n_samples, max_depth) ||
      n_threads < kThreads || n_threads % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  Params p = hdr_params(cam, sph, tab_w, n_spheres, tri, t_pad, cluster, sub,
                        chunk_box, n_chunks, boxes, n_boxes, group,
                        group_end, n_groups, tri_major, mesh_type,
                        counts, n_pix, pix_offset, seed, sample_base,
                        n_samples, width, height, max_depth, t_min, flags);
  p.g_r = g_r;
  p.g_g = g_g;
  p.g_b = g_b;
  p.sky_rows = sky_rows;
  p.cam_part = cam_part;
  p.gsph = gsph;
  p.gtri = gtri;
  p.rec = rec;
  p.n_threads = n_threads;
  mesh_megagrad<kSkyConsume>
      <<<n_threads / kThreads, kThreads, flat_smem_bytes(n_spheres, kMeshCamSlots),
         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

#ifdef ORT_K5_VARIANTS
// The measurement build of K5 and K7: the instances chip_smoke.py's split
// of their time launches, by index (its K5_VARIANTS names them in this
// order).  First the earlier design (a pixel per thread, the megagrad
// template's mesh instances, K5 then K7) and its timing cuts, then the
// instances of mesh_megagrad: its SIMT counts and its timing cuts.
namespace {
struct MeshVariant {
  void (*fn)(const Params);
  bool earlier;  // a pixel per thread, static shared memory
  bool cut;      // held to the blocks an SM of the kernel it is cut from
  bool consume;  // K7's sky
};
#define ORT_EARLIER(sky)                                       \
  {megagrad<true, sky, kCutNone>, true, false, sky == kSkyConsume},       \
  {megagrad<true, sky, kCutReplay>, true, true, sky == kSkyConsume},      \
  {megagrad<true, sky, kCutRecords>, true, true, sky == kSkyConsume},     \
  {megagrad<true, sky, kCutAtomics>, true, true, sky == kSkyConsume},     \
  {megagrad<true, sky, kCutTriAtomics>, true, true, sky == kSkyConsume},  \
  {megagrad<true, sky, kCutSimt>, true, true, sky == kSkyConsume}
const MeshVariant kMeshVariants[] = {
    ORT_EARLIER(kSkyComputed),
    ORT_EARLIER(kSkyConsume),
    {mesh_megagrad<kSkyComputed, kTimeSimt>, false, true, false},
    {mesh_megagrad<kSkyConsume, kTimeSimt>, false, true, true},
    {mesh_megagrad<kSkyComputed, kTimeNoAtomics>, false, true, false},
    {mesh_megagrad<kSkyComputed, kTimeNoTriAtomics>, false, true, false},
    {mesh_megagrad<kSkyComputed, kTimeReplay>, false, true, false},
};
#undef ORT_EARLIER
constexpr int kNumMeshVariants =
    sizeof(kMeshVariants) / sizeof(kMeshVariants[0]);

// The kernel that variant v is cut from or stands beside: the earlier
// design or mesh_megagrad, of its sky.
const void* mesh_base(const MeshVariant& mv) {
  if (mv.earlier)
    return mv.consume ? (const void*)megagrad<true, kSkyConsume>
                      : (const void*)megagrad<true, kSkyComputed>;
  return mv.consume ? (const void*)mesh_megagrad<kSkyConsume>
                    : (const void*)mesh_megagrad<kSkyComputed>;
}

// The dynamic shared memory of variant v: mesh_megagrad's, and for a cut
// as much more as holds it to its base kernel's blocks an SM (a cut needs
// fewer registers, and would otherwise differ in occupancy as well as in
// work); -1 when an occupancy query fails.
long long mesh_variant_smem(const MeshVariant& mv, int n_spheres) {
  size_t smem = mv.earlier ? 0 : flat_smem_bytes(n_spheres, kMeshCamSlots);
  if (!mv.cut) return (long long)smem;
  int base = 0, own = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&base, mesh_base(mv),
                                                    kThreads, smem) !=
      cudaSuccess)
    return -1;
  while (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &own, (const void*)mv.fn, kThreads, smem) == cudaSuccess &&
         own > base && smem < 48 * 1024)
    smem += 1024;
  return (long long)smem;
}
}  // namespace

// Threads variant v launches for n_pix pixels of n_samples samples: those
// of the kernel it is cut from (per pixel for the earlier design, per
// pixel sample for mesh_megagrad), or its own for an option; -1 for an
// unknown variant.
extern "C" int mesh_megagrad_variant_threads(int v, int n_pix, int n_samples,
                                             int n_spheres) {
  if (v < 0 || v >= kNumMeshVariants) return -1;
  const MeshVariant& mv = kMeshVariants[v];
  if (mv.earlier) return resident_threads(mesh_base(mv), 0, n_pix);
  return resident_threads(mv.cut ? mesh_base(mv) : (const void*)mv.fn,
                          flat_smem_bytes(n_spheres, kMeshCamSlots),
                          (long long)n_pix * n_samples);
}

// Launches variant v with hdr_consume_launch's arguments (sky_rows is read
// by K7's instances alone, and may be null for K5's; the scene's sky kind
// is in flags); counts, when not null, holds 7 counts: K5's four, and the
// SIMT instances' warp iterations of the replay, lane steps of the walk
// back and its warp iterations.
extern "C" int mesh_megagrad_variant_launch(
    int v, const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    const float* group, const int* group_end, int n_groups,
    const float* tri_major, int mesh_type, const float* g_r,
    const float* g_g, const float* g_b,
    const float* sky_rows, float* cam_part, float* gsph, float* gtri,
    float* rec, int n_threads, unsigned long long* counts, int n_pix,
    int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  if (v < 0 || v >= kNumMeshVariants ||
      !hdr_args_ok(tab_w, n_spheres, t_pad, n_chunks, n_boxes, n_groups,
                   n_pix, width, height, n_samples, max_depth) ||
      n_threads < kThreads || n_threads % kThreads != 0 ||
      (kMeshVariants[v].consume && sky_rows == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  const MeshVariant& mv = kMeshVariants[v];
  const long long smem = mesh_variant_smem(mv, n_spheres);
  if (smem < 0) return (int)cudaErrorInvalidConfiguration;
  Params p = hdr_params(cam, sph, tab_w, n_spheres, tri, t_pad, cluster, sub,
                        chunk_box, n_chunks, boxes, n_boxes, group,
                        group_end, n_groups, tri_major, mesh_type,
                        counts, n_pix, pix_offset, seed, sample_base,
                        n_samples, width, height, max_depth, t_min, flags);
  p.g_r = g_r;
  p.g_g = g_g;
  p.g_b = g_b;
  p.sky_rows = sky_rows;
  p.cam_part = cam_part;
  p.gsph = gsph;
  p.gtri = gtri;
  p.rec = rec;
  p.n_threads = n_threads;
  mv.fn<<<n_threads / kThreads, kThreads, (size_t)smem,
          (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
#endif

// Backward megakernels: the cotangents of the scene tables for an image
// cotangent, one thread per pixel.  Four instances of one body, each
// replacing an instance of opencl_ray_tracer_tpu/kernels/megagrad.py::
// _make_grad_kernel:
//
// - sphere_megagrad (K4): sphere scenes (mesh=None, hdr_mode=None).
// - mesh_megagrad (K5): spheres and one uniform-material triangle mesh in
//   gating boxes (mesh=(n_chunks, chunk, chunk_box_ids, n_boxes, m_type),
//   through _grad_tables_mesh_inner and its ladder).
// - hdr_emit (K6): the HDR backward's first pass (hdr_mode="emit", through
//   _hdr_emit_window and its ladder), on the scenes of the mesh megakernel's
//   HDR scope, with or without triangles: the mesh instance's replay alone,
//   which writes each sample's miss direction and throughput ((0, 0, 1) and
//   0 for a sample that did not miss) and each pixel's sum of the sample
//   contributions that are not sky (emitters, clamped, NaN as 0).  The
//   caller looks the texels up and rebuilds the image from these; the
//   lookup stays a torch op, as it stays an XLA op in the JAX package,
//   since the image's cotangent is a scatter over the same texels.
// - hdr_consume (K7): the second pass (hdr_mode="consume", through
//   _hdr_consume_window and its ladder): K5 with each miss's sky value read
//   from the caller's (3, n_samples, n_pix) rows instead of computed.  The
//   nearest-texel lookup is constant in the direction, so a miss seeds the
//   throughput's adjoint alone.  K6 and K7 replay with the same code, so
//   their directions agree bit for bit.  A scene without triangles runs the
//   mesh instance with no chunk and no gating box: no triangle is tested.
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
// Design, per pixel and sample:
// 1. Forward replay with the forward kernels' own device code (common.cuh,
//    and mesh.cuh's culled triangle hit for the mesh), so every discrete
//    decision is the forward's, but for the fuzz radius, which follows the
//    plain version (see common.cuh).  Each bounce that goes on stores its
//    state (origin, direction, throughput, winner code: a sphere index, or
//    n_spheres for a triangle; the mesh variant adds the hit t and the
//    triangle's plan-order id) in a global scratch buffer, one column per
//    thread of the grid, so neighbouring threads write neighbouring words.
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
// 4. Sphere cotangents are summed in shared memory per block (shared-memory
//    atomics) and flushed with one global atomicAdd per entry and block;
//    triangle cotangents go to gtri with one global atomicAdd per entry and
//    bounce.  The order of those float sums varies from run to run.  Camera
//    cotangents are summed in registers per thread, then over the warp and
//    the block in a fixed order, and each block writes its row of sums
//    (cam_part), which the wrapper adds up: they come out the same in every
//    run.  That matters where they cancel: a pinhole camera's focus-distance
//    gradient is exactly zero, and what is left of it is rounding.
//
// What bounds it: FP32 work, as the forward: the replay tests every sphere
// at every bounce (17 FLOPs a test, 4 to 6 more for a hit) and the
// triangles the culling lets through (38 FLOPs a test); the reverse costs
// 132 FLOPs for a Lambertian sphere bounce, 89 for a Lambertian triangle
// bounce and 72 more for a fuzzy-metal one (counted operation by
// operation in chip_smoke.py).  Device memory carries the tables, the
// cotangent planes and the records (40 bytes a bounce, 48 in the mesh
// variant, written once and read once, mostly from L2).  Left for later
// work: warp divergence from uneven path lengths (one thread walks a long
// path while its warp waits), shared-memory atomics that serialize when
// the lanes of a warp hit the same sphere, and the global atomics of the
// triangle cotangents (a block could stage them in shared memory where the
// mesh is small enough).

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

// Material cotangents of a sphere: the shared accumulator acc (rows of
// kMaxSpheres), column bi.
struct SphereSink {
  float* acc;
  int bi;
  __device__ __forceinline__ void add(int row, float v) {
    atomicAdd(&acc[row * kMaxSpheres + bi], v);
  }
};

// Material cotangents of a triangle, in registers until the bounce ends.
struct TriSink {
  float g[kGtriRows - GT_MAT];
  __device__ __forceinline__ void add(int row, float v) {
    g[row - G_ALR] += v;
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
// sphere bi at bounce `depth`.  On entry go, gd and gT hold the adjoints of
// the bounce's outputs (new origin = hit point, new direction, new
// throughput); on return, those of its inputs.  Sphere cotangents are added
// to the shared accumulator acc (rows of kMaxSpheres).
__device__ __forceinline__ void bounce_adjoint(
    const float* sph, int flags, float t_min, uint32_t seed, uint32_t pix,
    uint32_t sid, int depth, const float o[3], const float d[3],
    const float T[3], int bi, float go[3], float gd[3], float gT[3],
    float* acc) {
#define SPH(field) sph[(field) * kMaxSpheres + bi]
#define ACC(row, v) atomicAdd(&acc[(row) * kMaxSpheres + bi], (v))
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
  SphereSink sink{acc, bi};
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
// intersection's.  The cotangents of n, c and the triangle's material go to
// column j of gtri (rows of t_pad).
__device__ __forceinline__ void tri_adjoint(
    const MeshTables& mt, const float* cam, int mesh_type, float* gtri,
    int flags, uint32_t seed, uint32_t pix, uint32_t sid, int depth,
    const float o[3], const float d[3], const float T[3], int j, float t_rec,
    float go[3], float gd[3], float gT[3]) {
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
  TriSink sink{{0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
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
  atomicAdd(&gtri[(GT_N + 0) * tp + j], gnr[0]);
  atomicAdd(&gtri[(GT_N + 1) * tp + j], gnr[1]);
  atomicAdd(&gtri[(GT_N + 2) * tp + j], gnr[2]);
  atomicAdd(&gtri[GT_C * tp + j], gq);
  for (int r = 0; r < kGtriRows - GT_MAT; ++r)
    if (sink.g[r] != 0.f) atomicAdd(&gtri[(GT_MAT + r) * tp + j], sink.g[r]);
}

template <bool kMesh, int kSky>
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
        if constexpr (!kEmit) {
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
          for (int k = 0; k < 3; ++k)
            atomicAdd(&p.gtri[(GT_MAT + k) * p.mt.t_pad + win],
                      gcv[k] * T[k]);
        } else {
          for (int k = 0; k < 3; ++k)
            atomicAdd(&s_acc[(G_ALR + k) * kMaxSpheres + win],
                      gcv[k] * T[k]);
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
        const float* r = rec + (size_t)k * kR * rs;
        const float ok[3] = {r[R_OX * rs], r[R_OY * rs], r[R_OZ * rs]};
        const float dk[3] = {r[R_DX * rs], r[R_DY * rs], r[R_DZ * rs]};
        const float tk[3] = {r[R_TR * rs], r[R_TG * rs], r[R_TB * rs]};
        const int code = (int)r[R_WIN * rs];
        if constexpr (kMesh) {
          if (code == n) {
            ++n_reverse_tri;
            tri_adjoint(p.mt, s_cam, p.mesh_type, p.gtri, flags, p.seed, pix,
                        sid, k, ok, dk, tk, (int)r[R_TID * rs], r[R_T * rs],
                        go, gd, gT);
            continue;
          }
        }
        bounce_adjoint(s_sph, flags, p.t_min, p.seed, pix, sid, k, ok, dk, tk,
                       code, go, gd, gT, s_acc);
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

// Threads a variant launches for n_pix pixels on the current device: at
// most as many as can be resident at once, so that the record buffer
// (n_threads * max_depth * record floats) stays small.
template <bool kMesh, int kSky>
int threads_for(int n_pix) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, megagrad<kMesh, kSky>, kThreads, 0) != cudaSuccess)
    return -1;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  return (blocks < cap ? blocks : cap) * kThreads;
}

}  // namespace

extern "C" int sphere_megagrad_threads(int n_pix) {
  return threads_for<false, kSkyComputed>(n_pix);
}

extern "C" int mesh_megagrad_threads(int n_pix) {
  return threads_for<true, kSkyComputed>(n_pix);
}

extern "C" int hdr_consume_threads(int n_pix) {
  return threads_for<true, kSkyConsume>(n_pix);
}

// Launches the sphere variant on `stream` and returns cudaGetLastError():
// nonzero when the launch was refused.  g_*: (n_pix,) cotangent planes;
// cam_part (n_threads / 128 x 22) receives each block's camera cotangents
// (left as it is when n_pix or n_samples is 0); gsph (16 x tab_w) is added
// to; rec: n_threads * max_depth * 10 floats of scratch; counts, when not
// null, receives the bounces replayed and the bounces walked back.
extern "C" int sphere_megagrad_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* g_r, const float* g_g, const float* g_b, float* cam_part,
    float* gsph, float* rec, int n_threads, unsigned long long* counts,
    int n_pix, int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || tab_w < n_spheres ||
      n_pix < 0 || width < 1 || height < 1 || n_samples < 0 ||
      max_depth < 1 || n_threads < kThreads || n_threads % kThreads != 0)
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
  megagrad<false, kSkyComputed><<<n_threads / kThreads, kThreads, 0,
                                  (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches the mesh variant on `stream`, as sphere_megagrad_launch, with
// the mesh tables of the mesh megakernel (tri, cluster, sub, chunk_box,
// boxes), the mesh's material type, and gtri (10 x t_pad, added to);
// n_spheres may be 0; rec holds n_threads * max_depth * 12 floats; counts,
// when not null, receives the bounces replayed, the bounces walked back
// (sphere and triangle bounces, without the sphere variant's one more per
// sample), the triangle tests of the replay and the triangle bounces
// walked back.
extern "C" int mesh_megagrad_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    int mesh_type, const float* g_r, const float* g_g, const float* g_b,
    float* cam_part, float* gsph, float* gtri, float* rec, int n_threads,
    unsigned long long* counts, int n_pix, int pix_offset, unsigned int seed,
    unsigned int sample_base, int n_samples, int width, int height,
    int max_depth, float t_min, int flags, void* stream) {
  if (n_spheres < 0 || n_spheres > kMaxMeshSpheres || tab_w < n_spheres ||
      n_chunks < 1 || t_pad < n_chunks * kChunk || t_pad >= (1 << 24) ||
      n_boxes < 1 || n_pix < 0 || width < 1 || height < 1 ||
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
                    n_boxes};
  p.mesh_type = mesh_type;
  p.gtri = gtri;
  megagrad<true, kSkyComputed><<<n_threads / kThreads, kThreads, 0,
                                 (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The argument checks of the HDR passes: the mesh variant's, where the
// scene may have no triangles (n_chunks and n_boxes 0).
static bool hdr_args_ok(int tab_w, int n_spheres, int t_pad, int n_chunks,
                        int n_boxes, int n_pix, int width, int height,
                        int n_samples, int max_depth) {
  const bool no_mesh = n_chunks == 0 && n_boxes == 0;
  return n_spheres >= 0 && n_spheres <= kMaxMeshSpheres &&
         tab_w >= n_spheres &&
         (no_mesh || (n_chunks >= 1 && t_pad >= n_chunks * kChunk &&
                      n_boxes >= 1)) &&
         t_pad < (1 << 24) && n_pix >= 0 && width >= 1 && height >= 1 &&
         n_samples >= 0 && max_depth >= 1;
}

// The parameters both HDR passes take.
static Params hdr_params(const float* cam, const float* sph, int tab_w,
                         int n_spheres, const float* tri, int t_pad,
                         const float* cluster, const float* sub,
                         const int* chunk_box, int n_chunks,
                         const float* boxes, int n_boxes, int mesh_type,
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
                    n_boxes};
  p.mesh_type = mesh_type;
  return p;
}

// Launches K6 on `stream`, one thread per pixel, and returns
// cudaGetLastError().  Tables as mesh_megagrad_launch's (n_chunks and
// n_boxes may be 0: no triangles); emit (6 x n_samples x n_pix) receives
// each sample's miss direction and throughput, emis (3 x n_pix) each
// pixel's non-sky sum; counts, when not null, receives the bounces replayed
// and the triangle tests.
extern "C" int hdr_emit_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    int mesh_type, float* emit, float* emis, unsigned long long* counts,
    int n_pix, int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  if (!hdr_args_ok(tab_w, n_spheres, t_pad, n_chunks, n_boxes, n_pix, width,
                   height, n_samples, max_depth))
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  Params p = hdr_params(cam, sph, tab_w, n_spheres, tri, t_pad, cluster, sub,
                        chunk_box, n_chunks, boxes, n_boxes, mesh_type,
                        counts, n_pix, pix_offset, seed, sample_base,
                        n_samples, width, height, max_depth, t_min, flags);
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  p.n_threads = blocks * kThreads;
  p.emit = emit;
  p.emis = emis;
  megagrad<true, kSkyEmit><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches K7 on `stream`, as mesh_megagrad_launch (n_chunks and n_boxes
// may be 0: no triangles), with sky_rows (3 x n_samples x n_pix) the sky
// value of each sample that missed.
extern "C" int hdr_consume_launch(
    const float* cam, const float* sph, int tab_w, int n_spheres,
    const float* tri, int t_pad, const float* cluster, const float* sub,
    const int* chunk_box, int n_chunks, const float* boxes, int n_boxes,
    int mesh_type, const float* g_r, const float* g_g, const float* g_b,
    const float* sky_rows, float* cam_part, float* gsph, float* gtri,
    float* rec, int n_threads, unsigned long long* counts, int n_pix,
    int pix_offset, unsigned int seed, unsigned int sample_base,
    int n_samples, int width, int height, int max_depth, float t_min,
    int flags, void* stream) {
  if (!hdr_args_ok(tab_w, n_spheres, t_pad, n_chunks, n_boxes, n_pix, width,
                   height, n_samples, max_depth) ||
      n_threads < kThreads || n_threads % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || n_samples == 0) return 0;
  Params p = hdr_params(cam, sph, tab_w, n_spheres, tri, t_pad, cluster, sub,
                        chunk_box, n_chunks, boxes, n_boxes, mesh_type,
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
  megagrad<true, kSkyConsume><<<n_threads / kThreads, kThreads, 0,
                                (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

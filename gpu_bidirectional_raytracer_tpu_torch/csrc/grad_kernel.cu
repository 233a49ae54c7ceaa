// Adjoint of the eye-path kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernels gpu_bidirectional_raytracer_tpu/ops/
// pallas_grad.py::_bwd_kernel (entry point grad_kernel_launch: radiance
// cotangent in, gradients out; the backward of trace_pallas_diff) and
// ::_fused_kernel (entry point fused_kernel_launch: targets in, the l2 or
// log loss and its gradients out; trace_pallas_loss_grad). Both are one
// kernel template; kFused selects the second, and kVis adds the branch of
// the visibility carrier (vis_tau > 0; the TPU kernels' vis branch). Each
// entry point launches the kVis instantiation when its vis_tau is
// positive, and the carrier-off one, which compiles to the code without
// the branch, otherwise.
//
// What it differentiates is the port's own forward, integrators/
// path_tracer.py::trace as autograd sees it: hit ids, material and emitter
// masks, facing tests, occlusion and the Fresnel branch are detached; the
// hit distance is differentiable through the root of the hit sphere (its
// sqrt has no derivative below the 1e-6 tangency clamp); normalisation is
// v * 1 / (|v| + eps) as core/vecmath.norm writes it.
//
// Per thread:
// - a forward sweep runs tracer.cuh's eye_step, the code of the eye-path
//   kernel, and saves each depth's entry state (origin, direction,
//   throughput, specular flag), the hit sphere and the detached shadow
//   facts: one bit per light slot and VPL slot whose sample reached the
//   vertex. The fused kernel then forms its cotangent from the radiance:
//   2 (rad - t) / (3n) for l2, 2 (log1p rad - t) / (1 + rad) / (3n) for
//   log (targets come in log1p'd);
// - a reverse sweep over the depths carries the adjoints of origin,
//   direction and throughput back through the emitter term, next-event
//   estimation and the VPL gather, the diffuse / mirror / glass scatter, and
//   the hit-point, normal and root chain. What is left at depth 0 is the
//   gradient of the ray.
//
// Scene and VPL gradients are deterministic: no float atomics. The reverse
// sweep runs the warp in lockstep over depths and slots; each light slot
// and VPL slot is one table row for the whole warp, summed by a fixed
// butterfly of shuffles, and the hit sphere's row is summed per distinct
// sphere id the same way. Lane 0 adds each sum to its warp's table in
// shared memory; at the end the block adds its warps' tables in warp order
// into its partial [S, 16] and [V, 16] rows, and the wrapper sums the
// partials over blocks (torch.sum). Two launches on the same inputs give
// the same bits.
//
// The visibility carrier (integrators/direct.py::_vis_carrier): the
// forward is unchanged (its value is 0), and the reverse sweep adds, for
// every light and VPL slot of a diffuse vertex whose sample faces it (lit
// or occluded), the adjoint of stop(contrib) * soft, where soft =
// prod_s (1 - edge_s endp_s gate_s) over the candidate blockers
// (intersect.py::soft_visibility): a first pass over the blockers forms
// the product, a second one runs each blocker's adjoint with the guarded
// leave-one-out factor soft / (1 - blocked_s). The blocker's p and rad
// gradients go to a per-thread accumulator (one row of 4 floats per
// sphere, local memory, at most kVisSpheres rows), summed over the warp
// once, in sphere order, after the reverse sweep; the segment's direction
// and length adjoints go through the sample's segment into the hit point
// and the light or VPL row.
//
// Bound: FP32 ALU, as the eye-path kernel: the forward sweep is that
// kernel's work, and the reverse sweep adds per hit segment the adjoint of
// one root and the shading, per cast shadow sample the adjoint of its
// set-up (no new sphere scans: occlusion is saved), and per vertex the
// scatter's adjoint. The saved state lives in local memory (about 1 KB per
// thread); memory traffic proper is the rays, the cotangent or targets, the
// ray gradients and the per-block partials.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/_build.py; each launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

using namespace tracer;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxDepth = 16;   // ops/pallas_grad.py MAX_DEPTH
constexpr int kLitWords = 4;    // 128 shadow slots (MAX_SHADOW_SLOTS)
constexpr int kVisSpheres = 64;  // blocker rows of the carrier (SPHERE_LIMIT)
constexpr float kEndpointFrac = 0.25f;  // intersect.ENDPOINT_TAU_FRACTION
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* scene;     // [S, 16]
  const float* vpl;       // [V, 16]
  const uint32_t* keys;   // [K, 4] site keys; then light ids
  const float* tape;      // [K, n] streamed tape, or null (mix32 keys)
  const float* rays_o;    // [n, 3]
  const float* rays_d;    // [n, 3]
  const float* cot;       // [n, 3] radiance cotangent (grad mode)
  const float* target;    // [n, 3] targets (fused mode)
  float* dscene;          // [blocks, S, 16] partial gradients
  float* dvpl;            // [blocks, max(V, 1), 16]
  float* drays_o;         // [n, 3] or null
  float* drays_d;         // [n, 3] or null
  float* loss_part;       // [blocks] (fused mode)
  float* rad_out;         // [n, 3] or null (fused mode)
  int n_spheres, n_vpl, n_rows, n, max_depth, n_lights, n_light_slots;
  int combine_half, loss_kind;
  uint32_t lane_offset, lane_total;
  float emission_scale, light_gain, inv3n;
  float vis_tau;          // > 0: the visibility carrier (kVis)
};

// One depth's entry state and detached facts.
struct Saved {
  float o[3], d[3], tp[3];
  int hit, code, specular;
  uint32_t lit[kLitWords];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Adds the warp's sum of g[0..kCount) to columns 0..kCount of `row` (lane 0
// writes). Every lane of the warp calls it.
template <int kCount>
__device__ __forceinline__ void flush_row(float* row, const float* g) {
#pragma unroll
  for (int i = 0; i < kCount; ++i) {
    const float x = warp_sum(g[i]);
    if ((threadIdx.x & 31) == 0) row[i] += x;
  }
}

// The same for rows that differ by lane: one pass per distinct `id` among
// the lanes with `act`, in the order of their lowest lane.
template <int kCount>
__device__ __forceinline__ void flush_by_id(float* tab, bool act, int id,
                                            const float* g) {
  unsigned pending = __ballot_sync(kFull, act);
  while (pending != 0u) {
    const int leader = __ffs(pending) - 1;
    const int sid = __shfl_sync(kFull, id, leader);
    const bool mine = act && id == sid;
    float mg[kCount];
#pragma unroll
    for (int i = 0; i < kCount; ++i) mg[i] = mine ? g[i] : 0.0f;
    flush_row<kCount>(tab + sid * kCols, mg);
    pending &= ~__ballot_sync(kFull, mine);
  }
}

__device__ __forceinline__ bool lit_bit(const uint32_t* lit, int j) {
  return (lit[j >> 5] >> (j & 31)) & 1u;
}

// Adjoint of n = v * 1 / (|v| + eps) (core/vecmath.norm): adds b_v to bv.
// The derivative of |v| is taken as zero at v = 0.
__device__ __forceinline__ void normalize_adj(const float* v, float eps,
                                              const float* bn, float* bv) {
  const float q = dot3(v[0], v[1], v[2], v[0], v[1], v[2]);
  const float len = sqrtf(q);
  const float inv = 1.0f / (len + eps);
  const float binv = dot3(bn[0], bn[1], bn[2], v[0], v[1], v[2]);
  const float blen = -binv * inv * inv;
  const float bq = q > 0.0f ? blen * 0.5f / len : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) bv[i] += bn[i] * inv + 2.0f * v[i] * bq;
}

// Adjoint of `segment` from h to q, given the adjoints of its unit
// direction (bs_dir) and of its length (blen): adds b(q - h) to bqh.
__device__ __forceinline__ void segment_adj(const float* q, const float* h,
                                            const float* bs_dir, float blen,
                                            float* bqh) {
  const float sx = q[0] - h[0], sy = q[1] - h[1], sz = q[2] - h[2];
  const float len_sq = dot3(sx, sy, sz, sx, sy, sz);
  const float len = len_sq > 0.0f ? sqrtf(len_sq) : 0.0f;
  const float m = fmaxf(len, kTiny);
  const float bm = -dot3(bs_dir[0], bs_dir[1], bs_dir[2], sx, sy, sz) /
                   (m * m);
  if (len >= kTiny) blen += bm;
  const float bq = len_sq > 0.0f ? blen * 0.5f / len : 0.0f;
  bqh[0] += bs_dir[0] / m + 2.0f * sx * bq;
  bqh[1] += bs_dir[1] / m + 2.0f * sy * bq;
  bqh[2] += bs_dir[2] / m + 2.0f * sz * bq;
}

// The shaded vertex of one depth, recomputed from the saved state.
struct Vertex {
  const float* hs;              // hit sphere row
  float o[3], d[3], tp[3];
  float op[3], b, det, sq, t;   // the root
  bool use1;                    // the smaller root was taken
  float h[3], v[3], n[3], nl[3], dp, flip;
};

__device__ __forceinline__ void vertex(const Tables& T, const Saved& sv,
                                       Vertex& x) {
  x.hs = T.scene + sv.hit * kCols;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x.o[i] = sv.o[i];
    x.d[i] = sv.d[i];
    x.tp[i] = sv.tp[i];
  }
  // sphere_t's expressions, keeping what the adjoint needs.
  x.op[0] = x.hs[1] - x.o[0];
  x.op[1] = x.hs[2] - x.o[1];
  x.op[2] = x.hs[3] - x.o[2];
  x.b = dot3(x.op[0], x.op[1], x.op[2], x.d[0], x.d[1], x.d[2]);
  const float opop = dot3(x.op[0], x.op[1], x.op[2], x.op[0], x.op[1],
                          x.op[2]);
  x.det = x.b * x.b - opop + x.hs[0] * x.hs[0];
  x.sq = sqrtf(fmaxf(x.det, kDetClamp));
  const float t1 = x.b - x.sq;
  x.use1 = t1 > kEps;
  x.t = x.use1 ? t1 : x.b + x.sq;
  // eye_step's hit shading.
#pragma unroll
  for (int i = 0; i < 3; ++i) x.h[i] = x.o[i] + x.t * x.d[i];
  x.v[0] = x.h[0] - x.hs[1];
  x.v[1] = x.h[1] - x.hs[2];
  x.v[2] = x.h[2] - x.hs[3];
  x.n[0] = x.v[0];
  x.n[1] = x.v[1];
  x.n[2] = x.v[2];
  normalize(x.n[0], x.n[1], x.n[2], 1e-20f);
  x.dp = dot3(x.n[0], x.n[1], x.n[2], x.d[0], x.d[1], x.d[2]);
  x.flip = x.dp > 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) x.nl[i] = x.flip * x.n[i];
}

// Adjoint of the mirror direction d - 2 (n.d) n.
__device__ __forceinline__ void mirror_adj(const Vertex& x, const float* bnd,
                                           float* bd, float* bn) {
  const float k2 = 2.0f * dot3(x.n[0], x.n[1], x.n[2], x.d[0], x.d[1],
                               x.d[2]);
  const float bk2 = -dot3(bnd[0], bnd[1], bnd[2], x.n[0], x.n[1], x.n[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bd[i] += bnd[i] + 2.0f * bk2 * x.n[i];
    bn[i] += -k2 * bnd[i] + 2.0f * bk2 * x.d[i];
  }
}

// The scatter of one depth: recomputes eye_step's forward, returns the
// throughput multiplier `mul`, and adds the adjoints of d, n and nl for
// the adjoint bnd of the new direction and btp of the new throughput
// tp * (c * mul).
__device__ __forceinline__ float scatter_adj(const Tables& T, int row0,
                                             uint32_t gl, const Vertex& x,
                                             const float* bnd,
                                             const float* btp, float* bd,
                                             float* bn, float* bnl) {
  const float refl = x.hs[10];
  const int L = T.n_light_slots;
  if (refl == 0.0f) {  // diffuse: cosine lobe about nl
    const float u1 = tape(T, row0 + 2 * L, gl);
    const float u2 = tape(T, row0 + 2 * L + 1, gl);
    const float* nl = x.nl;
    const bool big_x = fabsf(nl[0]) > 0.1f;
    const float a[3] = {big_x ? 0.0f : 1.0f, big_x ? 1.0f : 0.0f, 0.0f};
    const float c[3] = {a[1] * nl[2] - a[2] * nl[1],
                        a[2] * nl[0] - a[0] * nl[2],
                        a[0] * nl[1] - a[1] * nl[0]};
    float u[3] = {c[0], c[1], c[2]};
    normalize(u[0], u[1], u[2], 0.0f);
    const float r1 = kTwoPi * u1;
    const float r2s = sqrtf(u2);
    const float cw = cosf(r1) * r2s;
    const float sw = sinf(r1) * r2s;
    const float wz = sqrtf(1.0f - u2);
    float bu[3], bv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      bu[i] = cw * bnd[i];
      bv[i] = sw * bnd[i];
      bnl[i] += wz * bnd[i];
    }
    // v = nl x u
    bnl[0] += u[1] * bv[2] - u[2] * bv[1];
    bnl[1] += u[2] * bv[0] - u[0] * bv[2];
    bnl[2] += u[0] * bv[1] - u[1] * bv[0];
    bu[0] += bv[1] * nl[2] - bv[2] * nl[1];
    bu[1] += bv[2] * nl[0] - bv[0] * nl[2];
    bu[2] += bv[0] * nl[1] - bv[1] * nl[0];
    // u = norm(c), c = a x nl
    float bc[3] = {0.0f, 0.0f, 0.0f};
    normalize_adj(c, 0.0f, bu, bc);
    bnl[0] += bc[1] * a[2] - bc[2] * a[1];
    bnl[1] += bc[2] * a[0] - bc[0] * a[2];
    bnl[2] += bc[0] * a[1] - bc[1] * a[0];
    return 1.0f;
  }
  if (refl == 1.0f) {
    mirror_adj(x, bnd, bd, bn);
    return 1.0f;
  }
  // Glass: Fresnel dielectric with Russian roulette.
  const float* n = x.n;
  const float* nl = x.nl;
  const float* d = x.d;
  const bool into = dot3(n[0], n[1], n[2], nl[0], nl[1], nl[2]) > 0.0f;
  const float nnt = into ? (1.0f / 1.5f) : 1.5f;
  const float ddn = dot3(d[0], d[1], d[2], nl[0], nl[1], nl[2]);
  const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
  if (!(cos2t >= 0.0f)) {  // total internal reflection: a mirror
    mirror_adj(x, bnd, bd, bn);
    return 1.0f;
  }
  const float sq = cos2t > 0.0f ? sqrtf(cos2t) : 0.0f;
  const float sgn = into ? 1.0f : -1.0f;
  const float kk = sgn * (ddn * nnt + sq);
  const float traw[3] = {nnt * d[0] - kk * n[0], nnt * d[1] - kk * n[1],
                         nnt * d[2] - kk * n[2]};
  float td[3] = {traw[0], traw[1], traw[2]};
  normalize(td[0], td[1], td[2], 0.0f);
  const float c1 = 1.0f - (into ? -ddn : dot3(td[0], td[1], td[2], n[0],
                                              n[1], n[2]));
  const float c2 = c1 * c1;
  const float re = 0.04f + 0.96f * (c1 * (c2 * c2));
  const float pr = 0.25f + 0.5f * re;
  const float urr = tape(T, row0 + 2 * L + 2, gl);
  const bool reflect = urr < pr;
  const float* c = x.hs + 7;
  const float bmul = btp[0] * x.tp[0] * c[0] + btp[1] * x.tp[1] * c[1] +
                     btp[2] * x.tp[2] * c[2];
  float mul, bre, bpr;
  float btd[3] = {0.0f, 0.0f, 0.0f};
  if (reflect) {
    mul = re / pr;
    bre = bmul / pr;
    bpr = -bmul * re / (pr * pr);
    mirror_adj(x, bnd, bd, bn);
  } else {
    const float omp = 1.0f - pr;
    mul = (1.0f - re) / omp;
    bre = -bmul / omp;
    bpr = bmul * (1.0f - re) / (omp * omp);
    btd[0] = bnd[0];
    btd[1] = bnd[1];
    btd[2] = bnd[2];
  }
  bre += 0.5f * bpr;
  // re = r0 + 0.96 (c1 (c2 c2)), c2 = c1 c1
  const float bx = 0.96f * bre;
  const float bw = bx * c1;
  float bc1 = bx * (c2 * c2) + 2.0f * c1 * (2.0f * c2 * bw);
  float bddn = 0.0f;
  if (into) {
    bddn += bc1;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      btd[i] -= bc1 * n[i];
      bn[i] -= bc1 * td[i];
    }
  }
  float btraw[3] = {0.0f, 0.0f, 0.0f};
  normalize_adj(traw, 0.0f, btd, btraw);
  const float bkk = -dot3(btraw[0], btraw[1], btraw[2], n[0], n[1], n[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bd[i] += nnt * btraw[i];
    bn[i] -= kk * btraw[i];
  }
  bddn += sgn * nnt * bkk;
  const float bsq = sgn * bkk;
  const float bcos2t = cos2t > 0.0f ? bsq * 0.5f / sq : 0.0f;
  bddn += bcos2t * (nnt * nnt) * 2.0f * ddn;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bd[i] += bddn * nl[i];
    bnl[i] += bddn * d[i];
  }
  return mul;
}

// One light slot at a diffuse vertex whose sample reached it: adds its
// contribution to ld, the adjoints of h and nl for the adjoint bdir of
// the direct-light sum, and writes the light row's gradient g = (rad,
// p(3), e(3)).
__device__ __forceinline__ void light_adj(const Tables& T, int row0,
                                          int slot, uint32_t gl,
                                          const Vertex& x, const float* bdir,
                                          float* ld, float* bh, float* bnl,
                                          float* g) {
  const float* ls = T.scene + T.lights[slot] * kCols;
  float u[3];
  light_dir(T, row0, slot, gl, u[0], u[1], u[2]);
  const float lrad = ls[0];
  const float q[3] = {ls[1] + lrad * u[0], ls[2] + lrad * u[1],
                      ls[3] + lrad * u[2]};
  float s[3], len;
  segment(q[0], q[1], q[2], x.h[0], x.h[1], x.h[2], s[0], s[1], s[2], len);
  const float wo = -dot3(s[0], s[1], s[2], u[0], u[1], u[2]);
  const float wi = dot3(s[0], s[1], s[2], x.nl[0], x.nl[1], x.nl[2]);
  const float len2 = len * len;
  const float big_q = fmaxf(len2, kTiny);
  const float a = kFourPi * lrad * lrad;
  const float num = a * wi * wo;
  const float gs = T.light_gain * (num / big_q);
  const float* e = ls + 4;
  ld[0] = ld[0] + e[0] * gs;
  ld[1] = ld[1] + e[1] * gs;
  ld[2] = ld[2] + e[2] * gs;

  g[4] = bdir[0] * gs;
  g[5] = bdir[1] * gs;
  g[6] = bdir[2] * gs;
  const float bscale =
      T.light_gain * dot3(bdir[0], bdir[1], bdir[2], e[0], e[1], e[2]);
  const float bnum = bscale / big_q;
  const float bq2 = -bscale * num / (big_q * big_q);
  float blen = len2 >= kTiny ? bq2 * 2.0f * len : 0.0f;
  const float bawi = bnum * wo;
  const float bwo = bnum * (a * wi);
  const float ba = bawi * wi;
  const float bwi = bawi * a;
  float blrad = ba * lrad * kFourPi + ba * (kFourPi * lrad);
  float bs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bs[i] = -bwo * u[i] + bwi * x.nl[i];
    bnl[i] += bwi * s[i];
  }
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(q, x.h, bs, blen, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) bh[i] -= bqh[i];
  blrad += dot3(bqh[0], bqh[1], bqh[2], u[0], u[1], u[2]);
  g[0] = blrad;
  g[1] = bqh[0];
  g[2] = bqh[1];
  g[3] = bqh[2];
}

// One VPL slot that reached the vertex: adds w * rad to vsum, the adjoints
// of h and nl for the adjoint bv of the VPL sum, and writes the VPL row's
// gradient g = (hp(3), rad(3), nl(3)).
__device__ __forceinline__ void vpl_adj(const Tables& T, int v,
                                        const Vertex& x, const float* bv,
                                        float* vsum, float* bh, float* bnl,
                                        float* g) {
  const float* vp = T.vpl + v * kCols;
  float s[3], len;
  segment(vp[0], vp[1], vp[2], x.h[0], x.h[1], x.h[2], s[0], s[1], s[2],
          len);
  const float wo = -dot3(s[0], s[1], s[2], vp[6], vp[7], vp[8]);
  const float wi = dot3(s[0], s[1], s[2], x.nl[0], x.nl[1], x.nl[2]);
  const float w = wi * wo;
  vsum[0] = vsum[0] + vp[3] * w;
  vsum[1] = vsum[1] + vp[4] * w;
  vsum[2] = vsum[2] + vp[5] * w;

  const float bw = dot3(bv[0], bv[1], bv[2], vp[3], vp[4], vp[5]);
  const float bwi = bw * wo;
  const float bwo = bw * wi;
  float bs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[3 + i] = bv[i] * w;
    g[6 + i] = -bwo * s[i];
    bs[i] = -bwo * vp[6 + i] + bwi * x.nl[i];
    bnl[i] += bwi * s[i];
  }
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(vp, x.h, bs, 0.0f, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] = bqh[i];
    bh[i] -= bqh[i];
  }
}

// One blocker's terms of soft_visibility for the segment from h along
// the unit sd up to maxt: the silhouette sigmoid of width max(tau r,
// 1e-6), the far-endpoint sigmoid of width we, and the hard near gate.
struct Blocker {
  float op[3], b, det, width, edge, endp, blocked;
};

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ void blocker(const float* sp, const float* h,
                                        const float* sd, float maxt,
                                        float tau, float we, Blocker& k) {
  k.op[0] = sp[1] - h[0];
  k.op[1] = sp[2] - h[1];
  k.op[2] = sp[3] - h[2];
  k.b = dot3(k.op[0], k.op[1], k.op[2], sd[0], sd[1], sd[2]);
  const float opop = dot3(k.op[0], k.op[1], k.op[2], k.op[0], k.op[1],
                          k.op[2]);
  k.det = k.b * k.b - opop + sp[0] * sp[0];
  k.width = fmaxf(tau * sp[0], 1e-6f);
  k.edge = sigmoid(k.det / k.width);
  const float t1 = k.b - sqrtf(fmaxf(k.det, kDetClamp));
  k.endp = sigmoid((maxt - t1) / we);
  k.blocked = k.b > kEps ? k.edge * k.endp : 0.0f;
}

// The carrier of one shadow segment: soft over the spheres that `skip`
// does not leave out, then the adjoint of bsoft * soft. Adds the blocker
// rows' (rad, p) gradients to acc, the hit point's to bh, and the
// segment's direction and length adjoints to bsd and blen.
template <typename Skip>
__device__ __forceinline__ void soft_adj(const Tables& T, const float* h,
                                         const float* sd, float maxt,
                                         float bsoft, float tau, Skip skip,
                                         float* acc, float* bh, float* bsd,
                                         float& blen) {
  const float we = fmaxf(kEndpointFrac * tau, 1e-6f);
  float soft = 1.0f;
#pragma unroll 1
  for (int s = 0; s < T.n_spheres; ++s) {
    const float* sp = T.scene + s * kCols;
    if (skip(s, sp)) continue;
    Blocker k;
    blocker(sp, h, sd, maxt, tau, we, k);
    soft = soft * (1.0f - k.blocked);
  }
#pragma unroll 1
  for (int s = 0; s < T.n_spheres; ++s) {
    const float* sp = T.scene + s * kCols;
    if (skip(s, sp)) continue;
    Blocker k;
    blocker(sp, h, sd, maxt, tau, we, k);
    if (!(k.b > kEps)) continue;   // the hard gate: no gradient
    const float denom = 1.0f - k.blocked;
    const float bblocked = denom > 1e-6f ? -bsoft * (soft / denom) : 0.0f;
    const float dsq = k.det >= kDetClamp
                          ? 0.5f / sqrtf(k.det) : 0.0f;
    const float gd = k.endp * (1.0f - k.endp) / we;
    // blocked = edge(det) * endp((maxt - b + sqrt(det)) / we)
    const float bdet = bblocked * (k.edge * (1.0f - k.edge) / k.width *
                                   k.endp + k.edge * gd * dsq);
    const float bz = bblocked * k.edge * gd;
    blen += bz;
    // det = b^2 - op.op + r^2, b = op.sd, op = p - h
    const float bb = 2.0f * k.b * bdet - bz;
    float* row = acc + 4 * s;
    row[0] += 2.0f * sp[0] * bdet;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float bop = bb * sd[i] - 2.0f * k.op[i] * bdet;
      row[1 + i] += bop;
      bh[i] -= bop;
      bsd[i] += bb * k.op[i];
    }
  }
}

// The carrier of light slot `slot` at a diffuse vertex: with its sample
// facing the vertex, adds the adjoints of h to bh and of the light row's
// (rad, p(3)) to g, and the blockers' to acc; the target light is left
// out of its own soft product.
__device__ __forceinline__ void light_vis_adj(const Tables& T, int row0,
                                              int slot, uint32_t gl,
                                              const Vertex& x,
                                              const float* bdir, float tau,
                                              float* acc, float* bh,
                                              float* g) {
  const int target = T.lights[slot];
  const float* ls = T.scene + target * kCols;
  float u[3];
  light_dir(T, row0, slot, gl, u[0], u[1], u[2]);
  const float lrad = ls[0];
  const float q[3] = {ls[1] + lrad * u[0], ls[2] + lrad * u[1],
                      ls[3] + lrad * u[2]};
  float sd[3], len;
  segment(q[0], q[1], q[2], x.h[0], x.h[1], x.h[2], sd[0], sd[1], sd[2],
          len);
  float wo = dot3(sd[0], sd[1], sd[2], u[0], u[1], u[2]);
  const bool facing = wo <= 0.0f;
  wo = -wo;
  const float wi = dot3(sd[0], sd[1], sd[2], x.nl[0], x.nl[1], x.nl[2]);
  if (!(facing && wi > 0.0f)) return;
  const float scale = kFourPi * lrad * lrad * wi * wo /
                      fmaxf(len * len, kTiny);
  const float bsoft = dot3(bdir[0], bdir[1], bdir[2], ls[4], ls[5], ls[6]) *
                      (T.light_gain * scale);
  float bsd[3] = {0.0f, 0.0f, 0.0f}, blen = 0.0f;
  soft_adj(T, x.h, sd, len - kEps, bsoft, tau,
           [target](int s, const float*) { return s == target; }, acc, bh,
           bsd, blen);
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(q, x.h, bsd, blen, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bh[i] -= bqh[i];
    g[1 + i] += bqh[i];
  }
  g[0] += dot3(bqh[0], bqh[1], bqh[2], u[0], u[1], u[2]);
}

// The carrier of VPL slot v (vacuum: emitters never block; the VPL's host
// sphere, column 10, is left out): adds the adjoints of h to bh, of the
// VPL's hp to g[0..3), and the blockers' to acc.
__device__ __forceinline__ void vpl_vis_adj(const Tables& T, int v,
                                            const Vertex& x, const float* bv,
                                            float tau, float* acc, float* bh,
                                            float* g) {
  const float* vp = T.vpl + v * kCols;
  if (!(vp[9] > 0.5f)) return;
  float sd[3], len;
  segment(vp[0], vp[1], vp[2], x.h[0], x.h[1], x.h[2], sd[0], sd[1], sd[2],
          len);
  float wo = dot3(sd[0], sd[1], sd[2], vp[6], vp[7], vp[8]);
  const bool facing = wo <= 0.0f;
  wo = -wo;
  const float wi = dot3(sd[0], sd[1], sd[2], x.nl[0], x.nl[1], x.nl[2]);
  if (!(facing && wi > 0.0f)) return;
  const float bsoft = dot3(bv[0], bv[1], bv[2], vp[3], vp[4], vp[5]) *
                      (wi * wo);
  const float host = vp[10];
  float bsd[3] = {0.0f, 0.0f, 0.0f}, blen = 0.0f;
  soft_adj(T, x.h, sd, len - kEps, bsoft, tau,
           [host](int s, const float* sp) {
             return emissive(sp) || static_cast<float>(s) == host;
           },
           acc, bh, bsd, blen);
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(vp, x.h, bsd, blen, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] += bqh[i];
    bh[i] -= bqh[i];
  }
}

template <bool kFused, bool kVis>
__global__ void __launch_bounds__(kBlock) grad_kernel(Params p) {
  extern __shared__ float smem[];
  const int rows = p.n_spheres + p.n_vpl;
  float* scene = smem;
  float* vpl = scene + p.n_spheres * kCols;
  uint32_t* keys = reinterpret_cast<uint32_t*>(vpl + p.n_vpl * kCols);
  const int n_key_words = p.n_rows * 4 + p.n_lights;
  float* wtab = reinterpret_cast<float*>(keys + n_key_words);
  float* wloss = wtab + kWarps * rows * kCols;
  for (int i = threadIdx.x; i < p.n_spheres * kCols; i += blockDim.x)
    scene[i] = p.scene[i];
  for (int i = threadIdx.x; i < p.n_vpl * kCols; i += blockDim.x)
    vpl[i] = p.vpl[i];
  for (int i = threadIdx.x; i < n_key_words; i += blockDim.x)
    keys[i] = p.keys[i];
  for (int i = threadIdx.x; i < kWarps * rows * kCols + kWarps;
       i += blockDim.x)
    wtab[i] = 0.0f;
  const int* lights = reinterpret_cast<const int*>(keys + p.n_rows * 4);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  float* tab = wtab + warp * rows * kCols;   // this warp's scene, VPL rows
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = idx < p.n;   // no early return: the warp stays whole
  const uint32_t gl = static_cast<uint32_t>(idx) + p.lane_offset;
  const Tables T{scene, vpl, keys, lights, p.tape, p.n_spheres, p.n_vpl,
                 p.n_lights, p.n_light_slots, p.combine_half, p.lane_offset,
                 p.lane_total, static_cast<uint32_t>(p.n),
                 p.emission_scale, p.light_gain, 0};
  const int per_depth = 2 * p.n_light_slots + 3;

  // ---- forward sweep: tracer.cuh's eye_step, saving each depth
  Saved saved[kMaxDepth];
  int n_saved = 0;
  float rad[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    Path s{p.rays_o[3 * idx], p.rays_o[3 * idx + 1], p.rays_o[3 * idx + 2],
           p.rays_d[3 * idx], p.rays_d[3 * idx + 1], p.rays_d[3 * idx + 2],
           1.0f, 1.0f, 1.0f, true};
#pragma unroll 1
    for (int depth = 0; depth < p.max_depth; ++depth) {
      Saved& sv = saved[depth];
      sv.o[0] = s.ox;
      sv.o[1] = s.oy;
      sv.o[2] = s.oz;
      sv.d[0] = s.dx;
      sv.d[1] = s.dy;
      sv.d[2] = s.dz;
      sv.tp[0] = s.tp_r;
      sv.tp[1] = s.tp_g;
      sv.tp[2] = s.tp_b;
      sv.specular = s.specular;
#pragma unroll
      for (int w = 0; w < kLitWords; ++w) sv.lit[w] = 0u;
      int hit;
      const int code = eye_step(T, depth * per_depth, gl, s, rad[0], rad[1],
                                rad[2], hit, sv.lit);
      if (code == kEscaped) break;
      sv.hit = hit;
      sv.code = code;
      ++n_saved;
      if (code == kEmitter) break;
    }
  }

  // ---- the radiance cotangent
  float cot[3] = {0.0f, 0.0f, 0.0f};
  if (kFused) {
    float sq_err = 0.0f;
    if (valid) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float t = p.target[3 * idx + i];
        if (p.loss_kind == 0) {
          const float diff = rad[i] - t;
          sq_err = sq_err + diff * diff;
          cot[i] = 2.0f * diff * p.inv3n;
        } else {
          const float diff = log1pf(rad[i]) - t;
          sq_err = sq_err + diff * diff;
          cot[i] = 2.0f * diff * p.inv3n / (1.0f + rad[i]);
        }
      }
      if (p.rad_out != nullptr) {
        p.rad_out[3 * idx] = rad[0];
        p.rad_out[3 * idx + 1] = rad[1];
        p.rad_out[3 * idx + 2] = rad[2];
      }
    }
    sq_err = warp_sum(sq_err);
    if ((threadIdx.x & 31) == 0) wloss[warp] = sq_err;
  } else if (valid) {
    cot[0] = p.cot[3 * idx];
    cot[1] = p.cot[3 * idx + 1];
    cot[2] = p.cot[3 * idx + 2];
  }

  // ---- reverse sweep: adjoints of the state after each depth
  // The carrier's blocker rows (rad, p(3)) of this thread.
  float vacc[kVis ? 4 * kVisSpheres : 1];
  if (kVis) {
#pragma unroll 1
    for (int i = 0; i < 4 * p.n_spheres; ++i) vacc[i] = 0.0f;
  }
  float bo[3] = {0.0f, 0.0f, 0.0f}, bd[3] = {0.0f, 0.0f, 0.0f};
  float btp[3] = {0.0f, 0.0f, 0.0f};
  const float half = (p.n_vpl > 0 && p.combine_half) ? 0.5f : 1.0f;
  const float inv_k = p.n_vpl > 0 ? 1.0f / static_cast<float>(p.n_vpl)
                                  : 0.0f;
#pragma unroll 1
  for (int k = p.max_depth - 1; k >= 0; --k) {
    const bool act = valid && k < n_saved;
    const Saved& sv = saved[act ? k : 0];
    const int row0 = k * per_depth;
    Vertex x;
    // Gradient of the hit sphere's row: rad, p(3), e(3), c(3).
    float gs[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                    0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float bh[3] = {0.0f, 0.0f, 0.0f}, bn[3] = {0.0f, 0.0f, 0.0f};
    float bnl[3] = {0.0f, 0.0f, 0.0f}, bok[3] = {0.0f, 0.0f, 0.0f};
    float bdk[3] = {0.0f, 0.0f, 0.0f}, btpk[3] = {0.0f, 0.0f, 0.0f};
    float bld[3] = {0.0f, 0.0f, 0.0f};   // adjoint of the NEE sum ld
    bool nee = false;
    if (act) {
      vertex(T, sv, x);
      const float* hs = x.hs;
      if (sv.code == kEmitter) {
        if (sv.specular) {  // rad += (es |dp|) e tp
          const float a = T.emission_scale * fabsf(x.dp);
          float ba = 0.0f;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            ba += cot[i] * hs[4 + i] * x.tp[i];
            gs[4 + i] = cot[i] * a * x.tp[i];
            btpk[i] += cot[i] * a * hs[4 + i];
          }
          const float sgn_dp = x.dp > 0.0f ? 1.0f : (x.dp < 0.0f ? -1.0f
                                                                 : 0.0f);
          const float bdp = T.emission_scale * sgn_dp * ba;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            bn[i] += bdp * x.d[i];
            bdk[i] += bdp * x.n[i];
          }
        }
      } else {
        // tp' = tp * (c * mul), o' = h, d' = the scattered direction.
        const float mul = scatter_adj(T, row0, gl, x, bd, btp, bdk, bn, bnl);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          btpk[i] += btp[i] * (hs[7 + i] * mul);
          gs[7 + i] += btp[i] * x.tp[i] * mul;
          bh[i] += bo[i];
        }
        if (hs[10] == 0.0f) {  // rad += (tp * c) * ld
          nee = true;
#pragma unroll
          for (int i = 0; i < 3; ++i) bld[i] = cot[i] * (x.tp[i] * hs[7 + i]);
        }
      }
    }

    // ---- next-event estimation: every lane of the warp runs the slots
    float ld[3] = {0.0f, 0.0f, 0.0f};
    float bdir[3] = {bld[0] * half, bld[1] * half, bld[2] * half};
#pragma unroll 1
    for (int slot = 0; slot < p.n_lights; ++slot) {
      float g[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (nee && lit_bit(sv.lit, slot))
        light_adj(T, row0, slot, gl, x, bdir, ld, bh, bnl, g);
      if (kVis && nee)
        light_vis_adj(T, row0, slot, gl, x, bdir, p.vis_tau, vacc, bh, g);
      flush_row<7>(tab + lights[slot] * kCols, g);
    }
    if (p.n_vpl > 0) {
      float vsum[3] = {0.0f, 0.0f, 0.0f};
      const float bv[3] = {bdir[0] * inv_k, bdir[1] * inv_k,
                           bdir[2] * inv_k};
#pragma unroll 1
      for (int v = 0; v < p.n_vpl; ++v) {
        float g[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (nee && lit_bit(sv.lit, p.n_lights + v))
          vpl_adj(T, v, x, bv, vsum, bh, bnl, g);
        if (kVis && nee) vpl_vis_adj(T, v, x, bv, p.vis_tau, vacc, bh, g);
        flush_row<9>(tab + (p.n_spheres + v) * kCols, g);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) ld[i] = (ld[i] + vsum[i] * inv_k) * half;
    }

    if (act) {
      const float* hs = x.hs;
      if (nee) {  // b(tp * c) = cot * ld
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float bm = cot[i] * ld[i];
          btpk[i] += bm * hs[7 + i];
          gs[7 + i] += bm * x.tp[i];
        }
      }
      // nl = flip n; n = norm(h - p); h = o + t d; t the root.
      float bv[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 3; ++i) bn[i] += x.flip * bnl[i];
      normalize_adj(x.v, 1e-20f, bn, bv);
      float bt = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        bh[i] += bv[i];
        gs[1 + i] -= bv[i];
        bok[i] += bh[i];
        bt += bh[i] * x.d[i];
        bdk[i] += x.t * bh[i];
      }
      // t = b -/+ sqrt(max(det, 1e-6)), det = b^2 - op.op + r^2, b = op.d
      const float bsq = x.use1 ? -bt : bt;
      const float bdet = x.det >= kDetClamp ? bsq * 0.5f / x.sq : 0.0f;
      const float bb = bt + 2.0f * x.b * bdet;
      gs[0] += 2.0f * hs[0] * bdet;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float bop = bb * x.d[i] - 2.0f * x.op[i] * bdet;
        bdk[i] += bb * x.op[i];
        gs[1 + i] += bop;
        bok[i] -= bop;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        bo[i] = bok[i];
        bd[i] = bdk[i];
        btp[i] = btpk[i];
      }
    }
    flush_by_id<10>(tab, act, act ? sv.hit : 0, gs);
  }

  if (kVis) {   // the carrier's blocker rows, summed over the warp
#pragma unroll 1
    for (int s = 0; s < p.n_spheres; ++s)
      flush_row<4>(tab + s * kCols, vacc + 4 * s);
  }

  if (valid && p.drays_o != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p.drays_o[3 * idx + i] = bo[i];
      p.drays_d[3 * idx + i] = bd[i];
    }
  }

  // ---- the block's partials: its warps' tables added in warp order
  __syncthreads();
  const int n_vpl_rows = p.n_vpl > 0 ? p.n_vpl : 1;
  float* dscene = p.dscene + blockIdx.x * p.n_spheres * kCols;
  float* dvpl = p.dvpl + blockIdx.x * n_vpl_rows * kCols;
  for (int i = threadIdx.x; i < rows * kCols; i += blockDim.x) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc = acc + wtab[w * rows * kCols + i];
    if (i < p.n_spheres * kCols)
      dscene[i] = acc;
    else
      dvpl[i - p.n_spheres * kCols] = acc;
  }
  if (p.n_vpl == 0 && threadIdx.x < kCols) dvpl[threadIdx.x] = 0.0f;
  if (kFused && threadIdx.x == 0) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc = acc + wloss[w];
    p.loss_part[blockIdx.x] = acc;
  }
}

template <bool kFused, bool kVis>
int launch(const Params& p, void* stream) {
  if (p.n <= 0) return 0;
  if (kVis && p.n_spheres > kVisSpheres)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = p.n_spheres + p.n_vpl;
  const size_t smem = sizeof(float) * rows * kCols +
                      sizeof(uint32_t) * (4 * p.n_rows + p.n_lights) +
                      sizeof(float) * (kWarps * rows * kCols + kWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grad_kernel<kFused, kVis>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (p.n + kBlock - 1) / kBlock;
  grad_kernel<kFused, kVis><<<grid, kBlock, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params common(const void* scene, int n_spheres, const void* vpl, int n_vpl,
              const void* keys, int n_rows, const void* tape, int n_lights,
              const void* rays_o,
              const void* rays_d, int n, int max_depth, int n_light_slots,
              int combine_half, unsigned int lane_offset,
              unsigned int lane_total, float emission_scale,
              float light_gain, float vis_tau) {
  Params p{};
  p.scene = static_cast<const float*>(scene);
  p.vpl = static_cast<const float*>(vpl);
  p.keys = static_cast<const uint32_t*>(keys);
  p.tape = static_cast<const float*>(tape);
  p.rays_o = static_cast<const float*>(rays_o);
  p.rays_d = static_cast<const float*>(rays_d);
  p.n_spheres = n_spheres;
  p.n_vpl = n_vpl;
  p.n_rows = n_rows;
  p.n = n;
  p.max_depth = max_depth < kMaxDepth ? max_depth : kMaxDepth;
  p.n_lights = n_lights;
  p.n_light_slots = n_light_slots;
  p.combine_half = combine_half;
  p.lane_offset = lane_offset;
  p.lane_total = lane_total;
  p.emission_scale = emission_scale;
  p.light_gain = light_gain;
  p.vis_tau = vis_tau;
  return p;
}

template <bool kFused>
int launch_any(const Params& p, void* stream) {
  return p.vis_tau > 0.0f ? launch<kFused, true>(p, stream)
                          : launch<kFused, false>(p, stream);
}

}  // namespace

extern "C" int grad_kernel_launch(
    const void* scene, int n_spheres, const void* vpl, int n_vpl,
    const void* keys, int n_rows, const void* tape, int n_lights,
    const void* rays_o,
    const void* rays_d, int n, int max_depth, int n_light_slots,
    int combine_half, unsigned int lane_offset, unsigned int lane_total,
    float emission_scale, float light_gain, float vis_tau, const void* cot,
    void* dscene, void* dvpl, void* drays_o, void* drays_d, void* stream) {
  Params p = common(scene, n_spheres, vpl, n_vpl, keys, n_rows, tape,
                    n_lights,
                    rays_o, rays_d, n, max_depth, n_light_slots, combine_half,
                    lane_offset, lane_total, emission_scale, light_gain,
                    vis_tau);
  p.cot = static_cast<const float*>(cot);
  p.dscene = static_cast<float*>(dscene);
  p.dvpl = static_cast<float*>(dvpl);
  p.drays_o = static_cast<float*>(drays_o);
  p.drays_d = static_cast<float*>(drays_d);
  return launch_any<false>(p, stream);
}

extern "C" int fused_kernel_launch(
    const void* scene, int n_spheres, const void* vpl, int n_vpl,
    const void* keys, int n_rows, const void* tape, int n_lights,
    const void* rays_o,
    const void* rays_d, int n, int max_depth, int n_light_slots,
    int combine_half, unsigned int lane_offset, unsigned int lane_total,
    float emission_scale, float light_gain, float vis_tau,
    const void* target, int loss_kind, float inv3n, void* dscene, void* dvpl,
    void* loss_part, void* rad_out, void* stream) {
  Params p = common(scene, n_spheres, vpl, n_vpl, keys, n_rows, tape,
                    n_lights,
                    rays_o, rays_d, n, max_depth, n_light_slots, combine_half,
                    lane_offset, lane_total, emission_scale, light_gain,
                    vis_tau);
  p.target = static_cast<const float*>(target);
  p.loss_kind = loss_kind;
  p.inv3n = inv3n;
  p.dscene = static_cast<float*>(dscene);
  p.dvpl = static_cast<float*>(dvpl);
  p.loss_part = static_cast<float*>(loss_part);
  p.rad_out = static_cast<float*>(rad_out);
  return launch_any<true>(p, stream);
}

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
//   kernel, and saves each depth's entry state packed into 10 words
//   (origin, direction, throughput; one word with the hit sphere, how the
//   depth ended, the specular flag and the glass vertex's branches) and
//   ceil((L + V) / 32) words of detached shadow facts: one bit per light
//   slot and VPL slot whose sample reached the vertex. The fused kernel
//   then forms its cotangent from the radiance: 2 (rad - t) / (3n) for l2,
//   2 (log1p rad - t) / (1 + rad) / (3n) for log (targets come in
//   log1p'd);
// - a reverse sweep over the depths carries the adjoints of origin,
//   direction and throughput back through next-event estimation and the
//   VPL gather, the emitter term, the diffuse / mirror / glass scatter, and
//   the hit-point, normal and root chain. What is left at depth 0 is the
//   gradient of the ray. Each depth shades its hit point again for the
//   next-event adjoint, then reads its entry state once more for the
//   scatter and the root chain, so that their values are not held in
//   registers across the next-event loops (the kernel's register peak;
//   92-96 registers, 5 blocks of 128 threads per SM). A glass vertex reads
//   its branches from the saved word, and a diffuse vertex its lobe's
//   coordinates from the next depth's saved direction, so the scatter's
//   tape draws, cosf and sinf are not evaluated again. Sums of adjoints,
//   which no branch reads, use fused multiply-adds; everything the forward
//   decides with keeps the forward's expressions.
//
// Scene and VPL gradients are deterministic: no float atomics. The reverse
// sweep runs the warp in lockstep over depths and slots (a depth or slot
// with no active lane is skipped, `__any_sync`). Table rows are summed over
// the warp by a transpose reduction (`transpose_sum`): each halving step
// exchanges half of the values still held, so K values cost about K
// shuffles rather than 5 K; the lanes then add their sums to the warp's
// table in shared memory, one value each. The rows of light slot 0 and VPL
// slot 0, which do not depend on the depth, are carried per lane in
// shared memory (a lane-major column, conflict-free) over the whole sweep
// and reduced once at its end; other slots are reduced per depth. The hit
// sphere's row is reduced per distinct sphere id among the warp's lanes,
// its emission columns apart and only where a specular chain reached an
// emitter. At the end the block adds its warps'
// tables in warp order into its partial [S, 16] and [V, 16] rows, and the
// wrapper sums the partials over blocks (torch.sum). Two launches on the
// same inputs give the same bits.
//
// The visibility carrier (integrators/direct.py::_vis_carrier): the
// forward is unchanged (its value is 0), and the reverse sweep adds, for
// every light and VPL slot of a diffuse vertex whose sample faces it (lit
// or occluded), the adjoint of stop(contrib) * soft, where soft =
// prod_s (1 - edge_s endp_s gate_s) over the candidate blockers
// (intersect.py::soft_visibility). The first pass over the blockers forms
// the product and keeps each blocker's sigmoids and root (edge, endp,
// sqrt(det)) in a lane-major table in shared memory; a blocker behind the
// segment's start (the hard gate b <= EPSILON) is a factor 1 and is not
// evaluated, and a product that reaches 0 ends the pass (its adjoint is
// then 0 for every blocker). The second pass, over the kept values, runs
// each gated blocker's adjoint with the guarded leave-one-out factor
// soft / (1 - blocked_s); it evaluates no sigmoid and no root again. Its
// (rad, p) row is reduced over the warp per blocker and segment (skipped
// where no lane's is nonzero); the segment's direction and length
// adjoints go through the sample's segment into the hit point and the
// light or VPL row.
//
// Bound: FP32 ALU, as the eye-path kernel: the forward sweep is that
// kernel's work, and the reverse sweep adds per hit segment the adjoint of
// one root and the shading, per cast shadow sample the adjoint of its
// set-up (no new sphere scans: occlusion is saved), and per vertex the
// scatter's adjoint. The saved state lives in local memory (11 words a
// depth at one light and one VPL; 308 bytes a thread over 7 depths);
// memory traffic proper is the rays, the cotangent or targets, the ray
// gradients and the per-block partials.
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
constexpr int kStateWords = 10;  // o(3), d(3), tp(3), the packed word
constexpr int kVisSpheres = 64;  // blockers of the carrier (SPHERE_LIMIT)
constexpr int kCache = 3;        // per blocker: edge, endp, sqrt(det)
constexpr int kSlot0 = 16;       // light slot 0's row (7), VPL slot 0's (9)
constexpr float kEndpointFrac = 0.25f;  // intersect.ENDPOINT_TAU_FRACTION
constexpr unsigned kFull = 0xffffffffu;

// The packed word of a depth: hit sphere, how it ended, the specular
// flag of its entry, and the glass branches (tracer.cuh kGlass*).
constexpr int kCodeShift = 16, kSpecularBit = 18, kGlassShift = 19;

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
  int combine_half, loss_kind, lit_words;
  uint32_t lane_offset, lane_total;
  float emission_scale, light_gain, inv3n;
  float vis_tau;          // > 0: the visibility carrier (kVis)
};

template <int kCount>
__host__ __device__ constexpr int pow2_at_least() {
  int k = 1;
  while (k < kCount) k <<= 1;
  return k;
}

// One halving step of `transpose_sum` over lane bit kOff, then the next:
// the lanes with the bit keep the upper kH of the 2 kH values they hold
// (renamed to v[0..kH)), the others the lower, each adding its partner's
// copy of the half it keeps.
template <int kH, int kOff>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const float send = upper ? v[i] : v[i + kH];
    const float keep = upper ? v[i + kH] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kOff);
  }
  if constexpr (kH > 1) halve<kH / 2, kOff / 2>(v, lane);
}

// The warp's sum of v[0..K) (K a power of two, 2 to 32) by a transpose
// reduction: log2 K halving steps over lane bits 4, 3, ... leave each lane
// one value, index lane / (32 / K), summed over those lane bits; a
// butterfly over the remaining bits completes it. Returns the lane's sum
// and sets `idx` to its index. K - 1 + 5 - log2 K shuffles, against 5 K
// for a butterfly per value.
template <int K>
__device__ __forceinline__ float transpose_sum(float* v, int& idx) {
  const int lane = threadIdx.x & 31;
  halve<K / 2, 16>(v, lane);
  float x = v[0];
#pragma unroll
  for (int off = 16 / K; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  idx = lane / (32 / K);
  return x;
}

// Adds the warp's sum of g[0..kCount) to `row`, one lane per value: value
// i to column i, or i + kGap from i = kGapAt on. Every lane of the warp
// calls it.
template <int kCount, int kGapAt = kCount, int kGap = 0>
__device__ __forceinline__ void flush_row(float* row, const float* g) {
  constexpr int K = pow2_at_least<kCount>();
  float v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = i < kCount ? g[i] : 0.0f;
  int idx;
  const float x = transpose_sum<K>(v, idx);
  if ((threadIdx.x & (32 / K - 1)) == 0 && idx < kCount)
    row[idx < kGapAt ? idx : idx + kGap] += x;
}

// The same for rows that differ by lane: one pass per distinct `id` among
// the lanes with `act`, in the order of their lowest lane.
template <int kCount, int kGapAt = kCount, int kGap = 0>
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
    flush_row<kCount, kGapAt, kGap>(tab + sid * kCols, mg);
    pending &= ~__ballot_sync(kFull, mine);
  }
}

// a.b with fused multiply-adds: only for sums of adjoints, which no branch
// reads (the forward's expressions stay as the plain version writes them).
__device__ __forceinline__ float fdot3(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  return __fmaf_rn(ax, bx, __fmaf_rn(ay, by, az * bz));
}

// Adjoint of n = v * 1 / (|v| + eps) (core/vecmath.norm): adds b_v to bv.
// The derivative of |v| is taken as zero at v = 0.
__device__ __forceinline__ void normalize_adj(const float* v, float eps,
                                              const float* bn, float* bv) {
  const float q = dot3(v[0], v[1], v[2], v[0], v[1], v[2]);
  const float len = sqrtf(q);
  const float inv = 1.0f / (len + eps);
  const float binv = fdot3(bn[0], bn[1], bn[2], v[0], v[1], v[2]);
  const float blen = -binv * inv * inv;
  const float bq = q > 0.0f ? blen * 0.5f / len : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    bv[i] = __fmaf_rn(bn[i], inv, __fmaf_rn(2.0f * v[i], bq, bv[i]));
}

// Adjoint of `segment` from h to q, given its length `len` (as `segment`
// returned it) and the adjoints of its unit direction (bs_dir) and of its
// length (blen): adds b(q - h) to bqh.
__device__ __forceinline__ void segment_adj(const float* q, const float* h,
                                            float len, const float* bs_dir,
                                            float blen, float* bqh) {
  const float sx = q[0] - h[0], sy = q[1] - h[1], sz = q[2] - h[2];
  const float len_sq = dot3(sx, sy, sz, sx, sy, sz);
  const float inv_m = 1.0f / fmaxf(len, kTiny);
  const float bm = -fdot3(bs_dir[0], bs_dir[1], bs_dir[2], sx, sy, sz) *
                   (inv_m * inv_m);
  if (len >= kTiny) blen += bm;
  const float bq = len_sq > 0.0f ? blen * 0.5f / len : 0.0f;
  bqh[0] = __fmaf_rn(bs_dir[0], inv_m, __fmaf_rn(2.0f * sx, bq, bqh[0]));
  bqh[1] = __fmaf_rn(bs_dir[1], inv_m, __fmaf_rn(2.0f * sy, bq, bqh[1]));
  bqh[2] = __fmaf_rn(bs_dir[2], inv_m, __fmaf_rn(2.0f * sz, bq, bqh[2]));
}

// A depth's packed word, unpacked.
struct Entry {
  int hit, code;
  bool specular;
  uint32_t glass;
};

__device__ __forceinline__ Entry unpack(uint32_t word) {
  Entry e;
  e.hit = static_cast<int>(word & 0xffffu);
  e.code = static_cast<int>((word >> kCodeShift) & 3u);
  e.specular = (word >> kSpecularBit) & 1u;
  e.glass = word >> kGlassShift;
  return e;
}

__device__ __forceinline__ bool lit_bit(const uint32_t* lit, int j) {
  return (lit[j >> 5] >> (j & 31)) & 1u;
}

// Three saved words as floats. `volatile` reads (the origin, direction
// and throughput after next-event estimation) load them again rather than
// keep the first copies live across it.
template <typename W>
__device__ __forceinline__ void load3(W* w, float* v) {
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = __uint_as_float(w[i]);
}

// The root of the hit sphere `hs` along o + t d: sphere_t's expressions,
// keeping what the adjoint needs.
struct Root {
  float op[3], b, det, sq, t;
  bool use1;                    // the smaller root was taken
};

__device__ __forceinline__ Root root(const float* hs, const float* o,
                                     const float* d) {
  Root r;
  r.op[0] = hs[1] - o[0];
  r.op[1] = hs[2] - o[1];
  r.op[2] = hs[3] - o[2];
  r.b = dot3(r.op[0], r.op[1], r.op[2], d[0], d[1], d[2]);
  const float opop = dot3(r.op[0], r.op[1], r.op[2], r.op[0], r.op[1],
                          r.op[2]);
  r.det = r.b * r.b - opop + hs[0] * hs[0];
  r.sq = sqrtf(fmaxf(r.det, kDetClamp));
  const float t1 = r.b - r.sq;
  r.use1 = t1 > kEps;
  r.t = r.use1 ? t1 : r.b + r.sq;
  return r;
}

// The shaded hit point of one depth as eye_step shades it: what
// next-event estimation reads, held across it.
struct Hit {
  const float* hs;              // hit sphere row
  float h[3], nl[3], flip;
};

__device__ __forceinline__ void shade(const float* hs, const float* o,
                                      const float* d, Hit& x) {
  const Root r = root(hs, o, d);
  x.hs = hs;
#pragma unroll
  for (int i = 0; i < 3; ++i) x.h[i] = o[i] + r.t * d[i];
  float n[3] = {x.h[0] - hs[1], x.h[1] - hs[2], x.h[2] - hs[3]};
  normalize(n[0], n[1], n[2], 1e-20f);
  const float dp = dot3(n[0], n[1], n[2], d[0], d[1], d[2]);
  x.flip = dp > 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) x.nl[i] = x.flip * n[i];
}

// What the scatter's adjoint reads: the hit sphere, the entry direction
// and throughput, the normal (flip nl, exactly eye_step's n) and nl.
struct Frame {
  const float* hs;
  float d[3], tp[3], n[3], nl[3];
};

// Adjoint of the mirror direction d - 2 (n.d) n.
__device__ __forceinline__ void mirror_adj(const Frame& x, const float* bnd,
                                           float* bd, float* bn) {
  const float k2 = 2.0f * fdot3(x.n[0], x.n[1], x.n[2], x.d[0], x.d[1],
                                x.d[2]);
  const float bk2 = -fdot3(bnd[0], bnd[1], bnd[2], x.n[0], x.n[1], x.n[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bd[i] = __fmaf_rn(2.0f * bk2, x.n[i], bd[i] + bnd[i]);
    bn[i] = __fmaf_rn(-k2, bnd[i], __fmaf_rn(2.0f * bk2, x.d[i], bn[i]));
  }
}

// The scatter of one depth: returns the throughput multiplier `mul`, and
// adds the adjoints of d, n and nl for the adjoint bnd of the new
// direction `nd` (the next depth's saved direction) and btp of the new
// throughput tp * (c * mul). A glass vertex reads its branches from
// `glass`. The diffuse lobe's coordinates (cos r1 sqrt u2, sin r1 sqrt u2,
// sqrt(1 - u2)) are read back from nd on its basis (u, nl x u, nl), not
// drawn and evaluated again: they enter only the adjoint.
__device__ __forceinline__ float scatter_adj(uint32_t glass, const Frame& x,
                                             const float* nd,
                                             const float* bnd,
                                             const float* btp, float* bd,
                                             float* bn, float* bnl) {
  const float refl = x.hs[10];
  if (refl == 0.0f) {  // diffuse: cosine lobe about nl
    const float* nl = x.nl;
    const bool big_x = fabsf(nl[0]) > 0.1f;
    const float a[3] = {big_x ? 0.0f : 1.0f, big_x ? 1.0f : 0.0f, 0.0f};
    const float c[3] = {a[1] * nl[2] - a[2] * nl[1],
                        a[2] * nl[0] - a[0] * nl[2],
                        a[0] * nl[1] - a[1] * nl[0]};
    float u[3] = {c[0], c[1], c[2]};
    normalize(u[0], u[1], u[2], 0.0f);
    const float v[3] = {nl[1] * u[2] - nl[2] * u[1],
                        nl[2] * u[0] - nl[0] * u[2],
                        nl[0] * u[1] - nl[1] * u[0]};
    const float cw = fdot3(nd[0], nd[1], nd[2], u[0], u[1], u[2]);
    const float sw = fdot3(nd[0], nd[1], nd[2], v[0], v[1], v[2]);
    const float wz = fdot3(nd[0], nd[1], nd[2], nl[0], nl[1], nl[2]);
    float bu[3], bv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      bu[i] = cw * bnd[i];
      bv[i] = sw * bnd[i];
      bnl[i] = __fmaf_rn(wz, bnd[i], bnl[i]);
    }
    // v = nl x u
    bnl[0] = __fmaf_rn(u[1], bv[2], __fmaf_rn(-u[2], bv[1], bnl[0]));
    bnl[1] = __fmaf_rn(u[2], bv[0], __fmaf_rn(-u[0], bv[2], bnl[1]));
    bnl[2] = __fmaf_rn(u[0], bv[1], __fmaf_rn(-u[1], bv[0], bnl[2]));
    bu[0] = __fmaf_rn(bv[1], nl[2], __fmaf_rn(-bv[2], nl[1], bu[0]));
    bu[1] = __fmaf_rn(bv[2], nl[0], __fmaf_rn(-bv[0], nl[2], bu[1]));
    bu[2] = __fmaf_rn(bv[0], nl[1], __fmaf_rn(-bv[1], nl[0], bu[2]));
    // u = norm(c), c = a x nl
    float bc[3] = {0.0f, 0.0f, 0.0f};
    normalize_adj(c, 0.0f, bu, bc);
    bnl[0] = __fmaf_rn(bc[1], a[2], __fmaf_rn(-bc[2], a[1], bnl[0]));
    bnl[1] = __fmaf_rn(bc[2], a[0], __fmaf_rn(-bc[0], a[2], bnl[1]));
    bnl[2] = __fmaf_rn(bc[0], a[1], __fmaf_rn(-bc[1], a[0], bnl[2]));
    return 1.0f;
  }
  if (refl == 1.0f || (glass & kGlassTir)) {  // mirror, or glass's TIR
    mirror_adj(x, bnd, bd, bn);
    return 1.0f;
  }
  // Glass: Fresnel dielectric with Russian roulette.
  const float* n = x.n;
  const float* nl = x.nl;
  const float* d = x.d;
  const bool into = (glass & kGlassInto) != 0u;
  const float nnt = into ? (1.0f / 1.5f) : 1.5f;
  const float ddn = dot3(d[0], d[1], d[2], nl[0], nl[1], nl[2]);
  const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
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
  const float* c = x.hs + 7;
  const float bmul = btp[0] * x.tp[0] * c[0] + btp[1] * x.tp[1] * c[1] +
                     btp[2] * x.tp[2] * c[2];
  float mul, bre, bpr;
  float btd[3] = {0.0f, 0.0f, 0.0f};
  if (glass & kGlassReflect) {
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
// the direct-light sum, and adds the light row's gradient (rad, p(3),
// e(3)) to g.
__device__ __forceinline__ void light_adj(const Tables& T, int row0,
                                          int slot, uint32_t gl,
                                          const Hit& x, const float* bdir,
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
  const float inv_q = 1.0f / fmaxf(len2, kTiny);
  const float a = kFourPi * lrad * lrad;
  const float num = a * wi * wo;
  const float gs = T.light_gain * (num * inv_q);
  const float* e = ls + 4;
  ld[0] = ld[0] + e[0] * gs;
  ld[1] = ld[1] + e[1] * gs;
  ld[2] = ld[2] + e[2] * gs;

  g[4] = __fmaf_rn(bdir[0], gs, g[4]);
  g[5] = __fmaf_rn(bdir[1], gs, g[5]);
  g[6] = __fmaf_rn(bdir[2], gs, g[6]);
  const float bscale =
      T.light_gain * fdot3(bdir[0], bdir[1], bdir[2], e[0], e[1], e[2]);
  const float bnum = bscale * inv_q;
  const float bq2 = -bnum * num * inv_q;
  float blen = len2 >= kTiny ? bq2 * 2.0f * len : 0.0f;
  const float bawi = bnum * wo;
  const float bwo = bnum * (a * wi);
  const float ba = bawi * wi;
  const float bwi = bawi * a;
  float blrad = ba * lrad * kFourPi + ba * (kFourPi * lrad);
  float bs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bs[i] = __fmaf_rn(-bwo, u[i], bwi * x.nl[i]);
    bnl[i] = __fmaf_rn(bwi, s[i], bnl[i]);
  }
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(q, x.h, len, bs, blen, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) bh[i] -= bqh[i];
  blrad += fdot3(bqh[0], bqh[1], bqh[2], u[0], u[1], u[2]);
  g[0] += blrad;
  g[1] += bqh[0];
  g[2] += bqh[1];
  g[3] += bqh[2];
}

// One VPL slot that reached the vertex: adds w * rad to vsum, the adjoints
// of h and nl for the adjoint bv of the VPL sum, and adds the VPL row's
// gradient (hp(3), rad(3), nl(3)) to g.
__device__ __forceinline__ void vpl_adj(const Tables& T, int v,
                                        const Hit& x, const float* bv,
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

  const float bw = fdot3(bv[0], bv[1], bv[2], vp[3], vp[4], vp[5]);
  const float bwi = bw * wo;
  const float bwo = bw * wi;
  float bs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[3 + i] = __fmaf_rn(bv[i], w, g[3 + i]);
    g[6 + i] = __fmaf_rn(-bwo, s[i], g[6 + i]);
    bs[i] = __fmaf_rn(-bwo, vp[6 + i], bwi * x.nl[i]);
    bnl[i] = __fmaf_rn(bwi, s[i], bnl[i]);
  }
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(vp, x.h, len, bs, 0.0f, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] += bqh[i];
    bh[i] -= bqh[i];
  }
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// The carrier of one shadow segment from h along the unit sd up to maxt,
// over the spheres that `skip` does not leave out (warp-uniform). Every
// lane of the warp calls it; `on` marks the lanes whose sample faces the
// vertex. Pass 1 forms soft = prod (1 - blocked) per lane, keeping each
// evaluated blocker's edge and endpoint sigmoids and sqrt(max(det, 1e-6))
// in `cache` (lane-major, kCache values per sphere); pass 2 runs the
// adjoint of bsoft * soft over the kept values: the blocker rows' (rad, p)
// gradients go to the warp table `tab`, the hit point's to bh, and the
// segment's direction and length adjoints to bsd and blen. Returns whether
// this lane's segment adjoint may be nonzero.
template <typename Skip>
__device__ __forceinline__ bool soft_adj(const Tables& T, const float* h,
                                         const float* sd, float maxt,
                                         float bsoft, float tau, bool on,
                                         Skip skip, float* cache, float* tab,
                                         float* bh, float* bsd,
                                         float& blen) {
  const float we = fmaxf(kEndpointFrac * tau, 1e-6f);
  float soft = 1.0f;
  if (on) {
#pragma unroll 1
    for (int s = 0; s < T.n_spheres; ++s) {
      const float* sp = T.scene + s * kCols;
      if (skip(s, sp)) continue;
      const float op0 = sp[1] - h[0], op1 = sp[2] - h[1], op2 = sp[3] - h[2];
      const float b = dot3(op0, op1, op2, sd[0], sd[1], sd[2]);
      if (!(b > kEps)) continue;   // blocked = 0: a factor of 1
      const float opop = dot3(op0, op1, op2, op0, op1, op2);
      const float det = b * b - opop + sp[0] * sp[0];
      const float width = fmaxf(tau * sp[0], 1e-6f);
      const float edge = sigmoid(det / width);
      const float sq = sqrtf(fmaxf(det, kDetClamp));
      const float endp = sigmoid((maxt - (b - sq)) / we);
      float* c = cache + kCache * s * kBlock;
      c[0] = edge;
      c[kBlock] = endp;
      c[2 * kBlock] = sq;
      soft = soft * (1.0f - edge * endp);
      if (soft == 0.0f) break;   // every blocker's adjoint is then 0
    }
  }
  const bool live = on && soft != 0.0f && bsoft != 0.0f;
  if (!__any_sync(kFull, live)) return false;
#pragma unroll 1
  for (int s = 0; s < T.n_spheres; ++s) {
    const float* sp = T.scene + s * kCols;
    if (skip(s, sp)) continue;
    float row[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool adds = false;
    if (live) {
      const float op[3] = {sp[1] - h[0], sp[2] - h[1], sp[3] - h[2]};
      const float b = dot3(op[0], op[1], op[2], sd[0], sd[1], sd[2]);
      const float* c = cache + kCache * s * kBlock;
      const float edge = b > kEps ? c[0] : 0.0f;
      const float endp = b > kEps ? c[kBlock] : 0.0f;
      // The hard gate, and the blockers whose terms are exactly 0.
      if (b > kEps && edge != 0.0f && endp != 0.0f) {
        adds = true;
        const float sq = c[2 * kBlock];
        const float opop = dot3(op[0], op[1], op[2], op[0], op[1], op[2]);
        const float det = b * b - opop + sp[0] * sp[0];
        const float width = fmaxf(tau * sp[0], 1e-6f);
        const float blocked = edge * endp;
        const float denom = 1.0f - blocked;
        const float bblocked =
            denom > 1e-6f ? -bsoft * (soft / denom) : 0.0f;
        const float dsq = det >= kDetClamp ? 0.5f / sq : 0.0f;
        const float gd = endp * (1.0f - endp) / we;
        // blocked = edge(det) * endp((maxt - b + sqrt(det)) / we)
        const float bdet = bblocked * (edge * (1.0f - edge) / width * endp +
                                       edge * gd * dsq);
        const float bz = bblocked * edge * gd;
        blen += bz;
        // det = b^2 - op.op + r^2, b = op.sd, op = p - h
        const float bb = 2.0f * b * bdet - bz;
        row[0] = 2.0f * sp[0] * bdet;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float bop = bb * sd[i] - 2.0f * op[i] * bdet;
          row[1 + i] = bop;
          bh[i] -= bop;
          bsd[i] += bb * op[i];
        }
      }
    }
    if (__any_sync(kFull, adds)) flush_row<4>(tab + s * kCols, row);
  }
  return live;
}

// The carrier of light slot `slot` at a diffuse vertex (`on`): with its
// sample facing the vertex, adds the adjoints of h to bh and of the light
// row's (rad, p(3)) to g, and the blockers' rows to the warp table; the
// target light is left out of its own soft product. Every lane of the
// warp calls it.
__device__ __forceinline__ void light_vis_adj(const Tables& T, int row0,
                                              int slot, uint32_t gl, bool on,
                                              const Hit& x,
                                              const float* bdir, float tau,
                                              float* cache, float* tab,
                                              float* bh, float* g) {
  const int target = T.lights[slot];
  const float* ls = T.scene + target * kCols;
  float u[3], q[3], sd[3], len = 0.0f, bsoft = 0.0f;
  if (on) {
    light_dir(T, row0, slot, gl, u[0], u[1], u[2]);
    const float lrad = ls[0];
    q[0] = ls[1] + lrad * u[0];
    q[1] = ls[2] + lrad * u[1];
    q[2] = ls[3] + lrad * u[2];
    segment(q[0], q[1], q[2], x.h[0], x.h[1], x.h[2], sd[0], sd[1], sd[2],
            len);
    float wo = dot3(sd[0], sd[1], sd[2], u[0], u[1], u[2]);
    const bool facing = wo <= 0.0f;
    wo = -wo;
    const float wi = dot3(sd[0], sd[1], sd[2], x.nl[0], x.nl[1], x.nl[2]);
    on = facing && wi > 0.0f;
    if (on) {
      const float scale = kFourPi * lrad * lrad * wi * wo /
                          fmaxf(len * len, kTiny);
      bsoft = dot3(bdir[0], bdir[1], bdir[2], ls[4], ls[5], ls[6]) *
              (T.light_gain * scale);
    }
  }
  if (!__any_sync(kFull, on)) return;
  float bsd[3] = {0.0f, 0.0f, 0.0f}, blen = 0.0f;
  if (!soft_adj(T, x.h, sd, len - kEps, bsoft, tau, on,
                [target](int s, const float*) { return s == target; },
                cache, tab, bh, bsd, blen))
    return;
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(q, x.h, len, bsd, blen, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bh[i] -= bqh[i];
    g[1 + i] += bqh[i];
  }
  g[0] += dot3(bqh[0], bqh[1], bqh[2], u[0], u[1], u[2]);
}

// The carrier of VPL slot v (vacuum: emitters never block; the VPL's host
// sphere, column 10, is left out) at a diffuse vertex (`on`): adds the
// adjoints of h to bh, of the VPL's hp to g[0..3), and the blockers' rows
// to the warp table. Every lane of the warp calls it.
__device__ __forceinline__ void vpl_vis_adj(const Tables& T, int v, bool on,
                                            const Hit& x, const float* bv,
                                            float tau, float* cache,
                                            float* tab, float* bh,
                                            float* g) {
  const float* vp = T.vpl + v * kCols;
  if (!(vp[9] > 0.5f)) return;   // warp-uniform
  float sd[3], len = 0.0f, bsoft = 0.0f;
  if (on) {
    segment(vp[0], vp[1], vp[2], x.h[0], x.h[1], x.h[2], sd[0], sd[1],
            sd[2], len);
    float wo = dot3(sd[0], sd[1], sd[2], vp[6], vp[7], vp[8]);
    const bool facing = wo <= 0.0f;
    wo = -wo;
    const float wi = dot3(sd[0], sd[1], sd[2], x.nl[0], x.nl[1], x.nl[2]);
    on = facing && wi > 0.0f;
    if (on)
      bsoft = dot3(bv[0], bv[1], bv[2], vp[3], vp[4], vp[5]) * (wi * wo);
  }
  if (!__any_sync(kFull, on)) return;
  const float host = vp[10];
  float bsd[3] = {0.0f, 0.0f, 0.0f}, blen = 0.0f;
  if (!soft_adj(T, x.h, sd, len - kEps, bsoft, tau, on,
                [host](int s, const float* sp) {
                  return emissive(sp) || static_cast<float>(s) == host;
                },
                cache, tab, bh, bsd, blen))
    return;
  float bqh[3] = {0.0f, 0.0f, 0.0f};
  segment_adj(vp, x.h, len, bsd, blen, bqh);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] += bqh[i];
    bh[i] -= bqh[i];
  }
}

// Dynamic shared memory of a launch: the scene and VPL tables, the site
// keys and light ids, the warps' gradient tables and loss sums, the
// lanes' slot-0 rows, and with the carrier the blockers' kept values.
template <bool kVis>
size_t smem_bytes(int n_spheres, int n_vpl, int n_rows, int n_lights) {
  const int rows = n_spheres + n_vpl;
  return sizeof(float) * rows * kCols +
         sizeof(uint32_t) * (4 * n_rows + n_lights) +
         sizeof(float) * (kWarps * rows * kCols + kWarps) +
         sizeof(float) * kSlot0 * kBlock +
         (kVis ? sizeof(float) * kCache * n_spheres * kBlock : 0);
}

// At least 5 resident blocks per SM for the carrier's instantiations,
// which the compiler's own choice spills; the carrier-off ones as the
// compiler chooses (no spills, 5 blocks; a bound of 5 there makes slower
// code, 6 spills).
template <bool kFused, bool kVis>
__global__ void __launch_bounds__(kBlock, kVis ? 5 : 1)
    grad_kernel(Params p) {
  extern __shared__ float smem[];
  const int rows = p.n_spheres + p.n_vpl;
  float* scene = smem;
  float* vpl = scene + p.n_spheres * kCols;
  uint32_t* keys = reinterpret_cast<uint32_t*>(vpl + p.n_vpl * kCols);
  const int n_key_words = p.n_rows * 4 + p.n_lights;
  float* wtab = reinterpret_cast<float*>(keys + n_key_words);
  float* wloss = wtab + kWarps * rows * kCols;
  // This lane's columns of the slot-0 rows ([kSlot0][lane]) and, with the
  // carrier, of the blockers' kept values ([S][kCache][lane]).
  float* slot0 = wloss + kWarps + threadIdx.x;
  float* cache = slot0 + kSlot0 * kBlock;
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
  const int stride = kStateWords + p.lit_words;   // saved words a depth

  // ---- forward sweep: tracer.cuh's eye_step, saving each depth
  uint32_t saved[kMaxDepth * (kStateWords + kLitWords)];
  int n_saved = 0;
  float rad[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    Path s{p.rays_o[3 * idx], p.rays_o[3 * idx + 1], p.rays_o[3 * idx + 2],
           p.rays_d[3 * idx], p.rays_d[3 * idx + 1], p.rays_d[3 * idx + 2],
           1.0f, 1.0f, 1.0f, true};
#pragma unroll 1
    for (int depth = 0; depth < p.max_depth; ++depth) {
      uint32_t* w = saved + depth * stride;
      w[0] = __float_as_uint(s.ox);
      w[1] = __float_as_uint(s.oy);
      w[2] = __float_as_uint(s.oz);
      w[3] = __float_as_uint(s.dx);
      w[4] = __float_as_uint(s.dy);
      w[5] = __float_as_uint(s.dz);
      w[6] = __float_as_uint(s.tp_r);
      w[7] = __float_as_uint(s.tp_g);
      w[8] = __float_as_uint(s.tp_b);
      const uint32_t specular = s.specular ? 1u : 0u;
#pragma unroll 1
      for (int i = 0; i < p.lit_words; ++i) w[kStateWords + i] = 0u;
      int hit;
      uint32_t glass = 0u;
      const int code = eye_step(T, depth * per_depth, gl, s, rad[0], rad[1],
                                rad[2], hit, w + kStateWords, &glass);
      if (code == kEscaped) break;
      w[9] = static_cast<uint32_t>(hit) |
             static_cast<uint32_t>(code) << kCodeShift |
             specular << kSpecularBit | glass << kGlassShift;
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq_err += __shfl_xor_sync(kFull, sq_err, off);
    if ((threadIdx.x & 31) == 0) wloss[warp] = sq_err;
  } else if (valid) {
    cot[0] = p.cot[3 * idx];
    cot[1] = p.cot[3 * idx + 1];
    cot[2] = p.cot[3 * idx + 2];
  }

  // ---- reverse sweep: adjoints of the state after each depth
  // The rows of light slot 0 (rad, p(3), e(3)) and VPL slot 0 (hp(3),
  // rad(3), nl(3)) are carried over the depths in this lane's column.
#pragma unroll
  for (int i = 0; i < kSlot0; ++i) slot0[i * kBlock] = 0.0f;
  float bo[3] = {0.0f, 0.0f, 0.0f}, bd[3] = {0.0f, 0.0f, 0.0f};
  float btp[3] = {0.0f, 0.0f, 0.0f};
  const float half = (p.n_vpl > 0 && p.combine_half) ? 0.5f : 1.0f;
  const float inv_k = p.n_vpl > 0 ? 1.0f / static_cast<float>(p.n_vpl)
                                  : 0.0f;
#pragma unroll 1
  for (int k = p.max_depth - 1; k >= 0; --k) {
    const bool act = valid && k < n_saved;
    if (!__any_sync(kFull, act)) continue;
    const uint32_t* w = saved + (act ? k : 0) * stride;
    const Entry sv = unpack(w[9]);
    const uint32_t* lit_bits = w + kStateWords;
    const int row0 = k * per_depth;
    // The hit point and its normal, what next-event estimation reads; the
    // root chain and the scatter are recomputed after it from the saved
    // entry state, so that their values are not held across it.
    Hit x;
    float bh[3] = {0.0f, 0.0f, 0.0f}, bnl[3] = {0.0f, 0.0f, 0.0f};
    float bld[3] = {0.0f, 0.0f, 0.0f};   // adjoint of the NEE sum ld
    bool nee = false;
    if (act) {
      float o[3], d[3];
      load3(w, o);
      load3(w + 3, d);
      shade(T.scene + sv.hit * kCols, o, d, x);
      if (sv.code != kEmitter) {
#pragma unroll
        for (int i = 0; i < 3; ++i) bh[i] = bo[i];   // o' = h
        if (x.hs[10] == 0.0f) {  // rad += (tp * c) * ld
          nee = true;
          float tp[3];
          load3(w + 6, tp);
#pragma unroll
          for (int i = 0; i < 3; ++i) bld[i] = cot[i] * (tp[i] * x.hs[7 + i]);
        }
      }
    }

    // ---- next-event estimation: every lane of the warp runs the slots
    float ld[3] = {0.0f, 0.0f, 0.0f};
    const float bdir[3] = {bld[0] * half, bld[1] * half, bld[2] * half};
    if (__any_sync(kFull, nee)) {
#pragma unroll 1
      for (int slot = 0; slot < p.n_lights; ++slot) {
        float g[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        const bool lit = nee && lit_bit(lit_bits, slot);
        if (lit) light_adj(T, row0, slot, gl, x, bdir, ld, bh, bnl, g);
        if (kVis)
          light_vis_adj(T, row0, slot, gl, nee, x, bdir, p.vis_tau, cache,
                        tab, bh, g);
        if (slot == 0) {
          if (lit || (kVis && nee)) {
#pragma unroll
            for (int i = 0; i < 7; ++i) slot0[i * kBlock] += g[i];
          }
        } else if (__any_sync(kFull, lit || kVis)) {
          flush_row<7>(tab + lights[slot] * kCols, g);
        }
      }
      if (p.n_vpl > 0) {
        float vsum[3] = {0.0f, 0.0f, 0.0f};
        const float bv[3] = {bdir[0] * inv_k, bdir[1] * inv_k,
                             bdir[2] * inv_k};
#pragma unroll 1
        for (int v = 0; v < p.n_vpl; ++v) {
          float g[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                        0.0f, 0.0f, 0.0f, 0.0f};
          const bool lit = nee && lit_bit(lit_bits, p.n_lights + v);
          if (lit) vpl_adj(T, v, x, bv, vsum, bh, bnl, g);
          if (kVis)
            vpl_vis_adj(T, v, nee, x, bv, p.vis_tau, cache, tab, bh, g);
          if (v == 0) {
            if (lit || (kVis && nee)) {
#pragma unroll
              for (int i = 0; i < 9; ++i) slot0[(7 + i) * kBlock] += g[i];
            }
          } else if (__any_sync(kFull, lit || kVis)) {
            flush_row<9>(tab + (p.n_spheres + v) * kCols, g);
          }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) ld[i] = (ld[i] + vsum[i] * inv_k) * half;
      }
    }

    // Gradient of the hit sphere's row: rad, p(3), e(3), c(3).
    float gs[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                    0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (act) {
      const float* hs = x.hs;
      const volatile uint32_t* wv = w;
      float o[3];
      Frame f;
      f.hs = hs;
      load3(wv, o);
      load3(wv + 3, f.d);
      load3(wv + 6, f.tp);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        f.nl[i] = x.nl[i];
        f.n[i] = x.flip * x.nl[i];
      }
      float bn[3] = {0.0f, 0.0f, 0.0f}, bok[3] = {0.0f, 0.0f, 0.0f};
      float bdk[3] = {0.0f, 0.0f, 0.0f}, btpk[3] = {0.0f, 0.0f, 0.0f};
      if (sv.code == kEmitter) {
        if (sv.specular) {  // rad += (es |dp|) e tp
          const float dp = dot3(f.n[0], f.n[1], f.n[2], f.d[0], f.d[1],
                                f.d[2]);
          const float a = T.emission_scale * fabsf(dp);
          float ba = 0.0f;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            ba += cot[i] * hs[4 + i] * f.tp[i];
            gs[4 + i] = cot[i] * a * f.tp[i];
            btpk[i] += cot[i] * a * hs[4 + i];
          }
          const float sgn_dp = dp > 0.0f ? 1.0f : (dp < 0.0f ? -1.0f : 0.0f);
          const float bdp = T.emission_scale * sgn_dp * ba;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            bn[i] += bdp * f.d[i];
            bdk[i] += bdp * f.n[i];
          }
        }
      } else {
        // tp' = tp * (c * mul), o' = h, d' = the scattered direction: the
        // next depth's entry direction, saved wherever bd or btp can be
        // nonzero. With both zero the scatter's adjoint is zero.
        float mul = 1.0f;
        if (bd[0] != 0.0f || bd[1] != 0.0f || bd[2] != 0.0f ||
            btp[0] != 0.0f || btp[1] != 0.0f || btp[2] != 0.0f) {
          float nd[3];
          load3(saved + (k + 1) * stride + 3, nd);
          mul = scatter_adj(sv.glass, f, nd, bd, btp, bdk, bn, bnl);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          btpk[i] += btp[i] * (hs[7 + i] * mul);
          gs[7 + i] += btp[i] * f.tp[i] * mul;
        }
        if (nee) {  // b(tp * c) = cot * ld
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float bm = cot[i] * ld[i];
            btpk[i] += bm * hs[7 + i];
            gs[7 + i] += bm * f.tp[i];
          }
        }
      }
      // nl = flip n; n = norm(h - p); h = o + t d; t the root.
      const Root r = root(hs, o, f.d);
      const float v[3] = {x.h[0] - hs[1], x.h[1] - hs[2], x.h[2] - hs[3]};
      float bv[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 3; ++i) bn[i] = __fmaf_rn(x.flip, bnl[i], bn[i]);
      normalize_adj(v, 1e-20f, bn, bv);
      float bt = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        bh[i] += bv[i];
        gs[1 + i] -= bv[i];
        bok[i] += bh[i];
        bt = __fmaf_rn(bh[i], f.d[i], bt);
        bdk[i] = __fmaf_rn(r.t, bh[i], bdk[i]);
      }
      // t = b -/+ sqrt(max(det, 1e-6)), det = b^2 - op.op + r^2, b = op.d
      const float bsq = r.use1 ? -bt : bt;
      const float bdet = r.det >= kDetClamp ? bsq * 0.5f / r.sq : 0.0f;
      const float bb = __fmaf_rn(2.0f * r.b, bdet, bt);
      gs[0] = __fmaf_rn(2.0f * hs[0], bdet, gs[0]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float bop = __fmaf_rn(bb, f.d[i], -2.0f * r.op[i] * bdet);
        bdk[i] = __fmaf_rn(bb, r.op[i], bdk[i]);
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
    // The hit sphere's rad, p(3) and c(3) (columns 0-3, 7-9); its e(3)
    // only where a specular chain reached an emitter.
    const float grc[7] = {gs[0], gs[1], gs[2], gs[3], gs[7], gs[8], gs[9]};
    flush_by_id<7, 4, 3>(tab, act, act ? sv.hit : 0, grc);
    const bool emits = act && sv.code == kEmitter && sv.specular;
    if (__any_sync(kFull, emits))
      flush_by_id<3>(tab + 4, emits, act ? sv.hit : 0, gs + 4);
  }

  // The slot-0 rows, summed over the warp once: lane l ends with value
  // l >> 1 (light row 0..6, then VPL row 0..8).
  if (p.n_lights > 0 || p.n_vpl > 0) {
    float v[kSlot0];
#pragma unroll
    for (int i = 0; i < kSlot0; ++i) v[i] = slot0[i * kBlock];
    int i;
    const float x = transpose_sum<kSlot0>(v, i);
    if ((threadIdx.x & 1) == 0) {
      if (i < 7 && p.n_lights > 0)
        tab[lights[0] * kCols + i] += x;
      else if (p.n_vpl > 0)
        tab[p.n_spheres * kCols + i - 7] += x;
    }
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
  const size_t smem = smem_bytes<kVis>(p.n_spheres, p.n_vpl, p.n_rows,
                                       p.n_lights);
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

// Dynamic shared memory and resident blocks per SM of one instantiation
// at a launch's table sizes.
template <bool kFused, bool kVis>
int resources(int n_spheres, int n_vpl, int n_rows, int n_lights,
              int* smem_out, int* blocks_out) {
  const size_t smem = smem_bytes<kVis>(n_spheres, n_vpl, n_rows, n_lights);
  *smem_out = static_cast<int>(smem);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grad_kernel<kFused, kVis>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_out, grad_kernel<kFused, kVis>, kBlock, smem));
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
  const int slots = n_lights + n_vpl;
  p.lit_words = slots > 0 ? (slots + 31) / 32 : 1;
  p.lane_offset = lane_offset;
  p.lane_total = lane_total;
  p.emission_scale = emission_scale;
  p.light_gain = light_gain;
  p.vis_tau = vis_tau;
  return p;
}

template <bool kFused>
int launch_any(const Params& p, void* stream) {
  if (p.lit_words > kLitWords || p.n_spheres > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
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

// The dynamic shared memory (bytes) and resident blocks per SM of the
// instantiation (fused, vis) at these table sizes.
extern "C" int grad_kernel_resources(int fused, int vis, int n_spheres,
                                     int n_vpl, int n_rows, int n_lights,
                                     int* smem_bytes_out,
                                     int* blocks_per_sm_out) {
  if (fused)
    return vis ? resources<true, true>(n_spheres, n_vpl, n_rows, n_lights,
                                       smem_bytes_out, blocks_per_sm_out)
               : resources<true, false>(n_spheres, n_vpl, n_rows, n_lights,
                                        smem_bytes_out, blocks_per_sm_out);
  return vis ? resources<false, true>(n_spheres, n_vpl, n_rows, n_lights,
                                      smem_bytes_out, blocks_per_sm_out)
             : resources<false, false>(n_spheres, n_vpl, n_rows, n_lights,
                                       smem_bytes_out, blocks_per_sm_out);
}

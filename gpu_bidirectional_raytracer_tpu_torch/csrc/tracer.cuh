// Device functions shared by the eye-path kernel (trace_kernel.cu), its
// adjoint (grad_kernel.cu) and the per-depth bounce and fact kernels
// (bounce_kernel.cu): the ray-sphere root, the any-hit scan, the random
// tape, shadow segments, and one depth of the eye path. All of them run
// the same forward code, so on the card the adjoint's forward sweep, the
// bounce kernel's depths and the eye-path kernel see the same bits.
//
// Expressions follow the plain PyTorch version's operation order
// (integrators/*.py, core/vecmath.py); the sources are built with
// -fmad=false and IEEE division and square root.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tracer {

constexpr int kCols = 16;          // floats per sphere row and VPL row
constexpr float kEps = 0.01f;      // EPSILON
constexpr float kBig = 1e20f;      // miss sentinel of the nearest scan
constexpr float kTiny = 1e-20f;
constexpr float kDetClamp = 1e-6f;  // tangency clamp of the root
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kFourPi = 12.566370614359172f;

// What one launch reads: the tables in shared memory and the config.
// The tape comes from one of two sources: the mix32 site keys (`keys`),
// regenerated in registers, or a streamed [K, n] buffer (`stream`, row r
// of the launch's lane i at stream[r * n + i]) that the wrapper built for
// any other key. Row r means the same draw either way.
struct Tables {
  const float* scene;     // [S, 16]: rad, p(3), e(3), c(3), refl, pad
  const float* vpl;       // [V, 16]: hp(3), rad(3), nl(3), valid, pad
  const uint32_t* keys;   // [K, 4] k0, k1, block row, 0 (mix32 only)
  const int* lights;      // [n_lights] sphere ids of the emitters
  const float* stream;    // [K, n] streamed tape, or null for mix32
  int n_spheres, n_vpl, n_lights, n_light_slots, combine_half;
  uint32_t lane_offset, lane_total, n;
  float emission_scale, light_gain;
  int direct_only;        // a diffuse vertex ends the path after its NEE
};

// The eye path between two depths.
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float tp_r, tp_g, tp_b;
  bool specular;
};

// How a depth ended.
enum : int {
  kEscaped = 0,   // no hit: the path ends, nothing at this depth
  kEmitter = 1,   // emitter hit: emission on specular chains, then it ends
  kContinue = 2,  // shaded and scattered
  kDirectEnd = 3,  // direct_only: NEE at a diffuse vertex, then it ends
};

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// v * 1 / (|v| + eps), as core/vecmath.norm.
__device__ __forceinline__ void normalize(float& x, float& y, float& z,
                                          float eps) {
  const float inv = 1.0f / (sqrtf(dot3(x, y, z, x, y, z)) + eps);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Reference quadratic with the EPSILON root choice and the 1e-6 tangency
// clamp (integrators/intersect.py::sphere_distances); 0 on a miss.
__device__ __forceinline__ float sphere_t(const float* s, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
  const float opx = s[1] - ox, opy = s[2] - oy, opz = s[3] - oz;
  const float b = dot3(opx, opy, opz, dx, dy, dz);
  const float opop = dot3(opx, opy, opz, opx, opy, opz);
  const float det = b * b - opop + s[0] * s[0];
  if (!(det >= 0.0f)) return 0.0f;
  const float sq = sqrtf(fmaxf(det, kDetClamp));
  const float t1 = b - sq;
  const float t2 = b + sq;
  return t1 > kEps ? t1 : (t2 > kEps ? t2 : 0.0f);
}

__device__ __forceinline__ bool emissive(const float* s) {
  return s[4] != 0.0f || s[5] != 0.0f || s[6] != 0.0f;
}

// Any hit with 0 < t < maxt; vacuum: emitters do not block.
__device__ __forceinline__ bool occluded(const float* scene, int n_spheres,
                                         float hx, float hy, float hz,
                                         float dx, float dy, float dz,
                                         float maxt, bool vacuum) {
#pragma unroll 1
  for (int s = 0; s < n_spheres; ++s) {
    const float* sp = scene + s * kCols;
    if (vacuum && emissive(sp)) continue;
    const float t = sphere_t(sp, hx, hy, hz, dx, dy, dz);
    if (t > 0.0f && t < maxt) return true;
  }
  return false;
}

// Tape row `row` at global lane `gl`. Streamed: the buffer's entry.
// mix32: mix32((rw * lane_total + gl) ^ k0, k1) mapped to
// (x >> 9) * 2^-23 (rng.py).
__device__ __forceinline__ float tape(const Tables& T, int row,
                                      uint32_t gl) {
  if (T.stream != nullptr)
    return T.stream[static_cast<size_t>(row) * T.n + (gl - T.lane_offset)];
  const uint32_t k0 = T.keys[4 * row], k1 = T.keys[4 * row + 1];
  const uint32_t rw = T.keys[4 * row + 2];
  uint32_t x = (rw * T.lane_total + gl) ^ k0;
  x ^= x >> 17;
  x *= 0xed5ad4bbu;
  x += k1;
  x ^= x >> 11;
  x *= 0xac4c1b51u;
  x ^= x >> 15;
  x *= 0x31848babu;
  x ^= x >> 14;
  return static_cast<float>(x >> 9) * 0x1p-23f;
}

// Unit direction, length and shadow maxt from h to a point q
// (integrators/direct.py::_segments).
__device__ __forceinline__ void segment(float qx, float qy, float qz,
                                        float hx, float hy, float hz,
                                        float& sx, float& sy, float& sz,
                                        float& len) {
  sx = qx - hx;
  sy = qy - hy;
  sz = qz - hz;
  const float len_sq = dot3(sx, sy, sz, sx, sy, sz);
  len = len_sq > 0.0f ? sqrtf(len_sq) : 0.0f;
  const float m = fmaxf(len, kTiny);
  sx = sx / m;
  sy = sy / m;
  sz = sz / m;
}

// The unit-sphere direction of light slot `slot`'s sample
// (integrators/sampling.py::uniform_sphere).
__device__ __forceinline__ void light_dir(const Tables& T, int row0, int slot,
                                          uint32_t gl, float& ux, float& uy,
                                          float& uz) {
  const float u1 = tape(T, row0 + slot, gl);
  const float u2 = tape(T, row0 + T.n_light_slots + slot, gl);
  const float zz = 1.0f - 2.0f * u1;
  const float r = sqrtf(fmaxf(1.0f - zz * zz, 0.0f));
  const float phi = kTwoPi * u2;
  ux = r * cosf(phi);
  uy = r * sinf(phi);
  uz = zz;
}

// Nearest hit: strict < from index 0 keeps the lowest index on ties.
__device__ __forceinline__ int nearest(const Tables& T, const Path& s,
                                       float& best_t) {
  best_t = kBig;
  int best = 0;
#pragma unroll 1
  for (int i = 0; i < T.n_spheres; ++i) {
    const float t = sphere_t(T.scene + i * kCols, s.ox, s.oy, s.oz, s.dx,
                             s.dy, s.dz);
    if (t > 0.0f && t < best_t) {
      best_t = t;
      best = i;
    }
  }
  return best;
}

// One depth of the eye path (integrators/path_tracer.py::trace): nearest
// hit, emission on specular chains, next-event estimation with the VPL
// gather at a diffuse vertex, then the scatter. Adds this depth's radiance
// and advances `s`; returns how the depth ended and the hit sphere. With
// `lit` non-null, bit j of lit[j / 32] is set for each light slot j, and
// bit n_lights + v for each VPL slot v, whose sample reached the vertex
// (faced it and was not occluded): the detached facts the adjoint and the
// fact kernel report. With T.direct_only a diffuse vertex returns
// kDirectEnd after its NEE, `s` untouched, as an emitter hit does.
__device__ __forceinline__ int eye_step(const Tables& T, int row0,
                                        uint32_t gl, Path& s, float& rad_r,
                                        float& rad_g, float& rad_b,
                                        int& hit, uint32_t* lit) {
  float best_t;
  const int best = nearest(T, s, best_t);
  hit = best;
  if (!(best_t < kBig)) return kEscaped;
  const float* hs = T.scene + best * kCols;
  const float dx = s.dx, dy = s.dy, dz = s.dz;

  const float hx = s.ox + best_t * dx;
  const float hy = s.oy + best_t * dy;
  const float hz = s.oz + best_t * dz;
  float nx = hx - hs[1], ny = hy - hs[2], nz = hz - hs[3];
  normalize(nx, ny, nz, 1e-20f);
  const float dp = dot3(nx, ny, nz, dx, dy, dz);
  const float flip = dp > 0.0f ? -1.0f : 1.0f;
  const float nlx = flip * nx, nly = flip * ny, nlz = flip * nz;

  if (emissive(hs)) {  // emission on specular chains, then the path ends
    if (s.specular) {
      const float g = T.emission_scale * fabsf(dp);
      rad_r = rad_r + g * hs[4] * s.tp_r;
      rad_g = rad_g + g * hs[5] * s.tp_g;
      rad_b = rad_b + g * hs[6] * s.tp_b;
    }
    return kEmitter;
  }

  const float refl = hs[10];
  const bool is_diff = refl == 0.0f;
  const float cr = hs[7], cg = hs[8], cb = hs[9];
  const int L = T.n_light_slots;

  if (is_diff) {
    // ---- next-event estimation (integrators/direct.py::sample_lights)
    float ld_r = 0.0f, ld_g = 0.0f, ld_b = 0.0f;
#pragma unroll 1
    for (int slot = 0; slot < T.n_lights; ++slot) {
      const float* ls = T.scene + T.lights[slot] * kCols;
      float ux, uy, uz;
      light_dir(T, row0, slot, gl, ux, uy, uz);
      const float lrad = ls[0];
      float sx, sy, sz, len;
      segment(ls[1] + lrad * ux, ls[2] + lrad * uy, ls[3] + lrad * uz, hx,
              hy, hz, sx, sy, sz, len);
      float wo = dot3(sx, sy, sz, ux, uy, uz);
      const bool facing = wo <= 0.0f;
      wo = -wo;
      const float wi = dot3(sx, sy, sz, nlx, nly, nlz);
      if (!(facing && wi > 0.0f)) continue;
      if (occluded(T.scene, T.n_spheres, hx, hy, hz, sx, sy, sz, len - kEps,
                   false))
        continue;
      if (lit != nullptr) lit[slot >> 5] |= 1u << (slot & 31);
      const float scale = kFourPi * lrad * lrad * wi * wo /
                          fmaxf(len * len, kTiny);
      const float gs = T.light_gain * scale;
      ld_r = ld_r + ls[4] * gs;
      ld_g = ld_g + ls[5] * gs;
      ld_b = ld_b + ls[6] * gs;
    }
    if (T.n_vpl > 0) {
      // ---- VPL gather with vacuum shadow rays
      float v_r = 0.0f, v_g = 0.0f, v_b = 0.0f;
#pragma unroll 1
      for (int v = 0; v < T.n_vpl; ++v) {
        const float* vp = T.vpl + v * kCols;
        if (!(vp[9] > 0.5f)) continue;
        float sx, sy, sz, len;
        segment(vp[0], vp[1], vp[2], hx, hy, hz, sx, sy, sz, len);
        float wo = dot3(sx, sy, sz, vp[6], vp[7], vp[8]);
        const bool facing = wo <= 0.0f;
        wo = -wo;
        const float wi = dot3(sx, sy, sz, nlx, nly, nlz);
        if (!(facing && wi > 0.0f)) continue;
        if (occluded(T.scene, T.n_spheres, hx, hy, hz, sx, sy, sz,
                     len - kEps, true))
          continue;
        if (lit != nullptr) {
          const int j = T.n_lights + v;
          lit[j >> 5] |= 1u << (j & 31);
        }
        const float w = wi * wo;
        v_r = v_r + vp[3] * w;
        v_g = v_g + vp[4] * w;
        v_b = v_b + vp[5] * w;
      }
      const float inv_k = 1.0f / static_cast<float>(T.n_vpl);
      ld_r = ld_r + v_r * inv_k;
      ld_g = ld_g + v_g * inv_k;
      ld_b = ld_b + v_b * inv_k;
      if (T.combine_half) {
        ld_r = ld_r * 0.5f;
        ld_g = ld_g * 0.5f;
        ld_b = ld_b * 0.5f;
      }
    }
    rad_r = rad_r + s.tp_r * cr * ld_r;
    rad_g = rad_g + s.tp_g * cg * ld_g;
    rad_b = rad_b + s.tp_b * cb * ld_b;
    if (T.direct_only) return kDirectEnd;
  }

  // ---- scatter (integrators/bsdf.py::scatter)
  float ndx, ndy, ndz, mul = 1.0f;
  if (is_diff) {
    const float u1 = tape(T, row0 + 2 * L, gl);
    const float u2 = tape(T, row0 + 2 * L + 1, gl);
    const bool big_x = fabsf(nlx) > 0.1f;
    const float ax = big_x ? 0.0f : 1.0f;
    const float ay = big_x ? 1.0f : 0.0f;
    const float az = 0.0f;
    float ux = ay * nlz - az * nly;
    float uy = az * nlx - ax * nlz;
    float uz = ax * nly - ay * nlx;
    normalize(ux, uy, uz, 0.0f);
    const float vx = nly * uz - nlz * uy;
    const float vy = nlz * ux - nlx * uz;
    const float vz = nlx * uy - nly * ux;
    const float r1 = kTwoPi * u1;
    const float r2s = sqrtf(u2);
    const float cw = cosf(r1) * r2s;
    const float sw = sinf(r1) * r2s;
    const float wz = sqrtf(1.0f - u2);
    ndx = cw * ux + sw * vx + wz * nlx;
    ndy = cw * uy + sw * vy + wz * nly;
    ndz = cw * uz + sw * vz + wz * nlz;
  } else {
    const float k2 = 2.0f * dot3(nx, ny, nz, dx, dy, dz);
    const float sx = dx - k2 * nx, sy = dy - k2 * ny, sz = dz - k2 * nz;
    ndx = sx;
    ndy = sy;
    ndz = sz;
    if (refl != 1.0f) {  // glass: Fresnel dielectric with Russian roulette
      const bool into = dot3(nx, ny, nz, nlx, nly, nlz) > 0.0f;
      const float nnt = into ? (1.0f / 1.5f) : 1.5f;
      const float ddn = dot3(dx, dy, dz, nlx, nly, nlz);
      const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
      if (cos2t >= 0.0f) {  // else total internal reflection: mirror
        const float sq = cos2t > 0.0f ? sqrtf(cos2t) : 0.0f;
        const float kk = (into ? 1.0f : -1.0f) * (ddn * nnt + sq);
        float tx = nnt * dx - kk * nx;
        float ty = nnt * dy - kk * ny;
        float tz = nnt * dz - kk * nz;
        normalize(tx, ty, tz, 0.0f);
        const float r0 = 0.04f;
        const float c1 = 1.0f - (into ? -ddn : dot3(tx, ty, tz, nx, ny, nz));
        const float c2 = c1 * c1;
        const float re = r0 + 0.96f * (c1 * (c2 * c2));
        const float pr = 0.25f + 0.5f * re;
        const float urr = tape(T, row0 + 2 * L + 2, gl);
        if (urr < pr) {
          mul = re / pr;
        } else {
          ndx = tx;
          ndy = ty;
          ndz = tz;
          mul = (1.0f - re) / (1.0f - pr);
        }
      }
    }
  }
  s.ox = hx;
  s.oy = hy;
  s.oz = hz;
  s.dx = ndx;
  s.dy = ndy;
  s.dz = ndz;
  s.tp_r = s.tp_r * (cr * mul);
  s.tp_g = s.tp_g * (cg * mul);
  s.tp_b = s.tp_b * (cb * mul);
  s.specular = !is_diff;
  return kContinue;
}

}  // namespace tracer

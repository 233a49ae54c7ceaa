// Eye-path megakernel for Hopper (sm_90a): one thread per pixel or ray.
//
// Replaces the TPU kernel gpu_bidirectional_raytracer_tpu/ops/pallas_trace.py
// ::_kernel (the pallas_call of trace_pallas_camera, camera mode, and of
// trace_pallas, ray mode). It computes the same estimator as the port's
// plain version (integrators/path_tracer.py::trace after camera.primary_rays):
// up to max_depth bounces of nearest hit, emission on specular chains,
// next-event estimation to every light, the vacuum-shadowed VPL-window
// gather with the (direct + vpl) / 2 combine, and diffuse / mirror /
// Fresnel-glass scatter. The mix32 random tape is regenerated in registers
// from per-row site keys (k0, k1, block row) with native uint32 arithmetic,
// bit for bit the tape of rng.site_uniforms.
//
// Design for the GPU rather than the TPU's (rows, 128) planes:
// - one thread per pixel, guarded by idx < n, so nothing is padded;
// - a lane whose path has ended leaves the bounce loop (the plain version
//   masks such lanes, with the same result), and each branch of the scatter
//   and each shadow ray is evaluated only where its result is used;
// - the sphere table, the VPL window and the tape keys sit in shared memory;
// - loops over depth, spheres, lights and VPLs stay rolled (#pragma unroll 1)
//   so the build takes seconds.
// Expressions follow the plain version's operation order, and the library is
// built with -fmad=false and IEEE division and square root, so on the card
// the kernel and the plain version agree bit for bit on almost every pixel.
//
// Bound: FP32 ALU. Per live ray segment it evaluates S sphere roots, and at
// each diffuse vertex (L + V) shadow rays of S roots more; its memory traffic
// is the 12-byte radiance of each pixel (about 3 MB at 512x512) and a few KB
// of tables.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/_build.py; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;          // floats per sphere row and VPL row
constexpr float kEps = 0.01f;      // EPSILON
constexpr float kBig = 1e20f;      // miss sentinel of the nearest scan
constexpr float kTiny = 1e-20f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kFourPi = 12.566370614359172f;

struct Params {
  const float* scene;     // [S, 16]: rad, p(3), e(3), c(3), refl, pad
  const float* vpl;       // [V, 16]: hp(3), rad(3), nl(3), valid, pad
  const uint32_t* keys;   // [K, 4] k0, k1, block row, 0; then light ids
  const float* cam;       // [32]: x_hat, y_hat, d_hat, orig, temp, film, jitter
  const float* rays_o;    // [n, 3] (ray mode)
  const float* rays_d;    // [n, 3] (ray mode)
  float* out;             // [n, 3] radiance
  int n_spheres, n_vpl, n_rows, n, width, cam_mode, cam_rows;
  int max_depth, n_lights, n_light_slots, combine_half;
  uint32_t lane_offset, lane_total;
  float emission_scale, light_gain;
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
  const float sq = sqrtf(fmaxf(det, 1e-6f));
  const float t1 = b - sq;
  const float t2 = b + sq;
  return t1 > kEps ? t1 : (t2 > kEps ? t2 : 0.0f);
}

__device__ __forceinline__ bool emissive(const float* s) {
  return s[4] != 0.0f || s[5] != 0.0f || s[6] != 0.0f;
}

// Any hit with 0 < t < maxt; vacuum: emitters do not block.
__device__ bool occluded(const float* scene, int n_spheres, float hx,
                         float hy, float hz, float dx, float dy, float dz,
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

// Tape row `row` at global lane `gl`: mix32((rw * lane_total + gl) ^ k0, k1)
// mapped to (x >> 9) * 2^-23 (rng.py).
__device__ __forceinline__ float tape(const uint32_t* keys, int row,
                                      uint32_t gl, uint32_t lane_total) {
  const uint32_t k0 = keys[4 * row], k1 = keys[4 * row + 1];
  const uint32_t rw = keys[4 * row + 2];
  uint32_t x = (rw * lane_total + gl) ^ k0;
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

__global__ void trace_kernel(Params p) {
  extern __shared__ float smem[];
  float* scene = smem;
  float* vpl = scene + p.n_spheres * kCols;
  uint32_t* keys = reinterpret_cast<uint32_t*>(vpl + p.n_vpl * kCols);
  for (int i = threadIdx.x; i < p.n_spheres * kCols; i += blockDim.x)
    scene[i] = p.scene[i];
  for (int i = threadIdx.x; i < p.n_vpl * kCols; i += blockDim.x)
    vpl[i] = p.vpl[i];
  for (int i = threadIdx.x; i < p.n_rows * 4 + p.n_lights; i += blockDim.x)
    keys[i] = p.keys[i];
  const int* lights = reinterpret_cast<const int*>(keys + p.n_rows * 4);
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const uint32_t gl = static_cast<uint32_t>(idx) + p.lane_offset;
  const uint32_t lt = p.lane_total;

  float ox, oy, oz, dx, dy, dz;
  if (p.cam_mode) {
    // camera.primary_rays: film coords, homogeneous divide, origin shift.
    const float* c = p.cam;
    float ju = tape(keys, 0, gl, lt);
    float jv = tape(keys, 1, gl, lt);
    if (c[23] > 0.0f) {  // stratified jitter: (s + u) * (1/k)
      ju = (c[20] + ju) * c[22];
      jv = (c[21] + jv) * c[22];
    }
    const float px = static_cast<float>(idx % p.width);
    const float py = static_cast<float>(idx / p.width);
    const float kx = px * c[15] - c[16] + ju * c[15];
    const float ky = py * c[17] - c[18] + jv * c[17];
    const float kz = 10.0f;
    float rx = kx * c[0] + ky * c[3] + kz * c[6];
    float ry = kx * c[1] + ky * c[4] + kz * c[7];
    float rz = kx * c[2] + ky * c[5] + kz * c[8];
    const float w = kx * c[12] + ky * c[13] + kz * c[14] + 1.0f;
    rx = rx / w;
    ry = ry / w;
    rz = rz / w;
    ox = c[9] + rx;
    oy = c[10] + ry;
    oz = c[11] + rz;
    dx = rx;
    dy = ry;
    dz = rz;
    normalize(dx, dy, dz, 0.0f);
  } else {
    ox = p.rays_o[3 * idx];
    oy = p.rays_o[3 * idx + 1];
    oz = p.rays_o[3 * idx + 2];
    dx = p.rays_d[3 * idx];
    dy = p.rays_d[3 * idx + 1];
    dz = p.rays_d[3 * idx + 2];
  }

  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  float tp_r = 1.0f, tp_g = 1.0f, tp_b = 1.0f;
  bool specular = true;
  const int L = p.n_light_slots;
  const int per_depth = 2 * L + 3;

#pragma unroll 1
  for (int depth = 0; depth < p.max_depth; ++depth) {
    const int row0 = p.cam_rows + depth * per_depth;

    // Nearest hit: strict < from index 0 keeps the lowest index on ties.
    float best_t = kBig;
    int best = 0;
#pragma unroll 1
    for (int s = 0; s < p.n_spheres; ++s) {
      const float t = sphere_t(scene + s * kCols, ox, oy, oz, dx, dy, dz);
      if (t > 0.0f && t < best_t) {
        best_t = t;
        best = s;
      }
    }
    if (!(best_t < kBig)) break;  // escaped: the path ends
    const float* hs = scene + best * kCols;

    const float hx = ox + best_t * dx;
    const float hy = oy + best_t * dy;
    const float hz = oz + best_t * dz;
    float nx = hx - hs[1], ny = hy - hs[2], nz = hz - hs[3];
    normalize(nx, ny, nz, 1e-20f);
    const float dp = dot3(nx, ny, nz, dx, dy, dz);
    const float flip = dp > 0.0f ? -1.0f : 1.0f;
    const float nlx = flip * nx, nly = flip * ny, nlz = flip * nz;

    if (emissive(hs)) {  // emission on specular chains, then the path ends
      if (specular) {
        const float g = p.emission_scale * fabsf(dp);
        rad_r = rad_r + g * hs[4] * tp_r;
        rad_g = rad_g + g * hs[5] * tp_g;
        rad_b = rad_b + g * hs[6] * tp_b;
      }
      break;
    }

    const float refl = hs[10];
    const bool is_diff = refl == 0.0f;
    const float cr = hs[7], cg = hs[8], cb = hs[9];

    if (is_diff) {
      // ---- next-event estimation (integrators/direct.py::sample_lights)
      float ld_r = 0.0f, ld_g = 0.0f, ld_b = 0.0f;
#pragma unroll 1
      for (int slot = 0; slot < p.n_lights; ++slot) {
        const float* ls = scene + lights[slot] * kCols;
        const float u1 = tape(keys, row0 + slot, gl, lt);
        const float u2 = tape(keys, row0 + L + slot, gl, lt);
        const float zz = 1.0f - 2.0f * u1;
        const float r = sqrtf(fmaxf(1.0f - zz * zz, 0.0f));
        const float phi = kTwoPi * u2;
        const float ux = r * cosf(phi), uy = r * sinf(phi), uz = zz;
        const float lrad = ls[0];
        float sx, sy, sz, len;
        segment(ls[1] + lrad * ux, ls[2] + lrad * uy, ls[3] + lrad * uz,
                hx, hy, hz, sx, sy, sz, len);
        float wo = dot3(sx, sy, sz, ux, uy, uz);
        const bool facing = wo <= 0.0f;
        wo = -wo;
        const float wi = dot3(sx, sy, sz, nlx, nly, nlz);
        if (!(facing && wi > 0.0f)) continue;
        if (occluded(scene, p.n_spheres, hx, hy, hz, sx, sy, sz, len - kEps,
                     false))
          continue;
        const float scale = kFourPi * lrad * lrad * wi * wo /
                            fmaxf(len * len, kTiny);
        const float gs = p.light_gain * scale;
        ld_r = ld_r + ls[4] * gs;
        ld_g = ld_g + ls[5] * gs;
        ld_b = ld_b + ls[6] * gs;
      }
      if (p.n_vpl > 0) {
        // ---- VPL gather with vacuum shadow rays
        float v_r = 0.0f, v_g = 0.0f, v_b = 0.0f;
#pragma unroll 1
        for (int v = 0; v < p.n_vpl; ++v) {
          const float* vp = vpl + v * kCols;
          if (!(vp[9] > 0.5f)) continue;
          float sx, sy, sz, len;
          segment(vp[0], vp[1], vp[2], hx, hy, hz, sx, sy, sz, len);
          float wo = dot3(sx, sy, sz, vp[6], vp[7], vp[8]);
          const bool facing = wo <= 0.0f;
          wo = -wo;
          const float wi = dot3(sx, sy, sz, nlx, nly, nlz);
          if (!(facing && wi > 0.0f)) continue;
          if (occluded(scene, p.n_spheres, hx, hy, hz, sx, sy, sz,
                       len - kEps, true))
            continue;
          const float w = wi * wo;
          v_r = v_r + vp[3] * w;
          v_g = v_g + vp[4] * w;
          v_b = v_b + vp[5] * w;
        }
        const float inv_k = 1.0f / static_cast<float>(p.n_vpl);
        ld_r = ld_r + v_r * inv_k;
        ld_g = ld_g + v_g * inv_k;
        ld_b = ld_b + v_b * inv_k;
        if (p.combine_half) {
          ld_r = ld_r * 0.5f;
          ld_g = ld_g * 0.5f;
          ld_b = ld_b * 0.5f;
        }
      }
      rad_r = rad_r + tp_r * cr * ld_r;
      rad_g = rad_g + tp_g * cg * ld_g;
      rad_b = rad_b + tp_b * cb * ld_b;
    }

    // ---- scatter (integrators/bsdf.py::scatter)
    float ndx, ndy, ndz, mul = 1.0f;
    if (is_diff) {
      const float u1 = tape(keys, row0 + 2 * L, gl, lt);
      const float u2 = tape(keys, row0 + 2 * L + 1, gl, lt);
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
          const float urr = tape(keys, row0 + 2 * L + 2, gl, lt);
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
    ox = hx;
    oy = hy;
    oz = hz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    tp_r = tp_r * (cr * mul);
    tp_g = tp_g * (cg * mul);
    tp_b = tp_b * (cb * mul);
    specular = !is_diff;
  }

  p.out[3 * idx] = rad_r;
  p.out[3 * idx + 1] = rad_g;
  p.out[3 * idx + 2] = rad_b;
}

}  // namespace

extern "C" int trace_kernel_launch(
    const void* scene, int n_spheres, const void* vpl, int n_vpl,
    const void* keys, int n_rows, int n_lights, const void* cam,
    const void* rays_o, const void* rays_d, int n, int width, int cam_rows, int max_depth,
    int n_light_slots, int combine_half,
    unsigned int lane_offset, unsigned int lane_total, float emission_scale,
    float light_gain, void* out, void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.scene = static_cast<const float*>(scene);
  p.vpl = static_cast<const float*>(vpl);
  p.keys = static_cast<const uint32_t*>(keys);
  p.cam = static_cast<const float*>(cam);
  p.rays_o = static_cast<const float*>(rays_o);
  p.rays_d = static_cast<const float*>(rays_d);
  p.out = static_cast<float*>(out);
  p.n_spheres = n_spheres;
  p.n_vpl = n_vpl;
  p.n_rows = n_rows;
  p.n = n;
  p.width = width;
  p.cam_mode = cam != nullptr;
  p.cam_rows = cam_rows;
  p.max_depth = max_depth;
  p.n_lights = n_lights;
  p.n_light_slots = n_light_slots;
  p.combine_half = combine_half;
  p.lane_offset = lane_offset;
  p.lane_total = lane_total;
  p.emission_scale = emission_scale;
  p.light_gain = light_gain;
  const size_t smem =
      sizeof(float) * (n_spheres + n_vpl) * kCols +
      sizeof(uint32_t) * (4 * n_rows + n_lights);
  const int block = 128;
  const int grid = (n + block - 1) / block;
  trace_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

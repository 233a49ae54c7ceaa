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
// bit for bit the tape of rng.site_uniforms; any other tape (threefry)
// comes streamed as a [K, n] buffer that the wrapper built with
// rng.site_uniforms (tracer.cuh's tape()).
//
// Design for the GPU rather than the TPU's (rows, 128) planes:
// - one thread per pixel, guarded by idx < n, so nothing is padded;
// - a lane whose path has ended leaves the bounce loop (the plain version
//   masks such lanes, with the same result), and each branch of the scatter
//   and each shadow ray is evaluated only where its result is used;
// - the scans read tracer.cuh's packed tables in shared memory, a float4
//   {p, r*r} a sphere, and for the VPLs' vacuum shadow rays a copy without
//   the emitters, so a root takes one 16-byte shared load and no emitter
//   test; each thread takes four spheres at a time, four independent roots
//   in flight, in index order with strict < (GroupScan<1>), so the
//   nearest hit is the serial scan's and the any-hit its OR. The [S, 16]
//   scene table beside them serves the shading, the VPL window and the
//   tape keys sit in shared memory too;
// - loops over depth, spheres, lights and VPLs stay rolled (#pragma unroll 1)
//   so the build takes seconds.
// Expressions follow the plain version's operation order, and the library is
// built with -fmad=false and IEEE division and square root, so on the card
// the kernel and the plain version agree bit for bit. The depth step is
// tracer.cuh's eye_step, shared with the adjoint (grad_kernel.cu, which
// scans per thread over the scene table: the same roots, the same bits).
//
// Bound: FP32 ALU. Per live ray segment it evaluates S sphere roots, and at
// each diffuse vertex (L + V) shadow rays of up to S roots more; its memory
// traffic is the 12-byte radiance of each pixel (about 3 MB at 512x512) and
// a few KB of tables. Without contraction into FMA and with IEEE square
// roots a root takes 47.5 SASS instructions in a four-root round, not the
// 20 operations the FLOP bound counts; on one H100 the roots' issue time is
// still well under the kernel's, which next-event estimation (about half)
// and warp divergence (about a fifth) hold (PERF.md).
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/_build.py; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

using namespace tracer;

struct Params {
  const float* scene;     // [S, 16]: rad, p(3), e(3), c(3), refl, pad
  const float* vpl;       // [V, 16]: hp(3), rad(3), nl(3), valid, pad
  const uint32_t* keys;   // [K, 4] k0, k1, block row, 0; then light ids
  const float* tape;      // [K, n] streamed tape, or null (mix32 keys)
  const float* cam;       // [32]: x_hat, y_hat, d_hat, orig, temp, film, jitter
  const float* rays_o;    // [n, 3] (ray mode)
  const float* rays_d;    // [n, 3] (ray mode)
  float* out;             // [n, 3] radiance
  int n_spheres, n_vpl, n_rows, n, width, cam_mode, cam_rows;
  int max_depth, n_lights, n_light_slots, combine_half;
  uint32_t lane_offset, lane_total;
  float emission_scale, light_gain;
};

// Dynamic shared memory of a launch: the two packed scan tables, the scene
// table, the VPL window, the tape keys and light ids, the loader's scratch.
size_t smem_bytes(int n_spheres, int n_vpl, int n_rows, int n_lights) {
  return sizeof(float4) * 2 * static_cast<size_t>(n_spheres) +
         sizeof(float) * static_cast<size_t>(n_spheres + n_vpl) * kCols +
         sizeof(uint32_t) * (4 * static_cast<size_t>(n_rows) + n_lights +
                             2 * ((n_spheres + 31) / 32));
}

__global__ void trace_kernel(Params p) {
  extern __shared__ float4 smem[];
  float4* spheres = smem;                    // [S] packed
  float4* solid = spheres + p.n_spheres;     // [S] the non-emitters
  float* scene = reinterpret_cast<float*>(solid + p.n_spheres);
  float* vpl = scene + p.n_spheres * kCols;
  uint32_t* keys = reinterpret_cast<uint32_t*>(vpl + p.n_vpl * kCols);
  uint32_t* scratch = keys + p.n_rows * 4 + p.n_lights;
  for (int i = threadIdx.x; i < p.n_spheres * kCols; i += blockDim.x)
    scene[i] = p.scene[i];
  for (int i = threadIdx.x; i < p.n_vpl * kCols; i += blockDim.x)
    vpl[i] = p.vpl[i];
  for (int i = threadIdx.x; i < p.n_rows * 4 + p.n_lights; i += blockDim.x)
    keys[i] = p.keys[i];
  // Ends with a barrier, after which every table above is in place.
  const int n_solid = load_scan_tables(p.scene, p.n_spheres, spheres, solid,
                                       scratch);
  const int* lights = reinterpret_cast<const int*>(keys + p.n_rows * 4);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n) return;
  const uint32_t gl = static_cast<uint32_t>(idx) + p.lane_offset;
  const Tables T{scene, vpl, keys, lights, p.tape, p.n_spheres, p.n_vpl,
                 p.n_lights, p.n_light_slots, p.combine_half, p.lane_offset,
                 p.lane_total, static_cast<uint32_t>(p.n),
                 p.emission_scale, p.light_gain, 0};

  float ox, oy, oz, dx, dy, dz;
  if (p.cam_mode) {
    // camera.primary_rays: film coords, homogeneous divide, origin shift.
    const float* c = p.cam;
    float ju = tape(T, 0, gl);
    float jv = tape(T, 1, gl);
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

  Path s{ox, oy, oz, dx, dy, dz, 1.0f, 1.0f, 1.0f, true};
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  const int per_depth = 2 * p.n_light_slots + 3;
  const GroupScan<1> scan{spheres, solid, p.n_spheres, n_solid,
                          group_mask<1>(), 0};

#pragma unroll 1
  for (int depth = 0; depth < p.max_depth; ++depth) {
    int hit;
    if (eye_step(T, p.cam_rows + depth * per_depth, gl, s, rad_r, rad_g,
                 rad_b, hit, nullptr, nullptr, scan) != kContinue)
      break;
  }

  p.out[3 * idx] = rad_r;
  p.out[3 * idx + 1] = rad_g;
  p.out[3 * idx + 2] = rad_b;
}

}  // namespace

extern "C" int trace_kernel_launch(
    const void* scene, int n_spheres, const void* vpl, int n_vpl,
    const void* keys, int n_rows, const void* tape, int n_lights,
    const void* cam, const void* rays_o, const void* rays_d, int n,
    int width, int cam_rows, int max_depth, int n_light_slots,
    int combine_half, unsigned int lane_offset, unsigned int lane_total,
    float emission_scale, float light_gain, void* out, int block,
    void* stream) {
  if (n <= 0) return 0;
  if (block <= 0 || block > 1024 || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.scene = static_cast<const float*>(scene);
  p.vpl = static_cast<const float*>(vpl);
  p.keys = static_cast<const uint32_t*>(keys);
  p.tape = static_cast<const float*>(tape);
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
  const size_t smem = smem_bytes(n_spheres, n_vpl, n_rows, n_lights);
  if (smem > 48 * 1024) {   // opt in to the block's 227 KB
    const cudaError_t err = cudaFuncSetAttribute(
        trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n + block - 1) / block;
  trace_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory and resident blocks per SM of a launch of
// `block` threads with these table sizes.
extern "C" int trace_kernel_resources(int n_spheres, int n_vpl, int n_rows,
                                      int n_lights, int block,
                                      int* smem_bytes_out,
                                      int* blocks_per_sm_out) {
  const size_t smem = smem_bytes(n_spheres, n_vpl, n_rows, n_lights);
  *smem_bytes_out = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm_out, trace_kernel, block, smem));
}

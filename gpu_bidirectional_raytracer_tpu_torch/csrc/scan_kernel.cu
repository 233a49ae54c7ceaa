// Per-bounce sphere-scan kernels for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the per-bounce scan route
// (integrators/path_tracer.py::trace with scan_backend="pallas"), where the
// tracer keeps the bounce loop in PyTorch and each depth runs three scans:
// - nearest_kernel_launch: gpu_bidirectional_raytracer_tpu/ops/
//   pallas_scan.py::_nearest_kernel. The nearest hit of each ray (strict <
//   from sphere 0, so ties keep the lowest index) with a fused gather of
//   the winning sphere's attributes: t, the id, p, e, c (nine float planes)
//   and refl (int32). A miss gives t = 1e20, id 0 and zero attributes.
//   One thread per lane.
// - anyhit_kernel_launch: ops/pallas_scan.py::_anyhit_kernel. Whether any
//   sphere has 0 < t < maxt along a shadow segment; in vacuum mode
//   emitters do not block (the VPL gather's shadow rays). A group of G
//   lanes per ray; the scan stops at the round of the first blocker, which
//   gives the answer of JAX's OR over all spheres.
//
// Both reuse tracer.cuh's root (sphere_t through nearest(); sphere_t4
// through occluded_group()), the code of the other kernels, so a scan here
// sees the bits the bounce kernel sees for the same ray.
//
// The skip rules. The TPU kernels skip a whole 1024-lane tile when none of
// its lanes is alive (nearest) or active (any-hit); a skipped lane reports
// a miss or no occlusion. The nearest kernel's unit is a warp (32 lanes,
// __any_sync), and a block with no live lane also skips the copy of the
// sphere table; lanes of a live warp are scanned whether they are alive or
// not, as the TPU kernel scans every lane of a live tile, so its outputs
// are those of the plain version (ops/pallas_scan.py, tile=32) on every
// lane. The any-hit kernel's unit is the ray: an inactive lane reports
// unoccluded, the plain version with tile=1. Active lanes do not depend on
// the unit, and every caller masks with `active`.
//
// Bound. The nearest kernel: FP32 ALU, S roots per live lane (about 20
// operations each); bytes 25 in and 48 out per lane. The any-hit kernel:
// the bytes, 29 in and 1 out per lane, since few lanes are active past the
// first depth (45.6% at the first, under 10% after, on complex.scn) and
// each active ray tests spheres only up to its first blocker; what holds
// it is the latency of one ray's dependent chain of roots.
//
// Design for the GPU. The nearest kernel: the sphere table [S, 16]
// (complex.scn: 783 spheres, 50,112 bytes) sits in dynamic shared memory,
// opted in above 48 KB with cudaFuncSetAttribute; rays come as the tracer
// holds them, [n, 3] origins and directions; outputs are planes, so a
// warp's stores are contiguous. The any-hit kernel: G lanes per ray (a
// power of two up to 32) over a packed table in shared memory, a float4
// {p, r*r} a sphere (in vacuum mode the non-emitters only), 12.5 KB for
// complex.scn; lane j tests spheres j, j + G, ..., four at a time, and
// the group votes after each four rounds (tracer.cuh's occluded_group),
// so a ray's chain of S roots becomes S / 4G. Persistent blocks of 1,024
// threads (the wrapper's default), as many as the
// SMs hold at once, load the table once each; each reads the active
// flags of its chunks of 32 contiguous segments, lists the active ones
// and spreads them over its groups (tracer.cuh's for_each_live_ray), so
// an inactive segment costs one flag and one store. A table above the
// block's 227 KB makes a launch fail with an error.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/_build.py; each launch returns its CUDA error (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

using namespace tracer;

constexpr size_t kMaxSmem = 232448;
constexpr unsigned kWarp = 0xffffffffu;
constexpr int kAttrs = 9;   // p(3), e(3), c(3): table columns 1..9

// The sphere table into shared memory; every thread of the block calls it.
__device__ __forceinline__ void load_table(float* table, const float* scene,
                                           int n_spheres) {
  for (int i = threadIdx.x; i < n_spheres * kCols; i += blockDim.x)
    table[i] = scene[i];
  __syncthreads();
}

__device__ __forceinline__ void write_miss(int idx, size_t n, float* t,
                                           int* id, float* attr,
                                           int* refl) {
  t[idx] = kBig;
  id[idx] = 0;
  for (int k = 0; k < kAttrs; ++k) attr[k * n + idx] = 0.0f;
  refl[idx] = 0;
}

__global__ void nearest_kernel(const float* __restrict__ scene_g,
                               int n_spheres, const float* __restrict__ o,
                               const float* __restrict__ d,
                               const uint8_t* __restrict__ alive, int n_int,
                               float* __restrict__ t_out,
                               int* __restrict__ id_out,
                               float* __restrict__ attr,
                               int* __restrict__ refl_out) {
  extern __shared__ float table[];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = static_cast<size_t>(n_int);
  const bool in = idx < n_int;
  const bool live = in && alive[idx] != 0;
  if (!__syncthreads_or(live)) {   // no live lane in the block
    if (in) write_miss(idx, n, t_out, id_out, attr, refl_out);
    return;
  }
  load_table(table, scene_g, n_spheres);
  if (!__any_sync(kWarp, live)) {  // no live lane in the warp
    if (in) write_miss(idx, n, t_out, id_out, attr, refl_out);
    return;
  }
  if (!in) return;

  Tables T{};
  T.scene = table;
  T.n_spheres = n_spheres;
  Path s{};
  s.ox = o[3 * idx];
  s.oy = o[3 * idx + 1];
  s.oz = o[3 * idx + 2];
  s.dx = d[3 * idx];
  s.dy = d[3 * idx + 1];
  s.dz = d[3 * idx + 2];
  float best_t;
  const int best = nearest(T, s, best_t);
  const bool hit = best_t < kBig;
  const float* w = table + best * kCols;
  t_out[idx] = best_t;
  id_out[idx] = best;
  for (int k = 0; k < kAttrs; ++k) attr[k * n + idx] = hit ? w[1 + k] : 0.0f;
  refl_out[idx] = hit ? static_cast<int>(w[10]) : 0;
}

template <int G>
__global__ void anyhit_kernel(const float* __restrict__ scene_g,
                              int n_spheres, const float* __restrict__ o,
                              const float* __restrict__ d,
                              const float* __restrict__ maxt,
                              const uint8_t* __restrict__ active, int n,
                              int vacuum, uint8_t* __restrict__ occ) {
  extern __shared__ float4 packed[];
  float4* spheres = packed;             // [S]
  float4* solid = spheres + n_spheres;  // [S] in vacuum mode
  uint32_t* scratch =
      reinterpret_cast<uint32_t*>(vacuum ? solid + n_spheres : solid);
  const int n_solid = load_scan_tables(scene_g, n_spheres, spheres,
                                       vacuum ? solid : nullptr, scratch);
  const float4* table = vacuum ? solid : spheres;
  const int n_table = vacuum ? n_solid : n_spheres;

  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const unsigned mask = group_mask<G>();
  for_each_live_ray<G>(
      n, reinterpret_cast<int*>(scratch + 2 * ((n_spheres + 31) / 32)),
      [&](int ray) { return active[ray] != 0; },
      [&](int ray) { occ[ray] = 0; },
      [&](int ray) {
        const bool blocked = occluded_group<G>(
            table, n_table, mask, lane, o[3 * ray], o[3 * ray + 1],
            o[3 * ray + 2], d[3 * ray], d[3 * ray + 1], d[3 * ray + 2],
            maxt[ray]);
        if (lane == 0) occ[ray] = blocked ? 1 : 0;
      });
}

// Dynamic shared memory of an any-hit launch: the packed table (and its
// vacuum copy), the loader's scratch words, the block's list of rays.
size_t anyhit_smem(int n_spheres, int vacuum, int block) {
  return sizeof(float4) * (vacuum ? 2 : 1) * static_cast<size_t>(n_spheres) +
         sizeof(uint32_t) * (2 * ((n_spheres + 31) / 32) +
                             live_list_rounds(block) * block + 32);
}

// Checks the launch shape and opts in to the table's shared memory.
template <typename Kernel>
int prepare(Kernel kernel, int n_spheres, int block, size_t& smem) {
  smem = sizeof(float) * static_cast<size_t>(n_spheres) * kCols;
  if (n_spheres < 0 || smem > kMaxSmem || block <= 0 || block > 1024 ||
      block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  return 0;
}

}  // namespace

extern "C" int nearest_kernel_launch(const void* scene, int n_spheres,
                                     const void* o, const void* d,
                                     const void* alive, int n, void* t,
                                     void* id, void* attr, void* refl,
                                     int block, void* stream) {
  if (n <= 0) return 0;
  size_t smem;
  const int err = prepare(nearest_kernel, n_spheres, block, smem);
  if (err != 0) return err;
  nearest_kernel<<<(n + block - 1) / block, block, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scene), n_spheres,
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const uint8_t*>(alive), n, static_cast<float*>(t),
      static_cast<int*>(id), static_cast<float*>(attr),
      static_cast<int*>(refl));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int anyhit_kernel_launch(const void* scene, int n_spheres,
                                    const void* o, const void* d,
                                    const void* maxt, const void* active,
                                    int n, int vacuum, void* occ, int block,
                                    int group, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = anyhit_smem(n_spheres, vacuum, block);
  if (n_spheres < 0 || block <= 0 || block > 1024 || block % 32 != 0 ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    int grid = 0, per_sm = 0;
    const int err = persistent_grid(anyhit_kernel<G>, n, block, smem, &grid,
                                    &per_sm);
    if (err != 0) return err;
    anyhit_kernel<G><<<grid, block, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scene), n_spheres,
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(maxt), static_cast<const uint8_t*>(active),
        n, vacuum, static_cast<uint8_t*>(occ));
    return static_cast<int>(cudaGetLastError());
  });
}

// The dynamic shared memory and resident blocks per SM of an any-hit
// launch at `group` lanes a segment.
extern "C" int anyhit_kernel_resources(int group, int n_spheres, int vacuum,
                                       int block, int* smem_bytes_out,
                                       int* blocks_per_sm_out) {
  const size_t smem = anyhit_smem(n_spheres, vacuum, block);
  *smem_bytes_out = static_cast<int>(smem);
  return with_group(group, [&](auto g) {
    int grid = 0;
    return persistent_grid(anyhit_kernel<decltype(g)::value>, 1 << 30,
                           block, smem, &grid, blocks_per_sm_out);
  });
}

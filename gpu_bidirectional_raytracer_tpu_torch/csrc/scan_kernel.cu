// Per-bounce sphere-scan kernels for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the per-bounce scan route
// (integrators/path_tracer.py::trace with scan_backend="pallas"), where the
// tracer keeps the bounce loop in PyTorch and each depth runs three scans:
// - nearest_kernel_launch: gpu_bidirectional_raytracer_tpu/ops/
//   pallas_scan.py::_nearest_kernel. The nearest hit of each ray (strict <
//   in index order, so ties keep the lowest index) with a fused gather of
//   the winning sphere's attributes: t, the id, p, e, c (nine float planes)
//   and refl (int32). A miss gives t = 1e20, id 0 and zero attributes.
// - anyhit_kernel_launch: ops/pallas_scan.py::_anyhit_kernel. Whether any
//   sphere has 0 < t < maxt along a shadow segment; in vacuum mode
//   emitters do not block (the VPL gather's shadow rays). The scan stops
//   at the round of the first blocker, which gives the answer of JAX's OR
//   over all spheres.
//
// Both take a group of G lanes of a warp per ray (a power of two up to 32)
// over tracer.cuh's packed table, a float4 {p, r*r} a sphere: lane j tests
// spheres j, j + G, ..., four at a time, so a ray's chain of S dependent
// roots becomes S / 4G. The nearest hit is the least (t, index) pair over
// the group's lanes (nearest_group), the any-hit a vote of the group after
// each four rounds (occluded_group). r*r is the per-thread root's one
// rounding, so a scan here sees the bits the other kernels see for the
// same ray.
//
// The skip rules. The TPU kernels skip a whole 1024-lane tile when none of
// its lanes is alive (nearest) or active (any-hit); a skipped lane reports
// a miss or no occlusion. Here the unit is the ray: a lane that is not
// alive reports a miss, one that is not active unoccluded, the plain
// versions with tile=1 (ops/pallas_scan.py), so on every lane the outputs
// are the plain version's bits. Live lanes do not depend on the unit, and
// every caller masks with `alive` or `active`.
//
// Bound. The nearest kernel: FP32 ALU, S roots per live lane (about 20
// operations each; without contraction into FMA and with IEEE square
// roots 46 SASS instructions in a four-root round, fewer for a miss);
// bytes 25 in and 48 out per lane. The
// any-hit kernel: the bytes, 29 in and 1 out per lane, since few lanes are
// active past the first depth (45.6% at the first, under 10% after, on
// complex.scn) and each active ray tests spheres only up to its first
// blocker. Past the first depths both are held by the latency of one
// ray's dependent chain of roots, which the group shortens.
//
// Design for the GPU: persistent blocks, as many as the SMs hold at once
// (tracer.cuh's persistent_grid), each loading the packed table once into
// shared memory (complex.scn: 12.5 KB; the any-hit kernel's vacuum mode
// keeps a second copy without the emitters). Each block reads the flags of
// its chunks of 32 contiguous rays, lists the live ones and deals them out
// to its groups (for_each_live_ray), so a dead ray costs one flag and its
// stores, and one live ray no longer makes a whole warp scan. The nearest
// kernel reads the winner's attributes from the [S, 16] table in global
// memory through the read-only path, once a ray, and spreads the 12
// output stores over the group's lanes; outputs are planes, so the
// stores of neighbouring rays are contiguous. A table above the block's
// 227 KB makes a launch fail with an error.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/_build.py; each launch returns its CUDA error (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

using namespace tracer;

constexpr size_t kMaxSmem = 232448;
constexpr int kAttrs = 9;   // p(3), e(3), c(3): table columns 1..9

__device__ __forceinline__ void write_miss(int idx, size_t n, float* t,
                                           int* id, float* attr,
                                           int* refl) {
  t[idx] = kBig;
  id[idx] = 0;
  for (int k = 0; k < kAttrs; ++k) attr[k * n + idx] = 0.0f;
  refl[idx] = 0;
}

// Shared ints of a block's scan-table scratch words and live-ray list.
__host__ __device__ constexpr int scratch_words(int n_spheres, int block) {
  return 2 * ((n_spheres + 31) / 32) + live_list_rounds(block) * block + 32;
}

template <int G>
__global__ void nearest_kernel(const float* __restrict__ scene_g,
                               int n_spheres, const float* __restrict__ o,
                               const float* __restrict__ d,
                               const uint8_t* __restrict__ alive, int n_int,
                               float* __restrict__ t_out,
                               int* __restrict__ id_out,
                               float* __restrict__ attr,
                               int* __restrict__ refl_out) {
  extern __shared__ float4 packed[];
  float4* spheres = packed;   // [S]
  uint32_t* scratch = reinterpret_cast<uint32_t*>(spheres + n_spheres);
  load_scan_tables(scene_g, n_spheres, spheres, nullptr, scratch);

  const size_t n = static_cast<size_t>(n_int);
  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const unsigned mask = group_mask<G>();
  for_each_live_ray<G>(
      n_int, reinterpret_cast<int*>(scratch + 2 * ((n_spheres + 31) / 32)),
      [&](int ray) { return alive[ray] != 0; },
      [&](int ray) { write_miss(ray, n, t_out, id_out, attr, refl_out); },
      [&](int ray) {
        Path s{};
        s.ox = o[3 * ray];
        s.oy = o[3 * ray + 1];
        s.oz = o[3 * ray + 2];
        s.dx = d[3 * ray];
        s.dy = d[3 * ray + 1];
        s.dz = d[3 * ray + 2];
        float best_t;
        const int best = nearest_group<G>(spheres, n_spheres, mask, lane, s,
                                          best_t);
        const bool hit = best_t < kBig;
        const float* row = scene_g + best * kCols;
        // The 12 outputs, spread over the group: t, id, refl, p, e, c.
#pragma unroll 1
        for (int k = lane; k < kAttrs + 3; k += G) {
          if (k == 0) {
            t_out[ray] = best_t;
          } else if (k == 1) {
            id_out[ray] = best;
          } else if (k == 2) {
            refl_out[ray] = hit ? static_cast<int>(__ldg(row + 10)) : 0;
          } else {
            attr[(k - 3) * n + ray] = hit ? __ldg(row + k - 2) : 0.0f;
          }
        }
      });
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

// Dynamic shared memory of a launch: the packed table (and for the
// any-hit kernel's vacuum mode its copy without emitters), the loader's
// scratch words, the block's list of rays.
size_t scan_smem(int n_spheres, int tables, int block) {
  return sizeof(float4) * tables * static_cast<size_t>(n_spheres) +
         sizeof(uint32_t) * scratch_words(n_spheres, block);
}

bool bad_shape(int n_spheres, int block, size_t smem) {
  return n_spheres < 0 || block <= 0 || block > 1024 || block % 32 != 0 ||
         smem > kMaxSmem;
}

}  // namespace

extern "C" int nearest_kernel_launch(const void* scene, int n_spheres,
                                     const void* o, const void* d,
                                     const void* alive, int n, void* t,
                                     void* id, void* attr, void* refl,
                                     int block, int group, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = scan_smem(n_spheres, 1, block);
  if (bad_shape(n_spheres, block, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    int grid = 0, per_sm = 0;
    const int err = persistent_grid(nearest_kernel<G>, n, block, smem, &grid,
                                    &per_sm);
    if (err != 0) return err;
    nearest_kernel<G><<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scene), n_spheres,
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const uint8_t*>(alive), n, static_cast<float*>(t),
        static_cast<int*>(id), static_cast<float*>(attr),
        static_cast<int*>(refl));
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int anyhit_kernel_launch(const void* scene, int n_spheres,
                                    const void* o, const void* d,
                                    const void* maxt, const void* active,
                                    int n, int vacuum, void* occ, int block,
                                    int group, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = scan_smem(n_spheres, vacuum ? 2 : 1, block);
  if (bad_shape(n_spheres, block, smem))
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
  const size_t smem = scan_smem(n_spheres, vacuum ? 2 : 1, block);
  *smem_bytes_out = static_cast<int>(smem);
  return with_group(group, [&](auto g) {
    int grid = 0;
    return persistent_grid(anyhit_kernel<decltype(g)::value>, 1 << 30,
                           block, smem, &grid, blocks_per_sm_out);
  });
}

// The same for a nearest-hit launch at `group` lanes a ray.
extern "C" int nearest_kernel_resources(int group, int n_spheres, int block,
                                        int* smem_bytes_out,
                                        int* blocks_per_sm_out) {
  const size_t smem = scan_smem(n_spheres, 1, block);
  *smem_bytes_out = static_cast<int>(smem);
  return with_group(group, [&](auto g) {
    int grid = 0;
    return persistent_grid(nearest_kernel<decltype(g)::value>, 1 << 30,
                           block, smem, &grid, blocks_per_sm_out);
  });
}

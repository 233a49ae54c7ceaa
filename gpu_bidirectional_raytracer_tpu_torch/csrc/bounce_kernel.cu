// Per-depth bounce and fact kernels for Hopper (sm_90a): a group of G lanes
// of a warp per ray.
//
// Replaces two TPU kernels of the many-sphere route (scenes of more than 64
// spheres, and direct-only rendering at any sphere count):
// - bounce_kernel_launch: gpu_bidirectional_raytracer_tpu/ops/
//   pallas_bounce.py::_bounce_kernel. One depth of the eye path on carried
//   state, launched once per depth by ops/pallas_bounce.py;
// - aux_kernel_launch: ops/pallas_bounce_grad.py::_aux_kernel. The same
//   depth, which also writes that depth's detached facts: the hit sphere
//   (-1 for a miss or a dead lane) and, per light slot and VPL slot,
//   whether its shadow sample was blocked. The differentiable re-walk
//   (integrators/path_tracer.py::trace with aux=) reads them instead of
//   scanning the spheres.
//
// The depth is tracer.cuh's eye_step, the code of the eye-path kernel, with
// its scans done by a group (GroupScan<G>), so a lane carried through the
// depths here sees the bits it sees there. The state is 14 float planes
// [14, n] (origin, direction, radiance, throughput, specular, alive),
// updated in place: only the ray's own entries are read and written. A
// dead ray passes through untouched; the fact kernel writes "missed,
// blocked" for it. A slot whose shadow ray was not cast (the sample faced
// away, or the lane is not at a live diffuse vertex) reads as blocked: the
// re-walk consumes a fact only through facing & (wi > 0) & !occluded at
// live diffuse lanes, where it is the kernel's own answer. (The TPU kernel
// writes the raw any-hit result at every lane of a live tile.)
//
// Bound: FP32 ALU at the first depth, where every ray is live: per live
// ray and depth S sphere roots for the nearest hit, and at a diffuse
// vertex (L + V) shadow rays of up to S roots each; without contraction
// into FMA and with IEEE square roots a root takes about 35 instructions.
// Past it 1-7% of the rays live, and a launch lasts as long as its
// slowest group's chain of roots plus the tables' load. The memory
// traffic is the state, 56 bytes each way per ray and depth (11 MB each
// way at 512x384), and for the fact kernel 4 + L + V bytes of facts per
// ray and depth.
//
// Design for the GPU:
// - a group of G lanes (a power of two up to 32) per ray: lane j tests
//   spheres j, j + G, ..., four at a time, so a ray's chain of S roots
//   becomes S / 4G; the nearest hit is the least (t, index) over the
//   group's lanes (shuffles), the shadow scans end at a vote of the group
//   (tracer.cuh's nearest_group, occluded_group; the collectives name the
//   group's lanes only). The shading runs the same in every lane of the
//   group, so no lane of a group leaves the others; lane 0 writes the
//   state and facts;
// - packed scan tables in shared memory: a float4 {p, r*r} a sphere, and
//   a second copy without the emitters for the vacuum (VPL) shadow rays,
//   32 bytes a sphere in all (complex.scn: 25 KB). The 64-byte scene rows
//   are read from global memory, only for the hit sphere and the lights;
// - persistent blocks: as many as the SMs hold at once, each loading its
//   tables once; each block reads the alive flags of its chunks of 32
//   contiguous rays, lists the live ones in shared memory and spreads
//   them over its groups (tracer.cuh's for_each_live_ray), so a dead ray
//   costs one flag and the groups' loads balance to within one ray;
// - the tape is mix32 regenerated from site keys or a streamed [K, n]
//   buffer, indexed by the ray's global lane (tracer.cuh's tape()).
// The wrapper (ops/pallas_bounce.py) picks G from the sphere count.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/_build.py; each launch returns its CUDA error (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

using namespace tracer;

constexpr int kPlanes = 14;
constexpr int kLitWords = 4;   // 128 light + VPL slots of facts
constexpr size_t kMaxSmem = 232448;

struct Params {
  const float* scene;      // [S, 16]
  const float* vpl;        // [V, 16]
  const uint32_t* keys;    // [K, 4] site keys (mix32); then light ids
  const float* tape;       // [K, n] streamed tape, or null (mix32 keys)
  float* state;            // [14, n] in place
  int* hit;                // [n] this depth's hit sphere or -1 (facts)
  uint8_t* occ_light;      // [n_lights, n] blocked flags (facts)
  uint8_t* occ_vpl;        // [V, n] blocked flags (facts)
  int n_spheres, n_vpl, n_rows, n, row0, n_lights, n_light_slots;
  int combine_half, direct_only;
  uint32_t lane_offset, lane_total;
  float emission_scale, light_gain;
};

// One ray of the launch, traced by its whole group; lane 0 writes.
template <bool kFacts, int G>
__device__ __forceinline__ void bounce_ray(const Params& p, const Tables& T,
                                           const GroupScan<G>& scan,
                                           int idx) {
  const size_t n = static_cast<size_t>(p.n);
  float* st = p.state + idx;
  const uint32_t gl = static_cast<uint32_t>(idx) + p.lane_offset;
  Path s{st[0],     st[n],     st[2 * n], st[3 * n],  st[4 * n],
         st[5 * n], st[9 * n], st[10 * n], st[11 * n], st[12 * n] > 0.5f};
  float rad_r = st[6 * n], rad_g = st[7 * n], rad_b = st[8 * n];
  uint32_t lit[kLitWords] = {0u, 0u, 0u, 0u};
  int hit;
  const int code = eye_step(T, p.row0, gl, s, rad_r, rad_g, rad_b, hit,
                            kFacts ? lit : nullptr, nullptr, scan);
  if (scan.lane != 0) return;
  st[6 * n] = rad_r;
  st[7 * n] = rad_g;
  st[8 * n] = rad_b;
  if (code == kContinue) {
    st[0] = s.ox;
    st[n] = s.oy;
    st[2 * n] = s.oz;
    st[3 * n] = s.dx;
    st[4 * n] = s.dy;
    st[5 * n] = s.dz;
    st[9 * n] = s.tp_r;
    st[10 * n] = s.tp_g;
    st[11 * n] = s.tp_b;
    st[12 * n] = s.specular ? 1.0f : 0.0f;
  } else {
    st[13 * n] = 0.0f;
  }
  if (kFacts) {
    p.hit[idx] = code == kEscaped ? -1 : hit;
    for (int j = 0; j < p.n_lights; ++j)
      p.occ_light[j * n + idx] = ((lit[j >> 5] >> (j & 31)) & 1u) ? 0 : 1;
    for (int v = 0; v < p.n_vpl; ++v) {
      const int j = p.n_lights + v;
      p.occ_vpl[v * n + idx] = ((lit[j >> 5] >> (j & 31)) & 1u) ? 0 : 1;
    }
  }
}

// Dynamic shared memory of a launch: the two packed tables, the VPL
// window, the tape keys and light ids, the loader's scratch words and the
// block's list of live rays.
size_t smem_bytes(const Params& p, int block) {
  return sizeof(float4) * 2 * static_cast<size_t>(p.n_spheres) +
         sizeof(float) * static_cast<size_t>(p.n_vpl) * kCols +
         sizeof(uint32_t) * (4 * static_cast<size_t>(p.n_rows) + p.n_lights +
                             2 * ((p.n_spheres + 31) / 32) +
                             live_list_rounds(block) * block + 32);
}

template <bool kFacts, int G>
__global__ void bounce_kernel(Params p) {
  extern __shared__ float4 smem[];
  float4* spheres = smem;
  float4* solid = spheres + p.n_spheres;
  float* vpl = reinterpret_cast<float*>(solid + p.n_spheres);
  uint32_t* keys = reinterpret_cast<uint32_t*>(vpl + p.n_vpl * kCols);
  uint32_t* scratch = keys + p.n_rows * 4 + p.n_lights;
  for (int i = threadIdx.x; i < p.n_vpl * kCols; i += blockDim.x)
    vpl[i] = p.vpl[i];
  for (int i = threadIdx.x; i < p.n_rows * 4 + p.n_lights; i += blockDim.x)
    keys[i] = p.keys[i];
  const int n_solid = load_scan_tables(p.scene, p.n_spheres, spheres, solid,
                                       scratch);
  const int* lights = reinterpret_cast<const int*>(keys + p.n_rows * 4);

  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const GroupScan<G> scan{spheres, solid, p.n_spheres, n_solid,
                          group_mask<G>(), lane};
  const Tables T{p.scene, vpl, keys, lights, p.tape, p.n_spheres, p.n_vpl,
                 p.n_lights, p.n_light_slots, p.combine_half, p.lane_offset,
                 p.lane_total, static_cast<uint32_t>(p.n),
                 p.emission_scale, p.light_gain, p.direct_only};
  const size_t n = static_cast<size_t>(p.n);
  for_each_live_ray<G>(
      p.n, reinterpret_cast<int*>(scratch + 2 * ((p.n_spheres + 31) / 32)),
      [&](int ray) { return p.state[13 * n + ray] > 0.5f; },
      [&](int ray) {   // a dead ray passes through; its facts: missed, blocked
        if (!kFacts) return;
        p.hit[ray] = -1;
        for (int j = 0; j < p.n_lights; ++j) p.occ_light[j * n + ray] = 1;
        for (int v = 0; v < p.n_vpl; ++v) p.occ_vpl[v * n + ray] = 1;
      },
      [&](int ray) { bounce_ray<kFacts, G>(p, T, scan, ray); });
}

template <bool kFacts>
int launch(const Params& p, int block, int group, void* stream) {
  if (p.n <= 0) return 0;
  if (kFacts && p.n_lights + p.n_vpl > 32 * kLitWords)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block <= 0 || block > 1024 || block % 32 != 0 ||
      smem_bytes(p, block) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    const size_t smem = smem_bytes(p, block);
    int grid = 0, per_sm = 0;
    const int err = persistent_grid(bounce_kernel<kFacts, G>, p.n, block,
                                    smem, &grid, &per_sm);
    if (err != 0) return err;
    bounce_kernel<kFacts, G><<<grid, block, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
  });
}

Params common(const void* scene, int n_spheres, const void* vpl, int n_vpl,
              const void* keys, int n_rows, const void* tape, int n_lights,
              void* state, int n, int row0, int n_light_slots,
              int combine_half, int direct_only, unsigned int lane_offset,
              unsigned int lane_total, float emission_scale,
              float light_gain) {
  Params p{};
  p.scene = static_cast<const float*>(scene);
  p.vpl = static_cast<const float*>(vpl);
  p.keys = static_cast<const uint32_t*>(keys);
  p.tape = static_cast<const float*>(tape);
  p.state = static_cast<float*>(state);
  p.n_spheres = n_spheres;
  p.n_vpl = n_vpl;
  p.n_rows = n_rows;
  p.n = n;
  p.row0 = row0;
  p.n_lights = n_lights;
  p.n_light_slots = n_light_slots;
  p.combine_half = combine_half;
  p.direct_only = direct_only;
  p.lane_offset = lane_offset;
  p.lane_total = lane_total;
  p.emission_scale = emission_scale;
  p.light_gain = light_gain;
  return p;
}

}  // namespace

extern "C" int bounce_kernel_launch(
    const void* scene, int n_spheres, const void* vpl, int n_vpl,
    const void* keys, int n_rows, const void* tape, int n_lights,
    void* state, int n, int row0, int n_light_slots, int combine_half,
    int direct_only, unsigned int lane_offset, unsigned int lane_total,
    float emission_scale, float light_gain, int block, int group,
    void* stream) {
  const Params p = common(scene, n_spheres, vpl, n_vpl, keys, n_rows, tape,
                          n_lights, state, n, row0, n_light_slots,
                          combine_half, direct_only, lane_offset, lane_total,
                          emission_scale, light_gain);
  return launch<false>(p, block, group, stream);
}

extern "C" int aux_kernel_launch(
    const void* scene, int n_spheres, const void* vpl, int n_vpl,
    const void* keys, int n_rows, const void* tape, int n_lights,
    void* state, int n, int row0, int n_light_slots, int combine_half,
    int direct_only, unsigned int lane_offset, unsigned int lane_total,
    float emission_scale, float light_gain, int block, int group, void* hit,
    void* occ_light, void* occ_vpl, void* stream) {
  Params p = common(scene, n_spheres, vpl, n_vpl, keys, n_rows, tape,
                    n_lights, state, n, row0, n_light_slots, combine_half,
                    direct_only, lane_offset, lane_total, emission_scale,
                    light_gain);
  p.hit = static_cast<int*>(hit);
  p.occ_light = static_cast<uint8_t*>(occ_light);
  p.occ_vpl = static_cast<uint8_t*>(occ_vpl);
  return launch<true>(p, block, group, stream);
}

// The dynamic shared memory and resident blocks per SM of a launch of
// either kernel at `group` lanes a ray with these table sizes.
extern "C" int bounce_kernel_resources(int facts, int group, int n_spheres,
                                       int n_vpl, int n_rows, int n_lights,
                                       int block, int* smem_bytes_out,
                                       int* blocks_per_sm_out) {
  Params p{};
  p.n_spheres = n_spheres;
  p.n_vpl = n_vpl;
  p.n_rows = n_rows;
  p.n_lights = n_lights;
  p.n = 1 << 30;
  const size_t smem = smem_bytes(p, block);
  *smem_bytes_out = static_cast<int>(smem);
  return with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    int grid = 0;
    return facts ? persistent_grid(bounce_kernel<true, G>, p.n, block, smem,
                                   &grid, blocks_per_sm_out)
                 : persistent_grid(bounce_kernel<false, G>, p.n, block,
                                   smem, &grid, blocks_per_sm_out);
  });
}

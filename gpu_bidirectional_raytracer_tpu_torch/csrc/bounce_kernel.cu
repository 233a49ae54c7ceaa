// Per-depth bounce and fact kernels for Hopper (sm_90a): one thread per lane.
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
// The depth is tracer.cuh's eye_step, the code of the eye-path kernel, so a
// lane carried through the depths here sees the bits it sees there. The
// state is 14 float planes [14, n] (origin, direction, radiance, throughput,
// specular, alive), updated in place: each thread reads and writes only its
// own lane. A dead lane leaves at once (the GPU's form of the TPU kernel's
// dead-tile skip); the fact kernel writes "missed, blocked" for it first.
// A slot whose shadow ray was not cast (the sample faced away, or the lane
// is not at a live diffuse vertex) reads as blocked: the re-walk consumes
// a fact only through facing & (wi > 0) & !occluded at live diffuse lanes,
// where it is the kernel's own answer. (The TPU kernel writes the raw
// any-hit result at every lane of a live tile.)
//
// Design for the GPU: the sphere table (complex.scn: 783 x 16 floats, 50 KB),
// the VPL window and the tape keys sit in dynamic shared memory, opted in
// above 48 KB with cudaFuncSetAttribute; a table larger than the block's
// 227 KB makes the launch fail with an error. The tape is mix32 regenerated
// from site keys or a streamed [K, n] buffer (tracer.cuh's tape()). The
// block size is the caller's (256 threads by default; see ops/
// pallas_bounce.py).
//
// Bound: FP32 ALU. Per live lane and depth it evaluates S sphere roots for
// the nearest hit, and at a diffuse vertex (L + V) shadow rays of up to S
// roots each; its memory traffic is the state, 56 bytes each way per lane
// and depth (11 MB each way at 512x384), and for the fact kernel 4 + L + V
// bytes of facts per lane and depth.
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

template <bool kFacts>
__global__ void bounce_kernel(Params p) {
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
  const size_t n = static_cast<size_t>(p.n);
  float* st = p.state + idx;
  if (!(st[13 * n] > 0.5f)) {   // dead lane: state passes through
    if (kFacts) {
      p.hit[idx] = -1;
      for (int j = 0; j < p.n_lights; ++j) p.occ_light[j * n + idx] = 1;
      for (int v = 0; v < p.n_vpl; ++v) p.occ_vpl[v * n + idx] = 1;
    }
    return;
  }

  const uint32_t gl = static_cast<uint32_t>(idx) + p.lane_offset;
  const Tables T{scene, vpl, keys, lights, p.tape, p.n_spheres, p.n_vpl,
                 p.n_lights, p.n_light_slots, p.combine_half, p.lane_offset,
                 p.lane_total, static_cast<uint32_t>(p.n),
                 p.emission_scale, p.light_gain, p.direct_only};
  Path s{st[0],     st[n],     st[2 * n], st[3 * n],  st[4 * n],
         st[5 * n], st[9 * n], st[10 * n], st[11 * n], st[12 * n] > 0.5f};
  float rad_r = st[6 * n], rad_g = st[7 * n], rad_b = st[8 * n];
  uint32_t lit[kLitWords] = {0u, 0u, 0u, 0u};
  int hit;
  const int code = eye_step(T, p.row0, gl, s, rad_r, rad_g, rad_b, hit,
                            kFacts ? lit : nullptr);

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

template <bool kFacts>
int launch(const Params& p, int block, void* stream) {
  if (p.n <= 0) return 0;
  if (kFacts && p.n_lights + p.n_vpl > 32 * kLitWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (p.n_spheres + p.n_vpl) * kCols +
                      sizeof(uint32_t) * (4 * p.n_rows + p.n_lights);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bounce_kernel<kFacts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (p.n + block - 1) / block;
  bounce_kernel<kFacts><<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
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
    float emission_scale, float light_gain, int block, void* stream) {
  const Params p = common(scene, n_spheres, vpl, n_vpl, keys, n_rows, tape,
                          n_lights, state, n, row0, n_light_slots,
                          combine_half, direct_only, lane_offset, lane_total,
                          emission_scale, light_gain);
  return launch<false>(p, block, stream);
}

extern "C" int aux_kernel_launch(
    const void* scene, int n_spheres, const void* vpl, int n_vpl,
    const void* keys, int n_rows, const void* tape, int n_lights,
    void* state, int n, int row0, int n_light_slots, int combine_half,
    int direct_only, unsigned int lane_offset, unsigned int lane_total,
    float emission_scale, float light_gain, int block, void* hit,
    void* occ_light, void* occ_vpl, void* stream) {
  Params p = common(scene, n_spheres, vpl, n_vpl, keys, n_rows, tape,
                    n_lights, state, n, row0, n_light_slots, combine_half,
                    direct_only, lane_offset, lane_total, emission_scale,
                    light_gain);
  p.hit = static_cast<int*>(hit);
  p.occ_light = static_cast<uint8_t*>(occ_light);
  p.occ_vpl = static_cast<uint8_t*>(occ_vpl);
  return launch<true>(p, block, stream);
}

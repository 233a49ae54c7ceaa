// Host emulation of the CUDA features the kernels of csrc/ use, so that a
// kernel source compiles as C++ (g++ -std=c++20 -ffp-contract=off
// -I csrc/emu) and runs on the CPU. It stands in for <cuda_runtime.h>; the
// tests put this directory first on the include path and rewrite only two
// things of the source: a launch `k<<<grid, block, smem, stream>>>(args)`
// becomes `emu::launch(k, grid, block, smem, stream, args)`, and
// `extern __shared__ T name[];` becomes a pointer to the block's dynamic
// shared memory.
//
// Every CUDA thread of a block is a fiber (ucontext) on the calling thread;
// the blocks of a grid run one after another. A fiber runs until it waits
// at a barrier: __syncthreads and __syncthreads_or for the block, and every
// warp collective (shuffles, ballots, votes) for the lanes its mask names,
// one barrier per mask, so groups of a warp with masks of their own run
// their collectives apart. A collective that some lane of its mask never
// reaches is found (the run aborts) rather than silently summed, as is a
// lane outside the mask that calls it or is read by a shuffle. Shuffles
// exchange through two buffers by barrier phase, so each costs one
// barrier. The card has kSms SMs here and holds one block of any kernel at
// a time (the occupancy query), so a persistent grid is kSms blocks. The
// float arithmetic is the host's (IEEE single, no contraction); the math
// library's expf/cosf/sinf may differ from the card's by an ulp.

#pragma once

#include <math.h>
#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

using cudaError_t = int;
using cudaStream_t = void*;
enum : int {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
};
enum cudaFuncAttribute : int {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
enum cudaDeviceAttr : int {
  cudaDevAttrMultiProcessorCount = 16,
};

struct float4 {
  float x, y, z, w;
};

inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {

constexpr size_t kMaxSmem = 232448;   // H100: 227 KB of dynamic shared memory
constexpr size_t kStack = 1 << 19;    // bytes of stack per fiber
constexpr long kMaxSpins = 20000000;  // yields before a barrier is declared stuck
constexpr int kSms = 3;               // SMs of the emulated card

struct Barrier {
  int count = 0, arrived = 0;
  unsigned gen = 0;
};

// The collectives of one lane mask of a warp.
struct Sync {
  Barrier bar;
  uint32_t x[2][32];
};

struct Warp {
  std::map<unsigned, Sync> sync;   // by mask; nodes never move
};

struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  bool done = false;
};

struct Block {
  std::function<void()> body;
  std::vector<Fiber> fibers;
  std::vector<Warp> warps;
  Barrier bar;
  int any[2];   // __syncthreads_or's result, by barrier phase
  ucontext_t sched;
  int current = 0;
  alignas(16) unsigned char smem[kMaxSmem];
};

inline thread_local Block* g_block = nullptr;
inline thread_local int g_last_error = cudaSuccess;
inline thread_local size_t g_max_smem = 48 * 1024;

inline void yield() {
  Block* b = g_block;
  swapcontext(&b->fibers[b->current].ctx, &b->sched);
}

inline void wait(Barrier& bar) {
  const unsigned gen = bar.gen;
  if (++bar.arrived == bar.count) {
    bar.arrived = 0;
    ++bar.gen;
    return;
  }
  long spins = 0;
  while (bar.gen == gen) {
    yield();
    if (++spins > kMaxSpins) {
      std::fprintf(stderr, "emu: thread %u of block %u stuck at a barrier "
                           "(a collective not reached by every thread)\n",
                   threadIdx.x, blockIdx.x);
      std::abort();
    }
  }
}

inline Warp& warp() { return g_block->warps[threadIdx.x >> 5]; }

inline void* dynamic_smem() { return g_block->smem; }

inline void fiber_main(int i) {
  Block* b = g_block;
  b->body();
  b->fibers[i].done = true;
}

inline void need_lane(unsigned mask, unsigned lane, const char* what) {
  if ((mask >> lane) & 1u) return;
  std::fprintf(stderr, "emu: thread %u of block %u: %s lane %u outside the "
                       "mask %08x\n", threadIdx.x, blockIdx.x, what, lane,
               mask);
  std::abort();
}

// Exchanges one 32-bit word with the lanes of `mask`; returns the buffer
// row that each of their words is in after the barrier.
inline const uint32_t* exchange(unsigned mask, uint32_t word) {
  const unsigned lane = threadIdx.x & 31u;
  need_lane(mask, lane, "a collective called by");
  Sync& g = warp().sync[mask];
  g.bar.count = __builtin_popcount(mask);
  uint32_t* row = g.x[g.bar.gen & 1];
  row[lane] = word;
  wait(g.bar);
  return row;
}

template <typename T>
uint32_t bits(T v) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return u;
}

template <typename T>
T from_bits(uint32_t u) {
  T v;
  std::memcpy(&v, &u, 4);
  return v;
}

template <typename Kernel, typename... Args>
void launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
            Args... args) {
  const unsigned n = block.x * block.y * block.z;
  if (n == 0 || n > 1024 || n % 32 != 0 || block.y != 1 || block.z != 1 ||
      grid.y != 1 || grid.z != 1 || smem > g_max_smem || smem > kMaxSmem) {
    g_last_error = cudaErrorInvalidConfiguration;
    return;
  }
  auto* b = new Block;
  g_block = b;
  gridDim = grid;
  blockDim = block;
  b->body = [&] { kernel(args...); };
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    blockIdx = dim3(bx);
    b->fibers.assign(n, Fiber{});
    b->warps.assign(n / 32, Warp{});
    b->bar = Barrier{static_cast<int>(n), 0, 0};
    std::memset(b->smem, 0xff, smem);   // shared memory starts undefined
    for (unsigned i = 0; i < n; ++i) {
      Fiber& f = b->fibers[i];
      f.stack.resize(kStack);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = &b->sched;
      makecontext(&f.ctx, reinterpret_cast<void (*)()>(fiber_main), 1,
                  static_cast<int>(i));
    }
    unsigned alive = n;
    while (alive > 0) {
      for (unsigned i = 0; i < n; ++i) {
        if (b->fibers[i].done) continue;
        b->current = static_cast<int>(i);
        threadIdx = dim3(i);
        swapcontext(&b->sched, &b->fibers[i].ctx);
        if (b->fibers[i].done) --alive;
      }
    }
  }
  g_block = nullptr;
  delete b;
}

}  // namespace emu

inline void __syncthreads() { emu::wait(emu::g_block->bar); }

inline int __syncthreads_or(int pred) {
  emu::Block* b = emu::g_block;
  int& any = b->any[b->bar.gen & 1];
  if (b->bar.arrived == 0) any = 0;   // the phase's first arrival
  any |= pred ? 1 : 0;
  emu::wait(b->bar);
  return any;
}

template <typename T>
T __shfl_sync(unsigned m, T v, int src, int = 32) {
  const uint32_t* row = emu::exchange(m, emu::bits(v));
  emu::need_lane(m, src & 31, "a shuffle reads");
  return emu::from_bits<T>(row[src & 31]);
}

template <typename T>
T __shfl_xor_sync(unsigned m, T v, int lane_mask, int = 32) {
  const uint32_t* row = emu::exchange(m, emu::bits(v));
  const unsigned src = (threadIdx.x & 31u) ^ (lane_mask & 31);
  emu::need_lane(m, src, "a shuffle reads");
  return emu::from_bits<T>(row[src]);
}

inline unsigned __ballot_sync(unsigned m, int pred) {
  const uint32_t* row = emu::exchange(m, pred ? 1u : 0u);
  unsigned out = 0;
  for (int i = 0; i < 32; ++i)
    if ((m >> i) & 1u) out |= (row[i] & 1u) << i;
  return out;
}

inline int __any_sync(unsigned m, int pred) {
  return __ballot_sync(m, pred) != 0u;
}

inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned __float_as_uint(float x) { return emu::bits(x); }
inline float __uint_as_float(unsigned x) { return emu::from_bits<float>(x); }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }

template <typename T>
T __ldg(const T* p) {   // the read-only path: a plain load here
  return *p;
}

template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute attr, int value) {
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) {
    if (value < 0 || static_cast<size_t>(value) > emu::kMaxSmem)
      return cudaErrorInvalidValue;
    emu::g_max_smem = static_cast<size_t>(value);
  }
  return cudaSuccess;
}

// One block per "SM" under emulation: the blocks run one at a time.
template <typename Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, Kernel, int block_size, size_t smem) {
  *blocks = (block_size > 0 && block_size <= 1024 &&
             smem <= emu::kMaxSmem) ? 1 : 0;
  return cudaSuccess;
}

inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}

inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr,
                                          int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? emu::kSms : 0;
  return cudaSuccess;
}

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu::g_last_error;
  emu::g_last_error = cudaSuccess;
  return e;
}

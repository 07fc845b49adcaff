// Advance sweep of the event engine, hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/vm_update.py::advance_sweep_pallas, the TPU kernel
// of the JAX package (bodies _fused_kernel and _tiled_kernel).  Per
// scenario row b of a [B, C] block:
//
//   dt[b]     = min( min_i rem/max(rate,1e-30) over active & rate>0 , bound[b] )
//   rem'[b,i] = active ? max(rem - rate*dt[b], 0) : rem
//
// What bounds it.  Each element is read once and written once: 4 B rem,
// 4 B rate, 1 B active (read as the bool tensor's bytes, no float copy),
// 4 B rem' = 13 B per element, against two flops and a division.  That is
// far below the H100's ratio of ~20 flops per byte, so the kernel is bound
// by device-memory bytes (3.35 TB/s).  The design moves no byte twice where
// it can help it:
//
// * Fused variant, one thread block per row.  Each thread loads up to ITEMS
//   elements (stride blockDim, so a warp reads consecutive addresses) into
//   registers, reduces its minimum, the block reduces with warp shuffles and
//   one word of shared memory per warp, and the same threads deplete the
//   elements they still hold: every element crosses device memory once, as
//   in the TPU kernel's VMEM-resident tile.  The row cap is 512 threads x 16
//   items = 8192 elements: 16 floats of rem, 16 of rate and a 16-bit mask
//   of active flags stay well inside the 128 registers a thread may use at
//   512 threads a block (65,536 per SM), so nothing spills.  The TPU's
//   2^17-element VMEM tile has no counterpart: a block's registers and
//   227 KB of shared memory hold far less than 2 MB.
// * Split variant, for rows longer than the cap or too few rows to fill the
//   132 SMs: a (nb, min(B, 65535)) grid of 1024-element tiles in two
//   launches, a block taking rows y, y + 65535, ... (the grid's y holds
//   65,535).  The first writes each tile's minimum to a [B, nb] scratch; the
//   second reduces the row's nb minima (a few hundred floats, from L2) and
//   depletes its tile.
//   Blocks run in no order on Hopper, so the TPU kernel's sequential
//   scratch carry becomes the launch boundary.  The second pass reads the
//   row again, mostly from the 50 MB L2 cache.
//
// Bitwise dt.  min is exact in any order, and the division is IEEE
// (__fdiv_rn; the library is built without --use_fast_math), so dt equals
// the plain PyTorch version bit for bit.  rem - rate*dt is __fmul_rn then
// __fsub_rn (and the build passes -fmad=false), two rounded operations
// exactly as PyTorch's eager kernels compute them, so rem' is bitwise too.
//
// Each C entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;

__device__ __forceinline__ float time_to_finish(float r, float q, bool a) {
  return (a && q > 0.f) ? __fdiv_rn(r, fmaxf(q, 1e-30f)) : kInf;
}

__device__ __forceinline__ float deplete(float r, float q, bool a, float dt) {
  return a ? fmaxf(__fsub_rn(r, __fmul_rn(q, dt)), 0.f) : r;
}

// Block-wide minimum, returned to every thread.  blockDim.x is a multiple of
// 32 and at most 1024; `warp_min` holds one float per warp.
__device__ float block_min(float v, float* warp_min) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? warp_min[lane] : kInf;
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) warp_min[0] = v;
  }
  __syncthreads();
  return warp_min[0];
}

template <int ITEMS>
__global__ void __launch_bounds__(512) advance_fused(
    const float* __restrict__ rem, const float* __restrict__ rate,
    const uint8_t* __restrict__ active, const float* __restrict__ bound,
    float* __restrict__ dt_out, float* __restrict__ out, int64_t c) {
  __shared__ float warp_min[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * c;
  float r[ITEMS], q[ITEMS];
  uint32_t act = 0;  // bit k: element k of this thread is active
  float m = kInf;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = threadIdx.x + static_cast<int64_t>(k) * blockDim.x;
    r[k] = 0.f;
    q[k] = 0.f;
    if (i < c) {
      r[k] = rem[base + i];
      q[k] = rate[base + i];
      const bool a = active[base + i] != 0;
      act |= static_cast<uint32_t>(a) << k;
      m = fminf(m, time_to_finish(r[k], q[k], a));
    }
  }
  const float dt = fminf(block_min(m, warp_min), bound[blockIdx.x]);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = threadIdx.x + static_cast<int64_t>(k) * blockDim.x;
    if (i < c) out[base + i] = deplete(r[k], q[k], (act >> k) & 1u, dt);
  }
  if (threadIdx.x == 0) dt_out[blockIdx.x] = dt;
}

template <int ITEMS>
__global__ void __launch_bounds__(512) advance_tile_min(
    const float* __restrict__ rem, const float* __restrict__ rate,
    const uint8_t* __restrict__ active, float* __restrict__ scratch, int b, int64_t c) {
  __shared__ float warp_min[32];
  const int64_t nb = gridDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x * ITEMS;
  for (int64_t row = blockIdx.y; row < b; row += gridDim.y) {
    const int64_t base = row * c;
    float m = kInf;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t i = start + threadIdx.x + static_cast<int64_t>(k) * blockDim.x;
      if (i < c)
        m = fminf(m, time_to_finish(rem[base + i], rate[base + i], active[base + i] != 0));
    }
    m = block_min(m, warp_min);
    if (threadIdx.x == 0) scratch[row * nb + blockIdx.x] = m;
    __syncthreads();  // every thread has read warp_min[0] before the next row writes it
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(512) advance_tile_apply(
    const float* __restrict__ rem, const float* __restrict__ rate,
    const uint8_t* __restrict__ active, const float* __restrict__ bound,
    const float* __restrict__ scratch, float* __restrict__ dt_out,
    float* __restrict__ out, int b, int64_t c) {
  __shared__ float warp_min[32];
  const int64_t nb = gridDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x * ITEMS;
  for (int64_t row = blockIdx.y; row < b; row += gridDim.y) {
    const int64_t base = row * c;
    float m = kInf;
    for (int64_t j = threadIdx.x; j < nb; j += blockDim.x) m = fminf(m, scratch[row * nb + j]);
    const float dt = fminf(block_min(m, warp_min), bound[row]);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t i = start + threadIdx.x + static_cast<int64_t>(k) * blockDim.x;
      if (i < c) out[base + i] = deplete(rem[base + i], rate[base + i], active[base + i] != 0, dt);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) dt_out[row] = dt;
    __syncthreads();  // every thread has read warp_min[0] before the next row writes it
  }
}

template <template <int> class Launch, typename... Args>
cudaError_t by_items(int items, Args... args) {
  switch (items) {
    case 1: Launch<1>::run(args...); break;
    case 2: Launch<2>::run(args...); break;
    case 4: Launch<4>::run(args...); break;
    case 8: Launch<8>::run(args...); break;
    case 16: Launch<16>::run(args...); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int ITEMS>
struct Fused {
  static void run(const float* rem, const float* rate, const uint8_t* active,
                  const float* bound, float* dt, float* out, int b, int64_t c,
                  int threads, cudaStream_t s) {
    advance_fused<ITEMS><<<b, threads, 0, s>>>(rem, rate, active, bound, dt, out, c);
  }
};

template <int ITEMS>
struct Split {
  static void run(const float* rem, const float* rate, const uint8_t* active,
                  const float* bound, float* scratch, float* dt, float* out,
                  int b, int64_t c, int threads, int nb, cudaStream_t s) {
    const dim3 grid(nb, b < 65535 ? b : 65535);
    advance_tile_min<ITEMS><<<grid, threads, 0, s>>>(rem, rate, active, scratch, b, c);
    advance_tile_apply<ITEMS><<<grid, threads, 0, s>>>(rem, rate, active, bound, scratch, dt, out,
                                                       b, c);
  }
};

}  // namespace

extern "C" int advance_sweep_fused(const void* rem, const void* rate,
                                   const void* active, const void* bound,
                                   void* dt, void* out, int b, long long c,
                                   int threads, int items, void* stream) {
  return static_cast<int>(by_items<Fused>(
      items, static_cast<const float*>(rem), static_cast<const float*>(rate),
      static_cast<const uint8_t*>(active), static_cast<const float*>(bound),
      static_cast<float*>(dt), static_cast<float*>(out), b,
      static_cast<int64_t>(c), threads, static_cast<cudaStream_t>(stream)));
}

extern "C" int advance_sweep_split(const void* rem, const void* rate,
                                   const void* active, const void* bound,
                                   void* scratch, void* dt, void* out, int b,
                                   long long c, int threads, int items, int nb,
                                   void* stream) {
  return static_cast<int>(by_items<Split>(
      items, static_cast<const float*>(rem), static_cast<const float*>(rate),
      static_cast<const uint8_t*>(active), static_cast<const float*>(bound),
      static_cast<float*>(scratch), static_cast<float*>(dt),
      static_cast<float*>(out), b, static_cast<int64_t>(c), threads, nb,
      static_cast<cudaStream_t>(stream)));
}

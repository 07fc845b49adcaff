// Flash attention (forward), hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas, the TPU
// kernel of the JAX package (body _flash_kernel).  For q [B, Hq, Sq, D] and
// k, v [B, Hk, Sk, D], query head h reads kv head h / (Hq / Hk) (GQA, no
// K/V repetition in memory) and, with rows aligned to the end of the key
// axis (row = i + Sk - Sq):
//
//   s    = (q . k) * scale;  s = softcap * tanh(s / softcap) if softcap > 0
//   mask = col < Sk  &&  (!causal || col <= row)  &&  (window < 0 || col > row - window)
//   s    = mask ? s : -1e30
//   online softmax over key tiles: m' = max(m, max s); p = s > -5e29 ? exp(s - m') : 0
//   l    = exp(m - m') * l + sum p;  acc = exp(m - m') * acc + p . v
//   o    = acc / max(l, 1e-30)      (a row whose keys are all masked gives 0)
//
// f32 or bf16 in, f32 arithmetic throughout, output in the input type.
//
// What bounds it.  Attention does 4 * D operations per valid (query, key)
// pair and moves q, k, v and o once: at the serving prefill (Sq = Sk = 512,
// D = 128) that is ~128 operations per byte, and at 8192 tokens ~2,000, so
// the H100 is bound by arithmetic, not by its 3.35 TB/s, at every shape the
// serving path gives it.  The card's rate for bf16 is its tensor cores'
// (989 TFLOP/s); this first version does all its arithmetic on the CUDA
// cores in f32 (67 TFLOP/s), which the f32 path needs to meet 2e-5 (no
// TF32), and which the bf16 path shares for simplicity.  wgmma, TMA and warp
// specialisation are for a later version.
//
// What the design does about it.
//
// * The TPU kernel's sequential key axis, with the running max, sum and
//   accumulator in VMEM scratch across grid steps (grid (B, Hq, nq, nk)),
//   becomes a loop over key tiles inside one block: one block per
//   (64-row query tile, head, batch) keeps its statistics and its 64 x D
//   accumulator in registers for the whole loop.
// * Register tiling against shared-memory traffic.  256 threads; thread
//   (ty, tx) owns rows 4ty..4ty+3 and, of S = Q K^T, the columns tx + 16j
//   (j < 4): per 4 steps of d it reads 4 float4 of Q and 4 float4 of K from
//   shared memory for 64 FMAs.  Of O it owns the same 4 rows and columns
//   2tx + 32g (+0, +1), so the softmax rescale of a row never leaves the
//   thread; row max and sum reduce over the 16 lanes of a half-warp with
//   shuffles.  Row strides padded by 4 floats make every shared-memory
//   access of a warp conflict-free or a broadcast.
// * The whole-tile skip of the TPU kernel becomes the loop's bounds: the
//   first key tile the sliding window reaches to the last tile the causal
//   mask allows.  Tiles that are partly masked are masked element by
//   element, and the ragged edges of Sq and Sk are masked in the kernel
//   (rows past the edge load as zeros), never padded in memory.
// * Shared memory: Q tile, one K/V tile (V overwrites K once S is done) and
//   P, all f32: 83 KB at D = 128, so two blocks share an SM.  Query tiles
//   are issued heaviest first (the last rows see the most keys).
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (or the error of cudaFuncSetAttribute) so
// the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLdP = kBlockK + 4;
constexpr float kNeg = -1.0e30f;

// Four consecutive elements as floats (16-byte or 8-byte aligned loads).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  // bf16 -> f32 is exact: the 16 bits become the high half of the float
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A [64, D] tile of rows [0, rows) into shared memory as f32 with row
// stride D + 4; rows past the edge are zeros (V rows must be: 0 * garbage
// could be NaN).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < kBlockQ * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const float4 x = r < rows ? load4(src + static_cast<size_t>(r) * D + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return (2 * kBlockQ * (D + 4) + kBlockQ * kLdP) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Hq, int Hk, int Sq,
          int Sk, int causal, int window, float softcap, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kGroups = D / 32;  // float2 column groups of O per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kvs = qs + kBlockQ * kLd;
  float* ps = kvs + kBlockK * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * kBlockQ;
  const int q_rows = min(kBlockQ, Sq - q0);
  const int offset = Sk - Sq;
  const T* qg = q + (static_cast<size_t>(b) * Hq + h) * Sq * D + static_cast<size_t>(q0) * D;
  const T* kg = k + (static_cast<size_t>(b) * Hk + hk) * Sk * D;
  const T* vg = v + (static_cast<size_t>(b) * Hk + hk) * Sk * D;
  T* og = o + (static_cast<size_t>(b) * Hq + h) * Sq * D + static_cast<size_t>(q0) * D;

  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);

  // Key tiles this query tile can see: the loop's bounds are the TPU
  // kernel's whole-tile skip.
  const int row_lo = q0 + offset;
  const int row_hi = q0 + q_rows - 1 + offset;
  const int nk = (Sk + kBlockK - 1) / kBlockK;
  int kt_hi = nk;
  if (causal) kt_hi = row_hi < 0 ? 0 : min(nk, row_hi / kBlockK + 1);
  int kt_lo = 0;
  if (window >= 0) {
    const int first_col = row_lo - window + 1;
    kt_lo = first_col <= 0 ? 0 : first_col / kBlockK;
  }

  float acc[4][2 * kGroups];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * kGroups; ++c) acc[i][c] = 0.f;
  }

  load_tile<T, D>(qs, qg, q_rows);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    const int k_rows = min(kBlockK, Sk - k0);
    __syncthreads();  // the previous tile's P . V is done with kvs and ps
    load_tile<T, D>(kvs, kg + static_cast<size_t>(k0) * D, k_rows);
    __syncthreads();

    // S = Q K^T for rows 4ty + i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i + offset;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (window >= 0) ok = ok && col > row - window;
        s[i][j] = ok ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * kNeg ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        psum += p;
      }
      // each thread keeps its own columns' part of l; alpha is the same
      // on the 16 lanes of a row, so the parts add up at the end
      l[i] = alpha * l[i] + psum;
#pragma unroll
      for (int c = 0; c < 2 * kGroups; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * kLdP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // S is done with K; P is complete
    load_tile<T, D>(kvs, vg + static_cast<size_t>(k0) * D, k_rows);
    __syncthreads();

    // acc += P V for rows 4ty + i, columns 2tx + 32g (+0, +1)
#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kLdP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float2 vb = *reinterpret_cast<const float2*>(kvs + (c + cc) * kLd + 2 * tx + 32 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
            acc[i][2 * g] = fmaf(p, vb.x, acc[i][2 * g]);
            acc[i][2 * g + 1] = fmaf(p, vb.y, acc[i][2 * g + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int r = 4 * ty + i;
    if (r < q_rows) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        store2(og + static_cast<size_t>(r) * D + 2 * tx + 32 * g,
               acc[i][2 * g] / li, acc[i][2 * g + 1] / li);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hk, int Sq, int Sk, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hk, Sq, Sk, causal,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hk, int Sq, int Sk, int D, int causal,
                      int window, float softcap, float scale,
                      cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hk, Sq, Sk, causal, window, softcap, scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, o, B, Hq, Hk, Sq, Sk, causal, window, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hk, Sq, Sk, causal, window, softcap, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window < 0: no sliding window.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Hq, int Hk, int Sq,
                                   int Sk, int D, int dtype, int causal,
                                   int window, float softcap, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(q, k, v, o, B, Hq, Hk, Sq, Sk, D, causal, window, softcap, scale, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, o, B, Hq, Hk, Sq, Sk, D, causal, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

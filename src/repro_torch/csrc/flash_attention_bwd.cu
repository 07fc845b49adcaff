// Flash attention (backward), hand-written for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel for this: it differentiates
// repro/models/attention.py:40 flash_xla with jax.grad.  This computes the
// same gradient for the function csrc/flash_attention.cu computes (GQA,
// causal mask aligned to the end of the key axis, sliding window, softcap
// before the mask, zero output for a row whose keys are all masked), from
// the forward's output o and its row log-sum-exp lse (natural log, +inf for
// a row with every key masked):
//
//   s    = (q . k) * scale;  s = softcap * tanh(s / softcap) if softcap > 0
//   P    = mask ? exp(s - lse) : 0                 (0 on a fully masked row)
//   dV   = P^T dO;   dP = dO V^T;   delta = rowsum(dO o o)
//   dS   = P o (dP - delta) o (1 - (s / softcap)^2 if softcap > 0)
//   dQ   = scale * dS K;   dK = scale * dS^T Q
//
// All arithmetic in f32; dQ, dK and dV in the inputs' type.
//
// What bounds it.  Five products of 2 * Sq * Sk * D operations per (batch,
// query head), halved by a causal mask, against q, k, v, o, dO, lse in and
// dQ, dK, dV out once: at internlm2's training shape ([8, 16/8, 2048, 128],
// causal) 344 GFLOP against 0.27 GB, so arithmetic bounds it (0.348 ms at
// 989 TFLOP/s bf16; the bytes take 0.08 ms).
//
// Three launches, no atomics, so two runs give bitwise the same gradients
// (the recompute of a checkpointed period relies on it):
//
// (a) bwd_delta: delta = rowsum(dO o o) in f32, one warp a row.
// (b) dK, dV over key tiles: grid (key tiles, Hk, B).  A block holds its K
//     and V tile and loops over the query tiles of all Hq / Hk query heads
//     of its group that can see it, so the GQA sum stays in registers.
// (c) dQ over query tiles: grid (query tiles, Hq, B).  A block holds its Q
//     and dO tile and loops over the key tiles its rows can see.
// The loops' bounds skip whole tiles that the causal mask or the window
// hides; element masks apply inside the tiles.
//
// Two variants of (b) and (c), picked by dtype in the launch plan
// (kernels/flash_attention.py kernel_plan_bwd):
//
// * bf16: bwd_dkdv_mma<D>, bwd_dq_mma<D>, on the tensor cores through
//   warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Four warps;
//   a warp owns 16 rows of the block's 64 (keys in (b), queries in (c)).
//   Tiles sit in shared memory as bf16 with rows padded by 16 bytes (no
//   bank conflicts for ldmatrix); operands come from it by ldmatrix
//   (.trans where the product reads a tile along its rows: dO and Q in
//   (b), K in (c)).  P and dS go to bf16 in registers, where the
//   accumulator's layout is the A operand's of the next product.  The
//   other side's tile is 32 rows an iteration, loaded with 16-byte loads,
//   synchronously.  A first design: no cp.async ring, no wgmma, no TMA.
// * f32: bwd_dkdv_cc<D>, bwd_dq_cc<D>, on the CUDA cores in f32 FMAs
//   (which its 1e-4 tolerance needs).  32 x 32 tiles, 256 threads; the
//   tiles as f32 in shared memory with rows padded by one float; S, dP
//   and dS through shared memory.
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns the first cudaGetLastError() that is not 0 (checked after
// each launch) or the error of cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Which keys query row i sees: rows are aligned to the end of the key axis.
struct Mask {
  int Sq, Sk, causal, window;
  __device__ __forceinline__ bool ok(int i, int j) const {
    const int row = i + Sk - Sq;
    return i < Sq && j < Sk && (!causal || j <= row) && (window < 0 || j > row - window);
  }
  // Key tiles [lo, hi) of size bk that query rows [q0, q0 + rows) can see.
  __device__ __forceinline__ void key_tiles(int q0, int rows, int bk, int* lo, int* hi) const {
    const int row_lo = q0 + Sk - Sq, row_hi = q0 + rows - 1 + Sk - Sq;
    const int nk = (Sk + bk - 1) / bk;
    *hi = causal ? (row_hi < 0 ? 0 : min(nk, row_hi / bk + 1)) : nk;
    const int first_col = row_lo - window + 1;
    *lo = window >= 0 && first_col > 0 ? first_col / bk : 0;
  }
  // Query tiles [lo, hi) of size bq that can see keys [k0, k0 + bk).
  __device__ __forceinline__ void query_tiles(int k0, int bk, int bq, int* lo, int* hi) const {
    const int offset = Sk - Sq;
    const int i_lo = causal ? max(0, k0 - offset) : 0;
    int i_hi = Sq - 1;
    if (window >= 0) i_hi = min(i_hi, k0 + bk - 2 - offset + window);
    *lo = i_lo / bq;
    *hi = i_lo > i_hi ? *lo : i_hi / bq + 1;
  }
};

// s (the raw product times scale) -> the capped logit, and the softcap's
// factor on dS (1 without a softcap).
__device__ __forceinline__ float cap(float x, float softcap, float* factor) {
  if (softcap > 0.f) {
    const float th = tanhf(x / softcap);
    *factor = 1.f - th * th;
    return softcap * th;
  }
  *factor = 1.f;
  return x;
}

// ============================================== (a) delta = rowsum(dO o o)

template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
          int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * D;
  const T* drow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) delta[row] = acc;
}

// ======================================================= bf16: mma.sync

constexpr int kRows = 64;   // the block's own rows, 16 a warp
constexpr int kOther = 32;  // the other side's rows an iteration
constexpr int kMmaThreads = 128;

template <int D>
__host__ __device__ constexpr int ld_bf16() { return D + 8; }  // a row padded by 16 bytes

template <int D>
constexpr int mma_smem_bytes() {
  return (2 * kRows + 2 * kOther) * ld_bf16<D>() * 2 + 2 * kOther * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c (16 x 8, f32) += a (16 x 16, row) b (16 x 8, col), bf16 operands
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses into a bf16 tile with row stride ld (elements); lane
// is the thread's lane.  ldmatrix.x4 takes one row address a lane: lanes
// 8m..8m+7 give the rows of 8 x 8 matrix m.
//
// A operand (16 x 16) at rows m0.., columns k0.. of a row-major [m][k] tile:
// matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
// are a0..a3.
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int ld, int m0, int k0, int lane) {
  const int row = m0 + (lane & 7) + ((lane >> 3) & 1) * 8, col = k0 + (lane >> 4) * 8;
  return base + (row * ld + col) * 2;
}
// B operands of two n-tiles (n0.., n0 + 8..) at depth k0.. from a [n][k]
// tile: r0, r1 = b0, b1 of the first; r2, r3 of the second.
__device__ __forceinline__ uint32_t b_addr_nk(uint32_t base, int ld, int n0, int k0, int lane) {
  const int m = lane >> 3;
  const int row = n0 + (lane & 7) + (m >> 1) * 8, col = k0 + (m & 1) * 8;
  return base + (row * ld + col) * 2;
}
// The same from a [k][n] tile, through ldmatrix.trans.
__device__ __forceinline__ uint32_t b_addr_kn(uint32_t base, int ld, int k0, int n0, int lane) {
  const int m = lane >> 3;
  const int row = k0 + (lane & 7) + (m & 1) * 8, col = n0 + (m >> 1) * 8;
  return base + (row * ld + col) * 2;
}

// rows [0, n) of a [rows, D] bf16 matrix into a tile of stride ld, zeros
// from row `valid` on.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int valid, int n) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < n * kVecs; idx += blockDim.x) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    const uint4 x = r < valid
                        ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * ld_bf16<D>() + c) = x;
  }
}

// 16 rows (a warp's) x 32 columns of two products from shared memory:
// s = A1 B1^T and t = A2 B2^T, A [m][D] at rows m0, B [n][D] (32 rows).
template <int D>
__device__ __forceinline__ void two_products(float (&s)[4][4], float (&t)[4][4], uint32_t a1,
                                             uint32_t b1, uint32_t a2, uint32_t b2, int m0,
                                             int lane) {
  constexpr int ld = ld_bf16<D>();
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = t[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, a_addr(a1, ld, m0, 16 * kk, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      ldsm_x4(b, b_addr_nk(b1, ld, 16 * np, 16 * kk, lane));
      mma(s[2 * np], a, b[0], b[1]);
      mma(s[2 * np + 1], a, b[2], b[3]);
    }
    ldsm_x4(a, a_addr(a2, ld, m0, 16 * kk, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      ldsm_x4(b, b_addr_nk(b2, ld, 16 * np, 16 * kk, lane));
      mma(t[2 * np], a, b[0], b[1]);
      mma(t[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += X (16 x 32, the registers of two_products' layout, as
// bf16) B, B [32][D] in shared memory read along its rows (.trans).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&x)[4][4],
                                           uint32_t b_tile, int lane) {
  constexpr int ld = ld_bf16<D>();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, b_addr_kn(b_tile, ld, 16 * kk, 16 * np, lane));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// 16 rows x D of an accumulator times `mul` to bf16 rows [r0, r0 + 16) of
// dst (row stride D), rows from `valid` on skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           float mul, int r0, int valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r) * D + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// (b) dK, dV: the block owns keys [k0, k0 + 64) of kv head (b, hk).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Hq, int Hk,
             Mask mask, float softcap, float scale) {
  constexpr int ld = ld_bf16<D>();
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* vs = ks + kRows * ld;
  __nv_bfloat16* qs = vs + kRows * ld;
  __nv_bfloat16* dos = qs + kOther * ld;
  float* lse_s = reinterpret_cast<float*>(dos + kOther * ld);
  float* delta_s = lse_s + kOther;

  const int hk = blockIdx.y, b = blockIdx.z, group = Hq / Hk;
  const int k0 = blockIdx.x * kRows;  // causal: the first key tiles are the heaviest
  const int k_rows = min(kRows, mask.Sk - k0);
  const size_t kv_off = (static_cast<size_t>(b) * Hk + hk) * mask.Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_tile_bf16<D>(ks, k + kv_off + static_cast<size_t>(k0) * D, k_rows, kRows);
  load_tile_bf16<D>(vs, v + kv_off + static_cast<size_t>(k0) * D, k_rows, kRows);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  int qt_lo, qt_hi;
  mask.query_tiles(k0, kRows, kOther, &qt_lo, &qt_hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const size_t q_off = (static_cast<size_t>(b) * Hq + h) * mask.Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kOther, q_rows = min(kOther, mask.Sq - q0);
      __syncthreads();  // the previous tile's products are done with qs, dos
      load_tile_bf16<D>(qs, q + (q_off + q0) * D, q_rows, kOther);
      load_tile_bf16<D>(dos, dout + (q_off + q0) * D, q_rows, kOther);
      if (threadIdx.x < kOther) {
        const bool in = threadIdx.x < q_rows;
        lse_s[threadIdx.x] = in ? lse[q_off + q0 + threadIdx.x] : INFINITY;
        delta_s[threadIdx.x] = in ? delta[q_off + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys 16 warp + g (+8), queries
      // 8n + 2t (+1)
      float st[4][4], dpt[4][4];
      two_products<D>(st, dpt, smem_u32(ks), smem_u32(qs), smem_u32(vs), smem_u32(dos),
                      16 * warp, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 16 * warp + g + 8 * (e >> 1), il = 8 * n + 2 * t + (e & 1);
          float factor;
          const float s = cap(st[n][e] * scale, softcap, &factor);
          const float p = mask.ok(q0 + il, j) ? exp2f((s - lse_s[il]) * kLog2e) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[il]) * factor;
        }
      // dV += P^T dO, dK += dS^T Q
      accumulate<D>(acc_dv, st, smem_u32(dos), lane);
      accumulate<D>(acc_dk, dpt, smem_u32(qs), lane);
    }
  }
  store_rows<D>(dk + kv_off + static_cast<size_t>(k0) * D, acc_dk, scale, 16 * warp, k_rows,
                lane);
  store_rows<D>(dv + kv_off + static_cast<size_t>(k0) * D, acc_dv, 1.f, 16 * warp, k_rows,
                lane);
}

// (c) dQ: the block owns query rows [q0, q0 + 64) of head (b, h).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int Hq, int Hk, Mask mask, float softcap,
           float scale) {
  constexpr int ld = ld_bf16<D>();
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* dos = qs + kRows * ld;
  __nv_bfloat16* ks = dos + kRows * ld;
  __nv_bfloat16* vs = ks + kOther * ld;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest query tiles first
  const int q_rows = min(kRows, mask.Sq - q0);
  const size_t q_off = (static_cast<size_t>(b) * Hq + h) * mask.Sq + q0;
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / (Hq / Hk)) * mask.Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_tile_bf16<D>(qs, q + q_off * D, q_rows, kRows);
  load_tile_bf16<D>(dos, dout + q_off * D, q_rows, kRows);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    lse_r[hh] = r < q_rows ? lse[q_off + r] : INFINITY;
    delta_r[hh] = r < q_rows ? delta[q_off + r] : 0.f;
  }

  float acc_dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[n][e] = 0.f;

  int kt_lo, kt_hi;
  mask.key_tiles(q0, q_rows, kOther, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int j0 = kt * kOther, j_rows = min(kOther, mask.Sk - j0);
    __syncthreads();  // the previous tile's products are done with ks, vs
    load_tile_bf16<D>(ks, k + kv_off + static_cast<size_t>(j0) * D, j_rows, kOther);
    load_tile_bf16<D>(vs, v + kv_off + static_cast<size_t>(j0) * D, j_rows, kOther);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries 16 warp + g (+8), keys 8n + 2t (+1)
    float s_[4][4], dp[4][4];
    two_products<D>(s_, dp, smem_u32(qs), smem_u32(ks), smem_u32(dos), smem_u32(vs),
                    16 * warp, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e >> 1), j = j0 + 8 * n + 2 * t + (e & 1);
        float factor;
        const float s = cap(s_[n][e] * scale, softcap, &factor);
        const float p = mask.ok(q0 + r, j) ? exp2f((s - lse_r[e >> 1]) * kLog2e) : 0.f;
        dp[n][e] = p * (dp[n][e] - delta_r[e >> 1]) * factor;
      }
    accumulate<D>(acc_dq, dp, smem_u32(ks), lane);  // dQ += dS K
  }
  store_rows<D>(dq + q_off * D, acc_dq, scale, 16 * warp, q_rows, lane);
}

// ===================================================== f32: CUDA cores

constexpr int kT = 32;         // rows of either side a tile
constexpr int kCcThreads = 256;

template <int D>
constexpr int cc_smem_bytes() {
  return (4 * kT * (D + 1) + 2 * kT * (kT + 1) + 2 * kT) * 4;
}

// rows [0, kT) of a [rows, D] matrix into shared memory of stride D + 1,
// zeros from row `valid` on.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int valid) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kCcThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r < valid ? src[static_cast<size_t>(r) * D + c] : 0.f;
  }
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// (b) dK, dV: the block owns keys [k0, k0 + 32) of kv head (b, hk).
// Thread x: in the scores, key x / 8 against queries x % 8 + 8c; in the
// accumulators, key x / 8, columns x % 8 + 8c.
template <int D>
__global__ void __launch_bounds__(kCcThreads)
bwd_dkdv_cc(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hk, Mask mask,
            float softcap, float scale) {
  constexpr int ld = D + 1, lp = kT + 1;
  extern __shared__ float smem_cc[];
  float* ks = smem_cc;
  float* vs = ks + kT * ld;
  float* qs = vs + kT * ld;
  float* dos = qs + kT * ld;
  float* ps = dos + kT * ld;  // [key][query]
  float* dss = ps + kT * lp;
  float* lse_s = dss + kT * lp;
  float* delta_s = lse_s + kT;

  const int hk = blockIdx.y, b = blockIdx.z, group = Hq / Hk;
  const int k0 = blockIdx.x * kT, k_rows = min(kT, mask.Sk - k0);
  const size_t kv_off = (static_cast<size_t>(b) * Hk + hk) * mask.Sk * D;
  const int jl = threadIdx.x / 8, c0 = threadIdx.x % 8;

  load_tile_f32<D>(ks, k + kv_off + static_cast<size_t>(k0) * D, k_rows);
  load_tile_f32<D>(vs, v + kv_off + static_cast<size_t>(k0) * D, k_rows);
  float acc_dk[D / 8], acc_dv[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc_dk[c] = acc_dv[c] = 0.f;

  int qt_lo, qt_hi;
  mask.query_tiles(k0, kT, kT, &qt_lo, &qt_hi);
  for (int hh = 0; hh < group; ++hh) {
    const size_t q_off = (static_cast<size_t>(b) * Hq + hk * group + hh) * mask.Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kT, q_rows = min(kT, mask.Sq - q0);
      __syncthreads();
      load_tile_f32<D>(qs, q + (q_off + q0) * D, q_rows);
      load_tile_f32<D>(dos, dout + (q_off + q0) * D, q_rows);
      if (threadIdx.x < kT) {
        const bool in = threadIdx.x < q_rows;
        lse_s[threadIdx.x] = in ? lse[q_off + q0 + threadIdx.x] : INFINITY;
        delta_s[threadIdx.x] = in ? delta[q_off + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = c0 + 8 * c;
        float factor;
        const float s = cap(dot_rows(ks + jl * ld, qs + il * ld, D) * scale, softcap, &factor);
        const float p = mask.ok(q0 + il, k0 + jl) ? expf(s - lse_s[il]) : 0.f;
        const float dp = dot_rows(vs + jl * ld, dos + il * ld, D);
        ps[jl * lp + il] = p;
        dss[jl * lp + il] = p * (dp - delta_s[il]) * factor;
      }
      __syncthreads();
      for (int il = 0; il < kT; ++il) {
        const float p = ps[jl * lp + il], ds = dss[jl * lp + il];
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc_dv[c] = fmaf(p, dos[il * ld + c0 + 8 * c], acc_dv[c]);
          acc_dk[c] = fmaf(ds, qs[il * ld + c0 + 8 * c], acc_dk[c]);
        }
      }
    }
  }
  if (jl < k_rows) {
    const size_t row = kv_off + static_cast<size_t>(k0 + jl) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      dk[row + c0 + 8 * c] = acc_dk[c] * scale;
      dv[row + c0 + 8 * c] = acc_dv[c];
    }
  }
}

// (c) dQ: the block owns query rows [q0, q0 + 32) of head (b, h).  Thread
// x: query x / 8 against keys x % 8 + 8c; of dQ, columns x % 8 + 8c.
template <int D>
__global__ void __launch_bounds__(kCcThreads)
bwd_dq_cc(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Hq, int Hk, Mask mask, float softcap, float scale) {
  constexpr int ld = D + 1, lp = kT + 1;
  extern __shared__ float smem_cc[];
  float* qs = smem_cc;
  float* dos = qs + kT * ld;
  float* ks = dos + kT * ld;
  float* vs = ks + kT * ld;
  float* dss = vs + kT * ld;  // [query][key]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT, q_rows = min(kT, mask.Sq - q0);
  const size_t q_off = (static_cast<size_t>(b) * Hq + h) * mask.Sq + q0;
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / (Hq / Hk)) * mask.Sk * D;
  const int il = threadIdx.x / 8, c0 = threadIdx.x % 8;

  load_tile_f32<D>(qs, q + q_off * D, q_rows);
  load_tile_f32<D>(dos, dout + q_off * D, q_rows);
  const float lse_i = il < q_rows ? lse[q_off + il] : INFINITY;
  const float delta_i = il < q_rows ? delta[q_off + il] : 0.f;
  float acc_dq[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc_dq[c] = 0.f;

  int kt_lo, kt_hi;
  mask.key_tiles(q0, q_rows, kT, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int j0 = kt * kT, j_rows = min(kT, mask.Sk - j0);
    __syncthreads();
    load_tile_f32<D>(ks, k + kv_off + static_cast<size_t>(j0) * D, j_rows);
    load_tile_f32<D>(vs, v + kv_off + static_cast<size_t>(j0) * D, j_rows);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jl = c0 + 8 * c;
      float factor;
      const float s = cap(dot_rows(qs + il * ld, ks + jl * ld, D) * scale, softcap, &factor);
      const float p = mask.ok(q0 + il, j0 + jl) ? expf(s - lse_i) : 0.f;
      const float dp = dot_rows(dos + il * ld, vs + jl * ld, D);
      dss[il * lp + jl] = p * (dp - delta_i) * factor;
    }
    __syncthreads();
    for (int jl = 0; jl < kT; ++jl) {
      const float ds = dss[il * lp + jl];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc_dq[c] = fmaf(ds, ks[jl * ld + c0 + 8 * c], acc_dq[c]);
    }
  }
  if (il < q_rows) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      dq[(q_off + il) * D + c0 + 8 * c] = acc_dq[c] * scale;
  }
}

// =========================================================== launching

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Hq, Hk;
  Mask mask;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* configured) {
  // once per instantiation, at its first launch (outside any graph capture)
  if (*configured) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *configured = true;
  return 0;
}

template <typename T, int D>
int launch_delta(const Args& a) {
  const int rows = a.B * a.Hq * a.mask.Sq;
  bwd_delta<T, D><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const Args& a) {
  using T = __nv_bfloat16;
  constexpr int kSmem = mma_smem_bytes<D>();
  static bool dkdv_ok = false, dq_ok = false;
  int err = launch_delta<T, D>(a);
  if (err == 0) err = allow_smem(bwd_dkdv_mma<D>, kSmem, &dkdv_ok);
  if (err == 0) err = allow_smem(bwd_dq_mma<D>, kSmem, &dq_ok);
  if (err != 0) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  bwd_dkdv_mma<D><<<dim3((a.mask.Sk + kRows - 1) / kRows, a.Hk, a.B), kMmaThreads, kSmem,
                    a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
                                static_cast<T*>(a.dv), a.Hq, a.Hk, a.mask, a.softcap, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dq_mma<D><<<dim3((a.mask.Sq + kRows - 1) / kRows, a.Hq, a.B), kMmaThreads, kSmem,
                  a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Hq,
                              a.Hk, a.mask, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_cc(const Args& a) {
  using T = float;
  constexpr int kSmem = cc_smem_bytes<D>();
  static bool dkdv_ok = false, dq_ok = false;
  int err = launch_delta<T, D>(a);
  if (err == 0) err = allow_smem(bwd_dkdv_cc<D>, kSmem, &dkdv_ok);
  if (err == 0) err = allow_smem(bwd_dq_cc<D>, kSmem, &dq_ok);
  if (err != 0) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  bwd_dkdv_cc<D><<<dim3((a.mask.Sk + kT - 1) / kT, a.Hk, a.B), kCcThreads, kSmem,
                   a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
                               static_cast<T*>(a.dv), a.Hq, a.Hk, a.mask, a.softcap,
                               a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dq_cc<D><<<dim3((a.mask.Sq + kT - 1) / kT, a.Hq, a.B), kCcThreads, kSmem,
                 a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Hq,
                             a.Hk, a.mask, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

struct Variant {
  int dtype, d, rows, other, threads, smem;
  int (*launch)(const Args&);
};

// Every instantiation, found by (dtype, D): the launch plan
// (kernels/flash_attention.py kernel_plan_bwd) picks those two; the tiles,
// threads and shared memory are the instantiation's own.
constexpr Variant kVariants[] = {
    {1, 64, kRows, kOther, kMmaThreads, mma_smem_bytes<64>(), launch_mma<64>},
    {1, 96, kRows, kOther, kMmaThreads, mma_smem_bytes<96>(), launch_mma<96>},
    {1, 128, kRows, kOther, kMmaThreads, mma_smem_bytes<128>(), launch_mma<128>},
    {0, 64, kT, kT, kCcThreads, cc_smem_bytes<64>(), launch_cc<64>},
    {0, 96, kT, kT, kCcThreads, cc_smem_bytes<96>(), launch_cc<96>},
    {0, 128, kT, kT, kCcThreads, cc_smem_bytes<128>(), launch_cc<128>},
};

const Variant* find(int dtype, int D) {
  for (const Variant& x : kVariants)
    if (x.dtype == dtype && x.d == D) return &x;
  return nullptr;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (mma.sync).  The
// block's own rows, the other side's rows an iteration, threads and shared
// memory of (b) and (c) for (dtype, D), or cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_geometry(int dtype, int D, int* rows, int* other,
                                            int* threads, int* smem) {
  const Variant* x = find(dtype, D);
  if (x == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *rows = x->rows;
  *other = x->other;
  *threads = x->threads;
  *smem = x->smem;
  return 0;
}

// q, o, dout, dq [B, Hq, Sq, D]; k, v, dk, dv [B, Hk, Sk, D]; lse and the
// scratch delta [B, Hq, Sq] f32.  window < 0: no sliding window.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Hq, int Hk, int Sq, int Sk,
                                   int D, int dtype, int causal, int window, float softcap,
                                   float scale, void* stream) {
  const Variant* x = find(dtype, D);
  if (x == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hk,
               Mask{Sq, Sk, causal, window}, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  return x->launch(a);
}

// Mamba2 SSD chunked scan (backward), hand-written for Hopper (sm_90a).
//
// The gradient of ssd_scan.cu's forward.  It replaces no Pallas kernel: the
// JAX package trains through jax.grad of its plain chunked scan
// (repro/models/ssm.py:124, ref.ssd_chunked_ref), because jax.grad through
// its Pallas kernel is not defined.  For x [B, S, H, P], dt [B, S, H], A
// and D [H], Bm and Cm [B, S, G, N] (head h reads group h / (H / G)) and
// the output's gradient dy [B, S, H, P], per (b, h) and chunk of Q steps,
// with cum the within-chunk cumsum of dt A, seg = cum[Q - 1],
// L_ij = exp(cum_i - cum_j) for i >= j (0 above the diagonal, masked
// before the exponential), S_ij = C_i . B_j, R_ij = dy_i . x_j,
// M = S L dt_j, dS = R L dt_j, w_j = exp(seg - cum_j) dt_j, h the state
// entering the chunk and G the gradient of the state leaving it:
//
//   dx  = D dy + M^T dy + w (B G^T)        dC = dS B + exp(cum) (dy h)
//   dB  = dS^T C + w (x G)                 dD = sum dy . x
//   dcum_i = sum_j M_ij R_ij - sum_j M_ji R_ji + exp(cum_i) C_i . (dy_i h)
//            - dw_i w_i  (+ exp(seg) <G, h> + sum_j dw_j w_j at i = Q - 1)
//   ddt_j = sum_i S_ij L_ij R_ij + dw_j exp(seg - cum_j) + A da_j
//   dA = sum dt da,  da = the reverse cumsum of dcum within the chunk,
//
// dw_j = x_j . (G B_j), G = sum_i exp(cum_i) dy_i^T C_i + exp(seg) G_next
// over the chunks in reverse (zero after the last).  ref.ssd_scan_bwd_ref
// is the same arithmetic in plain PyTorch.
//
// What bounds it.  Per (b, h) and chunk the causal triangles of S, R,
// M^T dy, dS B and dS^T C take Q(Q+1)/2 (3N + 2P) multiply-adds and the
// state products (the chunk's state and its gradient, B G^T, x G, dy h)
// 5 Q P N: at mamba2-130m's training shape (x [8, 2048, 24, 64], N = 128,
// Q = 128) 58.2 GFLOP, 58.8 us at the tensor cores' 989 TFLOP/s, against
// ~171 MB of inputs and gradients, 51 us at 3.35 TB/s: bound by the
// products, narrowly.  The states are chains across chunks (forward for h,
// backward for G); everything else is chunk-parallel.
//
// Six launches on the caller's stream, no atomics, every sum in a fixed
// order (the same inputs give bitwise the same gradients), f32 scratch
// allocated by the wrapper (kernels/ssd_scan.py kernel_plan_bwd):
//   1. ssd_bwd_chunk_states, a block per (chunk, h, b): the chunk's cum
//      (written for the later phases), its own state sum_j w_j x_j^T B_j
//      and its own state gradient sum_i exp(cum_i) dy_i^T C_i, K = Q in
//      panels of 32 rows.
//   2. ssd_bwd_state_pass, 4 state elements a thread of a (b, h): h over
//      the chunks in order and G in reverse, in f32 registers, written over
//      the two [B, H, nc, P, N] scratches in place (h entering chunk c, G
//      leaving it), and each chunk's <G, h> in per-warp partial sums.
//   3. ssd_bwd_dx_db, a block per (key panel of 32 rows, chunk, h, b): dx
//      and the head's dB for the panel's rows, over the query panels at or
//      below it; the column sums of S L R and dw.
//   4. ssd_bwd_dc, a block per (query panel, chunk, h, b): the head's dC
//      over the key panels at or above it (S and R are computed again);
//      the row sums of M R and exp(cum) C . (dy h).
//   5. ssd_bwd_dcum, a block per (chunk, h, b): dcum, its reverse cumsum by
//      one warp, ddt, and the chunk's part of dA.
//   6. ssd_bwd_reduce: dBm and dCm sum their group's heads in order; dA and
//      dD sum their parts over batch and chunks in order.
// Products: every block of 4 warps splits its output tile into warp tiles
// of 16-row by 8-column fragments (the mma.sync accumulator layout).  bf16
// runs them on the tensor cores, mma.sync m16n8k16 with f32 accumulators
// and ldmatrix from padded shared memory; the operands M, dS, the state,
// its gradient and the scaled rows of B and C round to bf16 once.  f32
// runs the same fragments on the CUDA cores in f32 FMAs (no TF32), so the
// two share every index and epilogue.  Rows past S load as zeros with
// dt = 0 (identity steps, as the forward pads) and get no gradient
// written.
//
// The C entry point returns cudaGetLastError() after each launch (or the
// error of cudaFuncSetAttribute), so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // 4 warps: every chunk-parallel kernel
constexpr int kPassThreads = 256;  // state pass and reduction
constexpr int kPanel = 32;         // rows of a panel
constexpr int kMaxQ = 128;         // the longest chunk
constexpr int kRed = 512;          // floats of a block's reduction scratch
constexpr int kRow = 0, kCol = 1;  // operand layouts in shared memory

// Leading dimension of a shared tile of w columns of T: rows 16 bytes
// apart beyond their width, so 8 rows of a fragment fall in 8 banks.
template <class T>
__host__ __device__ constexpr int ld_of(int w) {
  return w + 16 / static_cast<int>(sizeof(T));
}
// Floats after the tiles of phases 3 and 4: dt and cum of the chunk, two
// vectors of a panel's rows, the reduction scratch.
constexpr int kTail = 2 * kMaxQ + 2 * kPanel + kRed;

template <class T>
__host__ __device__ constexpr int states_smem(int P, int N) {
  return kPanel * (ld_of<T>(P) + ld_of<T>(N)) * static_cast<int>(sizeof(T)) + 4 * kMaxQ * 4;
}
template <class T>
__host__ __device__ constexpr int dxdb_smem(int P, int N) {
  return (2 * kPanel * (ld_of<T>(P) + ld_of<T>(N)) + P * ld_of<T>(N) + 2 * kPanel * ld_of<T>(32)) *
             static_cast<int>(sizeof(T)) +
         kTail * 4;
}
template <class T>
__host__ __device__ constexpr int dc_smem(int P, int N) {
  return (2 * kPanel * (ld_of<T>(P) + ld_of<T>(N)) + P * ld_of<T>(N) + kPanel * ld_of<T>(32)) *
             static_cast<int>(sizeof(T)) +
         kTail * 4;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- fragments
// A block's [MR x NC] output tile over its 4 warps: WM x WN warps, each
// MT 16-row by NT 8-column fragments; warps past WM * WN hold nothing.
template <int MR, int NC>
struct Grid {
  static constexpr int WM = MR / 16 < 4 ? MR / 16 : 4;
  static constexpr int WN = NC / 8 < 4 / WM ? NC / 8 : 4 / WM;
  static constexpr int MT = MR / 16 / WM;
  static constexpr int NT = NC / 8 / WN;
};

// acc[mt][nt][e] holds row m0 + 16 mt + lane / 4 + 8 (e / 2), column
// n0 + 8 nt + 2 (lane % 4) + e % 2 (the m16n8 accumulator of mma.sync).
// warp_mma adds A (16 MT x K) times B (K x 8 NT) from shared memory, K a
// multiple of 16: A(m, k) = a[m lda + k] (kRow) or a[k lda + m] (kCol),
// B(k, n) = b[k ldb + n] (kRow) or b[n ldb + k] (kCol), m and n counted
// from the warp's origin (m0, n0).
template <int AL, int BL, int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const float* a, int lda, int m0,
                                         const float* b, int ldb, int n0, int K, int lane) {
  const float* ao = AL == kRow ? a + m0 * lda : a + m0;
  const float* bo = BL == kRow ? b + n0 : b + n0 * ldb;
  const int r = lane / 4, c = 2 * (lane % 4);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[MT][2], bv[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = 16 * mt + r + 8 * u;
        av[mt][u] = AL == kRow ? ao[m * lda + k] : ao[k * lda + m];
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = 8 * nt + c + u;
        bv[nt][u] = BL == kRow ? bo[k * ldb + n] : bo[n * ldb + k];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = fmaf(av[mt][e >> 1], bv[nt][e & 1], acc[mt][nt][e]);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same product on the tensor cores: per 16 of K, ldmatrix loads A's
// 16 x 16 fragment of each M tile (.trans where A is stored K-major) and
// B's 16 x 8 fragment of each N tile (.trans where B is stored N-major).
template <int AL, int BL, int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const bf16* a, int lda, int m0,
                                         const bf16* b, int ldb, int n0, int K, int lane) {
  const bf16* ao = AL == kRow ? a + m0 * lda : a + m0;
  const bf16* bo = BL == kRow ? b + n0 : b + n0 * ldb;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (AL == kRow)
        ldsm_x4(af[mt], ao + (16 * mt + lane % 16) * lda + k0 + (lane / 16) * 8);
      else
        ldsm_x4_t(af[mt], ao + (k0 + lane % 8 + (lane / 16) * 8) * lda + 16 * mt +
                              ((lane / 8) % 2) * 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bfr[2];
      if (BL == kCol)
        ldsm_x2(bfr, bo + (8 * nt + lane % 8) * ldb + k0 + ((lane / 8) % 2) * 8);
      else
        ldsm_x2_t(bfr, bo + (k0 + lane % 16) * ldb + 8 * nt);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], bfr);
    }
  }
}

// The block's [MR x NC] tile += A B over K, each warp its fragments.
template <int MR, int NC, int AL, int BL, class T>
__device__ __forceinline__ void block_mma(float (&acc)[Grid<MR, NC>::MT][Grid<MR, NC>::NT][4],
                                          const T* a, int lda, const T* b, int ldb, int K,
                                          int warp, int lane) {
  using Gd = Grid<MR, NC>;
  if (warp >= Gd::WM * Gd::WN) return;
  warp_mma<AL, BL>(acc, a, lda, (warp % Gd::WM) * Gd::MT * 16, b, ldb,
                   (warp / Gd::WM) * Gd::NT * 8, K, lane);
}

template <int MR, int NC>
__device__ __forceinline__ void zero(float (&acc)[Grid<MR, NC>::MT][Grid<MR, NC>::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < Grid<MR, NC>::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Grid<MR, NC>::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// f(value, row, column, mt, nt, e) for each element this thread holds.
template <int MR, int NC, class F>
__device__ __forceinline__ void for_each(float (&acc)[Grid<MR, NC>::MT][Grid<MR, NC>::NT][4],
                                         int warp, int lane, F f) {
  using Gd = Grid<MR, NC>;
  if (warp >= Gd::WM * Gd::WN) return;
  const int m0 = (warp % Gd::WM) * Gd::MT * 16 + lane / 4;
  const int n0 = (warp / Gd::WM) * Gd::NT * 8 + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < Gd::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Gd::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(acc[mt][nt][e], m0 + 16 * mt + 8 * (e >> 1), n0 + 8 * nt + (e & 1), mt, nt, e);
}

// out[row] = the sum over the block of each thread's part[mt][u] of row
// m0 + 16 mt + lane / 4 + 8 u: the 4 lanes of a row, then the WN warps of
// its columns, in order.  Every thread of the block calls it.
template <int MR, int NC>
__device__ void reduce_rows(float (&part)[Grid<MR, NC>::MT][2], float* red, float* out, int warp,
                            int lane, int tid) {
  using Gd = Grid<MR, NC>;
  if (warp < Gd::WM * Gd::WN) {
    const int m0 = (warp % Gd::WM) * Gd::MT * 16 + lane / 4;
#pragma unroll
    for (int mt = 0; mt < Gd::MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = part[mt][u];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (lane % 4 == 0) red[(warp / Gd::WM) * MR + m0 + 16 * mt + 8 * u] = v;
      }
  }
  __syncthreads();
  for (int i = tid; i < MR; i += kThreads) {
    float s = 0.f;
    for (int wn = 0; wn < Gd::WN; ++wn) s += red[wn * MR + i];
    out[i] = s;
  }
  __syncthreads();
}

// out[col] = the sum over the block of each thread's part[nt][u] of column
// n0 + 8 nt + 2 (lane % 4) + u: the 8 lanes of a column, then the WM warps
// of its rows, in order.
template <int MR, int NC>
__device__ void reduce_cols(float (&part)[Grid<MR, NC>::NT][2], float* red, float* out, int warp,
                            int lane, int tid) {
  using Gd = Grid<MR, NC>;
  if (warp < Gd::WM * Gd::WN) {
    const int n0 = (warp / Gd::WM) * Gd::NT * 8 + 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < Gd::NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = part[nt][u];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[(warp % Gd::WM) * NC + n0 + 8 * nt + u] = v;
      }
  }
  __syncthreads();
  for (int i = tid; i < NC; i += kThreads) {
    float s = 0.f;
    for (int wm = 0; wm < Gd::WM; ++wm) s += red[wm * NC + i];
    out[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of every thread's v over a block of `threads`, in a fixed order;
// every thread gets it.
__device__ float block_sum(float v, float* red, int threads, int warp, int lane, int tid) {
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < threads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Inclusive cumsum of dt * a over rows [0, rows) of a chunk (rows <= 128),
// by one warp, with rounded products and no FMA, as ssd_scan.cu's forward
// sums them: lane l sums elements 4l..4l+3 in order, then a scan over the
// lanes' sums.
__device__ __forceinline__ void chunk_cumsum(const float* sDt, float* sCum, float a, int rows,
                                             int lane) {
  float part[4], run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = 4 * lane + u;
    run = __fadd_rn(run, i < rows ? __fmul_rn(sDt[i], a) : 0.f);
    part[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, o);
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);  // exclusive
  if (lane == 0) base = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (4 * lane + u < rows) sCum[4 * lane + u] = __fadd_rn(base, part[u]);
}

// out[i] = sum of in[k] for i <= k < n (n <= 128), by one warp, in the
// order of chunk_cumsum over the reversed rows.
__device__ __forceinline__ void reverse_cumsum(const float* in, float* out, int n, int lane) {
  float part[4], run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = 4 * lane + u;
    run += r < n ? in[n - 1 - r] : 0.f;
    part[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) base = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (4 * lane + u < n) out[n - 1 - (4 * lane + u)] = base + part[u];
}

// ------------------------------------------------------------ tile loads
// Rows [0, 32) of a panel of W columns (row i at src + i * stride
// elements, 16-byte aligned) into dst[i * ld + c]; rows i >= valid load as
// zeros.  With `scale`, row i is multiplied by scale[i] (one rounding to T).
template <int W, class T>
__device__ __forceinline__ void load_panel(T* dst, int ld, const T* src, int64_t stride,
                                           int valid, const float* scale, int tid) {
  constexpr int V = 16 / sizeof(T), PR = W / V;  // elements a piece, pieces a row
  for (int e = tid; e < kPanel * PR; e += kThreads) {
    const int i = e / PR, q = e - i * PR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < valid) {
      v = *reinterpret_cast<const uint4*>(src + i * stride + q * V);
      if (scale != nullptr) {
        T* t = reinterpret_cast<T*>(&v);
        const float s = scale[i];
#pragma unroll
        for (int u = 0; u < V; ++u) t[u] = from_f<T>(to_f(t[u]) * s);
      }
    }
    *reinterpret_cast<uint4*>(dst + i * ld + q * V) = v;
  }
}

// An f32 [P, N] state into shared memory [P][ld] as T.
template <int P, int N, class T>
__device__ __forceinline__ void load_state(T* dst, int ld, const float* src, int tid) {
  for (int e = tid; e < P * N / 4; e += kThreads) {
    const int r = (4 * e) / N, c = 4 * e - r * N;
    const float4 v = reinterpret_cast<const float4*>(src)[e];
    dst[r * ld + c] = from_f<T>(v.x);
    dst[r * ld + c + 1] = from_f<T>(v.y);
    dst[r * ld + c + 2] = from_f<T>(v.z);
    dst[r * ld + c + 3] = from_f<T>(v.w);
  }
}

struct Args {
  const void *x, *Bm, *Cm, *dy;  // T, contiguous, 16-byte aligned
  const float *dt, *A, *D;       // dt [B, S, H] contiguous
  void *dx, *dBm, *dCm;          // T, contiguous
  float *ddt, *dA, *dD;
  // f32 scratch: cum, the chunks' dcum row parts, column sums, dw
  // [B, H, nc Q]; state, state gradient [B, H, nc, P, N]; the heads' dB and
  // dC [B, S, H, N]; <G, h> parts [B, H, nc, tiles 8]; dA parts [B, H, nc];
  // dD parts [B, H, nc Q / 32]
  float *cum, *state, *grad, *dbh, *dch, *rowp, *colt, *dw, *dots, *dap, *ddp;
  int B, S, H, G, P, N, Q;
};

// dt and cum of chunk c into shared memory (rows past S: dt = 0).
__device__ __forceinline__ void load_chunk_dt_cum(const Args& a, float* sDt, float* sCum,
                                                  int64_t bh, int b, int h, int c, int nc,
                                                  int tid) {
  const int t0 = c * a.Q;
  for (int i = tid; i < kMaxQ; i += kThreads) {
    const int t = t0 + i;
    sDt[i] = i < a.Q && t < a.S ? a.dt[(static_cast<int64_t>(b) * a.S + t) * a.H + h] : 0.f;
    sCum[i] = i < a.Q ? a.cum[bh * nc * a.Q + t0 + i] : 0.f;
  }
}

// ============================================================== kernels

// 1. cum; the chunk's own state sum_j w_j x_j^T B_j and state gradient
// sum_i exp(cum_i) dy_i^T C_i, each [P, N] f32 into state / grad.
template <class T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_states(Args a) {
  constexpr int LP = ld_of<T>(P), LN = ld_of<T>(N);
  extern __shared__ __align__(16) uint8_t smem[];
  T* sX = reinterpret_cast<T*>(smem);  // x or dy panel [32][LP]
  T* sB = sX + kPanel * LP;            // B or C panel [32][LN], scaled
  float* sDt = reinterpret_cast<float*>(sB + kPanel * LN);
  float* sCum = sDt + kMaxQ;
  float* sW = sCum + kMaxQ;
  float* sE = sW + kMaxQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (a.H / a.G), Q = a.Q, t0 = c * Q, S = a.S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  for (int i = tid; i < kMaxQ; i += kThreads) {
    const int t = t0 + i;
    sDt[i] = i < Q && t < S ? a.dt[(static_cast<int64_t>(b) * S + t) * a.H + h] : 0.f;
  }
  __syncthreads();
  if (warp == 0) chunk_cumsum(sDt, sCum, a.A[h], Q, lane);
  __syncthreads();
  const float seg = sCum[Q - 1];
  for (int i = tid; i < Q; i += kThreads) {
    sW[i] = expf(seg - sCum[i]) * sDt[i];
    sE[i] = expf(sCum[i]);
    a.cum[bh * nc * Q + t0 + i] = sCum[i];
  }
  __syncthreads();

  float acc[Grid<P, N>::MT][Grid<P, N>::NT][4];
  for (int pass = 0; pass < 2; ++pass) {
    const T* xs = static_cast<const T*>(pass == 0 ? a.x : a.dy);
    const T* bs = static_cast<const T*>(pass == 0 ? a.Bm : a.Cm);
    const float* scale = pass == 0 ? sW : sE;
    zero<P, N>(acc);
    for (int j0 = 0; j0 < Q; j0 += kPanel) {
      const int t = t0 + j0;
      load_panel<P>(sX, LP, xs + ((static_cast<int64_t>(b) * S + t) * a.H + h) * P,
                    static_cast<int64_t>(a.H) * P, S - t, nullptr, tid);
      load_panel<N>(sB, LN, bs + ((static_cast<int64_t>(b) * S + t) * a.G + g) * N,
                    static_cast<int64_t>(a.G) * N, S - t, scale + j0, tid);
      __syncthreads();
      // [P, N] += x^T (w B): A(p, j) = x[j][p] (K-major), B(j, n) row-major
      block_mma<P, N, kCol, kRow>(acc, sX, LP, sB, LN, kPanel, warp, lane);
      __syncthreads();
    }
    float* out = (pass == 0 ? a.state : a.grad) + (bh * nc + c) * P * N;
    for_each<P, N>(acc, warp, lane,
                   [&](float v, int r, int col, int, int, int) { out[r * N + col] = v; });
  }
}

// 2. Per (b, h), 4 state elements a thread: h entering each chunk over the
// chunk's own state in place; then G leaving each chunk over the chunk's
// own gradient in place, and <G, h> of each chunk summed over each warp.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass(float* __restrict__ state, float* __restrict__ grad,
                   const float* __restrict__ cum, float* __restrict__ dots, int nc, int Q,
                   int PN) {
  const int tile = blockIdx.y, tiles = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = (tile * kPassThreads + threadIdx.x) * 4;
  const bool on = e < PN;
  const int64_t bh = blockIdx.x;
  const float* seg = cum + bh * nc * Q + Q - 1;
  float4* hp = reinterpret_cast<float4*>(state + bh * nc * PN + e);
  float4* gp = reinterpret_cast<float4*>(grad + bh * nc * PN + e);
  const int step = PN / 4;
  if (on) {
    float4 hs = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < nc; ++c) {
      const float decay = expf(seg[c * Q]);
      const float4 s = hp[c * step];
      hp[c * step] = hs;
      hs = make_float4(decay * hs.x + s.x, decay * hs.y + s.y, decay * hs.z + s.z,
                       decay * hs.w + s.w);
    }
  }
  float4 gs = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    float d = 0.f;
    if (on) {
      const float keep = expf(seg[c * Q]);  // G_c = u_c + exp(seg_c) G_{c+1}
      const float4 u = gp[c * step];
      const float4 hv = hp[c * step];
      gp[c * step] = gs;
      d = gs.x * hv.x + gs.y * hv.y + gs.z * hv.z + gs.w * hv.w;
      gs = make_float4(u.x + keep * gs.x, u.y + keep * gs.y, u.z + keep * gs.z,
                       u.w + keep * gs.w);
    }
    d = warp_sum(d);
    if (lane == 0) dots[((bh * nc + c) * tiles + tile) * (kPassThreads / 32) + warp] = d;
  }
}

// 3. Key panel jp of chunk c: dx = D dy + M^T dy + w (B G^T) and the
// head's dB = dS^T C + w (x G) for its 32 rows, over the query panels
// ip >= jp; the column sums of S L R and dw = x . (G B).
template <class T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_db(Args a) {
  constexpr int LP = ld_of<T>(P), LN = ld_of<T>(N), L32 = ld_of<T>(32);
  extern __shared__ __align__(16) uint8_t smem[];
  T* sB = reinterpret_cast<T*>(smem);  // the key panel's B, x
  T* sX = sB + kPanel * LN;
  T* sC = sX + kPanel * LP;            // a query panel's C, dy
  T* sDY = sC + kPanel * LN;
  T* sG = sDY + kPanel * LP;           // G [P][LN]
  T* sM = sG + P * LN;                 // M, dS of the panel pair [32][L32]
  T* sDS = sM + kPanel * L32;
  float* sDt = reinterpret_cast<float*>(sDS + kPanel * L32);
  float* sCum = sDt + kMaxQ;
  float* sWj = sCum + kMaxQ;           // w_j of the key panel
  float* sV = sWj + kPanel;            // dw, then the column sums
  float* red = sV + kPanel;

  const int nq = a.Q / kPanel;
  const int c = blockIdx.x / nq, jp = blockIdx.x % nq, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / nq, g = h / (a.H / a.G), Q = a.Q, S = a.S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  const int t0 = c * Q, tj = t0 + kPanel * jp;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const int64_t sx = static_cast<int64_t>(a.H) * P, sb = static_cast<int64_t>(a.G) * N;
  const int64_t xrow = static_cast<int64_t>(b) * S * a.H + h;  // (b, t = 0, h)
  const int64_t brow = static_cast<int64_t>(b) * S * a.G + g;

  load_chunk_dt_cum(a, sDt, sCum, bh, b, h, c, nc, tid);
  load_panel<N>(sB, LN, Bm + (brow + static_cast<int64_t>(tj) * a.G) * N, sb, S - tj, nullptr, tid);
  load_panel<P>(sX, LP, x + (xrow + static_cast<int64_t>(tj) * a.H) * P, sx, S - tj, nullptr, tid);
  load_state<P, N>(sG, LN, a.grad + (bh * nc + c) * P * N, tid);
  __syncthreads();
  const float seg = sCum[Q - 1];
  if (tid < kPanel) {
    const int j = kPanel * jp + tid;
    sWj[tid] = expf(seg - sCum[j]) * sDt[j];
  }

  using GX = Grid<kPanel, P>;
  using GB = Grid<kPanel, N>;
  using GS = Grid<kPanel, kPanel>;
  float ax[GX::MT][GX::NT][4], ab[GB::MT][GB::NT][4];
  zero<kPanel, P>(ax);
  zero<kPanel, N>(ab);
  // (B G^T)[j, p]: B(n, p) = G[p][n] (K-major); (x G)[j, n]: G row-major
  block_mma<kPanel, P, kRow, kCol>(ax, sB, LN, sG, LN, N, warp, lane);
  block_mma<kPanel, N, kRow, kRow>(ab, sX, LP, sG, LN, P, warp, lane);
  float part[GB::MT][2] = {};
  for_each<kPanel, N>(ab, warp, lane, [&](float v, int r, int col, int mt, int, int e) {
    part[mt][e >> 1] += to_f(sB[r * LN + col]) * v;
  });
  reduce_rows<kPanel, N>(part, red, sV, warp, lane, tid);  // dw; syncs (sWj)
  if (tid < kPanel) a.dw[bh * nc * Q + tj + tid] = sV[tid];
  for_each<kPanel, P>(ax, warp, lane, [&](float& v, int r, int, int, int, int) { v *= sWj[r]; });
  for_each<kPanel, N>(ab, warp, lane, [&](float& v, int r, int, int, int, int) { v *= sWj[r]; });

  float colp[GS::NT][2] = {};
  for (int ip = jp; ip < nq; ++ip) {
    const int ti = t0 + kPanel * ip;
    load_panel<N>(sC, LN, Cm + (brow + static_cast<int64_t>(ti) * a.G) * N, sb, S - ti, nullptr,
                  tid);
    load_panel<P>(sDY, LP, dy + (xrow + static_cast<int64_t>(ti) * a.H) * P, sx, S - ti, nullptr,
                  tid);
    __syncthreads();
    float s_[GS::MT][GS::NT][4], r_[GS::MT][GS::NT][4];
    zero<kPanel, kPanel>(s_);
    zero<kPanel, kPanel>(r_);
    // S = C B^T and R = dy x^T over the panel pair (B and x K-major)
    block_mma<kPanel, kPanel, kRow, kCol>(s_, sC, LN, sB, LN, N, warp, lane);
    block_mma<kPanel, kPanel, kRow, kCol>(r_, sDY, LP, sX, LP, P, warp, lane);
    for_each<kPanel, kPanel>(s_, warp, lane, [&](float sv, int ii, int jj, int mt, int nt, int e) {
      const int i = kPanel * ip + ii, j = kPanel * jp + jj;
      float m = 0.f, ds = 0.f;
      if (i >= j) {
        const float L = expf(sCum[i] - sCum[j]), rv = r_[mt][nt][e];
        m = sv * L * sDt[j];
        ds = rv * L * sDt[j];
        colp[nt][e & 1] += sv * L * rv;
      }
      sM[ii * L32 + jj] = from_f<T>(m);
      sDS[ii * L32 + jj] = from_f<T>(ds);
    });
    __syncthreads();
    // dx += M^T dy, dB += dS^T C: A(j, i) = M[i][j] (K-major), B row-major
    block_mma<kPanel, P, kCol, kRow>(ax, sM, L32, sDY, LP, kPanel, warp, lane);
    block_mma<kPanel, N, kCol, kRow>(ab, sDS, L32, sC, LN, kPanel, warp, lane);
    __syncthreads();
  }
  reduce_cols<kPanel, kPanel>(colp, red, sV, warp, lane, tid);
  if (tid < kPanel) a.colt[bh * nc * Q + tj + tid] = sV[tid];

  // dx = that + D dy, stored in T; dD's part of the panel
  const float dskip = a.D[h];
  float dd = 0.f;
  T* dx = static_cast<T*>(a.dx);
  for_each<kPanel, P>(ax, warp, lane, [&](float v, int r, int col, int, int, int) {
    const int t = tj + r;
    if (t >= S) return;
    const int64_t idx = (xrow + static_cast<int64_t>(t) * a.H) * P + col;
    const float dyv = to_f(dy[idx]);
    dx[idx] = from_f<T>(v + dskip * dyv);
    dd += dyv * to_f(x[idx]);
  });
  dd = block_sum(dd, red, kThreads, warp, lane, tid);
  if (tid == 0) a.ddp[(bh * nc + c) * nq + jp] = dd;
  for_each<kPanel, N>(ab, warp, lane, [&](float v, int r, int col, int, int, int) {
    const int t = tj + r;
    if (t < S) a.dbh[((static_cast<int64_t>(b) * S + t) * a.H + h) * N + col] = v;
  });
}

// 4. Query panel ip of chunk c: the head's dC = dS B + exp(cum) (dy h)
// for its 32 rows over the key panels jp <= ip; the row parts of dcum:
// sum_j M_ij R_ij + exp(cum_i) C_i . (dy_i h).
template <class T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dc(Args a) {
  constexpr int LP = ld_of<T>(P), LN = ld_of<T>(N), L32 = ld_of<T>(32);
  extern __shared__ __align__(16) uint8_t smem[];
  T* sC = reinterpret_cast<T*>(smem);  // the query panel's C, dy
  T* sDY = sC + kPanel * LN;
  T* sB = sDY + kPanel * LP;           // a key panel's B, x
  T* sX = sB + kPanel * LN;
  T* sH = sX + kPanel * LP;            // h [P][LN]
  T* sDS = sH + P * LN;                // dS of the panel pair [32][L32]
  float* sDt = reinterpret_cast<float*>(sDS + kPanel * L32);
  float* sCum = sDt + kMaxQ;
  float* sRp = sCum + kMaxQ;           // C . (dy h), then the row sums of M R
  float* sRz = sRp + kPanel;
  float* red = sRz + kPanel;

  const int nq = a.Q / kPanel;
  const int c = blockIdx.x / nq, ip = blockIdx.x % nq, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / nq, g = h / (a.H / a.G), Q = a.Q, S = a.S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  const int t0 = c * Q, ti = t0 + kPanel * ip;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const int64_t sx = static_cast<int64_t>(a.H) * P, sb = static_cast<int64_t>(a.G) * N;
  const int64_t xrow = static_cast<int64_t>(b) * S * a.H + h;
  const int64_t brow = static_cast<int64_t>(b) * S * a.G + g;

  load_chunk_dt_cum(a, sDt, sCum, bh, b, h, c, nc, tid);
  load_panel<N>(sC, LN, Cm + (brow + static_cast<int64_t>(ti) * a.G) * N, sb, S - ti, nullptr, tid);
  load_panel<P>(sDY, LP, dy + (xrow + static_cast<int64_t>(ti) * a.H) * P, sx, S - ti, nullptr,
                tid);
  load_state<P, N>(sH, LN, a.state + (bh * nc + c) * P * N, tid);
  __syncthreads();

  using GC = Grid<kPanel, N>;
  using GS = Grid<kPanel, kPanel>;
  float ac[GC::MT][GC::NT][4];
  zero<kPanel, N>(ac);
  // (dy h)[i, n] = sum_p dy[i][p] h[p][n]
  block_mma<kPanel, N, kRow, kRow>(ac, sDY, LP, sH, LN, P, warp, lane);
  float part[GC::MT][2] = {};
  for_each<kPanel, N>(ac, warp, lane, [&](float v, int r, int col, int mt, int, int e) {
    part[mt][e >> 1] += to_f(sC[r * LN + col]) * v;
  });
  reduce_rows<kPanel, N>(part, red, sRp, warp, lane, tid);
  for_each<kPanel, N>(ac, warp, lane, [&](float& v, int r, int, int, int, int) {
    v *= expf(sCum[kPanel * ip + r]);
  });

  float rowz[GS::MT][2] = {};
  for (int jp = 0; jp <= ip; ++jp) {
    const int tj = t0 + kPanel * jp;
    load_panel<N>(sB, LN, Bm + (brow + static_cast<int64_t>(tj) * a.G) * N, sb, S - tj, nullptr,
                  tid);
    load_panel<P>(sX, LP, x + (xrow + static_cast<int64_t>(tj) * a.H) * P, sx, S - tj, nullptr,
                  tid);
    __syncthreads();
    float s_[GS::MT][GS::NT][4], r_[GS::MT][GS::NT][4];
    zero<kPanel, kPanel>(s_);
    zero<kPanel, kPanel>(r_);
    block_mma<kPanel, kPanel, kRow, kCol>(s_, sC, LN, sB, LN, N, warp, lane);
    block_mma<kPanel, kPanel, kRow, kCol>(r_, sDY, LP, sX, LP, P, warp, lane);
    for_each<kPanel, kPanel>(s_, warp, lane, [&](float sv, int ii, int jj, int mt, int nt, int e) {
      const int i = kPanel * ip + ii, j = kPanel * jp + jj;
      float ds = 0.f;
      if (i >= j) {
        const float L = expf(sCum[i] - sCum[j]), rv = r_[mt][nt][e];
        ds = rv * L * sDt[j];
        rowz[mt][e >> 1] += sv * L * rv * sDt[j];
      }
      sDS[ii * L32 + jj] = from_f<T>(ds);
    });
    __syncthreads();
    // dC += dS B: dS row-major, B row-major
    block_mma<kPanel, N, kRow, kRow>(ac, sDS, L32, sB, LN, kPanel, warp, lane);
    __syncthreads();
  }
  reduce_rows<kPanel, kPanel>(rowz, red, sRz, warp, lane, tid);
  if (tid < kPanel)
    a.rowp[bh * nc * Q + ti + tid] = sRz[tid] + expf(sCum[kPanel * ip + tid]) * sRp[tid];
  for_each<kPanel, N>(ac, warp, lane, [&](float v, int r, int col, int, int, int) {
    const int t = ti + r;
    if (t < S) a.dch[((static_cast<int64_t>(b) * S + t) * a.H + h) * N + col] = v;
  });
}

// 5. Per (chunk, h, b), thread i of row i: dcum, da its reverse cumsum, ddt
// and the chunk's part of dA = sum dt da.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcum(Args a, int dot_parts) {
  __shared__ float sDc[kMaxQ], sDa[kMaxQ], red[kThreads / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Q = a.Q, S = a.S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  const int64_t base = bh * nc * Q + c * Q;
  const int i = tid, t = c * Q + i;
  const bool in = i < Q;
  const float dt = in && t < S ? a.dt[(static_cast<int64_t>(b) * S + t) * a.H + h] : 0.f;
  const float cum = in ? a.cum[base + i] : 0.f, seg = a.cum[base + Q - 1];
  const float colt = in ? a.colt[base + i] : 0.f, dw = in ? a.dw[base + i] : 0.f;
  const float rowp = in ? a.rowp[base + i] : 0.f;
  const float decay_j = in ? expf(seg - cum) : 0.f;
  const float dww = dw * decay_j * dt;
  float dot = 0.f;
  const float* parts = a.dots + (bh * nc + c) * dot_parts;
  for (int k = 0; k < dot_parts; ++k) dot += parts[k];
  const float dseg = expf(seg) * dot + block_sum(dww, red, kThreads, warp, lane, tid);
  if (in) sDc[i] = rowp - dt * colt - dww + (i == Q - 1 ? dseg : 0.f);
  __syncthreads();
  if (warp == 0) reverse_cumsum(sDc, sDa, Q, lane);
  __syncthreads();
  const float da = in ? sDa[i] : 0.f;
  if (in && t < S)
    a.ddt[(static_cast<int64_t>(b) * S + t) * a.H + h] = colt + dw * decay_j + a.A[h] * da;
  const float part = block_sum(dt * da, red, kThreads, warp, lane, tid);
  if (tid == 0) a.dap[bh * nc + c] = part;
}

// 6. blockIdx.y 0: dBm and dCm, 4 elements a thread, each the sum of its
// group's heads in order; blockIdx.y 1: dA and dD of head h, their parts
// summed over batch and chunks in order.
template <class T>
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_reduce(Args a, int nc) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (blockIdx.y == 1) {
    if (e >= a.H) return;
    const int nq = a.Q / kPanel;
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < a.B; ++b) {
      const int64_t bh = static_cast<int64_t>(b) * a.H + e;
      for (int c = 0; c < nc; ++c) sa += a.dap[bh * nc + c];
      for (int k = 0; k < nc * nq; ++k) sd += a.ddp[bh * nc * nq + k];
    }
    a.dA[e] = sa;
    a.dD[e] = sd;
    return;
  }
  const int64_t quads = static_cast<int64_t>(a.B) * a.S * a.G * a.N / 4;
  if (e >= quads) return;
  const int64_t idx = 4 * e;
  const int n = static_cast<int>(idx % a.N);
  const int64_t rest = idx / a.N;
  const int g = static_cast<int>(rest % a.G);
  const int64_t bs = rest / a.G;  // b * S + s
  const int hpg = a.H / a.G;
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int k = 0; k < hpg; ++k) {
    const int64_t off = (bs * a.H + g * hpg + k) * a.N + n;
    const float4 vb = *reinterpret_cast<const float4*>(a.dbh + off);
    const float4 vc = *reinterpret_cast<const float4*>(a.dch + off);
    sb = make_float4(sb.x + vb.x, sb.y + vb.y, sb.z + vb.z, sb.w + vb.w);
    sc = make_float4(sc.x + vc.x, sc.y + vc.y, sc.z + vc.z, sc.w + vc.w);
  }
  T* dB = static_cast<T*>(a.dBm) + idx;
  T* dC = static_cast<T*>(a.dCm) + idx;
  dB[0] = from_f<T>(sb.x), dB[1] = from_f<T>(sb.y), dB[2] = from_f<T>(sb.z), dB[3] = from_f<T>(sb.w);
  dC[0] = from_f<T>(sc.x), dC[1] = from_f<T>(sc.y), dC[2] = from_f<T>(sc.z), dC[3] = from_f<T>(sc.w);
}

constexpr int pass_tiles(int PN) { return (PN / 4 + kPassThreads - 1) / kPassThreads; }

template <class T, int P, int N>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kS1 = states_smem<T>(P, N), kS3 = dxdb_smem<T>(P, N), kS4 = dc_smem<T>(P, N);
  static_assert(kS3 <= 232448 && kS4 <= 232448, "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_states<T, P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kS1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dx_db<T, P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kS3);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dc<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kS4);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (a.S + a.Q - 1) / a.Q, nq = a.Q / kPanel, PN = P * N;
  const dim3 chunks(nc, a.H, a.B), panels(nc * nq, a.H, a.B);
  ssd_bwd_chunk_states<T, P, N><<<chunks, kThreads, kS1, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_state_pass<<<dim3(a.B * a.H, pass_tiles(PN)), kPassThreads, 0, stream>>>(
      a.state, a.grad, a.cum, a.dots, nc, a.Q, PN);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dx_db<T, P, N><<<panels, kThreads, kS3, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dc<T, P, N><<<panels, kThreads, kS4, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dcum<<<chunks, kThreads, 0, stream>>>(a, pass_tiles(PN) * (kPassThreads / 32));
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int64_t quads = static_cast<int64_t>(a.B) * a.S * a.G * a.N / 4;
  const int64_t blocks = (quads + kPassThreads - 1) / kPassThreads;
  const int64_t head_blocks = (a.H + kPassThreads - 1) / kPassThreads;
  ssd_bwd_reduce<T><<<dim3(static_cast<unsigned>(blocks > head_blocks ? blocks : head_blocks), 2),
                      kPassThreads, 0, stream>>>(a, nc);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const Args&, cudaStream_t);

bool head_dim(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

template <class T, int P>
Launch for_n(int N) {
  switch (N) {
    case 16: return launch<T, P, 16>;
    case 32: return launch<T, P, 32>;
    case 64: return launch<T, P, 64>;
    case 128: return launch<T, P, 128>;
    default: return nullptr;
  }
}

template <class T>
Launch for_pn(int P, int N) {
  switch (P) {
    case 16: return for_n<T, 16>(N);
    case 32: return for_n<T, 32>(N);
    case 64: return for_n<T, 64>(N);
    case 128: return for_n<T, 128>(N);
    default: return nullptr;
  }
}

Launch find(int dtype, int P, int N) {
  if (!head_dim(P) || !head_dim(N)) return nullptr;
  return dtype == 0 ? for_pn<float>(P, N) : dtype == 1 ? for_pn<bf16>(P, N) : nullptr;
}

template <class T>
int smem_of(int phase, int P, int N) {
  return phase == 0 ? states_smem<T>(P, N)
         : phase == 2 ? dxdb_smem<T>(P, N)
         : phase == 3 ? dc_smem<T>(P, N)
                      : 0;
}

}  // namespace

// Threads and dynamic shared memory of launch `phase` (0 chunk states,
// 1 state pass, 2 dx/dB, 3 dC, 4 dcum, 5 reduce) of the instantiation for
// (dtype, P, N); cudaErrorInvalidValue if there is none.
extern "C" int ssd_scan_bwd_geometry(int dtype, int P, int N, int phase, int* threads, int* smem) {
  if (find(dtype, P, N) == nullptr || phase < 0 || phase > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  *threads = phase == 1 || phase == 5 ? kPassThreads : kThreads;
  *smem = dtype == 0 ? smem_of<float>(phase, P, N) : smem_of<bf16>(phase, P, N);
  return 0;
}

// dtype of x, Bm, Cm, dy, dx, dBm, dCm: 0 = float32 (CUDA cores), 1 =
// bfloat16 (mma.sync).  Every tensor contiguous, x, Bm, Cm, dy 16-byte
// aligned; the scratch as Args lists it, f32, allocated by the wrapper
// (kernel_plan_bwd's "scratch").  Q: a multiple of 32 up to 128.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
                            void* dA, void* dBm, void* dCm, void* dD, void* cum, void* state,
                            void* grad, void* dbh, void* dch, void* rowp, void* colt, void* dw,
                            void* dots, void* dap, void* ddp, int B, int S, int H, int G, int P,
                            int N, int Q, int dtype, void* stream) {
  const Launch launch_fn = find(dtype, P, N);
  if (launch_fn == nullptr || Q % kPanel || Q < kPanel || Q > kMaxQ || G <= 0 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, Bm, Cm, dy,
               static_cast<const float*>(dt), static_cast<const float*>(A),
               static_cast<const float*>(D), dx, dBm, dCm,
               static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(dD),
               static_cast<float*>(cum), static_cast<float*>(state), static_cast<float*>(grad),
               static_cast<float*>(dbh), static_cast<float*>(dch), static_cast<float*>(rowp),
               static_cast<float*>(colt), static_cast<float*>(dw), static_cast<float*>(dots),
               static_cast<float*>(dap), static_cast<float*>(ddp),
               B, S, H, G, P, N, Q};
  return launch_fn(a, static_cast<cudaStream_t>(stream));
}

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
// over the chunks in reverse (zero after the last).  dBm and dCm sum the
// heads of their group.  ref.ssd_scan_bwd_ref is the same arithmetic in
// plain PyTorch.
//
// What bounds it.  Per (b, h) and chunk the causal triangles of R and
// M^T dy take Q(Q+1)/2 2P multiply-adds and the state products (the
// chunk's state and its gradient, B G^T, x G, dy h) 5 Q P N; per (b, g)
// and chunk, since C and B belong to the group, the triangles of S, dS B
// and dS^T C take Q(Q+1)/2 3N, with dS summed over the group's heads
// first: sum_h dS_h^T C = (sum_h dS_h)^T C, and likewise for dS B.  At
// mamba2-130m's training shape (x [8, 2048, 24, 64], N = 128, Q = 128)
// that is 39.5 GFLOP, 40.0 us at the tensor cores' 989 TFLOP/s, against
// ~171 MB of inputs and gradients, 51.0 us at 3.35 TB/s: bound by the
// bytes.  The states are chains across chunks (forward for h, backward for
// G); everything else is chunk-parallel.  The state terms of a group's
// heads are one product with the heads stacked along K, so neither they
// nor dS^T C and dS B need per-head partials in device memory.  S itself
// is head-free, but the dx / dS launch below forms S^T again for every
// head of a run.
//
// * bf16 (variant "wgmma"): six launches on the caller's stream, products
//   on the tensor cores (wgmma m64 n{64, 128} k16, f32 accumulators), x,
//   dy, Bm, Cm, h, G and dS by TMA (boxes of 64 columns, the 128-byte
//   swizzle; P and N below 64 padded to 64 with columns the hardware
//   zero-fills; a chunk of 32 or 96 rows in a tile of 64 or 128 with its
//   last rows zeroed in shared memory and dt = 0: identity steps).  The
//   chunk-parallel launches walk a run of a group's heads in order, B and
//   C loaded once a block and each head's tiles in a ring of two stages on
//   mbarriers, the next head's loads in flight while one is computed.  A
//   (chunk, group) is split into a few runs only where the grid would not
//   fill the card's 132 SMs (kernel_plan_bwd's "runs"); each run leaves one
//   part of dB and dC, added up in run order by the last launch.
//   1. ssd_bwd_states_wgmma, a block per (chunk, run, b): cum, and each
//      head's own state (w x)^T B and state gradient (exp(cum) dy)^T C, f32
//      into the [B, H, nc, P, N] scratch.
//   2. ssd_bwd_chain<bf16>, a block per (b h, 1024 state elements): h over
//      the chunks in order and G in reverse, kWin chunks loaded a thread
//      before any is used, h and G handed on in bf16 over the f32 rows they
//      came from (what the consumers' operands round to anyway), <G, h> in
//      f32 arithmetic from G in f32 and h as handed on, in bf16: the bf16
//      h overwrites the f32 one as the chain goes forward, and the chain
//      keeps no more than a window of chunks in registers, so the exact h
//      is gone by the time G comes back to its chunk.
//   3. ssd_bwd_dx_ds_wgmma, a block per (chunk, run, b), a warpgroup per 64
//      key rows: per head S^T and R^T once, M^T packed to bf16 as the
//      register operand of dx's product, dS^T summed over the run's heads
//      in f32 registers (written once as bf16), the row and column sums
//      dcum needs, dw, dx, dD's part.
//   4. ssd_bwd_db_dc_wgmma, a block per (chunk, dB or dC, run, b): the
//      state terms with the heads stacked along K in one accumulator, then
//      + dS^T C or + dS B; exp(cum_i) C_i . (dy_i h) of each head.
//   5. ssd_bwd_dcum, 6. ssd_bwd_reduce_runs: as below.
//   Scratch (the wrapper's torch.empty): at the training shape the two f32
//   [B, H, nc, P, N] state tensors (100.7 MB each) and ~12 MB besides; no
//   [B, S, H, N] tensor.  Registers: the dx / dS kernel carries the run's
//   dS^T (QT / 2 floats a thread) beside dx's accumulator and one 64-column
//   half of S^T and R^T at a time, so a warpgroup holds a 64 x 64 tile of
//   each, not 64 x QT.
// * f32 (variant "cuda_cores"): six launches of 4 warps, the products on
//   the CUDA cores in f32 FMAs (no TF32), 32-row panels:
//   1. ssd_bwd_chunk_states, a block per (chunk, h, b): cum, the chunk's
//      own state and state gradient.
//   2. ssd_bwd_chain<float>: the bf16 chain with h and G handed on in f32,
//      in place.
//   3. ssd_bwd_dx_db, a block per (key panel, chunk, h, b): dx and the
//      head's dB, the column sums of S L R and dw.
//   4. ssd_bwd_dc, a block per (query panel, chunk, h, b): the head's dC,
//      the row sums of M R and exp(cum) C . (dy h).
//   5. ssd_bwd_dcum (both variants), a block per (chunk, h, b): dcum, its
//      reverse cumsum by one warp, ddt, and the chunk's part of dA.
//   6. ssd_bwd_reduce: dBm and dCm sum their group's heads in order; dA
//      and dD sum their parts over batch and chunks in order.
// No atomics: every sum runs in a fixed order, so the same inputs give
// bitwise the same gradients.  Rows past S load as zeros with dt = 0
// (identity steps, as the forward pads) and get no gradient written.
//
// The C entry point returns cudaGetLastError() after each launch (or the
// error of cudaFuncSetAttribute, or hopper.cuh's kNoEncoder /
// kEncodeFailed), so the Python wrapper can raise.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // 4 warps: every chunk-parallel kernel
constexpr int kPassThreads = 256;  // reductions
constexpr int kChain = 256;        // state chain: threads a block, 4 elements each
constexpr int kWin = 8;            // state chain: chunks a thread loads before it computes
constexpr int kPanel = 32;         // rows of a panel
constexpr int kMaxQ = 128;         // the longest chunk
constexpr int kRed = 512;          // floats of a block's reduction scratch
constexpr int kRow = 0, kCol = 1;  // operand layouts in shared memory

// Leading dimension of a shared f32 tile of w columns: rows 16 bytes apart
// beyond their width, so 8 rows of a fragment fall in 8 banks.
__host__ __device__ constexpr int ld_of(int w) { return w + 4; }
// Floats after the tiles of phases 3 and 4: dt and cum of the chunk, two
// vectors of a panel's rows, the reduction scratch.
constexpr int kTail = 2 * kMaxQ + 2 * kPanel + kRed;

__host__ __device__ constexpr int states_smem(int P, int N) {
  return kPanel * (ld_of(P) + ld_of(N)) * 4 + 4 * kMaxQ * 4;
}
__host__ __device__ constexpr int dxdb_smem(int P, int N) {
  return (2 * kPanel * (ld_of(P) + ld_of(N)) + P * ld_of(N) + 2 * kPanel * ld_of(32) + kTail) * 4;
}
__host__ __device__ constexpr int dc_smem(int P, int N) {
  return (2 * kPanel * (ld_of(P) + ld_of(N)) + P * ld_of(N) + kPanel * ld_of(32) + kTail) * 4;
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

// The block's [MR x NC] tile += A B over K, each warp its fragments.
template <int MR, int NC, int AL, int BL>
__device__ __forceinline__ void block_mma(float (&acc)[Grid<MR, NC>::MT][Grid<MR, NC>::NT][4],
                                          const float* a, int lda, const float* b, int ldb, int K,
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
// zeros.  With `scale`, row i is multiplied by scale[i].
template <int W>
__device__ __forceinline__ void load_panel(float* dst, int ld, const float* src, int64_t stride,
                                           int valid, const float* scale, int tid) {
  constexpr int V = 4, PR = W / V;  // elements a piece, pieces a row
  for (int e = tid; e < kPanel * PR; e += kThreads) {
    const int i = e / PR, q = e - i * PR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < valid) {
      v = *reinterpret_cast<const uint4*>(src + i * stride + q * V);
      if (scale != nullptr) {
        float* t = reinterpret_cast<float*>(&v);
        const float s = scale[i];
#pragma unroll
        for (int u = 0; u < V; ++u) t[u] *= s;
      }
    }
    *reinterpret_cast<uint4*>(dst + i * ld + q * V) = v;
  }
}

// An f32 [P, N] state into shared memory [P][ld].
template <int P, int N>
__device__ __forceinline__ void load_state(float* dst, int ld, const float* src, int tid) {
  for (int e = tid; e < P * N / 4; e += kThreads) {
    const int r = (4 * e) / N, c = 4 * e - r * N;
    const float4 v = reinterpret_cast<const float4*>(src)[e];
    dst[r * ld + c] = v.x;
    dst[r * ld + c + 1] = v.y;
    dst[r * ld + c + 2] = v.z;
    dst[r * ld + c + 3] = v.w;
  }
}

struct Args {
  const void *x, *Bm, *Cm, *dy;  // f32, contiguous, 16-byte aligned
  const float *dt, *A, *D;       // dt [B, S, H] contiguous
  void *dx, *dBm, *dCm;          // f32, contiguous
  float *ddt, *dA, *dD;
  // f32 scratch: cum, the chunks' dcum row parts, column sums, dw
  // [B, H, nc Q]; state, state gradient [B, H, nc, P, N]; the heads' dB and
  // dC [B, S, H, N]; <G, h> parts [B, H, nc, tiles]; dA parts [B, H, nc];
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
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_states(Args a) {
  constexpr int LP = ld_of(P), LN = ld_of(N);
  extern __shared__ __align__(16) uint8_t smem[];
  float* sX = reinterpret_cast<float*>(smem);  // x or dy panel [32][LP]
  float* sB = sX + kPanel * LP;        // B or C panel [32][LN], scaled
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
    const float* xs = static_cast<const float*>(pass == 0 ? a.x : a.dy);
    const float* bs = static_cast<const float*>(pass == 0 ? a.Bm : a.Cm);
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

// h and G handed on in the chain's output type: f32 in place, or bf16 over
// the first half of the f32 row they came from.
__device__ __forceinline__ void put4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void put4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ float4 get4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 get4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 2. The state chain, a block per (b h, 1024 state elements = whole rows of
// [P, N]), 4 elements a thread: h entering each chunk over the chunks in
// order, then G leaving each chunk in reverse, in f32 registers.  A thread
// loads kWin chunks' f32 states (or gradients, with its own h read back)
// before it computes with any of them, so every chunk is not a trip to
// memory of its own.  h and G are handed on as Out: f32 in place, or bf16
// (the rounding the tensor-core consumers' operands take) over the first
// half of the f32 rows they come from, once the whole block has read them
// (hence whole rows a block).  <G, h> of each chunk in f32 from G in
// registers and h as handed on, summed over the block in a fixed order into
// dots[b, h, c, tile].
template <class Out>
__global__ void __launch_bounds__(kChain)
ssd_bwd_chain(float* __restrict__ state, float* __restrict__ grad, const float* __restrict__ cum,
              float* __restrict__ dots, int nc, int Q, int P, int N) {
  __shared__ float red[kChain / 32][kWin];
  constexpr int W = sizeof(float) / sizeof(Out);  // Out elements an f32 slot holds
  const int PN = P * N, tile = blockIdx.y, tiles = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = (tile * kChain + threadIdx.x) * 4, n = e % N;
  const bool on = e < PN;
  const int64_t bh = blockIdx.x;
  const float* seg = cum + bh * nc * Q + Q - 1;
  const float4* s4 = reinterpret_cast<const float4*>(state + bh * nc * PN + e);
  const float4* u4 = reinterpret_cast<const float4*>(grad + bh * nc * PN + e);
  // element e of chunk c as Out: index W (c PN + row(e) N) + col(e)
  Out* hb = reinterpret_cast<Out*>(state + bh * nc * PN) + W * e - (W - 1) * n;
  Out* gb = reinterpret_cast<Out*>(grad + bh * nc * PN) + W * e - (W - 1) * n;
  const int64_t step4 = PN / 4, stepb = W * static_cast<int64_t>(PN);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 hs = zero4;
  for (int c0 = 0; c0 < nc; c0 += kWin) {
    float4 v[kWin];
    float dec[kWin];
#pragma unroll
    for (int u = 0; u < kWin; ++u) {
      const int c = c0 + u;
      v[u] = on && c < nc ? s4[c * step4] : zero4;
      dec[u] = c < nc ? expf(seg[c * Q]) : 0.f;
    }
    __syncthreads();  // the block has read these chunks' rows before h goes over them
#pragma unroll
    for (int u = 0; u < kWin; ++u) {
      const int c = c0 + u;
      if (!on || c >= nc) continue;
      put4(hb + c * stepb, hs);
      hs = make_float4(dec[u] * hs.x + v[u].x, dec[u] * hs.y + v[u].y, dec[u] * hs.z + v[u].z,
                       dec[u] * hs.w + v[u].w);
    }
  }
  float4 gs = zero4;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kWin) {
    float4 v[kWin], hv[kWin];
    float dec[kWin], d[kWin];
#pragma unroll
    for (int u = 0; u < kWin; ++u) {
      const int c = c1 - u;
      v[u] = on && c >= 0 ? u4[c * step4] : zero4;
      hv[u] = on && c >= 0 ? get4(hb + c * stepb) : zero4;
      dec[u] = c >= 0 ? expf(seg[c * Q]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kWin; ++u) {
      const int c = c1 - u;
      d[u] = 0.f;
      if (!on || c < 0) continue;
      put4(gb + c * stepb, gs);
      d[u] = gs.x * hv[u].x + gs.y * hv[u].y + gs.z * hv[u].z + gs.w * hv[u].w;
      const float keep_c = dec[u];  // G_c = u_c + exp(seg_c) G_{c+1}
      gs = make_float4(v[u].x + keep_c * gs.x, v[u].y + keep_c * gs.y, v[u].z + keep_c * gs.z,
                       v[u].w + keep_c * gs.w);
    }
#pragma unroll
    for (int u = 0; u < kWin; ++u) {
      const float s = warp_sum(d[u]);
      if (lane == 0) red[warp][u] = s;
    }
    __syncthreads();
    if (threadIdx.x < kWin && c1 - static_cast<int>(threadIdx.x) >= 0) {
      float s = 0.f;
      for (int w = 0; w < kChain / 32; ++w) s += red[w][threadIdx.x];
      dots[(bh * nc + c1 - threadIdx.x) * tiles + tile] = s;
    }
  }
}

// 3. Key panel jp of chunk c: dx = D dy + M^T dy + w (B G^T) and the
// head's dB = dS^T C + w (x G) for its 32 rows, over the query panels
// ip >= jp; the column sums of S L R and dw = x . (G B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_db(Args a) {
  constexpr int LP = ld_of(P), LN = ld_of(N), L32 = ld_of(32);
  extern __shared__ __align__(16) uint8_t smem[];
  float* sB = reinterpret_cast<float*>(smem);  // the key panel's B, x
  float* sX = sB + kPanel * LN;
  float* sC = sX + kPanel * LP;        // a query panel's C, dy
  float* sDY = sC + kPanel * LN;
  float* sG = sDY + kPanel * LP;       // G [P][LN]
  float* sM = sG + P * LN;             // M, dS of the panel pair [32][L32]
  float* sDS = sM + kPanel * L32;
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
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  const float* Bm = static_cast<const float*>(a.Bm);
  const float* Cm = static_cast<const float*>(a.Cm);
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
    part[mt][e >> 1] += sB[r * LN + col] * v;
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
      sM[ii * L32 + jj] = m;
      sDS[ii * L32 + jj] = ds;
    });
    __syncthreads();
    // dx += M^T dy, dB += dS^T C: A(j, i) = M[i][j] (K-major), B row-major
    block_mma<kPanel, P, kCol, kRow>(ax, sM, L32, sDY, LP, kPanel, warp, lane);
    block_mma<kPanel, N, kCol, kRow>(ab, sDS, L32, sC, LN, kPanel, warp, lane);
    __syncthreads();
  }
  reduce_cols<kPanel, kPanel>(colp, red, sV, warp, lane, tid);
  if (tid < kPanel) a.colt[bh * nc * Q + tj + tid] = sV[tid];

  // dx = that + D dy; dD's part of the panel
  const float dskip = a.D[h];
  float dd = 0.f;
  float* dx = static_cast<float*>(a.dx);
  for_each<kPanel, P>(ax, warp, lane, [&](float v, int r, int col, int, int, int) {
    const int t = tj + r;
    if (t >= S) return;
    const int64_t idx = (xrow + static_cast<int64_t>(t) * a.H) * P + col;
    const float dyv = dy[idx];
    dx[idx] = v + dskip * dyv;
    dd += dyv * x[idx];
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
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dc(Args a) {
  constexpr int LP = ld_of(P), LN = ld_of(N), L32 = ld_of(32);
  extern __shared__ __align__(16) uint8_t smem[];
  float* sC = reinterpret_cast<float*>(smem);  // the query panel's C, dy
  float* sDY = sC + kPanel * LN;
  float* sB = sDY + kPanel * LP;       // a key panel's B, x
  float* sX = sB + kPanel * LN;
  float* sH = sX + kPanel * LP;        // h [P][LN]
  float* sDS = sH + P * LN;            // dS of the panel pair [32][L32]
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
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  const float* Bm = static_cast<const float*>(a.Bm);
  const float* Cm = static_cast<const float*>(a.Cm);
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
    part[mt][e >> 1] += sC[r * LN + col] * v;
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
      sDS[ii * L32 + jj] = ds;
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

// What the dcum launch reads and writes: per (b, h) [B, H, nc Q] rows of
// cum, the column sums of S L R (colt) and dw; the row sums of M R, as
// row_parts arrays row_stride apart, plus erow where the wgmma path gives
// exp(cum) C . (dy h) apart (null on the CUDA cores, whose rows hold it);
// <G, h> of each chunk in dot_parts parts [B, H, nc, dot_parts].
struct Dcum {
  const float *dt, *A, *cum, *colt, *dw, *rows, *erow, *dots;
  float *ddt, *dap;
  int64_t row_stride;
  int row_parts, dot_parts, S, H, Q;
};

// 5. Per (chunk, h, b), thread i of row i: dcum, da its reverse cumsum, ddt
// and the chunk's part of dA = sum dt da.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcum(Dcum a) {
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
  float rowp = 0.f;
  for (int k = 0; k < a.row_parts; ++k) rowp += in ? a.rows[k * a.row_stride + base + i] : 0.f;
  if (a.erow != nullptr && in) rowp += a.erow[base + i];
  const float decay_j = in ? expf(seg - cum) : 0.f;
  const float dww = dw * decay_j * dt;
  float dot = 0.f;
  const float* parts = a.dots + (bh * nc + c) * a.dot_parts;
  for (int k = 0; k < a.dot_parts; ++k) dot += parts[k];
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
  static_cast<float4*>(a.dBm)[e] = sb;
  static_cast<float4*>(a.dCm)[e] = sc;
}

template <int P, int N>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kS1 = states_smem(P, N), kS3 = dxdb_smem(P, N), kS4 = dc_smem(P, N);
  static_assert(kS3 <= 232448 && kS4 <= 232448, "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_states<P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kS1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dx_db<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kS3);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dc<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kS4);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (a.S + a.Q - 1) / a.Q, nq = a.Q / kPanel, PN = P * N;
  const dim3 chunks(nc, a.H, a.B), panels(nc * nq, a.H, a.B);
  ssd_bwd_chunk_states<P, N><<<chunks, kThreads, kS1, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (PN + 4 * kChain - 1) / (4 * kChain);
  ssd_bwd_chain<float><<<dim3(a.B * a.H, tiles), kChain, 0, stream>>>(a.state, a.grad, a.cum,
                                                                      a.dots, nc, a.Q, P, N);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dx_db<P, N><<<panels, kThreads, kS3, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dc<P, N><<<panels, kThreads, kS4, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const Dcum d{a.dt, a.A, a.cum, a.colt, a.dw, a.rowp, nullptr, a.dots, a.ddt, a.dap,
               0, 1, tiles, a.S, a.H, a.Q};
  ssd_bwd_dcum<<<chunks, kThreads, 0, stream>>>(d);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int64_t quads = static_cast<int64_t>(a.B) * a.S * a.G * a.N / 4;
  const int64_t blocks = (quads + kPassThreads - 1) / kPassThreads;
  const int64_t head_blocks = (a.H + kPassThreads - 1) / kPassThreads;
  ssd_bwd_reduce<<<dim3(static_cast<unsigned>(blocks > head_blocks ? blocks : head_blocks), 2),
                 kPassThreads, 0, stream>>>(a, nc);
  return static_cast<int>(cudaGetLastError());
}


// ====================================================== bf16: wgmma and TMA

constexpr int kRowsBox = 32;       // rows of a TMA box of x, dy, Bm, Cm
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may have
constexpr float kLog2e = 1.4426950408889634f;

// Columns a tile keeps in shared memory for a width of 16..128: whole
// 64-column boxes (128 bytes a row, the 128-byte swizzle's span).
__host__ __device__ constexpr int padded(int w) { return w <= 64 ? 64 : 128; }

// Dynamic shared memory of the three tensor-core launches: 1 KB to align
// the swizzled tiles to 1024 bytes, the tiles, the mbarriers, then floats.
// Chunk states: B and C, two stages of x and dy; dt, cum, w, exp(cum).
__host__ __device__ constexpr int states_wg_smem(int Pp, int Np, int QT) {
  return 1024 + 2 * (Np / 64) * QT * 128 + 4 * (Pp / 64) * QT * 128 + 3 * 8 + 4 * QT * 4;
}
// dx / dS with WGS warpgroups over 64 WGS key rows: those rows of B and
// all QT of C, two stages of x (the key rows), dy (all rows) and G; dt,
// cum, w, each warp's column sums of M R, the block sum's scratch.
__host__ __device__ constexpr int dxds_smem(int Pp, int Np, int QT, int WGS) {
  return 1024 + (Np / 64) * 64 * WGS * 128 + (Np / 64) * QT * 128 +
         2 * ((Pp / 64) * 64 * WGS * 128 + (Pp / 64) * QT * 128 + (Np / 64) * Pp * 128) + 3 * 8 +
         (3 * QT + 4 * WGS * QT + 8) * 4;
}
// dB / dC: C; two stages of x or dy (QT rows) and G or h (Pp rows), whose
// room the closing products' dS (QT x QT) and B reuse; the row scales.
__host__ __device__ constexpr int dbdc_room(int Pp, int Np, int QT) {
  return 2 * ((Pp / 64) * QT * 128 + (Np / 64) * Pp * 128) >
                 (QT / 64) * QT * 128 + (Np / 64) * QT * 128
             ? 2 * ((Pp / 64) * QT * 128 + (Np / 64) * Pp * 128)
             : (QT / 64) * QT * 128 + (Np / 64) * QT * 128;
}
__host__ __device__ constexpr int dbdc_smem(int Pp, int Np, int QT) {
  return 1024 + (Np / 64) * QT * 128 + dbdc_room(Pp, Np, QT) + 4 * 8 + QT * 4;
}
// Warpgroups of a dx / dS block: one per 64 key rows of the tile, or one
// where that does not fit (P = N = 128 in 128-row tiles: two blocks split
// the key rows).
__host__ __device__ constexpr int dxds_wgs(int Pp, int Np, int QT) {
  return dxds_smem(Pp, Np, QT, QT / 64) <= kSmemMax ? QT / 64 : 1;
}

// What the bf16 launches share.  Every tensor dense; the scratch as the
// wrapper lists it (kernel_plan_bwd), allocated with torch.empty.
struct WArgs {
  const float *dt, *A, *D;  // dt [B, S, H]
  bf16 *dx, *dBm, *dCm;
  float *ddt, *dA, *dD;
  float* cum;               // [B, H, nc Q]
  float *state, *grad;      // [B, H, nc, P, N]: the chunks' own f32 states and
                            // state gradients; the chain writes h and G as
                            // bf16 over the first half of each row
  float* dots;              // <G, h> [B, H, nc, tiles]
  float *colt, *dw, *erow;  // [B, H, nc Q]
  float* rowmr;             // row sums of M R [key blocks, B, H, nc Q]
  bf16* ds;                 // dS summed over a run's heads [runs, B, nc, G, QT, QT]
  float *dap, *ddp;         // dA parts [B, H, nc]; dD parts [B, H, nc, key blocks]
  float* bc_runs;           // dB, dC of each run [2, runs, B, S, G, N], or null (one run)
  int B, S, H, G, P, N, Q, nc, runs, run_len;
};

// Byte offset of bf16 element (row, col) in a tile of 64-column boxes
// `box` bytes apart, written by TMA with the 128-byte swizzle: 16-byte
// piece q of a row sits at piece q ^ (row % 8).
__device__ __forceinline__ uint32_t swz(int row, int col, uint32_t box) {
  const int c = col % 64;
  return (col / 64) * box + row * 128 + (((c / 8) ^ (row % 8)) * 16) + (c % 8) * 2;
}
__device__ __forceinline__ float2 ld2(const uint8_t* tile, uint32_t off) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + off));
}

// Bytes of `rows` rows (a multiple of 32) of `boxes` 64-column boxes.
__host__ __device__ constexpr uint32_t rows_bytes(int boxes, int rows) {
  return static_cast<uint32_t>(boxes * ((rows + kRowsBox - 1) / kRowsBox) * kRowsBox * 128);
}

// Rows [t0, t0 + rows) of head (or group) `head` of a [B, S, heads, cols]
// map into a tile of `tile_rows` rows a 64-column box at dst: boxes of 64
// columns by 32 rows (rows past S zero-filled by the hardware).
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int boxes, int tile_rows, int rows, int head, int t0,
                                         int b) {
  for (int cb = 0; cb < boxes; ++cb)
    for (int r = 0; r < rows; r += kRowsBox)
      tma_load(dst + cb * tile_rows * 128 + r * 128, map, bar, 64 * cb, head, t0 + r, b);
}

// Rows [from, rows) of `boxes` consecutive boxes of `rows` rows to zero.
__device__ __forceinline__ void zero_rows(uint8_t* tile, int boxes, int rows, int from, int tid,
                                          int threads) {
  const int per_box = (rows - from) * 8;  // 16-byte pieces
  for (int e = tid; e < boxes * per_box; e += threads) {
    const int bx = e / per_box, r = e - bx * per_box;
    *reinterpret_cast<uint4*>(tile + bx * rows * 128 + from * 128 + r * 16) = make_uint4(0, 0, 0, 0);
  }
}

// Each 16-byte piece e of `pieces` (8 a row of a box of `rows` rows) times
// scale[row], rounded to bf16 once.
__device__ __forceinline__ void scale_rows(uint8_t* tile, int pieces, int rows, const float* scale,
                                           int tid, int threads) {
  for (int e = tid; e < pieces; e += threads) {
    uint4* piece = reinterpret_cast<uint4*>(tile + e * 16);
    uint4 v = *piece;
    __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&v);
    const float f = scale[(e / 8) % rows];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(pair[k]);
      pair[k] = __floats2bfloat162_rn(x.x * f, x.y * f);
    }
    *piece = v;
  }
}

// The sum of v over the 4 lanes of a row of an accumulator fragment.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D (+)= A B of m64 n{64, 128} k16 from shared memory (TA / TB: A / B
// MN-major), and the same with A from registers (B MN-major).
template <int NP, int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss(float (&d)[NP / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NP == 64)
    wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  else
    wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
}
template <int NP>
__device__ __forceinline__ void mma_rs(float (&d)[NP / 2], const uint32_t* a, uint64_t db) {
  if constexpr (NP == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// 1. A block per (chunk, run of a group's heads, b), two warpgroups: cum
// of each head; its own state s = (w x)^T B (warpgroup 0) and state
// gradient u = (exp(cum) dy)^T C (warpgroup 1), [P, N] f32 each.  B and C
// load once; x and dy by TMA into a ring of two stages, the next head's in
// flight while one is computed; their rows are scaled in place (w_j and
// exp(cum_i), one rounding to bf16).  M = P (x^T MN-major), N = N
// (MN-major), K = the chunk's rows.
template <int Pp, int Np, int QT>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_states_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                     const WArgs a) {
  constexpr int kXB = Pp / 64, kNB = Np / 64;
  constexpr uint32_t kBox = QT * 128, kTileN = kNB * kBox, kTileP = kXB * kBox;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* tiles = smem + (base - smem_u32(smem));
  const uint32_t b_s = base, c_s = b_s + kTileN, st_s = c_s + kTileN;  // stage s: x, dy
  const uint32_t bar_bc = st_s + 4 * kTileP, full = bar_bc + 8;        // full + 8 s
  float* sDt = reinterpret_cast<float*>(tiles + (bar_bc - base) + 24);
  float* sCum = sDt + QT;
  float* sW = sCum + QT;
  float* sE = sW + QT;

  const int c = blockIdx.x, run = blockIdx.y % a.runs, g = blockIdx.y / a.runs, b = blockIdx.z;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  const int Q = a.Q, S = a.S, nc = a.nc, t0 = c * Q;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const uint32_t head_bytes = 2 * rows_bytes(kXB, Q);
  if (tid == 0) {
    mbar_init(bar_bc, 1);
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_bc, 2 * rows_bytes(kNB, Q));
    tma_rows(b_s, &tb, bar_bc, kNB, QT, Q, g, t0, b);
    tma_rows(c_s, &tc, bar_bc, kNB, QT, Q, g, t0, b);
    for (int k = 0; k < 2 && k < nh; ++k) {
      const uint32_t xs = st_s + k * 2 * kTileP;
      mbar_expect_tx(full + 8 * k, head_bytes);
      tma_rows(xs, &tx, full + 8 * k, kXB, QT, Q, h0 + k, t0, b);
      tma_rows(xs + kTileP, &tdy, full + 8 * k, kXB, QT, Q, h0 + k, t0, b);
    }
  }
  if (Q < QT) {  // rows past the chunk: zeros (TMA writes rows < Q only)
    zero_rows(tiles, 2 * kNB, QT, Q, tid, 256);
    zero_rows(tiles + (st_s - base), 4 * kXB, QT, Q, tid, 256);
  }
  fence_proxy_async();
  const float* dtb = a.dt + static_cast<int64_t>(b) * S * a.H;
  const bool row_in = tid < Q && t0 + tid < S;
  float pdt = row_in ? dtb[static_cast<int64_t>(t0 + tid) * a.H + h0] : 0.f;
  mbar_wait(bar_bc, 0);
  const int64_t PN = static_cast<int64_t>(a.P) * a.N;
  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k, st = k & 1;
    const int64_t bh = static_cast<int64_t>(b) * a.H + h;
    if (tid < QT) {
      sDt[tid] = pdt;
      if (k + 1 < nh) pdt = row_in ? dtb[static_cast<int64_t>(t0 + tid) * a.H + h + 1] : 0.f;
    }
    __syncthreads();
    if (tid < 32) chunk_cumsum(sDt, sCum, a.A[h], QT, lane);  // dt = 0 past the chunk
    __syncthreads();
    const float seg = sCum[QT - 1];
    if (tid < QT) {
      sW[tid] = expf(seg - sCum[tid]) * sDt[tid];
      sE[tid] = tid < Q ? expf(sCum[tid]) : 0.f;
      if (tid < Q) a.cum[bh * nc * Q + t0 + tid] = sCum[tid];
    }
    __syncthreads();
    mbar_wait(full + 8 * st, (k >> 1) & 1);
    uint8_t* xt = tiles + (st_s - base) + st * 2 * kTileP;
    scale_rows(xt, kXB * QT * 8, QT, sW, tid, 256);
    scale_rows(xt + kTileP, kXB * QT * 8, QT, sE, tid, 256);
    fence_proxy_async();
    __syncthreads();

    const uint32_t as = st_s + st * 2 * kTileP + wg * kTileP, bs = wg == 0 ? b_s : c_s;
    float* out = (wg == 0 ? a.state : a.grad) + (bh * nc + c) * PN;
#pragma unroll
    for (int mt = 0; mt < kXB; ++mt) {
      float acc[Np / 2];
#pragma unroll
      for (int e = 0; e < Np / 2; ++e) acc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        mma_ss<Np, 1, 1>(acc, gmma_desc(as + mt * kBox + kk * 2048, kBox),
                         gmma_desc(bs + kk * 2048, kBox), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 64 * mt + 16 * warp + lane / 4 + 8 * r;
        if (p >= a.P) continue;
#pragma unroll
        for (int j = 0; j < Np / 8; ++j) {
          const int n = 8 * j + 2 * (lane % 4);
          if (n < a.N)
            *reinterpret_cast<float2*>(out + p * a.N + n) =
                make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
    }
    __syncthreads();  // the stage is free
    if (tid == 0 && k + 2 < nh) {
      const uint32_t xs = st_s + st * 2 * kTileP;
      mbar_expect_tx(full + 8 * st, head_bytes);
      tma_rows(xs, &tx, full + 8 * st, kXB, QT, Q, h + 2, t0, b);
      tma_rows(xs + kTileP, &tdy, full + 8 * st, kXB, QT, Q, h + 2, t0, b);
    }
  }
}

// 3. dx and dS, a block per (chunk and its key block, run, b), a warpgroup
// per 64 key rows j.  B (the key rows) and C load once; x, dy and G of
// each head by TMA into a ring of two stages.  Per head, all in the
// transposed orientation (rows j, columns i), so that M^T is the register
// operand of dx's product:
//   dx = w (B G^T), B G^T's rows dotted with x first (dw);
//   per 64 query columns i at or past the warpgroup's rows: S^T = B C^T
//   and R^T = x dy^T in one commit (S and R once per chunk and head);
//   masked before the exponential, L = exp(cum_i - cum_j), M^T = S L dt_j
//   packed to bf16 as the A operand of dx += M^T dy (dy MN-major),
//   dS^T = R L dt_j added into the run's f32 dS^T in registers; the row
//   sums of S L R (colt_j) and the column sums of M R (over j, per warp
//   into shared memory, then over the block in order);
//   dx + D dy stored as bf16; dD's part.
// After the run's last head its dS^T goes out as bf16 [QT, QT] (rows j,
// zero above the diagonal), rounded once, for the dB / dC launch.
template <int Pp, int Np, int QT, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
ssd_bwd_dx_ds_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap tg, const WArgs a) {
  constexpr int kXB = Pp / 64, kNB = Np / 64, JR = 64 * WGS, kThreads = 128 * WGS;
  constexpr int kIH = QT / 64;                       // 64-column halves of the query rows
  constexpr uint32_t kJBox = JR * 128, kQBox = QT * 128, kGBox = Pp * 128;
  constexpr uint32_t kX = kXB * kJBox, kDY = kXB * kQBox, kStage = kX + kDY + kNB * kGBox;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* tiles = smem + (base - smem_u32(smem));
  const uint32_t b_s = base, c_s = b_s + kNB * kJBox, st_s = c_s + kNB * kQBox;
  const uint32_t bar_bc = st_s + 2 * kStage, full = bar_bc + 8;
  float* sDt = reinterpret_cast<float*>(tiles + (bar_bc - base) + 24);
  float* sCum = sDt + QT;
  float* sW = sCum + QT;
  float* sRow = sW + QT;          // [4 WGS warps][QT]
  float* red = sRow + 4 * WGS * QT;

  const int jbs = QT / JR;        // blocks over a tile's key rows
  const int c = blockIdx.x / jbs, jblk = blockIdx.x % jbs, jr0 = jblk * JR;
  const int run = blockIdx.y % a.runs, g = blockIdx.y / a.runs, b = blockIdx.z;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  const int Q = a.Q, S = a.S, nc = a.nc, t0 = c * Q;
  const int jrows = max(0, min(Q, jr0 + JR) - jr0);  // the block's key rows in the chunk
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int jb = jblk * WGS + wg;                    // the warpgroup's 64-row block of keys
  const int jl0 = 64 * wg + 16 * warp + lane / 4;    // its rows jl0, jl0 + 8 of the block
  const uint32_t head_bytes = rows_bytes(kXB, jrows) + rows_bytes(kXB, Q) + kNB * kGBox;

  if (tid == 0) {
    mbar_init(bar_bc, 1);
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_head = [&](int k, int st) {  // head k into stage st (one thread)
    const int h = h0 + k;
    const uint32_t xs = st_s + st * kStage, bar = full + 8 * st;
    mbar_expect_tx(bar, head_bytes);
    tma_rows(xs, &tx, bar, kXB, JR, jrows, h, t0 + jr0, b);
    tma_rows(xs + kX, &tdy, bar, kXB, QT, Q, h, t0, b);
    const int slot = static_cast<int>((static_cast<int64_t>(b) * a.H + h) * nc + c);
    for (int cb = 0; cb < kNB; ++cb) tma_load(xs + kX + kDY + cb * kGBox, &tg, bar, 64 * cb, 0, slot);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_bc, rows_bytes(kNB, jrows) + rows_bytes(kNB, Q));
    tma_rows(b_s, &tb, bar_bc, kNB, JR, jrows, g, t0 + jr0, b);
    tma_rows(c_s, &tc, bar_bc, kNB, QT, Q, g, t0, b);
    for (int k = 0; k < 2 && k < nh; ++k) load_head(k, k);
  }
  if (jrows < JR) zero_rows(tiles, kNB, JR, jrows, tid, kThreads);
  if (Q < QT) zero_rows(tiles + (c_s - base), kNB, QT, Q, tid, kThreads);
  for (int s = 0; s < 2; ++s) {
    uint8_t* xt = tiles + (st_s - base) + s * kStage;
    if (jrows < JR) zero_rows(xt, kXB, JR, jrows, tid, kThreads);
    if (Q < QT) zero_rows(xt + kX, kXB, QT, Q, tid, kThreads);
  }
  fence_proxy_async();

  const float* dtb = a.dt + static_cast<int64_t>(b) * S * a.H;
  const bool row_in = tid < Q && t0 + tid < S;
  auto dt_of = [&](int h) { return row_in ? dtb[static_cast<int64_t>(t0 + tid) * a.H + h] : 0.f; };
  auto cum_of = [&](int h) {
    return tid < Q ? a.cum[(static_cast<int64_t>(b) * a.H + h) * nc * Q + t0 + tid] : 0.f;
  };
  float pdt = tid < QT ? dt_of(h0) : 0.f, pcum = tid < QT ? cum_of(h0) : 0.f;
  float dsum[kIH][32];  // the run's dS^T, rows jl0 (+ 8), columns of each query half
#pragma unroll
  for (int ih = 0; ih < kIH; ++ih)
#pragma unroll
    for (int e = 0; e < 32; ++e) dsum[ih][e] = 0.f;
  mbar_wait(bar_bc, 0);

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k, st = k & 1;
    const int64_t bh = static_cast<int64_t>(b) * a.H + h, rows0 = bh * nc * Q + t0;
    if (tid < QT) {
      sDt[tid] = pdt;
      sCum[tid] = pcum;
      if (k + 1 < nh) {
        pdt = dt_of(h + 1);
        pcum = cum_of(h + 1);
      }
    }
    __syncthreads();
    const float seg = sCum[Q - 1];
    if (tid < QT) sW[tid] = expf(seg - sCum[tid]) * sDt[tid];
    __syncthreads();
    mbar_wait(full + 8 * st, (k >> 1) & 1);
    const uint32_t xs = st_s + st * kStage, dys = xs + kX, gs = dys + kDY;
    const uint8_t* xt = tiles + (xs - base);
    const uint8_t* dyt = tiles + (dys - base);

    // B G^T [j, p]: A = B (K-major over n), B = G^T (K-major: G's rows are
    // p); committed with the first query half's S^T and R^T
    float ax[Pp / 2];
#pragma unroll
    for (int e = 0; e < Pp / 2; ++e) ax[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Np / 16; ++kk) {
      if (kk >= a.N / 16) break;
      const uint32_t col = (kk / 4) * kJBox + (kk % 4) * 32;
      mma_ss<Pp>(ax, gmma_desc(b_s + col + wg * 64 * 128, 16),
                 gmma_desc(gs + (kk / 4) * kGBox + (kk % 4) * 32, 16), kk > 0);
    }

    float ct[2] = {0.f, 0.f};  // row sums of S L R (colt_j)
#pragma unroll
    for (int ih = 0; ih < kIH; ++ih) {
      float* rowp = sRow + (4 * wg + warp) * QT + 64 * ih;
      if (ih < jb) {  // query rows all before the keys: nothing
        if (lane < 4)
          for (int q = 0; q < 16; ++q) rowp[8 * (q / 2) + 2 * lane + (q & 1)] = 0.f;
        continue;
      }
      float s_[32], r_[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s_[e] = r_[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Np / 16; ++kk) {
        if (kk >= a.N / 16) break;
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(s_, gmma_desc(b_s + (kk / 4) * kJBox + wg * 64 * 128 + col, 16),
                     gmma_desc(c_s + (kk / 4) * kQBox + ih * 64 * 128 + col, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < Pp / 16; ++kk) {
        if (kk >= a.P / 16) break;
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(r_, gmma_desc(xs + (kk / 4) * kJBox + wg * 64 * 128 + col, 16),
                     gmma_desc(dys + (kk / 4) * kQBox + ih * 64 * 128 + col, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_);
      fence_regs(r_);
      if (ih == jb) {  // B G^T is in: dw_j = x_j . (G B_j), then w_j (B G^T)_j
        fence_regs(ax);
        float dwp[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < Pp / 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 xv = ld2(xt, swz(jl0 + 8 * r, 8 * jj + 2 * (lane % 4), kJBox));
            dwp[r] += ax[4 * jj + 2 * r] * xv.x + ax[4 * jj + 2 * r + 1] * xv.y;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = jr0 + jl0 + 8 * r;
          const float dwr = quad_sum(dwp[r]);
          if (lane % 4 == 0 && j < Q) a.dw[rows0 + j] = dwr;
          const float w = sW[j];
#pragma unroll
          for (int jj = 0; jj < Pp / 8; ++jj) {
            ax[4 * jj + 2 * r] *= w;
            ax[4 * jj + 2 * r + 1] *= w;
          }
        }
      }
      float cs[16];  // column sums of M R over this thread's two rows
#pragma unroll
      for (int q = 0; q < 16; ++q) cs[q] = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1, j = jr0 + jl0 + 8 * r;
        const int i = 64 * ih + 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
        float m = 0.f;
        if (j <= i && i < Q) {  // masked before the exponential
          const float L = exp2f((sCum[i] - sCum[j]) * kLog2e), sl = s_[e] * L, dtj = sDt[j];
          m = sl * dtj;
          dsum[ih][e] += r_[e] * L * dtj;
          ct[r] += sl * r_[e];
          cs[2 * (e / 4) + (e & 1)] += m * r_[e];
        }
        s_[e] = m;
      }
      uint32_t wa[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) wa[q] = pack_bf16(s_[2 * q], s_[2 * q + 1]);
      // dx += M^T dy: M^T from registers (K = this half's query rows), dy MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<Pp>(ax, wa + 4 * kk, gmma_desc(dys + ih * 64 * 128 + kk * 2048, kQBox));
      wgmma_commit();
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        float v = cs[q];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cs[q] = v;
      }
      if (lane < 4)
#pragma unroll
        for (int q = 0; q < 16; ++q) rowp[8 * (q / 2) + 2 * lane + (q & 1)] = cs[q];
      wgmma_wait_all();
      fence_regs(ax);
    }

    // dx = that + D dy, stored as bf16; dD's part; colt
    const float dskip = a.D[h];
    float dd = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int jl = jl0 + 8 * r, j = jr0 + jl, t = t0 + j;
      const float colt = quad_sum(ct[r]);
      if (lane % 4 == 0 && j < Q) a.colt[rows0 + j] = colt;
      if (j >= Q || t >= S) continue;
      bf16* dxrow = a.dx + ((static_cast<int64_t>(b) * S + t) * a.H + h) * a.P;
#pragma unroll
      for (int jj = 0; jj < Pp / 8; ++jj) {
        const int p = 8 * jj + 2 * (lane % 4);
        if (p >= a.P) continue;
        const float2 dyv = ld2(dyt, swz(j, p, kQBox)), xv = ld2(xt, swz(jl, p, kJBox));
        *reinterpret_cast<__nv_bfloat162*>(dxrow + p) = __floats2bfloat162_rn(
            ax[4 * jj + 2 * r] + dskip * dyv.x, ax[4 * jj + 2 * r + 1] + dskip * dyv.y);
        dd += dyv.x * xv.x + dyv.y * xv.y;
      }
    }
    __syncthreads();  // every warp's column sums are in
    if (tid < Q) {
      float s = 0.f;
      for (int w = 0; w < 4 * WGS; ++w) s += sRow[w * QT + tid];
      a.rowmr[(static_cast<int64_t>(jblk) * a.B * a.H) * nc * Q + rows0 + tid] = s;
    }
    dd = block_sum(dd, red, kThreads, tid / 32, lane, tid);  // syncs: the stage is free
    if (tid == 0) {
      a.ddp[(bh * nc + c) * jbs + jblk] = dd;
      if (k + 2 < nh) load_head(k + 2, st);
    }
  }

  // the run's dS^T as bf16, rows j of the block, every column
  const int64_t slot = ((static_cast<int64_t>(run) * a.B + b) * nc + c) * a.G + g;
  bf16* out = a.ds + slot * QT * QT;
#pragma unroll
  for (int ih = 0; ih < kIH; ++ih)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int j = jr0 + jl0 + 8 * ((e >> 1) & 1);
      const int i = 64 * ih + 8 * (e / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + j * QT + i) =
          __floats2bfloat162_rn(dsum[ih][e], dsum[ih][e + 1]);
    }
}

// 4. dB (x.5 = 0) and dC (x.5 = 1) of a (chunk, run, b), a warpgroup per 64
// rows, one accumulator each, kept over the run's heads: the state terms
// stacked along K, sum_h (w_h x_h) G_h for dB and sum_h (exp(cum_h) dy_h)
// h_h for dC, x or dy scaled in place (one rounding to bf16) and G or h
// MN-major, the ring of two stages as in 3.  dC's rows also give
// exp(cum_i) C_i . (dy_i h) of each head, the rise of C_i . acc_i over the
// head's product (erow, for dcum).  Then + dS^T C (dS^T K-major) or + dS B
// (dS MN-major), dS and B by TMA into the stages' room; stored as bf16, or
// as the run's f32 part where the heads are split into runs.
template <int Pp, int Np, int QT>
__global__ void __launch_bounds__(2 * QT, 1)
ssd_bwd_db_dc_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tds, const WArgs a) {
  constexpr int kXB = Pp / 64, kNB = Np / 64, kThreads = 2 * QT;
  constexpr uint32_t kBox = QT * 128, kPBox = Pp * 128;
  constexpr uint32_t kA = kXB * kBox, kStage = kA + kNB * kPBox;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* tiles = smem + (base - smem_u32(smem));
  const uint32_t c_s = base, st_s = c_s + kNB * kBox;
  const uint32_t bar_c = st_s + dbdc_room(Pp, Np, QT), full = bar_c + 8, bar_end = full + 16;
  float* sV = reinterpret_cast<float*>(tiles + (bar_c - base) + 32);

  const int c = blockIdx.x >> 1, side = blockIdx.x & 1;
  const int run = blockIdx.y % a.runs, g = blockIdx.y / a.runs, b = blockIdx.z;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  const int Q = a.Q, S = a.S, nc = a.nc, t0 = c * Q;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int i0 = 64 * wg + 16 * warp + lane / 4;  // this thread's rows i0, i0 + 8
  const CUtensorMap* ta = side ? &tdy : &tx;
  const CUtensorMap* ts = side ? &th : &tg;
  const uint32_t head_bytes = rows_bytes(kXB, Q) + kNB * kPBox;

  if (tid == 0) {
    mbar_init(bar_c, 1);
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(bar_end, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_head = [&](int k, int st) {
    const int h = h0 + k;
    const uint32_t xs = st_s + st * kStage, bar = full + 8 * st;
    mbar_expect_tx(bar, head_bytes);
    tma_rows(xs, ta, bar, kXB, QT, Q, h, t0, b);
    const int slot = static_cast<int>((static_cast<int64_t>(b) * a.H + h) * nc + c);
    for (int cb = 0; cb < kNB; ++cb) tma_load(xs + kA + cb * kPBox, ts, bar, 64 * cb, 0, slot);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_c, rows_bytes(kNB, Q));
    tma_rows(c_s, &tc, bar_c, kNB, QT, Q, g, t0, b);
    for (int k = 0; k < 2 && k < nh; ++k) load_head(k, k);
  }
  if (Q < QT) {
    zero_rows(tiles, kNB, QT, Q, tid, kThreads);
    for (int s = 0; s < 2; ++s) zero_rows(tiles + (st_s - base) + s * kStage, kXB, QT, Q, tid, kThreads);
  }
  fence_proxy_async();

  const float* dtb = a.dt + static_cast<int64_t>(b) * S * a.H;
  const bool row_in = tid < Q && t0 + tid < S;
  // row scale of head h: w_j = exp(seg - cum_j) dt_j (dB), exp(cum_i) (dC)
  auto scale_of = [&](int h) {
    if (tid >= QT) return 0.f;
    const float* cm = a.cum + (static_cast<int64_t>(b) * a.H + h) * nc * Q + t0;
    const float cum = tid < Q ? cm[tid] : 0.f;
    if (side) return tid < Q ? expf(cum) : 0.f;
    const float dt = row_in ? dtb[static_cast<int64_t>(t0 + tid) * a.H + h] : 0.f;
    return expf(cm[Q - 1] - cum) * dt;
  };
  float pv = scale_of(h0);
  float acc[Np / 2];
#pragma unroll
  for (int e = 0; e < Np / 2; ++e) acc[e] = 0.f;
  float dold[2] = {0.f, 0.f};
  mbar_wait(bar_c, 0);

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k, st = k & 1;
    const int64_t rows0 = (static_cast<int64_t>(b) * a.H + h) * nc * Q + t0;
    if (tid < QT) sV[tid] = pv;
    if (k + 1 < nh) pv = scale_of(h + 1);
    mbar_wait(full + 8 * st, (k >> 1) & 1);
    __syncthreads();
    const uint32_t xs = st_s + st * kStage, ss = xs + kA;
    scale_rows(tiles + (xs - base), kXB * QT * 8, QT, sV, tid, kThreads);
    fence_proxy_async();
    __syncthreads();
    // acc += (scaled x or dy) [rows, p] (K-major) times G or h [p, n] (MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Pp / 16; ++kk) {
      if (kk >= a.P / 16) break;
      mma_ss<Np, 0, 1>(acc, gmma_desc(xs + (kk / 4) * kBox + wg * 64 * 128 + (kk % 4) * 32, 16),
                       gmma_desc(ss + kk * 2048, kPBox), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (side) {  // erow_i = exp(cum_i) C_i . (dy_i h): the rise of C_i . acc_i
      const uint8_t* ct = tiles;
      float dn[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < Np / 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 cv = ld2(ct, swz(i0 + 8 * r, 8 * jj + 2 * (lane % 4), kBox));
          dn[r] += acc[4 * jj + 2 * r] * cv.x + acc[4 * jj + 2 * r + 1] * cv.y;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dn[r] = quad_sum(dn[r]);
        const int i = i0 + 8 * r;
        if (lane % 4 == 0 && i < Q) a.erow[rows0 + i] = dn[r] - dold[r];
        dold[r] = dn[r];
      }
    }
    __syncthreads();  // the stage is free
    if (tid == 0 && k + 2 < nh) load_head(k + 2, st);
  }

  // + dS^T C (dB) or + dS B (dC): dS [QT rows j, QT columns i] and B into the stages' room
  const uint32_t ds_s = st_s, b_s = st_s + (QT / 64) * kBox;
  const int slot = static_cast<int>(((static_cast<int64_t>(run) * a.B + b) * nc + c) * a.G + g);
  if (tid == 0) {
    mbar_expect_tx(bar_end, (QT / 64) * kBox + (side ? rows_bytes(kNB, Q) : 0));
    for (int cb = 0; cb < QT / 64; ++cb) tma_load(ds_s + cb * kBox, &tds, bar_end, 64 * cb, 0, slot);
    if (side) tma_rows(b_s, &tb, bar_end, kNB, QT, Q, g, t0, b);
  }
  if (side && Q < QT) zero_rows(tiles + (b_s - base), kNB, QT, Q, tid, kThreads);
  fence_proxy_async();
  mbar_wait(bar_end, 0);
  __syncthreads();
  wgmma_fence();
  if (side) {
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      mma_ss<Np, 1, 1>(acc, gmma_desc(ds_s + wg * kBox + kk * 2048, kBox),
                       gmma_desc(b_s + kk * 2048, kBox), 1);
  } else {
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      mma_ss<Np, 0, 1>(acc, gmma_desc(ds_s + (kk / 4) * kBox + wg * 64 * 128 + (kk % 4) * 32, 16),
                       gmma_desc(c_s + kk * 2048, kBox), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r, t = t0 + i;
    if (i >= Q || t >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + t) * a.G + g) * a.N;
#pragma unroll
    for (int jj = 0; jj < Np / 8; ++jj) {
      const int n = 8 * jj + 2 * (lane % 4);
      if (n >= a.N) continue;
      const float v0 = acc[4 * jj + 2 * r], v1 = acc[4 * jj + 2 * r + 1];
      if (a.bc_runs == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>((side ? a.dCm : a.dBm) + row + n) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        const int64_t part = (static_cast<int64_t>(side) * a.runs + run) * a.B * S * a.G * a.N;
        *reinterpret_cast<float2*>(a.bc_runs + part + row + n) = make_float2(v0, v1);
      }
    }
  }
}

// 6. blockIdx.y 0: dA and dD, a warp a head, their parts over batch and
// chunks summed by each lane over a fixed stride, then over the lanes in a
// fixed tree; blockIdx.y 1 (heads split into runs): dBm and dCm, 4
// elements a thread, each the sum of the runs' parts in order.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_reduce_runs(WArgs a, int dd_parts) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (blockIdx.y == 0) {
    const int head = static_cast<int>(e / 32), lane = threadIdx.x % 32;
    if (head >= a.H) return;
    const int nd = a.nc * dd_parts;
    float sa = 0.f, sd = 0.f;
    for (int k = lane; k < a.B * a.nc; k += 32)
      sa += a.dap[(static_cast<int64_t>(k / a.nc) * a.H + head) * a.nc + k % a.nc];
    for (int k = lane; k < a.B * nd; k += 32)
      sd += a.ddp[(static_cast<int64_t>(k / nd) * a.H + head) * nd + k % nd];
    sa = warp_sum(sa);
    sd = warp_sum(sd);
    if (lane == 0) {
      a.dA[head] = sa;
      a.dD[head] = sd;
    }
    return;
  }
  const int64_t size = static_cast<int64_t>(a.B) * a.S * a.G * a.N;
  if (4 * e >= size) return;
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int r = 0; r < a.runs; ++r) {
    const float4 vb = reinterpret_cast<const float4*>(a.bc_runs + r * size)[e];
    const float4 vc = reinterpret_cast<const float4*>(a.bc_runs + (a.runs + r) * size)[e];
    sb = make_float4(sb.x + vb.x, sb.y + vb.y, sb.z + vb.z, sb.w + vb.w);
    sc = make_float4(sc.x + vc.x, sc.y + vc.y, sc.z + vc.z, sc.w + vc.w);
  }
  reinterpret_cast<uint2*>(a.dBm)[e] = make_uint2(pack_bf16(sb.x, sb.y), pack_bf16(sb.z, sb.w));
  reinterpret_cast<uint2*>(a.dCm)[e] = make_uint2(pack_bf16(sc.x, sc.y), pack_bf16(sc.z, sc.w));
}

// A 4-D map over x / dy [B, S, H, P] or Bm / Cm [B, S, G, N], dense: boxes
// of 64 columns by 32 rows.
int encode_rows(CUtensorMap* map, const void* ptr, int B, int S, int heads, int cols) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(heads) * cols * 2,
                                 static_cast<cuuint64_t>(S) * heads * cols * 2};
  const cuuint32_t box[4] = {64, 1, kRowsBox, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}
// A 3-D map over `slots` [rows, cols] bf16 matrices whose rows are
// `row_bytes` apart (h and G: rows of the f32 scratch; dS: dense), boxes
// of 64 columns by `box_rows`.
int encode_slots(CUtensorMap* map, const void* ptr, int cols, int rows, int64_t slots,
                 int64_t row_bytes, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slots)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(row_bytes) * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return encode_bf16(map, ptr, 3, dims, strides, box);
}

template <int Pp, int Np, int QT>
int launch_wgmma(const WArgs& a, const void* x, const void* dy, const void* Bm, const void* Cm,
                 cudaStream_t stream) {
  constexpr int WGS = dxds_wgs(Pp, Np, QT);
  constexpr int kS1 = states_wg_smem(Pp, Np, QT), kS3 = dxds_smem(Pp, Np, QT, WGS);
  constexpr int kS4 = dbdc_smem(Pp, Np, QT);
  static_assert(kS1 <= kSmemMax && kS3 <= kSmemMax && kS4 <= kSmemMax,
                "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_wgmma<Pp, Np, QT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kS1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dx_ds_wgmma<Pp, Np, QT, WGS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kS3);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_db_dc_wgmma<Pp, Np, QT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kS4);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t slots = static_cast<int64_t>(a.B) * a.H * a.nc;
  CUtensorMap tx, tdy, tb, tc, th, tg, tds;
  int err = encode_rows(&tx, x, a.B, a.S, a.H, a.P);
  if (err == 0) err = encode_rows(&tdy, dy, a.B, a.S, a.H, a.P);
  if (err == 0) err = encode_rows(&tb, Bm, a.B, a.S, a.G, a.N);
  if (err == 0) err = encode_rows(&tc, Cm, a.B, a.S, a.G, a.N);
  if (err == 0) err = encode_slots(&th, a.state, a.N, a.P, slots, 4 * static_cast<int64_t>(a.N), Pp);
  if (err == 0) err = encode_slots(&tg, a.grad, a.N, a.P, slots, 4 * static_cast<int64_t>(a.N), Pp);
  if (err == 0)
    err = encode_slots(&tds, a.ds, QT, QT, static_cast<int64_t>(a.runs) * a.B * a.nc * a.G,
                       2 * QT, QT);
  if (err != 0) return err;
  const int tiles = (a.P * a.N + 4 * kChain - 1) / (4 * kChain), jbs = QT / (64 * WGS);
  const dim3 runs_grid(a.nc, a.G * a.runs, a.B);
  ssd_bwd_states_wgmma<Pp, Np, QT><<<runs_grid, 256, kS1, stream>>>(tx, tdy, tb, tc, a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chain<bf16><<<dim3(a.B * a.H, tiles), kChain, 0, stream>>>(a.state, a.grad, a.cum,
                                                                     a.dots, a.nc, a.Q, a.P, a.N);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dx_ds_wgmma<Pp, Np, QT, WGS><<<dim3(a.nc * jbs, a.G * a.runs, a.B), 128 * WGS, kS3,
                                          stream>>>(tx, tdy, tb, tc, tg, a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_db_dc_wgmma<Pp, Np, QT><<<dim3(2 * a.nc, a.G * a.runs, a.B), 2 * QT, kS4, stream>>>(
      tx, tdy, tb, tc, th, tg, tds, a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.nc * a.Q;
  const Dcum d{a.dt, a.A, a.cum, a.colt, a.dw, a.rowmr, a.erow, a.dots, a.ddt, a.dap,
               rows, jbs, tiles, a.S, a.H, a.Q};
  ssd_bwd_dcum<<<dim3(a.nc, a.H, a.B), kThreads, 0, stream>>>(d);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int64_t quads = a.runs > 1 ? static_cast<int64_t>(a.B) * a.S * a.G * a.N / 4 : 0;
  const int64_t run_blocks = (quads + kPassThreads - 1) / kPassThreads;
  const int64_t head_blocks = (a.H + kPassThreads / 32 - 1) / (kPassThreads / 32);
  const int64_t blocks = run_blocks > head_blocks ? run_blocks : head_blocks;
  ssd_bwd_reduce_runs<<<dim3(static_cast<unsigned>(blocks), a.runs > 1 ? 2 : 1), kPassThreads, 0,
                        stream>>>(a, jbs);
  return static_cast<int>(cudaGetLastError());
}

// ========================================================== entry points

using Launch = int (*)(const Args&, cudaStream_t);
using WLaunch = int (*)(const WArgs&, const void*, const void*, const void*, const void*,
                        cudaStream_t);

bool head_dim(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

template <int P>
Launch f32_for(int N) {
  switch (N) {
    case 16: return launch<P, 16>;
    case 32: return launch<P, 32>;
    case 64: return launch<P, 64>;
    case 128: return launch<P, 128>;
    default: return nullptr;
  }
}

Launch find_f32(int P, int N) {
  if (!head_dim(P) || !head_dim(N)) return nullptr;
  switch (P) {
    case 16: return f32_for<16>(N);
    case 32: return f32_for<32>(N);
    case 64: return f32_for<64>(N);
    default: return f32_for<128>(N);
  }
}

template <int Pp, int Np>
WLaunch wgmma_for(int rows) {
  return rows == 64 ? launch_wgmma<Pp, Np, 64> : rows == 128 ? launch_wgmma<Pp, Np, 128> : nullptr;
}

// The bf16 instantiation for (P, N, tile rows: the chunk rounded up to 64).
WLaunch find_wgmma(int P, int N, int rows) {
  if (!head_dim(P) || !head_dim(N)) return nullptr;
  if (padded(P) == 64)
    return padded(N) == 64 ? wgmma_for<64, 64>(rows) : wgmma_for<64, 128>(rows);
  return padded(N) == 64 ? wgmma_for<128, 64>(rows) : wgmma_for<128, 128>(rows);
}

int f32_smem(int phase, int P, int N) {
  return phase == 0 ? states_smem(P, N)
         : phase == 2 ? dxdb_smem(P, N)
         : phase == 3 ? dc_smem(P, N)
                      : 0;
}

}  // namespace

// Threads and dynamic shared memory of launch `phase` (0..5, in the order
// of the header's lists) of the instantiation for (dtype, P, N, tile rows);
// rows is the chunk rounded up to 64 for bf16 and unused for f32.
// cudaErrorInvalidValue if there is none.
extern "C" int ssd_scan_bwd_geometry(int dtype, int P, int N, int rows, int phase, int* threads,
                                     int* smem) {
  if (phase < 0 || phase > 5) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (find_f32(P, N) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    *threads = phase == 1 ? kChain : phase == 5 ? kPassThreads : kThreads;
    *smem = f32_smem(phase, P, N);
    return 0;
  }
  if (dtype != 1 || find_wgmma(P, N, rows) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Pp = padded(P), Np = padded(N), wgs = dxds_wgs(Pp, Np, rows);
  const int t[6] = {256, kChain, 128 * wgs, 2 * rows, kThreads, kPassThreads};
  const int m[6] = {states_wg_smem(Pp, Np, rows), 0, dxds_smem(Pp, Np, rows, wgs),
                    dbdc_smem(Pp, Np, rows), 0, 0};
  *threads = t[phase];
  *smem = m[phase];
  return 0;
}

// dtype of x, Bm, Cm, dy, dx, dBm, dCm: 0 = float32 (CUDA cores), 1 =
// bfloat16 (wgmma).  Every tensor contiguous and 16-byte aligned.  scratch:
// n_scratch pointers in the order of kernel_plan_bwd's "scratch" (f32: 11;
// bf16: 11, and the runs' dB / dC parts where runs > 1).  runs: the bf16
// plan's head runs a group (ignored for f32).  Q: a multiple of 32 up to
// 128.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
                            void* dA, void* dBm, void* dCm, void* dD, void* const* scratch,
                            int n_scratch, int B, int S, int H, int G, int P, int N, int Q,
                            int dtype, int runs, void* stream) {
  if (Q % kPanel || Q < kPanel || Q > kMaxQ || G <= 0 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](int k) { return static_cast<float*>(scratch[k]); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Launch fn = find_f32(P, N);
    if (fn == nullptr || n_scratch != 11) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, Bm, Cm, dy,
                 static_cast<const float*>(dt), static_cast<const float*>(A),
                 static_cast<const float*>(D), dx, dBm, dCm,
                 static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(dD),
                 f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10),
                 B, S, H, G, P, N, Q};
    return fn(a, st);
  }
  const int hpg = H / G;
  const WLaunch fn = dtype == 1 ? find_wgmma(P, N, Q <= 64 ? 64 : 128) : nullptr;
  if (fn == nullptr || runs < 1 || runs > hpg || n_scratch != (runs > 1 ? 12 : 11))
    return static_cast<int>(cudaErrorInvalidValue);
  const int run_len = (hpg + runs - 1) / runs;
  if ((runs - 1) * run_len >= hpg) return static_cast<int>(cudaErrorInvalidValue);
  WArgs a{};
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.dx = static_cast<bf16*>(dx);
  a.dBm = static_cast<bf16*>(dBm);
  a.dCm = static_cast<bf16*>(dCm);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dD = static_cast<float*>(dD);
  a.cum = f(0);
  a.state = f(1);
  a.grad = f(2);
  a.dots = f(3);
  a.colt = f(4);
  a.dw = f(5);
  a.rowmr = f(6);
  a.erow = f(7);
  a.ds = static_cast<bf16*>(scratch[8]);
  a.dap = f(9);
  a.ddp = f(10);
  a.bc_runs = runs > 1 ? f(11) : nullptr;
  a.B = B, a.S = S, a.H = H, a.G = G, a.P = P, a.N = N, a.Q = Q;
  a.nc = (S + Q - 1) / Q, a.runs = runs, a.run_len = run_len;
  return fn(a, x, dy, Bm, Cm, st);
}

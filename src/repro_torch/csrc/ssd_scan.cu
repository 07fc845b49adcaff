// Mamba2 SSD chunked scan (forward), hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan_pallas, the TPU kernel of the
// JAX package (body _ssd_kernel).  For x [B, S, H, P], dt [B, S, H], A and D
// [H], Bm and Cm [B, S, G, N] (head h reads group h / (H / G)), per chunk of
// Q steps with cum = inclusive cumsum of dt * A over the chunk and
// seg = cum[Q - 1]:
//
//   W[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      (i >= j, else 0)
//   y_i     = sum_j W[i, j] x_j  +  (C_i . h_in) * exp(cum_i)  +  D * x_i
//   h_out   = exp(seg) * h_in  +  sum_j x_j (exp(seg - cum_j) dt_j B_j)^T
//
// where h is the [P, N] state carried from chunk to chunk (zero at the
// start).  Rows past S load as zeros with dt = 0: identity steps, the same
// as the Pallas path's padding, without padding anything in memory.  x, Bm,
// Cm are f32 or bf16; dt, A, D are f32; y has x's type.  All arithmetic is
// f32 on the CUDA cores (no TF32: the f32 tolerance is 2e-4), expf without
// fast math.
//
// What bounds it.  Per (b, h, chunk) the scan does Q^2 N + 3 Q P N
// multiply-adds (the C.B products, W x, C h_in and the state update) on
// Q (P + 2N) + Q inputs: at the training shape of mamba2-130m (Q = 128,
// P = 64, N = 128) ~160 operations per byte read, so the H100 is bound by
// arithmetic.  Its rate for bf16 is the tensor cores' (989 TFLOP/s); this
// first version does f32 FMAs on the CUDA cores (67 TFLOP/s peak), the
// precision the f32 path needs, shared by the bf16 path for simplicity.
// wgmma, TMA and a chunk-parallel state pass are for a later version.
//
// What the design does about it.
//
// * The TPU grid (B, H, S/Q) runs its chunk axis in order and keeps the
//   state in VMEM scratch between grid steps.  Here one block per (h, b)
//   loops over the chunks itself; the state lives in registers (each thread
//   owns a micro-tile of it) and is mirrored into shared memory for the
//   C . h_in products.  It never goes to device memory.
// * x, Bm, Cm are read in place, in their [B, S, H|G, P|N] layout, through
//   strides: no transposed copies (the JAX wrapper makes four).
// * Shared memory.  The [Q, Q] matrix W is built in row panels of 32: per
//   panel the C rows, then W (C.B, decay, causal mask), then the panel's
//   y rows, written out at once.  So the chunk's x and B tiles, the state,
//   one C panel and one W panel are resident, all f32 with odd row strides
//   where a warp reads down a column: 163 KB at Q = 128, P = 64, N = 128,
//   232,192 bytes at most (P = N = 128), one block per SM.
// * Register tiling.  Every product is a micro-tile per thread (W: 4 rows x
//   up to 4 columns; y: up to 4 x 4; state: up to 16 x 4), so each value
//   read from shared memory feeds several FMAs.  The kernel is a template
//   on P and N (and the W panel on its column count), so every tile is
//   exact: a guard on a runtime size would still execute the FMAs it
//   switches off, and at one block of 8 warps per SM the kernel is bound by
//   instruction throughput.  Causality bounds the loops: panel p builds W
//   only for the 32 (p + 1) columns it can see.  The inner loops are
//   unrolled by 4, the cumsum is a warp scan, and each thread keeps 8 tile
//   loads in flight.
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (or the error of cudaFuncSetAttribute) so
// the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kPanel = 32;      // rows of W built at a time
constexpr int kMaxQ = 128;
constexpr int kLoadBatch = 8;   // tile loads in flight per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared-memory floats for one block, in the order they are laid out.
__host__ __device__ constexpr int smem_floats(int Q, int P, int N) {
  return Q * P               // x tile            [Q][P]
         + Q * (N + 1)       // B tile            [Q][N + 1]
         + kPanel * (N + 1)  // C panel           [32][N + 1]
         + P * (N + 1)       // state h_in        [P][N + 1]
         + kPanel * (Q + 1)  // W panel           [32][Q + 1]
         + 3 * Q;            // dt, cum, exp(seg - cum) * dt
}

struct Strides {
  int64_t b, s, h;
};

// Rows [row0, row0 + rows) of a [*, cols] tile (row stride `stride`) into
// shared memory with leading dimension ld, as f32; rows past S load as
// zeros.  Each thread starts kLoadBatch loads before it stores any.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int rows, int cols,
                                          int row0, int S, int tid) {
  const int total = rows * cols;
  for (int e0 = tid; e0 < total; e0 += kLoadBatch * kThreads) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * kThreads, i = e / cols, c = e - i * cols;
      v[u] = e < total && row0 + i < S
                 ? to_f32(src[(row0 + i) * stride + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * kThreads, i = e / cols, c = e - i * cols;
      if (e < total) dst[i * ld + c] = v[u];
    }
  }
}

// One panel of W: rows warp + 8k (k < 4) of the panel starting at row i0,
// columns lane + 32m for the NC column groups the panel's rows can see.
template <int N, int NC>
__device__ __forceinline__ void w_panel(const float* sC, const float* sB,
                                        float* sW, const float* sCum,
                                        const float* sDt, int LDW, int i0,
                                        int warp, int lane) {
  constexpr int LDB = N + 1;
  float acc[4][NC];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[k][m] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cr[4], bj[NC];
#pragma unroll
    for (int k = 0; k < 4; ++k) cr[k] = sC[(warp + 8 * k) * LDB + n];
#pragma unroll
    for (int m = 0; m < NC; ++m) bj[m] = sB[(lane + 32 * m) * LDB + n];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < NC; ++m) acc[k][m] = fmaf(cr[k], bj[m], acc[k][m]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + 8 * k, i = i0 + r;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int j = lane + 32 * m;
      sW[r * LDW + j] =
          i >= j ? acc[k][m] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
    }
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, const float* __restrict__ D,
        T* __restrict__ y, int S, int H, int G, int Q, Strides sx,
        Strides sdt, Strides sb, Strides sc) {
  // y micro-tile: columns p = lane % LP + LP * m (m < PM), rows
  // r = warp * RW + lane / LP + 8 * RW * k (k < RM) of a 32-row panel.
  constexpr int LP = P < 32 ? P : 32, RW = 32 / LP, PM = P / LP,
                RM = 4 / RW;
  // state micro-tile: columns n = lane % LN + LN * m (m < NM), rows
  // p = warp * RWn + lane / LN + 8 * RWn * k (k < PK).
  constexpr int LN = N < 32 ? N : 32, RWn = 32 / LN, NM = N / LN,
                PK = P / (8 * RWn);
  constexpr int LDB = N + 1, LDS = N + 1;

  extern __shared__ float smem[];
  const int LDW = Q + 1;
  float* sX = smem;
  float* sB = sX + Q * P;
  float* sC = sB + Q * LDB;
  float* sS = sC + kPanel * LDB;
  float* sW = sS + P * LDS;
  float* sDt = sW + kPanel * LDW;
  float* sCum = sDt + Q;
  float* sWj = sCum + Q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a = A[h], dskip = D[h];

  const T* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const T* Bb = Bm + b * sb.b + g * sb.h;
  const T* Cb = Cm + b * sc.b + g * sc.h;
  T* yb = y + (static_cast<int64_t>(b) * S * H + h) * P;
  const int64_t sy = static_cast<int64_t>(H) * P;
  const int yp = lane % LP, yr = warp * RW + lane / LP;
  const int sn = lane % LN, sp = warp * RWn + lane / LN;

  float hs[PK][NM];  // this thread's part of the state, across chunks
#pragma unroll
  for (int k = 0; k < PK; ++k)
#pragma unroll
    for (int m = 0; m < NM; ++m) hs[k][m] = 0.f;
  for (int e = tid; e < P * LDS; e += kThreads) sS[e] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    // ---- load the chunk's x, B and dt (rows past S: zeros, dt = 0)
    load_tile(sX, P, xb, sx.s, Q, P, t0, S, tid);
    load_tile(sB, LDB, Bb, sb.s, Q, N, t0, S, tid);
    for (int i = tid; i < Q; i += kThreads) {
      const int t = t0 + i;
      sDt[i] = t < S ? dtb[t * sdt.s] : 0.f;
    }
    __syncthreads();
    if (warp == 0) {
      // inclusive cumsum of dt * A (products rounded, no FMA): lane l sums
      // elements 4l..4l+3 in order, then a scan over the lanes' sums
      float part[4], run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * lane + u;
        run = __fadd_rn(run, i < Q ? __fmul_rn(sDt[i], a) : 0.f);
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
        if (4 * lane + u < Q) sCum[4 * lane + u] = __fadd_rn(base, part[u]);
    }
    __syncthreads();
    const float seg = sCum[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      sWj[i] = expf(seg - sCum[i]) * sDt[i];

    // ---- row panels of W and y
    for (int i0 = 0; i0 < Q; i0 += kPanel) {
      load_tile(sC, LDB, Cb, sc.s, kPanel, N, t0 + i0, S, tid);
      __syncthreads();

      switch (i0 / kPanel) {  // the column groups the panel's rows can see
        case 0: w_panel<N, 1>(sC, sB, sW, sCum, sDt, LDW, i0, warp, lane); break;
        case 1: w_panel<N, 2>(sC, sB, sW, sCum, sDt, LDW, i0, warp, lane); break;
        case 2: w_panel<N, 3>(sC, sB, sW, sCum, sDt, LDW, i0, warp, lane); break;
        default: w_panel<N, 4>(sC, sB, sW, sCum, sDt, LDW, i0, warp, lane); break;
      }
      __syncthreads();

      // y rows of the panel: intra-chunk W x, inter-chunk (C h_in) exp(cum)
      float intra[RM][PM], inter[RM][PM];
#pragma unroll
      for (int k = 0; k < RM; ++k)
#pragma unroll
        for (int m = 0; m < PM; ++m) intra[k][m] = inter[k][m] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cr[RM], hv[PM];
#pragma unroll
        for (int k = 0; k < RM; ++k) cr[k] = sC[(yr + 8 * RW * k) * LDB + n];
#pragma unroll
        for (int m = 0; m < PM; ++m) hv[m] = sS[(yp + LP * m) * LDS + n];
#pragma unroll
        for (int k = 0; k < RM; ++k)
#pragma unroll
          for (int m = 0; m < PM; ++m)
            inter[k][m] = fmaf(cr[k], hv[m], inter[k][m]);
      }
      const int jend = i0 + kPanel;  // W is 0 above the diagonal
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        float wr[RM], xv[PM];
#pragma unroll
        for (int k = 0; k < RM; ++k) wr[k] = sW[(yr + 8 * RW * k) * LDW + j];
#pragma unroll
        for (int m = 0; m < PM; ++m) xv[m] = sX[j * P + yp + LP * m];
#pragma unroll
        for (int k = 0; k < RM; ++k)
#pragma unroll
          for (int m = 0; m < PM; ++m)
            intra[k][m] = fmaf(wr[k], xv[m], intra[k][m]);
      }
#pragma unroll
      for (int k = 0; k < RM; ++k) {
        const int i = i0 + yr + 8 * RW * k, t = t0 + i;
        if (t >= S) continue;
        const float ecum = expf(sCum[i]);
#pragma unroll
        for (int m = 0; m < PM; ++m) {
          const int p = yp + LP * m;
          const float v = intra[k][m] + inter[k][m] * ecum;
          store(yb + t * sy + p, v + dskip * sX[i * P + p]);
        }
      }
      __syncthreads();  // the next panel rewrites sC and sW; the state
                        // update below rewrites sS (h_in)
    }

    // ---- state update: h = exp(seg) h + sum_j x_j^T (wj_j B_j)
    float acc[PK][NM];
#pragma unroll
    for (int k = 0; k < PK; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) acc[k][m] = 0.f;
#pragma unroll 4
    for (int j = 0; j < Q; ++j) {
      const float wj = sWj[j];
      float bw[NM], xv[PK];
#pragma unroll
      for (int m = 0; m < NM; ++m) bw[m] = sB[j * LDB + sn + LN * m] * wj;
#pragma unroll
      for (int k = 0; k < PK; ++k) xv[k] = sX[j * P + sp + 8 * RWn * k];
#pragma unroll
      for (int k = 0; k < PK; ++k)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[k][m] = fmaf(xv[k], bw[m], acc[k][m]);
    }
    const float decay = expf(seg);
#pragma unroll
    for (int k = 0; k < PK; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        hs[k][m] = decay * hs[k][m] + acc[k][m];
        sS[(sp + 8 * RWn * k) * LDS + sn + LN * m] = hs[k][m];
      }
    __syncthreads();  // sS, sX, sB are rewritten by the next chunk
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, void* y, int B, int S, int H,
           int G, int Q, Strides sx, Strides sdt, Strides sb, Strides sc,
           cudaStream_t stream) {
  constexpr int kMaxSmem = smem_floats(kMaxQ, P, N) * 4;
  static_assert(kMaxSmem <= 232448, "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(H, B);
  ssd_fwd<T, P, N><<<grid, kThreads, smem_floats(Q, P, N) * 4, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, static_cast<T*>(y), S, H, G, Q, sx, sdt,
      sb, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_state_dim(int N, const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* D,
                       void* y, int B, int S, int H, int G, int Q, Strides sx,
                       Strides sdt, Strides sb, Strides sc,
                       cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int P, int N, const void* x, const float* dt, const float* A,
             const void* Bm, const void* Cm, const float* D, void* y, int B,
             int S, int H, int G, int Q, Strides sx, Strides sdt, Strides sb,
             Strides sc, cudaStream_t stream) {
  switch (P) {
    case 16: return dispatch_state_dim<T, 16>(N, x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    case 32: return dispatch_state_dim<T, 32>(N, x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    case 64: return dispatch_state_dim<T, 64>(N, x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    case 128: return dispatch_state_dim<T, 128>(N, x, dt, A, Bm, Cm, D, y, B, S, H, G, Q, sx, sdt, sb, sc, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype of x, Bm, Cm and y: 0 = float32, 1 = bfloat16.  Strides are in
// elements, for the batch, sequence and head (group) axes; the last axis of
// x, Bm and Cm is contiguous.  The wrapper checks P, N in {16, 32, 64, 128},
// Q a multiple of 32 up to 128, and H a multiple of G.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            void* y, int B, int S, int H, int G, int P, int N,
                            int Q, int dtype, int64_t sxb, int64_t sxs,
                            int64_t sxh, int64_t sdb, int64_t sds, int64_t sdh,
                            int64_t sbb, int64_t sbs, int64_t sbg, int64_t scb,
                            int64_t scs, int64_t scg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sx{sxb, sxs, sxh}, sdt{sdb, sds, sdh}, sb{sbb, sbs, sbg},
      sc{scb, scs, scg};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  if (dtype == 0)
    return dispatch<float>(P, N, x, dtf, Af, Bm, Cm, Df, y, B, S, H, G, Q, sx, sdt, sb, sc, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, dtf, Af, Bm, Cm, Df, y, B, S, H, G, Q, sx, sdt, sb, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mamba2 SSD chunked scan (forward), hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py:81 ssd_scan_pallas, the TPU kernel of
// the JAX package (body _ssd_kernel).  For x [B, S, H, P], dt [B, S, H], A
// and D [H], Bm and Cm [B, S, G, N] (head h reads group h / (H / G)), per
// chunk of Q steps with cum = inclusive cumsum of dt * A over the chunk and
// seg = cum[Q - 1]:
//
//   W[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      (i >= j, else 0)
//   y_i     = sum_j W[i, j] x_j  +  (C_i . h_in) * exp(cum_i)  +  D * x_i
//   h_out   = exp(seg) * h_in  +  sum_j x_j (exp(seg - cum_j) dt_j B_j)^T
//
// where h is the [P, N] state carried from chunk to chunk (zero at the
// start).  Rows past S load as zeros with dt = 0: identity steps, the same
// as the Pallas path's padding, without padding anything in memory.  x, Bm,
// Cm are f32 or bf16; dt, A, D are f32; y has x's type.  On request the
// state after the last chunk (the state at S: padded steps are identities)
// is written as f32 [B, H, P, N], which seeds the recurrent decode after a
// prefill; the Pallas kernel has no such output (the JAX package's prefill
// runs its plain chunked version for it).
//
// What bounds it.  Per (b, h, chunk) the scan does Q(Q+1)/2 (N + P)
// multiply-adds for the causal triangles of C.B^T and W x, and 2 Q P N for
// C h_in and the state update, on Q (P + 2N) bf16 inputs: at mamba2-130m's
// training shape (x [8, 2048, 24, 64], N = 128, Q = 128) that is 22.6
// GFLOP, 22.9 us at the tensor cores' 989 TFLOP/s, against 110.6 MB of x,
// dt, B, C and y, 33.0 us at 3.35 TB/s: the H100 is bound by bytes.  The
// state is a chain across chunks, and the TPU grid walks the chunk axis in
// order; on 132 SMs a chain per (b, h) leaves most of the card idle and
// puts the products on the CUDA cores.
//
// Two kernels, picked by dtype in the launch plan (kernels/ssd_scan.py
// kernel_plan), which passes the instantiation's tile rows;
// ssd_scan_geometry reports each phase's threads and shared memory.
//
// * bf16: three phases on the caller's stream, each chunk-parallel, the
//   products on the tensor cores (wgmma), the tiles loaded by TMA:
//   1. ssd_fwd_chunk_state, one block (one warpgroup) per (chunk, h, b):
//      dt, the chunk's cumsum (the warp scan below fixes its rounding
//      order), written to an f32 scratch [B, H, S_pad] that phase 3 reads
//      again, so all phases see the same decay; B's rows scaled in shared
//      memory by w_j = exp(seg - cum_j) dt_j (a row of a box is one
//      128-byte line whatever the swizzle, rounding w_j B_j to bf16 once);
//      then s_c = x^T (w B), M = P (x^T MN-major), N = N (MN-major), K = the
//      chunk's rows, f32 into a scratch [B, H, nc, P, N].
//   2. ssd_fwd_state_pass, one thread per 4 state elements of a (b, h):
//      h_in[c] = h; h = exp(seg_c) h + s_c over the chunks in order, h in
//      f32 registers, h_in written as bf16 [B, H, nc, P, N] for phase 3,
//      and the final h as f32 where the caller asks for it.
//   3. ssd_fwd_chunk_scan, one block per (chunk, h, b), a warpgroup per 64
//      of the chunk's rows: S = C B^T and y = C h_in^T (both K-major, K =
//      N) in one commit; y's rows scaled by exp(cum_i) in the accumulator
//      (f32: no operand is rescaled, so C keeps one rounding); W = S masked
//      to i >= j before the exponential, times exp(cum_i - cum_j) dt_j, in
//      the S accumulator, packed to bf16 as wgmma's register operand; y +=
//      W x with x MN-major (the transpose bit), a 64-row warpgroup skipping
//      the key columns past its rows; then + D x and y stored as bf16.
//   Tiles: boxes of 64 columns; P and N below 64 pad to 64 with columns
//   the hardware zero-fills, so every product is m64 n{64,128} k16.  A
//   chunk of 32 or 96 rows sits in a tile of 64 or 128 (the tile rows of
//   the plan), its last rows zeroed in shared memory with dt = 0: identity
//   steps, exact.  4-D tensor maps over x [B, S, H, P] and Bm/Cm
//   [B, S, G, N] built from their strides (no copies; a stride must be a
//   multiple of 16 bytes), rows past S zero-filled.
//   Scratch: the f32 s_c, its bf16 h_in and cum, allocated by the wrapper
//   (torch.empty): at the training shape 100.7 MB + 50.3 MB + 1.6 MB, which
//   the three phases write once and read once, ~300 MB of traffic beside
//   the 110.6 MB the scan must move.
//
// * f32: ssd_fwd_f32<P, N>, on the CUDA cores in f32 FMAs, which its 2e-4
//   tolerance needs (no TF32, no bf16 operands).  One block per (h, b)
//   loops over the chunks itself with the state in registers (each thread
//   owns a micro-tile, mirrored into shared memory for C . h_in, and
//   written out after the last chunk where the caller asks); x, B, C,
//   dt read through strides; W built in row panels of 32, all f32 in
//   shared memory with odd row strides (163 KB at Q = 128, P = 64, N = 128,
//   232,192 bytes at most), one block per SM; every product a register
//   micro-tile per thread, templated on P and N so every tile is exact.
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (or the error of cudaFuncSetAttribute, or
// the codes kNoEncoder / kEncodeFailed of hopper.cuh) so the Python wrapper
// can raise.

#include "hopper.cuh"

namespace {

struct Strides {
  int64_t b, s, h;
};

// Inclusive cumsum of dt * A over rows [0, 128) of a chunk (rows past the
// chunk hold dt = 0), by one warp, with rounded products and no FMA: lane
// l sums elements 4l..4l+3 in order, then a scan over the lanes' sums.
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

// ====================================================== bf16: tensor cores

constexpr int kPassThreads = 256;  // state pass: threads a block, 4 elements each

// Columns a tile keeps in shared memory for a width of 16..128: whole
// 64-column boxes.
constexpr int padded(int w) { return w <= 64 ? 64 : 128; }

// Dynamic shared memory of the two chunk-parallel phases: 1 KB to align
// the base to the 128-byte swizzle's 1024-byte pattern, the boxes of QT
// rows (x and B; C, B and x), h_in's boxes of Pp rows, the mbarrier, and
// per-row floats (dt, cum, w; dt, cum).
constexpr int chunk_state_smem(int Pp, int Np, int QT) {
  return 1024 + QT * 128 * (Pp / 64 + Np / 64) + 8 + 3 * QT * 4;
}
constexpr int chunk_scan_smem(int Pp, int Np, int QT) {
  return 1024 + QT * 128 * (2 * (Np / 64) + Pp / 64) + Pp * 128 * (Np / 64) + 8 + 2 * QT * 4;
}

// Rows [q, QT) of `boxes` consecutive boxes of QT rows of 128 bytes to zero.
__device__ __forceinline__ void zero_rows(uint8_t* tiles, int boxes, int QT, int q, int tid,
                                          int threads) {
  const int per_box = (QT - q) * 8;  // 16-byte pieces
  for (int e = tid; e < boxes * per_box; e += threads) {
    const int bx = e / per_box, r = e - bx * per_box;
    *reinterpret_cast<uint4*>(tiles + bx * QT * 128 + q * 128 + r * 16) = make_uint4(0, 0, 0, 0);
  }
}

template <int Pp, int Np, int QT>
__global__ void __launch_bounds__(128, 1)
ssd_fwd_chunk_state(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    float* __restrict__ cum, float* __restrict__ state, int S, int H, int G,
                    int P, int N, int Q, Strides sdt) {
  constexpr int kXB = Pp / 64, kNB = Np / 64;  // 64-column boxes of x and B
  constexpr uint32_t kBox = QT * 128;          // bytes of a box
  extern __shared__ uint8_t smem[];
  const uint32_t x_s = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* tiles = smem + (x_s - smem_u32(smem));
  const uint32_t b_s = x_s + kXB * kBox, bar = b_s + kNB * kBox;
  float* sDt = reinterpret_cast<float*>(tiles + (kXB + kNB) * kBox + 8);
  float* sCum = sDt + QT;
  float* sW = sCum + QT;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G), t0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (kXB + kNB) * Q * 128);
    for (int i = 0; i < kXB; ++i) tma_load(x_s + i * kBox, &tx, bar, 64 * i, h, t0, b);
    for (int i = 0; i < kNB; ++i) tma_load(b_s + i * kBox, &tb, bar, 64 * i, g, t0, b);
  }
  if (Q < QT) zero_rows(tiles, kXB + kNB, QT, Q, tid, 128);
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  for (int i = tid; i < QT; i += 128) {
    const int t = t0 + i;
    sDt[i] = i < Q && t < S ? dtb[t * sdt.s] : 0.f;
  }
  __syncthreads();
  if (warp == 0) chunk_cumsum(sDt, sCum, A[h], QT, lane);
  __syncthreads();
  const float seg = sCum[QT - 1];  // rows past the chunk add nothing
  for (int i = tid; i < QT; i += 128) {
    sW[i] = expf(seg - sCum[i]) * sDt[i];
    if (i < Q) cum[bh * nc * Q + t0 + i] = sCum[i];
  }
  __syncthreads();
  mbar_wait(bar, 0);

  // B's rows j scaled by w_j in place: a row of a box is one 128-byte line
  for (int e = tid; e < kNB * QT * 8; e += 128) {
    uint4* piece = reinterpret_cast<uint4*>(tiles + kXB * kBox + e * 16);
    uint4 v = *piece;
    __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&v);
    const float w = sW[(e / 8) % QT];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(pair[k]);
      pair[k] = __floats2bfloat162_rn(f.x * w, f.y * w);
    }
    *piece = v;
  }
  fence_proxy_async();
  __syncthreads();

  // s_c[p, n] = sum_j x[j, p] (w B)[j, n]: A = x^T (MN-major), B = w B
  // (MN-major), one 64-row M tile of p at a time
  float* out = state + (bh * nc + c) * P * N;
#pragma unroll
  for (int mt = 0; mt < kXB; ++mt) {
    float acc[Np / 2];
#pragma unroll
    for (int e = 0; e < Np / 2; ++e) acc[e] = 0.f;  // overwritten (scale-d 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint64_t da = gmma_desc(x_s + mt * kBox + kk * 2048, kBox);
      const uint64_t db = gmma_desc(b_s + kk * 2048, kBox);
      if constexpr (Np == 64)
        wgmma_ss_n64<1, 1>(acc, da, db, kk > 0);
      else
        wgmma_ss_n128<1, 1>(acc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 64 * mt + 16 * warp + lane / 4 + 8 * r;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < Np / 8; ++j) {
        const int n = 8 * j + 2 * (lane % 4);
        if (n < N)
          *reinterpret_cast<float2*>(out + p * N + n) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// h_in[c] = h (as bf16); h = exp(seg_c) h + s_c, over the chunks in order;
// then the final h into final_state (f32 [B, H, P, N]) unless it is null.
// Block (bh, tile): elements 4 (tile * 256 + thread) .. + 3 of the [P, N]
// state of one (b, h).
__global__ void __launch_bounds__(kPassThreads)
ssd_fwd_state_pass(const float* __restrict__ cum, const float* __restrict__ state,
                   __nv_bfloat16* __restrict__ h_in, float* __restrict__ final_state, int nc,
                   int Q, int PN) {
  const int e = (blockIdx.y * kPassThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const int64_t bh = blockIdx.x;
  const float* seg = cum + bh * nc * Q + Q - 1;
  const float4* s = reinterpret_cast<const float4*>(state + bh * nc * PN + e);
  uint2* out = reinterpret_cast<uint2*>(h_in + bh * nc * PN + e);
  const int step = PN / 4;  // float4s (and 4-bf16 groups) a chunk
  float4 hs = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float decay = expf(seg[c * Q]);
    const float4 sc = s[c * step];
    out[c * step] = make_uint2(pack_bf16(hs.x, hs.y), pack_bf16(hs.z, hs.w));
    hs = make_float4(decay * hs.x + sc.x, decay * hs.y + sc.y, decay * hs.z + sc.z,
                     decay * hs.w + sc.w);
  }
  if (final_state != nullptr) *reinterpret_cast<float4*>(final_state + bh * PN + e) = hs;
}

template <int Pp, int Np, int QT>
__global__ void __launch_bounds__(2 * QT, 1)
ssd_fwd_chunk_scan(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap th,
                   const float* __restrict__ dt, const float* __restrict__ cum,
                   const float* __restrict__ Dv, __nv_bfloat16* __restrict__ y, int S, int H,
                   int G, int P, int N, int Q, Strides sdt) {
  constexpr int kThreads = 2 * QT;              // a warpgroup per 64 rows
  constexpr int kXB = Pp / 64, kNB = Np / 64;
  constexpr uint32_t kBox = QT * 128, kHBox = Pp * 128;
  extern __shared__ uint8_t smem[];
  const uint32_t c_s = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* tiles = smem + (c_s - smem_u32(smem));
  const uint32_t b_s = c_s + kNB * kBox, x_s = b_s + kNB * kBox;
  const uint32_t h_s = x_s + kXB * kBox, bar = h_s + kNB * kHBox;
  const uint8_t* x_tile = tiles + (x_s - c_s);
  float* sDt = reinterpret_cast<float*>(tiles + (bar - c_s) + 8);
  float* sCum = sDt + QT;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G), t0 = c * Q;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (2 * kNB + kXB) * Q * 128 + kNB * kHBox);
    for (int i = 0; i < kNB; ++i) {
      tma_load(c_s + i * kBox, &tc, bar, 64 * i, g, t0, b);
      tma_load(b_s + i * kBox, &tb, bar, 64 * i, g, t0, b);
      tma_load(h_s + i * kHBox, &th, bar, 64 * i, 0, static_cast<int>(bh * nc + c));
    }
    for (int i = 0; i < kXB; ++i) tma_load(x_s + i * kBox, &tx, bar, 64 * i, h, t0, b);
  }
  if (Q < QT) zero_rows(tiles, 2 * kNB + kXB, QT, Q, tid, kThreads);
  fence_proxy_async();
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  for (int i = tid; i < QT; i += kThreads) {
    const int t = t0 + i;
    sDt[i] = i < Q && t < S ? dtb[t * sdt.s] : 0.f;
    sCum[i] = i < Q ? cum[bh * nc * Q + t0 + i] : 0.f;
  }
  __syncthreads();
  mbar_wait(bar, 0);

  // S = C B^T (K = N) and y = C h_in^T, C's rows 64 wg.. of this warpgroup
  float acc_s[QT / 2], acc_y[Pp / 2];
#pragma unroll
  for (int e = 0; e < QT / 2; ++e) acc_s[e] = 0.f;
#pragma unroll
  for (int e = 0; e < Pp / 2; ++e) acc_y[e] = 0.f;
  const int k_steps = N / 16;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Np / 16; ++kk) {
    if (kk >= k_steps) break;
    const uint32_t col = (kk / 4) * kBox + (kk % 4) * 32;
    const uint64_t da = gmma_desc(c_s + wg * 64 * 128 + col, 16);
    const uint64_t db = gmma_desc(b_s + col, 16);
    if constexpr (QT == 64)
      wgmma_ss_n64(acc_s, da, db, 1);
    else
      wgmma_ss_n128(acc_s, da, db, 1);
    const uint64_t dh = gmma_desc(h_s + (kk / 4) * kHBox + (kk % 4) * 32, 16);
    if constexpr (Pp == 64)
      wgmma_ss_n64(acc_y, da, dh, 1);
    else
      wgmma_ss_n128(acc_y, da, dh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc_s);
  fence_regs(acc_y);

  // this thread's rows i0 (r = 0) and i0 + 8 (r = 1) of the chunk
  const int i0 = 64 * wg + 16 * warp + lane / 4;
  float ecum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) ecum[r] = expf(sCum[i0 + 8 * r]);
#pragma unroll
  for (int e = 0; e < Pp / 2; ++e) acc_y[e] *= ecum[(e / 2) & 1];
  // W, masked to j <= i (and to the chunk's rows) before the exponential
#pragma unroll
  for (int e = 0; e < QT / 2; ++e) {
    const int i = i0 + 8 * ((e / 2) & 1);
    const int j = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
    acc_s[e] = j <= i && i < Q ? acc_s[e] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
  }
  uint32_t wa[QT / 4];
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk) {
    wa[4 * kk + 0] = pack_bf16(acc_s[8 * kk + 0], acc_s[8 * kk + 1]);
    wa[4 * kk + 1] = pack_bf16(acc_s[8 * kk + 2], acc_s[8 * kk + 3]);
    wa[4 * kk + 2] = pack_bf16(acc_s[8 * kk + 4], acc_s[8 * kk + 5]);
    wa[4 * kk + 3] = pack_bf16(acc_s[8 * kk + 6], acc_s[8 * kk + 7]);
  }

  // y += W x: x [rows j, P] MN-major; rows 64 wg.. see key columns < 64 (wg + 1)
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk) {
    if (kk >= 4 * (wg + 1)) break;
    const uint64_t dx = gmma_desc(x_s + kk * 2048, kBox);
    if constexpr (Pp == 64)
      wgmma_rs_n64(acc_y, wa + 4 * kk, dx);
    else
      wgmma_rs_n128(acc_y, wa + 4 * kk, dx);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc_y);

  // + D x (x from the swizzled tile: 16-byte piece p / 8 of row i sits at
  // piece (p / 8) ^ (i % 8)), stored as bf16
  const float dskip = Dv[h];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r, t = t0 + i;
    if (i >= Q || t >= S) continue;
    __nv_bfloat16* yrow = y + ((static_cast<int64_t>(b) * S + t) * H + h) * P;
#pragma unroll
    for (int j = 0; j < Pp / 8; ++j) {
      const int p = 8 * j + 2 * (lane % 4);
      if (p >= P) continue;
      const int col = p % 64;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          x_tile + (p / 64) * kBox + i * 128 + ((((col / 8) ^ (i % 8)) * 16)) + (col % 8) * 2));
      *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __floats2bfloat162_rn(
          acc_y[4 * j + 2 * r] + dskip * xv.x, acc_y[4 * j + 2 * r + 1] + dskip * xv.y);
    }
  }
}

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *A, *D;
  void* y;
  float *cum, *state;
  __nv_bfloat16* h_in;
  float* final_state;  // f32 [B, H, P, N], or null: not written
  int B, S, H, G, P, N, Q;
  Strides sx, sdt, sb, sc;
};

// A 4-D map over x [B, S, H, P] or Bm / Cm [B, S, G, N] (strides in
// elements, the last axis contiguous), boxes of 64 columns x Q rows.
int encode_4d(CUtensorMap* map, const void* ptr, int B, int S, int heads, int cols, Strides st,
              int Q) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(Q), 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

template <int Pp, int Np, int QT>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  constexpr int kSmem1 = chunk_state_smem(Pp, Np, QT), kSmem3 = chunk_scan_smem(Pp, Np, QT);
  static_assert(kSmem3 <= 232448, "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_fwd_chunk_state<Pp, Np, QT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_fwd_chunk_scan<Pp, Np, QT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem3);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (a.S + a.Q - 1) / a.Q;
  CUtensorMap tx, tb, tc, th;
  int err = encode_4d(&tx, a.x, a.B, a.S, a.H, a.P, a.sx, a.Q);
  if (err == 0) err = encode_4d(&tb, a.Bm, a.B, a.S, a.G, a.N, a.sb, a.Q);
  if (err == 0) err = encode_4d(&tc, a.Cm, a.B, a.S, a.G, a.N, a.sc, a.Q);
  if (err == 0) {
    // h_in [B * H * nc, P, N], boxes of 64 columns x Pp rows
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.N), static_cast<cuuint64_t>(a.P),
                                static_cast<cuuint64_t>(a.B) * a.H * nc};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.N) * 2,
                                   static_cast<cuuint64_t>(a.P) * a.N * 2};
    const cuuint32_t box[3] = {64, Pp, 1};
    err = encode_bf16(&th, a.h_in, 3, dims, strides, box);
  }
  if (err != 0) return err;
  const dim3 grid(nc, a.H, a.B);
  ssd_fwd_chunk_state<Pp, Np, QT><<<grid, 128, kSmem1, stream>>>(
      tx, tb, a.dt, a.A, a.cum, a.state, a.S, a.H, a.G, a.P, a.N, a.Q, a.sdt);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int PN = a.P * a.N;
  const dim3 pass_grid(a.B * a.H, (PN / 4 + kPassThreads - 1) / kPassThreads);
  ssd_fwd_state_pass<<<pass_grid, kPassThreads, 0, stream>>>(a.cum, a.state, a.h_in,
                                                              a.final_state, nc, a.Q, PN);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_fwd_chunk_scan<Pp, Np, QT><<<grid, 2 * QT, kSmem3, stream>>>(
      tx, tb, tc, th, a.dt, a.cum, a.D, static_cast<__nv_bfloat16*>(a.y), a.S, a.H, a.G, a.P,
      a.N, a.Q, a.sdt);
  return static_cast<int>(cudaGetLastError());
}

// ========================================================= f32: CUDA cores

constexpr int kThreads = 256;   // 8 warps
constexpr int kPanel = 32;      // rows of W built at a time
constexpr int kMaxQ = 128;
constexpr int kLoadBatch = 8;   // tile loads in flight per thread

// Shared-memory floats for one block, in the order they are laid out.
__host__ __device__ constexpr int smem_floats(int Q, int P, int N) {
  return Q * P               // x tile            [Q][P]
         + Q * (N + 1)       // B tile            [Q][N + 1]
         + kPanel * (N + 1)  // C panel           [32][N + 1]
         + P * (N + 1)       // state h_in        [P][N + 1]
         + kPanel * (Q + 1)  // W panel           [32][Q + 1]
         + 3 * Q;            // dt, cum, exp(seg - cum) * dt
}

// Rows [row0, row0 + rows) of a [*, cols] tile (row stride `stride`) into
// shared memory with leading dimension ld; rows past S load as zeros.  Each
// thread starts kLoadBatch loads before it stores any.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t stride,
                                          int rows, int cols, int row0, int S, int tid) {
  const int total = rows * cols;
  for (int e0 = tid; e0 < total; e0 += kLoadBatch * kThreads) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * kThreads, i = e / cols, c = e - i * cols;
      v[u] = e < total && row0 + i < S ? src[(row0 + i) * stride + c] : 0.f;
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
__device__ __forceinline__ void w_panel(const float* sC, const float* sB, float* sW,
                                        const float* sCum, const float* sDt, int LDW, int i0,
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
      sW[r * LDW + j] = i >= j ? acc[k][m] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_f32(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ D, float* __restrict__ y,
            float* __restrict__ final_state, int S, int H, int G, int Q, Strides sx,
            Strides sdt, Strides sb, Strides sc) {
  // y micro-tile: columns p = lane % LP + LP * m (m < PM), rows
  // r = warp * RW + lane / LP + 8 * RW * k (k < RM) of a 32-row panel.
  constexpr int LP = P < 32 ? P : 32, RW = 32 / LP, PM = P / LP, RM = 4 / RW;
  // state micro-tile: columns n = lane % LN + LN * m (m < NM), rows
  // p = warp * RWn + lane / LN + 8 * RWn * k (k < PK).
  constexpr int LN = N < 32 ? N : 32, RWn = 32 / LN, NM = N / LN, PK = P / (8 * RWn);
  constexpr int LDB = N + 1, LDS = N + 1;

  extern __shared__ float smem_f[];
  const int LDW = Q + 1;
  float* sX = smem_f;
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

  const float* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const float* Bb = Bm + b * sb.b + g * sb.h;
  const float* Cb = Cm + b * sc.b + g * sc.h;
  float* yb = y + (static_cast<int64_t>(b) * S * H + h) * P;
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
    if (warp == 0) chunk_cumsum(sDt, sCum, a, Q, lane);
    __syncthreads();
    const float seg = sCum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) sWj[i] = expf(seg - sCum[i]) * sDt[i];

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
          for (int m = 0; m < PM; ++m) inter[k][m] = fmaf(cr[k], hv[m], inter[k][m]);
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
          for (int m = 0; m < PM; ++m) intra[k][m] = fmaf(wr[k], xv[m], intra[k][m]);
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
          yb[t * sy + p] = v + dskip * sX[i * P + p];
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
  if (final_state == nullptr) return;
  float* fin = final_state + (static_cast<int64_t>(b) * H + h) * P * N;
#pragma unroll
  for (int k = 0; k < PK; ++k)
#pragma unroll
    for (int m = 0; m < NM; ++m) fin[(sp + 8 * RWn * k) * N + sn + LN * m] = hs[k][m];
}

template <int P, int N>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int kMaxSmem = smem_floats(kMaxQ, P, N) * 4;
  static_assert(kMaxSmem <= 232448, "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd_f32<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(a.H, a.B);
  ssd_fwd_f32<P, N><<<grid, kThreads, smem_floats(a.Q, P, N) * 4, stream>>>(
      static_cast<const float*>(a.x), a.dt, a.A, static_cast<const float*>(a.Bm),
      static_cast<const float*>(a.Cm), a.D, static_cast<float*>(a.y), a.final_state, a.S, a.H,
      a.G, a.Q, a.sx, a.sdt, a.sb, a.sc);
  return static_cast<int>(cudaGetLastError());
}

// ========================================================== entry points

using Launch = int (*)(const Args&, cudaStream_t);

bool head_dim(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

template <int P>
Launch f32_for(int N) {
  switch (N) {
    case 16: return launch_f32<P, 16>;
    case 32: return launch_f32<P, 32>;
    case 64: return launch_f32<P, 64>;
    case 128: return launch_f32<P, 128>;
    default: return nullptr;
  }
}

template <int Pp, int Np>
Launch wgmma_for(int rows) {
  return rows == 64 ? launch_wgmma<Pp, Np, 64> : rows == 128 ? launch_wgmma<Pp, Np, 128> : nullptr;
}

// The instantiation for (dtype, P, N, tile rows), or nullptr.  Tile rows:
// the chunk rounded up to 64 for bf16; the chunk itself for f32.
Launch find(int dtype, int P, int N, int rows) {
  if (!head_dim(P) || !head_dim(N)) return nullptr;
  if (dtype == 0) {
    if (rows % 32 || rows < 32 || rows > kMaxQ) return nullptr;
    switch (P) {
      case 16: return f32_for<16>(N);
      case 32: return f32_for<32>(N);
      case 64: return f32_for<64>(N);
      default: return f32_for<128>(N);
    }
  }
  if (dtype != 1) return nullptr;
  if (padded(P) == 64)
    return padded(N) == 64 ? wgmma_for<64, 64>(rows) : wgmma_for<64, 128>(rows);
  return padded(N) == 64 ? wgmma_for<128, 64>(rows) : wgmma_for<128, 128>(rows);
}

}  // namespace

// Threads and dynamic shared memory of phase `phase` of the instantiation
// for (dtype, P, N, tile rows): bf16 (dtype 1) has phases 0 chunk state,
// 1 state pass, 2 chunk scan; f32 (dtype 0) one.  cudaErrorInvalidValue if
// there is no such instantiation or phase.
extern "C" int ssd_scan_geometry(int dtype, int P, int N, int rows, int phase, int* threads,
                                 int* smem) {
  if (find(dtype, P, N, rows) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && phase == 0) {
    *threads = kThreads;
    *smem = smem_floats(rows, P, N) * 4;
    return 0;
  }
  const int Pp = padded(P), Np = padded(N);
  switch (dtype == 1 ? phase : -1) {
    case 0: *threads = 128; *smem = chunk_state_smem(Pp, Np, rows); return 0;
    case 1: *threads = kPassThreads; *smem = 0; return 0;
    case 2: *threads = 2 * rows; *smem = chunk_scan_smem(Pp, Np, rows); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype of x, Bm, Cm and y: 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the three tensor-core phases, which take the scratch: cum f32
// [B, H, nc * Q], state f32 and h_in bf16 [B, H, nc, P, N], nc = ceil(S /
// Q)).  final_state: f32 [B, H, P, N], 16-byte aligned, for the state after
// the last step, or null.  rows: the plan's tile rows.  Strides are in elements, for the batch,
// sequence and head (group) axes; the last axis of x, Bm and Cm is
// contiguous.  The wrapper checks the shapes, and for bf16 that x, Bm, Cm
// are 16-byte aligned with strides of a multiple of 16 bytes.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, void* y, void* cum, void* state,
                            void* h_in, void* final_state, int B, int S, int H, int G, int P,
                            int N, int Q,
                            int dtype, int rows, int64_t sxb, int64_t sxs, int64_t sxh,
                            int64_t sdb, int64_t sds, int64_t sdh, int64_t sbb, int64_t sbs,
                            int64_t sbg, int64_t scb, int64_t scs, int64_t scg, void* stream) {
  const Launch launch = find(dtype, P, N, rows);
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, Bm, Cm,
               static_cast<const float*>(dt), static_cast<const float*>(A),
               static_cast<const float*>(D), y,
               static_cast<float*>(cum), static_cast<float*>(state),
               static_cast<__nv_bfloat16*>(h_in), static_cast<float*>(final_state),
               B, S, H, G, P, N, Q,
               {sxb, sxs, sxh}, {sdb, sds, sdh}, {sbb, sbs, sbg}, {scb, scs, scg}};
  return launch(a, static_cast<cudaStream_t>(stream));
}

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
// What bounds it.  Per (b, h, chunk) the scan does Q(Q+1)/2 P
// multiply-adds for the causal triangle of W x and 2 Q P N for C h_in and
// the state update, and per (b, g, chunk) Q(Q+1)/2 N for that of S = C B^T
// (B and C belong to the group), on Q (P + 2N) inputs: at mamba2-130m's
// training shape (x [8, 2048, 24, 64], N = 128, Q = 128) that is 16.4
// GFLOP, 16.6 us at the tensor cores' 989 TFLOP/s or 0.245 ms at the CUDA
// cores' 67 TFLOP/s, against 110.6 MB of bf16 x, dt, B, C and y, 33.0 us
// at 3.35 TB/s (221 MB in f32, 66 us): bf16 is bound by bytes, f32 by
// operations.  The state is a chain across chunks, and the TPU grid walks
// the chunk axis in order; on 132 SMs a chain per (b, h) leaves most of
// the card idle, so every phase but the state pass is chunk-parallel.
//
// Two variants, picked by dtype in the launch plan (kernels/ssd_scan.py
// kernel_plan), which passes the instantiation's tile rows (the chunk
// rounded up to 64); ssd_scan_geometry reports each phase's threads and
// shared memory.
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
// * f32: the same three phases on the CUDA cores in f32 FMAs, which its
//   2e-4 tolerance needs (no TF32, no bf16 operands), 256 threads a block,
//   tiles of f32 rows 16 bytes longer than their width loaded by cp.async
//   (16 bytes a copy; x, Bm, Cm rows 16-byte aligned, dt read through its
//   strides), every product a 64-row tile of 4 x (width / 16) register
//   blocks (cuda_cores.cuh).  A group's heads are split into runs
//   (kernel_plan's "runs", head_runs' rule: as many as fill the card's 132
//   SMs), and a block walks its run's heads in order:
//   1. ssd_fwd_chunk_state_cc, a block per (chunk, run, b): B's rows once;
//      per head cum (written to the scratch) and s_c = (w x)^T B, x's rows
//      scaled in place, the next head's x in flight (ssd_cuda_cores.cuh).
//   2. ssd_fwd_state_pass<float>: as for bf16, h_in handed on in f32 over
//      the chunk's own state, in place.
//   3. ssd_fwd_chunk_scan_cc, a block per (chunk and 64-row query half, 64
//      columns of y where P = 128, run, b): S = C B^T once, into registers;
//      per head y = exp(cum_i) (C h_in^T) + W x + D x, W masked before the
//      exponential and handed through shared memory; x two stages deep, the
//      next head's h_in loaded as soon as C h_in^T has read it.
//   Scratch: cum and the f32 states (100.7 MB at mamba2-130m's training
//   shape), no h_in of its own.
//
// Every phase but the state pass reads its (head or run, batch) pair from
// the grid's y and z, folded past 65,535 (grid_fold.cuh).  The wrapper
// brings every other input of ssd_scan_pallas's domain to these
// instantiations (kernels/ssd_scan.py ssd_decomposed: the chunk, P and N
// padded or sliced).
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (or the error of cudaFuncSetAttribute, or
// the codes kNoEncoder / kEncodeFailed of hopper.cuh) so the Python wrapper
// can raise.

#include "grid_fold.cuh"
#include "ssd_cuda_cores.cuh"

namespace {

struct Strides {
  int64_t b, s, h;
};

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
                    float* __restrict__ cum, float* __restrict__ state, int B, int S, int H,
                    int G, int P, int N, int Q, Strides sdt) {
  constexpr int kXB = Pp / 64, kNB = Np / 64;  // 64-column boxes of x and B
  constexpr uint32_t kBox = QT * 128;          // bytes of a box
  extern __shared__ uint8_t smem[];
  const uint32_t x_s = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* tiles = smem + (x_s - smem_u32(smem));
  const uint32_t b_s = x_s + kXB * kBox, bar = b_s + kNB * kBox;
  float* sDt = reinterpret_cast<float*>(tiles + (kXB + kNB) * kBox + 8);
  float* sCum = sDt + QT;
  float* sW = sCum + QT;

  const int c = blockIdx.x;
  int h, b;
  if (!fold_pair(H, B, h, b)) return;
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

// h and the state handed on as Out: bf16 into h_in, or f32 in place.
__device__ __forceinline__ void put4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

constexpr int kPassWin = 4;  // state pass: chunks a thread has in registers at a time

// h_in[c] = h; h = exp(seg_c) h + s_c, over the chunks in order; then the
// final h into final_state (f32 [B, H, P, N]) unless it is null.  h_in as
// Out: bf16 for the tensor-core chunk scan, or f32 over the chunk's own
// state s_c (h_in == state, in place).  Block (bh, tile): elements
// 4 (tile * 256 + thread) .. + 3 of the [P, N] state of one (b, h).  A
// thread holds kPassWin chunks' s_c and reads the next kPassWin before it
// writes the current ones' slots: a window's loads are in flight while the
// one before is carried, and the in-place form reads each s_c before its
// slot is overwritten.  The bf16 form, whose state nothing writes, reads it
// through the read-only path.
template <class Out>
__global__ void __launch_bounds__(kPassThreads)
ssd_fwd_state_pass(const float* __restrict__ cum, const float* state, Out* h_in,
                   float* __restrict__ final_state, int nc, int Q, int PN) {
  const int e = (blockIdx.y * kPassThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const int64_t bh = blockIdx.x;
  const float* seg = cum + bh * nc * Q + Q - 1;
  const float4* s = reinterpret_cast<const float4*>(state + bh * nc * PN + e);
  Out* out = h_in + bh * nc * PN + e;
  const int step = PN / 4;  // float4s a chunk
  auto load = [&](int c0, float4 (&sc)[kPassWin], float (&dec)[kPassWin]) {
#pragma unroll
    for (int u = 0; u < kPassWin; ++u) {
      const int c = c0 + u < nc ? c0 + u : nc - 1;
      if constexpr (sizeof(Out) == sizeof(float))
        sc[u] = s[c * step];
      else
        sc[u] = __ldg(s + c * step);
      dec[u] = expf(seg[c * Q]);
    }
  };
  float4 hs = make_float4(0.f, 0.f, 0.f, 0.f), sc[kPassWin], nsc[kPassWin];
  float dec[kPassWin], ndec[kPassWin];
  load(0, sc, dec);
  for (int c0 = 0; c0 < nc; c0 += kPassWin) {
    if (c0 + kPassWin < nc) load(c0 + kPassWin, nsc, ndec);
#pragma unroll
    for (int u = 0; u < kPassWin; ++u) {
      if (c0 + u >= nc) break;
      put4(out + static_cast<int64_t>(c0 + u) * PN, hs);
      const float decay = dec[u];
      hs = make_float4(decay * hs.x + sc[u].x, decay * hs.y + sc[u].y, decay * hs.z + sc[u].z,
                       decay * hs.w + sc[u].w);
    }
    if (c0 + kPassWin < nc) {
#pragma unroll
      for (int u = 0; u < kPassWin; ++u) {
        sc[u] = nsc[u];
        dec[u] = ndec[u];
      }
    }
  }
  if (final_state != nullptr) *reinterpret_cast<float4*>(final_state + bh * PN + e) = hs;
}

template <int Pp, int Np, int QT>
__global__ void __launch_bounds__(2 * QT, 1)
ssd_fwd_chunk_scan(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap th,
                   const float* __restrict__ dt, const float* __restrict__ cum,
                   const float* __restrict__ Dv, __nv_bfloat16* __restrict__ y, int B, int S,
                   int H, int G, int P, int N, int Q, Strides sdt) {
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

  const int c = blockIdx.x;
  int h, b;
  if (!fold_pair(H, B, h, b)) return;
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
  int runs, run_len;  // f32: runs of a group's heads, heads a run
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
  const dim3 grid = head_grid(nc, a.H, a.B);
  ssd_fwd_chunk_state<Pp, Np, QT><<<grid, 128, kSmem1, stream>>>(
      tx, tb, a.dt, a.A, a.cum, a.state, a.B, a.S, a.H, a.G, a.P, a.N, a.Q, a.sdt);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int PN = a.P * a.N;
  const dim3 pass_grid(a.B * a.H, (PN / 4 + kPassThreads - 1) / kPassThreads);
  ssd_fwd_state_pass<__nv_bfloat16><<<pass_grid, kPassThreads, 0, stream>>>(
      a.cum, a.state, a.h_in, a.final_state, nc, a.Q, PN);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_fwd_chunk_scan<Pp, Np, QT><<<grid, 2 * QT, kSmem3, stream>>>(
      tx, tb, tc, th, a.dt, a.cum, a.D, static_cast<__nv_bfloat16*>(a.y), a.B, a.S, a.H, a.G,
      a.P, a.N, a.Q, a.sdt);
  return static_cast<int>(cudaGetLastError());
}

// ========================================================= f32: CUDA cores

// y's columns a chunk-scan block computes: P, or 64 of P = 128.
__host__ __device__ constexpr int pt_of(int P) { return P < 64 ? P : 64; }
// The chunk scan's shared memory past C, h_in and x's first stage: B's key
// rows until S is formed, then W's 64 rows and x's second stage.
__host__ __device__ constexpr int scan_cc_late(int PT, int N, int QT) {
  return QT * (N + 4) > 64 * (QT + 4) + QT * (PT + 4) ? QT * (N + 4)
                                                      : 64 * (QT + 4) + QT * (PT + 4);
}
// Floats of the chunk scan's shared memory at tile rows QT: C's 64 query
// rows, h_in's PT rows, x's first stage (QT key rows), the late room, dt
// and cum.  Rows of every tile 16 bytes longer than their width.
__host__ __device__ constexpr int scan_cc_floats(int P, int N, int QT) {
  return 64 * (N + 4) + pt_of(P) * (N + 4) + QT * (pt_of(P) + 4) + scan_cc_late(pt_of(P), N, QT) +
         2 * QT;
}

// 1. The chunk states s_c = (w x)^T B of a run of a group's heads, and cum,
// one block per (chunk, run, b) (ssd_cuda_cores.cuh's chunk_states_run).
template <int P, int N>
__global__ void __launch_bounds__(kCcThreads, 1)
ssd_fwd_chunk_state_cc(const Args a) {
  extern __shared__ __align__(16) float smem_f[];
  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int c = blockIdx.x, run = yr % a.runs, g = yr / a.runs;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  const int nc = gridDim.x, t0 = c * a.Q, QT = a.Q <= 64 ? 64 : 128;
  const int64_t PN = static_cast<int64_t>(P) * N, bh0 = static_cast<int64_t>(b) * a.H;
  const Rows x{static_cast<const float*>(a.x) + b * a.sx.b + t0 * a.sx.s, a.sx.s, a.sx.h};
  const Rows m{static_cast<const float*>(a.Bm) + b * a.sb.b + t0 * a.sb.s + g * a.sb.h, a.sb.s, 0};
  const Rows dt{a.dt + b * a.sdt.b + t0 * a.sdt.s, a.sdt.s, a.sdt.h};
  chunk_states_run<P, N, true>(smem_f, x, m, dt, a.A, a.cum + bh0 * nc * a.Q + t0,
                               static_cast<int64_t>(nc) * a.Q, a.state + (bh0 * nc + c) * PN,
                               nc * PN, h0, nh, min(a.Q, a.S - t0), a.Q, QT);
}

// 3. One 64-row query tile (rows i0 .. i0 + 63 of chunk c, KT = i0 + 64 key
// rows) of y's columns [64 ph, 64 ph + PT), over a run of a group's heads.
// S = C B^T is formed once, into registers (the thread's rows and key
// columns), kept over the run; per head:
//   y = exp(cum_i) (C h_in^T) + W x + D x,
//   W = S exp(cum_i - cum_j) dt_j, masked to j <= i before the exponential,
// W through shared memory (rows i, key columns j).  x by cp.async into two
// stages, the next head's in flight while one is computed; h_in into one
// buffer, the next head's loaded as soon as C h_in^T has read it.
template <int P, int N, int KT>
__device__ __forceinline__ void chunk_scan_cc(const Args& a, float* smem, int c, int i0, int ph,
                                              int g, int h0, int nh, int b) {
  constexpr int PT = pt_of(P), LP = PT + 4, LN = N + 4, LW = KT + 4, JS = KT / 16, JY = PT / 16;
  const int Q = a.Q, S = a.S, QT = Q <= 64 ? 64 : 128, nc = (S + Q - 1) / Q, t0 = c * Q;
  const int rows = min(Q, S - t0);  // the chunk's rows with data
  if (i0 >= rows) return;           // a tile past S: no row of y to write
  const int kv = min(KT, rows);     // key rows with data
  float* sC = smem;
  float* sH = sC + 64 * LN;
  float* sX0 = sH + PT * LN;
  float* late = sX0 + QT * LP;
  float* sB = late;                 // until S is formed
  float* sW = late;                 // then W and x's second stage
  float* sX1 = late + 64 * (QT + 4);
  float* sDt = late + scan_cc_late(PT, N, QT);
  float* sCum = sDt + QT;
  const int tid = threadIdx.x, warp = tid / 32, ty = tid / 16, tx = tid % 16;
  const int64_t bh0 = static_cast<int64_t>(b) * a.H, PN = static_cast<int64_t>(P) * N;
  const float* x = static_cast<const float*>(a.x) + b * a.sx.b + t0 * a.sx.s + 64 * ph;
  const float* dtb = a.dt + b * a.sdt.b + t0 * a.sdt.s;
  auto h_rows = [&](int h) {  // rows [64 ph, 64 ph + PT) of h_in entering chunk c
    const int64_t slot = (bh0 + h) * nc + c;
    return a.state + slot * PN + 64 * ph * N;
  };
  load_rows_async(sC, LN,
                  static_cast<const float*>(a.Cm) + b * a.sc.b + (t0 + i0) * a.sc.s + g * a.sc.h,
                  a.sc.s, 64, min(64, rows - i0), N);
  load_rows_async(sB, LN, static_cast<const float*>(a.Bm) + b * a.sb.b + t0 * a.sb.s + g * a.sb.h,
                  a.sb.s, KT, kv, N);
  cp_async_commit();
  load_rows_async(sX0, LP, x + h0 * a.sx.h, a.sx.s, KT, kv, PT);
  load_rows_async(sH, LN, h_rows(h0), N, PT, PT, N);
  cp_async_commit();
  auto dt_of = [&](int h) { return tid < kv ? dtb[tid * a.sdt.s + h * a.sdt.h] : 0.f; };
  auto cum_of = [&](int h) {
    return tid < KT && tid < Q ? a.cum[(bh0 + h) * nc * Q + t0 + tid] : 0.f;
  };
  float pdt = dt_of(h0), pcum = cum_of(h0);
  cp_async_wait<1>();  // C and B are in
  __syncthreads();
  float sreg[4][JS];   // S [i0 + 4ty + i][tx + 16j]: the group's, kept over the run
  zero_tile(sreg);
  mm_dots(sreg, sC, LN, sB, LN, N);
  __syncthreads();     // B is read: its room takes W and x's second stage
  if (nh > 1) load_rows_async(sX1, LP, x + (h0 + 1) * a.sx.h, a.sx.s, KT, kv, PT);
  cp_async_commit();

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    float* sx = (k & 1) ? sX1 : sX0;
    if (tid < KT) {
      sDt[tid] = pdt;
      sCum[tid] = pcum;
    }
    if (k + 1 < nh) {
      pdt = dt_of(h + 1);
      pcum = cum_of(h + 1);
    }
    cp_async_wait<1>();  // this head's x and h_in are in
    __syncthreads();
    float acc[4][JY];    // y [i0 + 4ty + i][64 ph + tx + 16j]
    zero_tile(acc);
    mm_dots(acc, sC, LN, sH, LN, N);
    __syncthreads();     // h_in is read: the next head's goes in
    if (k + 1 < nh) load_rows_async(sH, LN, h_rows(h + 1), N, PT, PT, N);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, ri = i0 + r;
      const float ci = sCum[ri];
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int cj = tx + 16 * j;
        sW[r * LW + cj] = cj <= ri && ri < rows ? sreg[i][j] * expf(ci - sCum[cj]) * sDt[cj] : 0.f;
      }
      const float e = expf(ci);
#pragma unroll
      for (int j = 0; j < JY; ++j) acc[i][j] *= e;
    }
    __syncthreads();     // W is in
    // y += W x over the key rows this warp's rows see
    mm_rows(acc, sW, LW, sx, LP, 0, min(KT, i0 + 8 * warp + 8));
    const float dskip = a.D[h];
    float* yb = static_cast<float*>(a.y) + ((static_cast<int64_t>(b) * S + t0) * a.H + h) * P +
                64 * ph;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + 4 * ty + i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < JY; ++j) {
        const int p = tx + 16 * j;
        yb[static_cast<int64_t>(r) * a.H * P + p] = acc[i][j] + dskip * sx[r * LP + p];
      }
    }
    __syncthreads();     // x's stage and W are read
    if (k + 2 < nh) load_rows_async(sx, LP, x + (h + 2) * a.sx.h, a.sx.s, KT, kv, PT);
    cp_async_commit();
  }
}

// 3. A block per (chunk, 64-row query half, 64 columns of y where P = 128;
// run of a group's heads; b).
template <int P, int N>
__global__ void __launch_bounds__(kCcThreads, 1)
ssd_fwd_chunk_scan_cc(const Args a) {
  extern __shared__ __align__(16) float smem_f[];
  const int halves = a.Q <= 64 ? 1 : 2, ps = P / pt_of(P);
  const int c = blockIdx.x / (halves * ps), rest = blockIdx.x % (halves * ps);
  const int ih = rest / ps, ph = rest % ps;
  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int run = yr % a.runs, g = yr / a.runs;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  if (ih == 0)
    chunk_scan_cc<P, N, 64>(a, smem_f, c, 0, ph, g, h0, nh, b);
  else
    chunk_scan_cc<P, N, 128>(a, smem_f, c, 64, ph, g, h0, nh, b);
}

template <int P, int N>
int launch_cc(const Args& a, cudaStream_t stream) {
  constexpr int kMax1 = states_cc_floats(P, N, 128) * 4, kMax3 = scan_cc_floats(P, N, 128) * 4;
  static_assert(kMax1 <= 232448 && kMax3 <= 232448,
                "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_fwd_chunk_state_cc<P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMax1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_fwd_chunk_scan_cc<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMax3);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (a.S + a.Q - 1) / a.Q, QT = a.Q <= 64 ? 64 : 128, PN = P * N;
  ssd_fwd_chunk_state_cc<P, N><<<head_grid(nc, a.G * a.runs, a.B), kCcThreads,
                                  states_cc_floats(P, N, QT) * 4, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const dim3 pass_grid(a.B * a.H, (PN / 4 + kPassThreads - 1) / kPassThreads);
  ssd_fwd_state_pass<float><<<pass_grid, kPassThreads, 0, stream>>>(a.cum, a.state, a.state,
                                                                    a.final_state, nc, a.Q, PN);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (QT / 64) * (P / pt_of(P));
  ssd_fwd_chunk_scan_cc<P, N><<<head_grid(nc * tiles, a.G * a.runs, a.B), kCcThreads,
                                 scan_cc_floats(P, N, QT) * 4, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ========================================================== entry points

using Launch = int (*)(const Args&, cudaStream_t);

bool head_dim(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

template <int P>
Launch f32_for(int N) {
  switch (N) {
    case 16: return launch_cc<P, 16>;
    case 32: return launch_cc<P, 32>;
    case 64: return launch_cc<P, 64>;
    case 128: return launch_cc<P, 128>;
    default: return nullptr;
  }
}

template <int Pp, int Np>
Launch wgmma_for(int rows) {
  return rows == 64 ? launch_wgmma<Pp, Np, 64> : rows == 128 ? launch_wgmma<Pp, Np, 128> : nullptr;
}

// The instantiation for (dtype, P, N, tile rows: the chunk rounded up to
// 64), or nullptr.
Launch find(int dtype, int P, int N, int rows) {
  if (!head_dim(P) || !head_dim(N)) return nullptr;
  if (dtype == 0) {
    if (rows != 64 && rows != 128) return nullptr;
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

// Threads and dynamic shared memory of phase `phase` (0 chunk state, 1
// state pass, 2 chunk scan) of the instantiation for (dtype, P, N, tile
// rows).  cudaErrorInvalidValue if there is no such instantiation or phase.
extern "C" int ssd_scan_geometry(int dtype, int P, int N, int rows, int phase, int* threads,
                                 int* smem) {
  if (find(dtype, P, N, rows) == nullptr || phase < 0 || phase > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (phase == 1) {
    *threads = kPassThreads;
    *smem = 0;
    return 0;
  }
  if (dtype == 0) {
    *threads = kCcThreads;
    *smem = (phase == 0 ? states_cc_floats(P, N, rows) : scan_cc_floats(P, N, rows)) * 4;
    return 0;
  }
  const int Pp = padded(P), Np = padded(N);
  *threads = phase == 0 ? 128 : 2 * rows;
  *smem = phase == 0 ? chunk_state_smem(Pp, Np, rows) : chunk_scan_smem(Pp, Np, rows);
  return 0;
}

// dtype of x, Bm, Cm and y: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores).  Scratch: cum f32 [B, H, nc * Q] and state f32 [B, H, nc, P, N]
// (nc = ceil(S / Q)) for both; h_in bf16 [B, H, nc, P, N] for bf16 (f32
// hands h_in on over the state, in place; h_in is null).  final_state: f32
// [B, H, P, N], 16-byte aligned, for the state after the last step, or
// null.  rows: the plan's tile rows; runs: f32's runs of a group's heads
// (kernel_plan's "runs"; bf16 ignores it).  Strides are in elements, for
// the batch, sequence and head (group) axes; the last axis of x, Bm and Cm
// is contiguous.  The wrapper checks the shapes, that x, Bm, Cm are 16-byte
// aligned, and that their strides are multiples of 16 bytes.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, void* y, void* cum, void* state,
                            void* h_in, void* final_state, int B, int S, int H, int G, int P,
                            int N, int Q, int dtype, int rows, int runs, int64_t sxb,
                            int64_t sxs, int64_t sxh, int64_t sdb, int64_t sds, int64_t sdh,
                            int64_t sbb, int64_t sbs, int64_t sbg, int64_t scb, int64_t scs,
                            int64_t scg, void* stream) {
  const Launch launch = find(dtype, P, N, rows);
  if (launch == nullptr || G <= 0 || H % G) return static_cast<int>(cudaErrorInvalidValue);
  const int hpg = H / G;
  if (dtype == 0 && (runs < 1 || runs > hpg)) return static_cast<int>(cudaErrorInvalidValue);
  const int run_len = dtype == 0 ? (hpg + runs - 1) / runs : hpg;
  if (dtype == 0 && (runs - 1) * run_len >= hpg) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, Bm, Cm,
               static_cast<const float*>(dt), static_cast<const float*>(A),
               static_cast<const float*>(D), y,
               static_cast<float*>(cum), static_cast<float*>(state),
               static_cast<__nv_bfloat16*>(h_in), static_cast<float*>(final_state),
               B, S, H, G, P, N, Q,
               {sxb, sxs, sxh}, {sdb, sds, sdh}, {sbb, sbs, sbg}, {scb, scs, scg},
               runs, run_len};
  return launch(a, static_cast<cudaStream_t>(stream));
}

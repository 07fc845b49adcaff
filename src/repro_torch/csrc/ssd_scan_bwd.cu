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
// is head-free: the f32 dx / dS launch forms S^T once a run; the bf16 one
// forms it again for every head of a run.
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
// * f32 (variant "cuda_cores"): the same structure on the CUDA cores in
//   f32 FMAs (no TF32), 256-thread blocks of 64-row f32 tiles loaded by
//   cp.async (rows 16 bytes longer than their width), every product a
//   64-row tile of 4 x (width / 16) register blocks (cuda_cores.cuh); the
//   same head runs as bf16, each block walking its run in order with the
//   next head's tiles in flight (two stages where they fit at 128-row
//   tiles, else one):
//   1. ssd_bwd_states_cc, two blocks per (chunk, run, b): cum and each
//      head's own state, or its state gradient (ssd_cuda_cores.cuh).
//   2. ssd_bwd_chain<float>: h and G handed on in f32, in place.
//   3. ssd_bwd_dx_ds_cc, a block per (chunk, 64-row key block, run, b):
//      S^T = B C^T once, kept in registers over the run; per head R^T,
//      B G^T (dw), M^T through shared memory for dx's product, dS^T summed
//      over the run's heads in f32 registers (written once, f32), the row
//      and column sums dcum needs, dx, dD's part.
//   4. ssd_bwd_db_dc_cc, a block per (chunk, dB or dC, 64-row block, run,
//      b): the state terms stacked along K in one accumulator, then
//      + dS^T C or + dS B; exp(cum_i) C_i . (dy_i h) of each head.
//   5. ssd_bwd_dcum, 6. ssd_bwd_reduce_runs<float>: as below.
//   Scratch: as bf16's, dS in f32; 219.3 MB at the training shape, no
//   [B, S, H, N] tensor.
// Both variants end with
//   5. ssd_bwd_dcum, a block per (chunk, h, b): dcum, its reverse cumsum
//      by one warp, ddt, and the chunk's part of dA;
//   6. ssd_bwd_reduce_runs<Out>: dA and dD sum their parts
//      over batch and chunks in order, in f64 (a batch of thousands adds
//      thousands of parts a lane); where the heads are split into runs,
//      dBm and dCm sum the runs' parts in order.
// No atomics: every sum runs in a fixed order, so the same inputs give
// bitwise the same gradients.  Rows past S load as zeros with dt = 0
// (identity steps, as the forward pads) and get no gradient written.
// Every launch but the chain and the reduction reads its (head or run,
// batch) pair from the grid's y and z, folded past 65,535 (grid_fold.cuh);
// the wrapper brings every other input of the forward's domain to these
// instantiations (kernels/ssd_scan.py ssd_bwd_decomposed).
//
// The C entry point returns cudaGetLastError() after each launch (or the
// error of cudaFuncSetAttribute, or hopper.cuh's kNoEncoder /
// kEncodeFailed), so the Python wrapper can raise.

#include "grid_fold.cuh"
#include "ssd_cuda_cores.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // dcum: threads a block
constexpr int kPassThreads = 256;  // reductions
constexpr int kChain = 256;        // state chain: threads a block, 4 elements each
constexpr int kWin = 8;            // state chain: chunks a thread loads before it computes
constexpr int kMaxQ = 128;         // the longest chunk
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may have

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

// What the dcum launch reads and writes: per (b, h) [B, H, nc Q] rows of
// cum, the column sums of S L R (colt) and dw; the row sums of M R, as
// row_parts arrays row_stride apart, plus erow where the wgmma path gives
// exp(cum) C . (dy h) apart (null on the CUDA cores, whose rows hold it);
// <G, h> of each chunk in dot_parts parts [B, H, nc, dot_parts].
struct Dcum {
  const float *dt, *A, *cum, *colt, *dw, *rows, *erow, *dots;
  float *ddt, *dap;
  int64_t row_stride;
  int row_parts, dot_parts, B, S, H, Q;
};

// 5. Per (chunk, h, b), thread i of row i: dcum, da its reverse cumsum, ddt
// and the chunk's part of dA = sum dt da.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcum(Dcum a) {
  __shared__ float sDc[kMaxQ], sDa[kMaxQ], red[kThreads / 32];
  const int c = blockIdx.x;
  int h, b;
  if (!fold_pair(a.H, a.B, h, b)) return;
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

// ====================================================== bf16: wgmma and TMA

constexpr int kRowsBox = 32;       // rows of a TMA box of x, dy, Bm, Cm
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

  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int c = blockIdx.x, run = yr % a.runs, g = yr / a.runs;
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
  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int run = yr % a.runs, g = yr / a.runs;
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
  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int run = yr % a.runs, g = yr / a.runs;
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

// What the last launch reads and writes (both variants).
struct Reduce {
  const float *dap, *ddp;  // dA parts [B, H, nc]; dD parts [B, H, nc, dd_parts]
  const float* bc_runs;    // dB, dC of each run [2, runs, B, S, G, N]
  void *dBm, *dCm;         // Out [B, S, G, N]
  float *dA, *dD;
  int B, S, H, G, N, nc, runs, dd_parts;
};

// 6. blockIdx.y 0: dA and dD, a warp a head, their parts over batch and
// chunks summed in f64 by each lane over a fixed stride, then over the
// lanes in a fixed tree; blockIdx.y 1 (heads split into runs): dBm and dCm as Out, 4
// elements a thread, each the sum of the runs' parts in order.
template <class Out>
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_reduce_runs(const Reduce a) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (blockIdx.y == 0) {
    const int head = static_cast<int>(e / 32), lane = threadIdx.x % 32;
    if (head >= a.H) return;
    // in f64: a lane adds B nc / 32 parts in order, thousands where the
    // batch is large, which f32 would round in every step
    const int64_t nd = static_cast<int64_t>(a.nc) * a.dd_parts;
    double sa = 0.0, sd = 0.0;
    for (int64_t k = lane; k < static_cast<int64_t>(a.B) * a.nc; k += 32)
      sa += a.dap[(k / a.nc * a.H + head) * a.nc + k % a.nc];
    for (int64_t k = lane; k < a.B * nd; k += 32)
      sd += a.ddp[(k / nd * a.H + head) * nd + k % nd];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sd += __shfl_xor_sync(0xffffffffu, sd, o);
    }
    if (lane == 0) {
      a.dA[head] = static_cast<float>(sa);
      a.dD[head] = static_cast<float>(sd);
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
  put4(static_cast<Out*>(a.dBm) + 4 * e, sb);
  put4(static_cast<Out*>(a.dCm) + 4 * e, sc);
}

// The reduction's launch: a warp a head, and with more than one run a
// thread per 4 elements of [B, S, G, N].
template <class Out>
int launch_reduce(const Reduce& r, cudaStream_t stream) {
  const int64_t quads = r.runs > 1 ? static_cast<int64_t>(r.B) * r.S * r.G * r.N / 4 : 0;
  const int64_t run_blocks = (quads + kPassThreads - 1) / kPassThreads;
  const int64_t head_blocks = (r.H + kPassThreads / 32 - 1) / (kPassThreads / 32);
  const int64_t blocks = run_blocks > head_blocks ? run_blocks : head_blocks;
  ssd_bwd_reduce_runs<Out><<<dim3(static_cast<unsigned>(blocks), r.runs > 1 ? 2 : 1),
                             kPassThreads, 0, stream>>>(r);
  return static_cast<int>(cudaGetLastError());
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
  const dim3 runs_grid = head_grid(a.nc, a.G * a.runs, a.B);
  ssd_bwd_states_wgmma<Pp, Np, QT><<<runs_grid, 256, kS1, stream>>>(tx, tdy, tb, tc, a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chain<bf16><<<dim3(a.B * a.H, tiles), kChain, 0, stream>>>(a.state, a.grad, a.cum,
                                                                     a.dots, a.nc, a.Q, a.P, a.N);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dx_ds_wgmma<Pp, Np, QT, WGS><<<head_grid(a.nc * jbs, a.G * a.runs, a.B), 128 * WGS, kS3,
                                          stream>>>(tx, tdy, tb, tc, tg, a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_db_dc_wgmma<Pp, Np, QT><<<head_grid(2 * a.nc, a.G * a.runs, a.B), 2 * QT, kS4, stream>>>(
      tx, tdy, tb, tc, th, tg, tds, a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.nc * a.Q;
  const Dcum d{a.dt, a.A, a.cum, a.colt, a.dw, a.rowmr, a.erow, a.dots, a.ddt, a.dap,
               rows, jbs, tiles, a.B, a.S, a.H, a.Q};
  ssd_bwd_dcum<<<head_grid(a.nc, a.H, a.B), kThreads, 0, stream>>>(d);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const Reduce r{a.dap, a.ddp, a.bc_runs, a.dBm, a.dCm, a.dA, a.dD,
                 a.B, a.S, a.H, a.G, a.N, a.nc, a.runs, jbs};
  return launch_reduce<bf16>(r, stream);
}

// ========================================================= f32: CUDA cores

// What the f32 launches share.  Every tensor dense; the scratch as the
// wrapper lists it (kernel_plan_bwd), allocated with torch.empty, in the
// bf16 variant's order but for dS, here f32.
struct CArgs {
  const float *x, *dy, *Bm, *Cm;  // [B, S, H, P], [B, S, G, N]
  const float *dt, *A, *D;        // dt [B, S, H]
  float *dx, *dBm, *dCm, *ddt, *dA, *dD;
  float* cum;                     // [B, H, nc Q]
  float *state, *grad;            // [B, H, nc, P, N]: the chunks' own states and
                                  // state gradients, then h and G in place
  float* dots;                    // <G, h> [B, H, nc, tiles]
  float *colt, *dw, *erow;        // [B, H, nc Q]
  float* rowmr;                   // column sums of M R [key blocks, B, H, nc Q]
  float* ds;                      // dS^T summed over a run's heads [runs, B, nc, G, QT, QT]
  float *dap, *ddp;               // dA parts [B, H, nc]; dD parts [B, H, nc, key blocks]
  float* bc_runs;                 // dB, dC of each run [2, runs, B, S, G, N], or null
  int B, S, H, G, P, N, Q, nc, runs, run_len;
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// dx / dS: a stage holds x's 64 key rows and dy's query rows (up to QT).
__host__ __device__ constexpr int dxds_cc_stage(int P, int QT) { return (64 + QT) * (P + 4); }
// The room after B's key rows and the first stage: C's query rows until
// S^T is formed, then M^T, G (in M^T's own room where kGinM) and, with two
// stages, the second.
__host__ __device__ constexpr int dxds_cc_late(int P, int N, int QT, int stages, bool g_in_m) {
  return imax(QT * (N + 4), (g_in_m ? imax(64 * (QT + 4), P * (N + 4))
                                    : 64 * (QT + 4) + P * (N + 4)) +
                                (stages - 1) * dxds_cc_stage(P, QT));
}
// Floats of dx / dS's shared memory: B's key rows, the first stage, the
// late room, then dt and cum of the tile's rows, w of the key rows, each
// warp's column sums and the block sum's 8 floats.
__host__ __device__ constexpr int dxds_cc_floats(int P, int N, int QT, int stages, bool g_in_m) {
  return 64 * (N + 4) + dxds_cc_stage(P, QT) + dxds_cc_late(P, N, QT, stages, g_in_m) + 2 * QT +
         64 + 8 * QT + 8;
}
// Two stages and G apart where they fit at 128-row tiles, else one stage,
// else G in M^T's room too (P = N = 128).
__host__ __device__ constexpr int dxds_cc_stages(int P, int N) {
  return dxds_cc_floats(P, N, 128, 2, false) * 4 <= kSmemMax ? 2 : 1;
}
__host__ __device__ constexpr bool dxds_cc_g_in_m(int P, int N) {
  return dxds_cc_floats(P, N, 128, 1, false) * 4 > kSmemMax;
}
// dB / dC: a stage holds x's or dy's 64 rows and G or h; after the heads
// the stages' room takes the closing product's tiles, the run's dS^T and
// C's or B's rows.
__host__ __device__ constexpr int dbdc_cc_room(int P, int N, int QT, int stages) {
  return imax(stages * (64 * (P + 4) + P * (N + 4)), QT * 68 + QT * (N + 4));
}
// Floats of dB / dC's shared memory: C's 64 rows (dC's erow), the room,
// the row scale.
__host__ __device__ constexpr int dbdc_cc_floats(int P, int N, int QT, int stages) {
  return 64 * (N + 4) + dbdc_cc_room(P, N, QT, stages) + 64;
}
__host__ __device__ constexpr int dbdc_cc_stages(int P, int N) {
  return dbdc_cc_floats(P, N, 128, 2) * 4 <= kSmemMax ? 2 : 1;
}

// 1. A block per (chunk, side, run, b): cum and each head's own state
// s = (w x)^T B (side 0) or state gradient u = (exp(cum) dy)^T C (side 1),
// f32 [P, N] (ssd_cuda_cores.cuh's chunk_states_run).
template <int P, int N>
__global__ void __launch_bounds__(kCcThreads, 1)
ssd_bwd_states_cc(const CArgs a) {
  extern __shared__ __align__(16) float smem_f[];
  const int c = blockIdx.x >> 1, side = blockIdx.x & 1;
  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int run = yr % a.runs, g = yr / a.runs;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  const int Q = a.Q, nc = a.nc, t0 = c * Q, QT = Q <= 64 ? 64 : 128;
  const int64_t PN = static_cast<int64_t>(P) * N, bh0 = static_cast<int64_t>(b) * a.H;
  const int64_t row0 = static_cast<int64_t>(b) * a.S + t0;  // (b, t0)
  const Rows av{(side ? a.dy : a.x) + row0 * a.H * P, static_cast<int64_t>(a.H) * P, P};
  const Rows m{(side ? a.Cm : a.Bm) + (row0 * a.G + g) * N, static_cast<int64_t>(a.G) * N, 0};
  const Rows dt{a.dt + row0 * a.H, a.H, 1};
  const int rows = min(Q, a.S - t0);
  if (side == 0)
    chunk_states_run<P, N, true>(smem_f, av, m, dt, a.A, a.cum + bh0 * nc * Q + t0,
                                 static_cast<int64_t>(nc) * Q, a.state + (bh0 * nc + c) * PN,
                                 nc * PN, h0, nh, rows, Q, QT);
  else
    chunk_states_run<P, N, false>(smem_f, av, m, dt, a.A, nullptr, 0,
                                  a.grad + (bh0 * nc + c) * PN, nc * PN, h0, nh, rows, Q, QT);
}

// 3. dx and dS^T of one 64-row key block (key rows j0 .. j0 + 63 of chunk
// c, query rows i from j0 on: NI of them) over a run of a group's heads,
// in the transposed orientation (rows j, columns i).  S^T = B C^T once,
// into registers (the thread's rows and columns), kept over the run; per
// head:
//   R^T = x dy^T; B G^T, its rows dotted with x (dw), times w_j;
//   masked before the exponential, L = exp(cum_i - cum_j):
//   M^T = S^T L dt_j through shared memory, dS^T = R^T L dt_j added into
//   the run's sum in registers, the row sums of S L R (colt) and the
//   column sums of M R (this key block's part of them);
//   dx = w (B G^T) + M^T dy + D dy; dD's part.
// x and dy two stages deep where they fit, G in a buffer of its own (or in
// M^T's room) loaded for the next head as soon as it is read.  After the
// run its dS^T goes out as f32 [QT, QT] (rows j of the block, columns
// before j0 zero) for the dB / dC launch.
template <int P, int N, int NI>
__device__ __forceinline__ void dx_ds_cc(const CArgs& a, float* smem, int c, int jb, int run, int g,
                                         int h0, int nh, int b) {
  constexpr int kSt = dxds_cc_stages(P, N);
  constexpr bool kGinM = dxds_cc_g_in_m(P, N);
  constexpr int LP = P + 4, LN = N + 4, LM = NI + 4, JI = NI / 16, JP = P / 16;
  const int Q = a.Q, S = a.S, nc = a.nc, QT = Q <= 64 ? 64 : 128, t0 = c * Q, j0 = 64 * jb;
  const int rows = min(Q, S - t0);
  const int jv = max(0, min(64, rows - j0)), iv = max(0, min(NI, rows - j0));
  const int jbs = QT / 64;
  float* sB = smem;
  float* st0 = sB + 64 * LN;
  float* late = st0 + dxds_cc_stage(P, QT);
  float* sC = late;
  float* sM = late;
  float* sG = kGinM ? late : late + 64 * (QT + 4);
  float* st1 = late + (kGinM ? imax(64 * (QT + 4), P * LN) : 64 * (QT + 4) + P * LN);
  float* sDt = late + dxds_cc_late(P, N, QT, kSt, kGinM);
  float* sCum = sDt + QT;
  float* sW = sCum + QT;
  float* red = sW + 64;
  float* red2 = red + 8 * QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ty = tid / 16, tx = tid % 16;
  const int64_t bh0 = static_cast<int64_t>(b) * a.H, PN = static_cast<int64_t>(P) * N;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0 + j0;  // (b, t0 + j0)
  const int64_t srow = static_cast<int64_t>(a.H) * P, grow = static_cast<int64_t>(a.G) * N;
  const float* xb = a.x + row0 * srow;
  const float* dyb = a.dy + row0 * srow;
  auto load_head = [&](int h, float* st) {
    load_rows_async(st, LP, xb + h * P, srow, 64, jv, P);
    load_rows_async(st + 64 * LP, LP, dyb + h * P, srow, NI, iv, P);
  };
  auto load_g = [&](int h) {
    load_rows_async(sG, LN, a.grad + ((bh0 + h) * nc + c) * PN, N, P, P, N);
  };
  load_rows_async(sB, LN, a.Bm + (row0 * a.G + g) * N, grow, 64, jv, N);
  load_rows_async(sC, LN, a.Cm + (row0 * a.G + g) * N, grow, NI, iv, N);
  cp_async_commit();
  load_head(h0, st0);
  cp_async_commit();
  auto dt_of = [&](int h) {
    return tid < rows ? a.dt[(static_cast<int64_t>(b) * S + t0 + tid) * a.H + h] : 0.f;
  };
  auto cum_of = [&](int h) { return tid < Q ? a.cum[(bh0 + h) * nc * Q + t0 + tid] : 0.f; };
  float pdt = dt_of(h0), pcum = cum_of(h0);
  cp_async_wait<1>();  // B and C are in
  __syncthreads();
  float sT[4][JI];     // S^T [j0 + 4ty + i][j0 + tx + 16j]: the group's, kept over the run
  zero_tile(sT);
  mm_dots(sT, sB, LN, sC, LN, N);
  __syncthreads();     // C is read: its room takes M^T, G and the second stage
  load_g(h0);
  cp_async_commit();
  if (kSt == 2 && nh > 1) load_head(h0 + 1, st1);
  cp_async_commit();
  float dsum[4][JI];   // the run's dS^T
  zero_tile(dsum);

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    float* sx = kSt == 2 && (k & 1) ? st1 : st0;
    float* sdy = sx + 64 * LP;
    if (tid < QT) {
      sDt[tid] = pdt;
      sCum[tid] = pcum;
    }
    if (k + 1 < nh) {
      pdt = dt_of(h + 1);
      pcum = cum_of(h + 1);
    }
    __syncthreads();
    const float seg = sCum[Q - 1];
    if (tid < 64) sW[tid] = expf(seg - sCum[j0 + tid]) * sDt[j0 + tid];
    cp_async_wait<kSt - 1>();  // this head's x, dy and G are in
    __syncthreads();
    float r[4][JI];      // R^T [j][i]
    zero_tile(r);
    mm_dots(r, sx, LP, sdy, LP, P);
    float acc[4][JP];    // B G^T [j][p], then dx
    zero_tile(acc);
    mm_dots(acc, sB, LN, sG, LN, N);
    __syncthreads();     // G is read
    if (!kGinM) {
      if (k + 1 < nh) load_g(h + 1);
      cp_async_commit();
    }
    const int64_t rows0 = (bh0 + h) * nc * Q + t0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // dw_j = x_j . (G B_j), then w_j (B G^T)_j
      const int jl = 4 * ty + i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < JP; ++j) part += acc[i][j] * sx[jl * LP + tx + 16 * j];
      part = row_sum16(part);
      if (tx == 0 && j0 + jl < Q) a.dw[rows0 + j0 + jl] = part;
      const float w = sW[jl];
#pragma unroll
      for (int j = 0; j < JP; ++j) acc[i][j] *= w;
    }
    float colp[JI];
#pragma unroll
    for (int j = 0; j < JI; ++j) colp[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jr = j0 + 4 * ty + i;
      const float cj = sCum[jr], dtj = sDt[jr];
      float ct = 0.f;
#pragma unroll
      for (int j = 0; j < JI; ++j) {
        const int ir = j0 + tx + 16 * j;
        float m = 0.f;
        if (jr <= ir && ir < Q) {  // masked before the exponential
          const float L = expf(sCum[ir] - cj), sl = sT[i][j] * L, rv = r[i][j];
          m = sl * dtj;
          dsum[i][j] += rv * L * dtj;
          ct += sl * rv;
          colp[j] += m * rv;
        }
        sM[(4 * ty + i) * LM + tx + 16 * j] = m;
      }
      ct = row_sum16(ct);
      if (tx == 0 && jr < Q) a.colt[rows0 + jr] = ct;
    }
#pragma unroll
    for (int j = 0; j < JI; ++j) {
      const float v = colp[j] + __shfl_xor_sync(0xffffffffu, colp[j], 16);
      if (lane < 16) red[warp * QT + tx + 16 * j] = v;
    }
    __syncthreads();     // M^T and the column sums are in
    if (tid < QT) {      // this key block's part of the column sums, zero before j0
      float v = 0.f;
      if (tid >= j0)
        for (int w = 0; w < 8; ++w) v += red[w * QT + tid - j0];
      if (tid < Q) a.rowmr[static_cast<int64_t>(jb) * a.B * a.H * nc * Q + rows0 + tid] = v;
    }
    // dx += M^T dy over the query rows this warp's key rows see
    mm_rows(acc, sM, LM, sdy, LP, 8 * warp, NI);
    if (kGinM) {
      __syncthreads();   // M^T is read: G's room takes the next head's
      if (k + 1 < nh) load_g(h + 1);
      cp_async_commit();
    }
    const float dskip = a.D[h];
    float dd = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jl = 4 * ty + i, t = t0 + j0 + jl;
      if (j0 + jl >= Q || t >= S) continue;
      float* dxr = a.dx + (static_cast<int64_t>(b) * S + t) * srow + static_cast<int64_t>(h) * P;
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const int p = tx + 16 * j;
        const float dyv = sdy[jl * LP + p];
        dxr[p] = acc[i][j] + dskip * dyv;
        dd += dyv * sx[jl * LP + p];
      }
    }
    dd = block_sum(dd, red2, kCcThreads, warp, lane, tid);  // syncs: the stage is free
    if (tid == 0) a.ddp[((bh0 + h) * nc + c) * jbs + jb] = dd;
    if (k + kSt < nh) load_head(h + kSt, sx);
    cp_async_commit();
  }

  float* out = a.ds + (((static_cast<int64_t>(run) * a.B + b) * nc + c) * a.G + g) * QT * QT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JI; ++j) out[(j0 + 4 * ty + i) * QT + j0 + tx + 16 * j] = dsum[i][j];
  for (int e = tid; e < 64 * j0; e += kCcThreads) out[(j0 + e / j0) * QT + e % j0] = 0.f;
}

// 3. A block per (chunk and its 64-row key block, run, b).
template <int P, int N>
__global__ void __launch_bounds__(kCcThreads, 1)
ssd_bwd_dx_ds_cc(const CArgs a) {
  extern __shared__ __align__(16) float smem_f[];
  const int jbs = a.Q <= 64 ? 1 : 2, c = blockIdx.x / jbs, jb = blockIdx.x % jbs;
  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int run = yr % a.runs, g = yr / a.runs;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  if (jbs == 2 && jb == 0)
    dx_ds_cc<P, N, 128>(a, smem_f, c, jb, run, g, h0, nh, b);
  else
    dx_ds_cc<P, N, 64>(a, smem_f, c, jb, run, g, h0, nh, b);
}

// 4. dB (side 0) or dC (side 1) of 64 rows (r0 .. r0 + 63 of chunk c) over
// a run of a group's heads, one accumulator kept over the run: the state
// terms stacked along K, sum_h (w_h x_h) G_h for dB and
// sum_h (exp(cum_h) dy_h) h_h for dC, the rows of x or dy scaled in place;
// dC's rows also give exp(cum_i) C_i . (dy_i h) of each head (erow, for
// dcum) from the head's own product before it joins the sum.  Then
// + dS^T C (dB: the run's dS^T rows j, columns i >= r0) or + dS B (dC: its
// columns i of the block, rows j up to them), both from the scratch dx / dS
// wrote; stored, or as the run's part where the heads are split into runs.
template <int P, int N>
__global__ void __launch_bounds__(kCcThreads, 1)
ssd_bwd_db_dc_cc(const CArgs a) {
  constexpr int kSt = dbdc_cc_stages(P, N), LP = P + 4, LN = N + 4, JN = N / 16;
  extern __shared__ __align__(16) float smem_f[];
  const int Q = a.Q, S = a.S, nc = a.nc, QT = Q <= 64 ? 64 : 128, rbs = QT / 64;
  const int c = blockIdx.x / (2 * rbs), side = (blockIdx.x / rbs) & 1, rb = blockIdx.x % rbs;
  int yr, b;
  if (!fold_pair(a.G * a.runs, a.B, yr, b)) return;
  const int run = yr % a.runs, g = yr / a.runs;
  const int hpg = a.H / a.G, h0 = g * hpg + run * a.run_len;
  const int nh = min(a.run_len, hpg - run * a.run_len);
  const int t0 = c * Q, r0 = 64 * rb, rows = min(Q, S - t0), rv = max(0, min(64, rows - r0));
  const int tid = threadIdx.x, warp = tid / 32, ty = tid / 16, tx = tid % 16;
  const int stage = 64 * LP + P * LN;
  float* sCi = smem_f;
  float* room = sCi + 64 * LN;
  float* sScale = room + dbdc_cc_room(P, N, QT, kSt);
  const int64_t bh0 = static_cast<int64_t>(b) * a.H, PN = static_cast<int64_t>(P) * N;
  const int64_t srow = static_cast<int64_t>(a.H) * P, grow = static_cast<int64_t>(a.G) * N;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;  // (b, t0)
  const float* ab = (side ? a.dy : a.x) + (row0 + r0) * srow;
  const float* hg = side ? a.state : a.grad;  // h entering the chunk, or G leaving it
  auto load_head = [&](int h, float* st) {
    load_rows_async(st, LP, ab + h * P, srow, 64, rv, P);
    load_rows_async(st + 64 * LP, LN, hg + ((bh0 + h) * nc + c) * PN, N, P, P, N);
  };
  if (side) load_rows_async(sCi, LN, a.Cm + ((row0 + r0) * a.G + g) * N, grow, 64, rv, N);
  load_head(h0, room);
  cp_async_commit();
  if (kSt == 2 && nh > 1) load_head(h0 + 1, room + stage);
  cp_async_commit();
  auto scale_of = [&](int h) {  // w_j (dB) or exp(cum_i) (dC) of row r0 + tid
    const int r = r0 + tid;
    if (tid >= 64 || r >= Q) return 0.f;
    const float* cm = a.cum + (bh0 + h) * nc * Q + t0;
    if (side) return expf(cm[r]);
    const float dt = r < rows ? a.dt[(row0 + r) * a.H + h] : 0.f;
    return expf(cm[Q - 1] - cm[r]) * dt;
  };
  float pv = scale_of(h0);
  float acc[4][JN];
  zero_tile(acc);

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    float* st = room + (kSt == 2 && (k & 1) ? stage : 0);
    if (tid < 64) sScale[tid] = pv;
    if (k + 1 < nh) pv = scale_of(h + 1);
    cp_async_wait<kSt - 1>();  // this head's rows and state are in
    __syncthreads();
    for (int e = tid; e < 16 * P; e += kCcThreads) {  // 64 rows of P / 4 float4s
      const int r = e / (P / 4), c4 = (e - r * (P / 4)) * 4;
      float4* v = reinterpret_cast<float4*>(st + r * LP + c4);
      const float f = sScale[r];
      *v = make_float4(v->x * f, v->y * f, v->z * f, v->w * f);
    }
    __syncthreads();
    if (side == 0) {
      mm_rows(acc, st, LP, st + 64 * LP, LN, 0, P);
    } else {
      float hacc[4][JN];
      zero_tile(hacc);
      mm_rows(hacc, st, LP, st + 64 * LP, LN, 0, P);
      const int64_t rows0 = (bh0 + h) * nc * Q + t0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          v += hacc[i][j] * sCi[(4 * ty + i) * LN + tx + 16 * j];
          acc[i][j] += hacc[i][j];
        }
        v = row_sum16(v);
        const int r = r0 + 4 * ty + i;
        if (tx == 0 && r < Q) a.erow[rows0 + r] = v;
      }
    }
    __syncthreads();  // the stage is free
    if (k + kSt < nh) load_head(h + kSt, st);
    cp_async_commit();
  }

  // the run's dS^T and the group's rows into the stages' room
  const float* ds = a.ds + (((static_cast<int64_t>(run) * a.B + b) * nc + c) * a.G + g) * QT * QT;
  cp_async_wait<0>();
  if (side == 0) {  // + dS^T C: rows j, columns i >= r0
    const int ni = QT - r0;
    load_rows_async(room, ni + 4, ds + r0 * QT + r0, QT, 64, 64, ni);
    load_rows_async(room + 64 * (QT + 4), LN, a.Cm + ((row0 + r0) * a.G + g) * N, grow, ni,
                    max(0, min(ni, rows - r0)), N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mm_rows(acc, room, ni + 4, room + 64 * (QT + 4), LN, 8 * warp, ni);
  } else {          // + dS B: rows i of the block, key rows j < r0 + 64
    const int kend = r0 + 64;
    load_rows_async(room, 68, ds + r0, QT, kend, kend, 64);
    load_rows_async(room + QT * 68, LN, a.Bm + (row0 * a.G + g) * N, grow, kend,
                    max(0, min(kend, rows)), N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mm_cols(acc, room, 68, room + QT * 68, LN, 0, min(kend, r0 + 8 * warp + 8));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i, t = t0 + r;
    if (r >= Q || t >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + t) * a.G + g) * N;
    float* o = a.bc_runs == nullptr
                   ? (side ? a.dCm : a.dBm) + row
                   : a.bc_runs + (static_cast<int64_t>(side) * a.runs + run) * a.B * S * grow + row;
#pragma unroll
    for (int j = 0; j < JN; ++j) o[tx + 16 * j] = acc[i][j];
  }
}

template <int P, int N>
int launch_cc(const CArgs& a, cudaStream_t stream) {
  constexpr int kSt3 = dxds_cc_stages(P, N), kSt4 = dbdc_cc_stages(P, N);
  constexpr bool kGinM = dxds_cc_g_in_m(P, N);
  constexpr int kS1 = states_cc_floats(P, N, 128) * 4;
  constexpr int kS3 = dxds_cc_floats(P, N, 128, kSt3, kGinM) * 4;
  constexpr int kS4 = dbdc_cc_floats(P, N, 128, kSt4) * 4;
  static_assert(kS1 <= kSmemMax && kS3 <= kSmemMax && kS4 <= kSmemMax,
                "shared memory over the 227 KB a block may have");
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_cc<P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kS1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dx_ds_cc<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kS3);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_db_dc_cc<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kS4);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int QT = a.Q <= 64 ? 64 : 128, jbs = QT / 64;
  const int tiles = (P * N + 4 * kChain - 1) / (4 * kChain);
  ssd_bwd_states_cc<P, N><<<head_grid(2 * a.nc, a.G * a.runs, a.B), kCcThreads,
                             states_cc_floats(P, N, QT) * 4, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chain<float><<<dim3(a.B * a.H, tiles), kChain, 0, stream>>>(a.state, a.grad, a.cum,
                                                                      a.dots, a.nc, a.Q, P, N);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dx_ds_cc<P, N><<<head_grid(a.nc * jbs, a.G * a.runs, a.B), kCcThreads,
                            dxds_cc_floats(P, N, QT, kSt3, kGinM) * 4, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_db_dc_cc<P, N><<<head_grid(2 * jbs * a.nc, a.G * a.runs, a.B), kCcThreads,
                            dbdc_cc_floats(P, N, QT, kSt4) * 4, stream>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.nc * a.Q;
  const Dcum d{a.dt, a.A, a.cum, a.colt, a.dw, a.rowmr, a.erow, a.dots, a.ddt, a.dap,
               rows, jbs, tiles, a.B, a.S, a.H, a.Q};
  ssd_bwd_dcum<<<head_grid(a.nc, a.H, a.B), kThreads, 0, stream>>>(d);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const Reduce r{a.dap, a.ddp, a.bc_runs, a.dBm, a.dCm, a.dA, a.dD,
                 a.B, a.S, a.H, a.G, a.N, a.nc, a.runs, jbs};
  return launch_reduce<float>(r, stream);
}

// ========================================================== entry points

using CLaunch = int (*)(const CArgs&, cudaStream_t);
using WLaunch = int (*)(const WArgs&, const void*, const void*, const void*, const void*,
                        cudaStream_t);

bool head_dim(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

template <int P>
CLaunch cc_for(int N) {
  switch (N) {
    case 16: return launch_cc<P, 16>;
    case 32: return launch_cc<P, 32>;
    case 64: return launch_cc<P, 64>;
    case 128: return launch_cc<P, 128>;
    default: return nullptr;
  }
}

CLaunch find_cc(int P, int N) {
  if (!head_dim(P) || !head_dim(N)) return nullptr;
  switch (P) {
    case 16: return cc_for<16>(N);
    case 32: return cc_for<32>(N);
    case 64: return cc_for<64>(N);
    default: return cc_for<128>(N);
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

// Shared memory of the f32 launches at tile rows QT (0 for those with none).
template <int P, int N>
int cc_smem(int phase, int QT) {
  switch (phase) {
    case 0: return states_cc_floats(P, N, QT) * 4;
    case 2: return dxds_cc_floats(P, N, QT, dxds_cc_stages(P, N), dxds_cc_g_in_m(P, N)) * 4;
    case 3: return dbdc_cc_floats(P, N, QT, dbdc_cc_stages(P, N)) * 4;
    default: return 0;
  }
}
template <int P>
int cc_smem_n(int N, int phase, int QT) {
  return N == 16 ? cc_smem<P, 16>(phase, QT)
         : N == 32 ? cc_smem<P, 32>(phase, QT)
         : N == 64 ? cc_smem<P, 64>(phase, QT)
                   : cc_smem<P, 128>(phase, QT);
}

}  // namespace

// Threads and dynamic shared memory of launch `phase` (0..5, in the order
// of the header's lists) of the instantiation for (dtype, P, N, tile rows:
// the chunk rounded up to 64).  cudaErrorInvalidValue if there is none.
extern "C" int ssd_scan_bwd_geometry(int dtype, int P, int N, int rows, int phase, int* threads,
                                     int* smem) {
  if (phase < 0 || phase > 5 || (rows != 64 && rows != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (find_cc(P, N) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int t[6] = {kCcThreads, kChain, kCcThreads, kCcThreads, kThreads, kPassThreads};
    *threads = t[phase];
    *smem = P == 16 ? cc_smem_n<16>(N, phase, rows)
            : P == 32 ? cc_smem_n<32>(N, phase, rows)
            : P == 64 ? cc_smem_n<64>(N, phase, rows)
                      : cc_smem_n<128>(N, phase, rows);
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
// n_scratch pointers in the order of kernel_plan_bwd's "scratch" (11, and
// the runs' dB / dC parts where runs > 1).  runs: the plan's head runs a
// group.  Q: a multiple of 32 up to 128.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
                            void* dA, void* dBm, void* dCm, void* dD, void* const* scratch,
                            int n_scratch, int B, int S, int H, int G, int P, int N, int Q,
                            int dtype, int runs, void* stream) {
  if (Q % 32 || Q < 32 || Q > kMaxQ || G <= 0 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hpg = H / G;
  if (runs < 1 || runs > hpg || n_scratch != (runs > 1 ? 12 : 11))
    return static_cast<int>(cudaErrorInvalidValue);
  const int run_len = (hpg + runs - 1) / runs;
  if ((runs - 1) * run_len >= hpg) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](int k) { return static_cast<float*>(scratch[k]); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const CLaunch fn = find_cc(P, N);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    CArgs a{};
    a.x = static_cast<const float*>(x);
    a.dy = static_cast<const float*>(dy);
    a.Bm = static_cast<const float*>(Bm);
    a.Cm = static_cast<const float*>(Cm);
    a.dt = static_cast<const float*>(dt);
    a.A = static_cast<const float*>(A);
    a.D = static_cast<const float*>(D);
    a.dx = static_cast<float*>(dx);
    a.dBm = static_cast<float*>(dBm);
    a.dCm = static_cast<float*>(dCm);
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
    a.ds = f(8);
    a.dap = f(9);
    a.ddp = f(10);
    a.bc_runs = runs > 1 ? f(11) : nullptr;
    a.B = B, a.S = S, a.H = H, a.G = G, a.P = P, a.N = N, a.Q = Q;
    a.nc = (S + Q - 1) / Q, a.runs = runs, a.run_len = run_len;
    return fn(a, st);
  }
  const WLaunch fn = dtype == 1 ? find_wgmma(P, N, Q <= 64 ? 64 : 128) : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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

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
// 989 TFLOP/s bf16; the bytes take 0.08 ms).  The products belong on wgmma,
// the only way to the tensor cores' full rate, fed by TMA so that no thread
// spends its issue slots on loads, with the elementwise work (exp2, the
// masks, the softcap) kept to what each tile needs.
//
// Three launches, no atomics, so two runs give bitwise the same gradients
// (the recompute of a checkpointed period relies on it):
//
// (a) bwd_delta: delta = rowsum(dO o o) in f32, one warp a row.
// (b) dK, dV over key blocks: grid (key blocks, Hk, B).  A block holds its K
//     and V rows and loops over the query tiles of all Hq / Hk query heads
//     of its group that can see them, so the GQA sum stays in registers.
// (c) dQ over query blocks: grid (query blocks, Hq, B).  A block holds its
//     Q and dO rows and loops over the key tiles its rows can see.  It
//     recomputes S and dP (seven products for five) because the ways to
//     take dQ out of (b) cost more: a deterministic split of dQ over key
//     blocks needs [Sk / 128, Sq, D] f32 of scratch a head (~1 GB written
//     and read at internlm2's shape), and an accumulation ordered by
//     semaphores, as FlashAttention-3's deterministic mode does, is a later
//     design's.
// The loops' bounds skip whole tiles that the causal mask or the window
// hides; tiles are visited heaviest first (key block 0 in (b), the last
// query block in (c), under a causal mask).
//
// Two variants of (b) and (c), picked by dtype in the launch plan
// (kernels/flash_attention.py kernel_plan_bwd):
//
// * bf16: bwd_dkdv_wgmma<D, WG>, bwd_dq_wgmma<D, WG>, on the tensor cores.
//   A block of WG warpgroups (128 threads each) owns 64 * WG rows, 64 a
//   warpgroup: keys in (b), queries in (c).  The entry point takes 128-row
//   blocks (two warpgroups) unless that leaves fewer blocks than the card
//   has SMs, then 64, as the forward's plan does; flash_attention_bwd_blocks
//   reports the choice.
//   - TMA: one thread (no producer warp of its own) loads the block's two
//     tiles once and each tile of the other side (64 rows: Q and dO in (b),
//     K and V in (c)) into a ring of two shared-memory stages, completing
//     on mbarriers, so tile i + 1 is in flight while tile i is computed; an
//     "empty" mbarrier per stage, on which every consumer warp arrives after
//     its last product of the tile, lets the stage be refilled.  The maps
//     are 3-D over [B * H, S, D] with 64-column boxes and the 128-byte
//     swizzle: rows past S (the ragged edges) are zero-filled, never read
//     from the next head; D = 128 loads as two boxes and D = 96 as two with
//     columns 96-127 zero-filled.
//   - Other widths: every D with D % 8 == 0 up to 128 runs.  64, 96 and
//     128 have instantiations of their own; any other D runs the
//     instantiation of its class (kAny: 64 columns for D < 64, 128 for
//     64 < D < 128) with D read at run time, as the forward does: the maps
//     have D columns, so TMA zero-fills the boxes past D; the products over
//     D stop at the first 16-column slice past it; dK, dV and dQ are stored
//     in D columns a row and no more.
//   - (b): S^T = K Q^T and dP^T = V dO^T on wgmma m64n64k16, both operands
//     K-major, as the forward's S = Q K^T, committed as two groups.  P goes
//     to bf16 in registers while dP^T runs (the accumulator's layout is the
//     A fragment of wgmma's register form), dV += P^T dO runs while dS is
//     formed, then dK += dS^T Q: both on wgmma m64n128k16 (n64 at D = 64)
//     with dO and Q MN-major, as the forward's P V reads V.  lse and delta
//     belong to the columns of S^T: each warpgroup's threads bring the next
//     tile's 64 of each from device memory a tile ahead into the
//     warpgroup's own two stages in shared memory (+inf and 0 past Sq, so
//     P is 0 on rows past the edge).
//   - (c): S = Q K^T and dP = dO V^T on wgmma m64n64k16 as two groups, P
//     formed while dP runs, then dQ += dS K on the register form with K
//     MN-major; a thread's two rows' lse and delta stay in registers.
//   - Registers: the compiler would hold every wgmma descriptor of the loop
//     in registers; the tiles' addresses are made opaque each iteration
//     (opaque()), so that dK/dV at D = 128 fits its 2 x 64 accumulators,
//     S^T, dP^T and P in 246 registers without spilling.
//   - Masks by tile: element masks only on tiles that need them (the causal
//     diagonal, the window's edge; in (c) also the ragged key edge: in (b)
//     keys past Sk are the block's own rows, never stored); the softcap's
//     tanh only when softcap > 0 (both as template arguments of the
//     elementwise step, picked by a uniform branch).
//   Shared memory at D = 128 and 128-row blocks: the block's two tiles 64
//   KB, two stages of the other side's two tiles 64 KB, lse and delta 2 KB
//   in (b): ~131 KB, one block an SM.  A first design on wgmma: no producer
//   warp with setmaxnreg; a tile's last product is waited for before the
//   next tile's first is issued.
// * f32: bwd_dkdv_cc<D>, bwd_dq_cc<D>, on the CUDA cores in f32 FMAs
//   (which its 1e-4 tolerance needs).  32 x 32 tiles, 256 threads; the
//   tiles as f32 in shared memory with rows padded by one float; S, dP
//   and dS through shared memory.  Other widths than 64, 96 and 128 run
//   the kAny instantiation of their class, as the bf16 kernels do: tiles
//   loaded zero past D, dot products over D, D columns stored.
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns the first cudaGetLastError() that is not 0 (checked after
// each launch), the error of cudaFuncSetAttribute, or the codes kNoEncoder
// / kEncodeFailed of hopper.cuh.  The mbarrier, TMA and wgmma helpers are in
// hopper.cuh, shared with the forward and ssd_scan.cu.

#include <math.h>

#include "hopper.cuh"

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
  // Whether some pair of keys [k0, k0 + 64) x query rows [q0, q0 + 64)
  // is hidden by the causal mask or the window (the tile needs the element
  // mask); the ragged edges are the caller's.
  __device__ __forceinline__ bool cuts(int q0, int k0) const {
    const int row_lo = q0 + Sk - Sq;
    return (causal && k0 + 63 > row_lo) || (window >= 0 && k0 <= row_lo + 63 - window);
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

// In every kernel below, kAny: the head width is d_run (d_run % 8 == 0,
// d_run <= D), else D.
template <typename T, int D, bool kAny>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
          int rows, int d_run) {
  const int d = kAny ? d_run : D;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * d;
  const T* drow = dout + static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) delta[row] = acc;
}

// ================================================= bf16: TMA + wgmma

constexpr int kTile = 64;  // the other side's rows a tile: queries in (b), keys in (c)

template <int D>
__host__ __device__ constexpr int padded_cols() {
  return D <= 64 ? 64 : 128;  // columns in shared memory (D = 96 pads to 128)
}

// Dynamic shared memory of (b) and (c) with blocks of 64 * kWG rows: 1 KB to
// align the base to the 128-byte swizzle's 1024-byte pattern, the block's
// two tiles, two stages of the other side's two tiles, in (b) each
// warpgroup's two stages of 64 lse and 64 delta (1 KB), and the mbarriers.
template <int D, int kWG>
constexpr int dkdv_smem_bytes() {
  return 1024 + (2 * 64 * kWG + 4 * kTile) * padded_cols<D>() * 2 + 1024 * kWG + 64;
}
template <int D, int kWG>
constexpr int dq_smem_bytes() {
  return 1024 + (2 * 64 * kWG + 4 * kTile) * padded_cols<D>() * 2 + 64;
}

// The 128 threads of warpgroup `wg` wait for each other (named barrier
// 1 + wg; 0 is __syncthreads'), the barrier's id an immediate so that ptxas
// reserves three barriers, not all sixteen.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;" ::: "memory");
}

// Wait until at most N committed groups of wgmma of this warpgroup are
// still running (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A shared-memory address the compiler must treat as new in each loop
// iteration, so that it builds the wgmma descriptors from it where they are
// used instead of holding every descriptor of the loop in registers (which
// spilled dK/dV's accumulators at D = 128).
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
}

// wgmma descriptors into a tile stored as 64-column boxes of `box` bytes
// each (rows x 128 bytes, as TMA writes them).  K-major (the contraction
// runs along a row): columns 16kk..16kk+15 of every row.  MN-major (the
// contraction runs down the rows): rows 16kk..16kk+15 of every box.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, uint32_t box, int kk) {
  return gmma_desc(tile + (kk / 4) * box + (kk % 4) * 32, 16);
}
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, uint32_t box, int kk) {
  return gmma_desc(tile + kk * 16 * 128, box);
}

// acc (64 x 64) = A B^T over d columns (D unless kAny), A the 64 rows at a,
// B the 64 rows at b, both K-major; the 16-column slices past d are zeros.
template <int D, bool kAny>
__device__ __forceinline__ void product_abt(float (&acc)[32], uint32_t a, uint32_t a_box,
                                            uint32_t b, uint32_t b_box, int d) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if (kAny && 16 * kk >= d) break;
    wgmma_ss_n64(acc, k_major(a, a_box, kk), k_major(b, b_box, kk), kk > 0);
  }
}

// acc (64 x padded D) += X B, X (64 x 64) as bf16 A fragments, B the 64 rows
// at b, MN-major.
template <int D>
__device__ __forceinline__ void product_xb(float (&acc)[padded_cols<D>() / 2],
                                           const uint32_t (&x)[16], uint32_t b, uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if constexpr (padded_cols<D>() == 64)
      wgmma_rs_n64(acc, x + 4 * kk, mn_major(b, box, kk));
    else
      wgmma_rs_n128(acc, x + 4 * kk, mn_major(b, box, kk));
  }
}

// A 64 x 64 accumulator as wgmma's A fragments in bf16: slice kk (columns
// 16kk..16kk+15) is the accumulator's blocks 2kk and 2kk + 1 (hopper.cuh).
__device__ __forceinline__ void to_fragments(uint32_t (&x)[16], const float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// The first elementwise step of (b), on S^T while dP^T is computed: P as
// bf16 A fragments into pa, and P times the softcap's factor (P without a
// softcap) into st, for dS.  A thread's rows are keys key0 and key0 + 8; its
// columns, queries q0 + 8j + c_lane (+1), whose lse (log2 units) is
// stats[col].
template <bool kCap, bool kMask>
__device__ __forceinline__ void dkdv_probs(float (&st)[32], uint32_t (&pa)[16],
                                           const float* stats, const Mask& mask, int q0,
                                           int key0, int c_lane, float scale_l2,
                                           float scale_cap, float cap_l2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + c_lane;
    const float2 lse2 = *reinterpret_cast<const float2*>(stats + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * h + c;
        float x, fac = 1.f;
        if constexpr (kCap) {
          const float th = tanhf(st[e] * scale_cap);
          x = cap_l2 * th;
          fac = 1.f - th * th;
        } else {
          x = st[e] * scale_l2;
        }
        p[c] = exp2f(x - (c ? lse2.y : lse2.x));
        if constexpr (kMask) p[c] = mask.ok(q0 + col + c, key0 + 8 * h) ? p[c] : 0.f;
        st[e] = p[c] * fac;
      }
      pa[2 * j + h] = pack_bf16(p[0], p[1]);
    }
  }
}

// The second, on dP^T while dV is computed: dS (without scale) into dpt from
// st (P times the factor) and the columns' delta, stats[64 + col].
__device__ __forceinline__ void dkdv_grads(const float (&st)[32], float (&dpt)[32],
                                           const float* stats, int c_lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dlt2 = *reinterpret_cast<const float2*>(stats + 64 + 8 * j + c_lane);
#pragma unroll
    for (int e = 4 * j; e < 4 * j + 4; ++e) dpt[e] = st[e] * (dpt[e] - (e & 1 ? dlt2.y : dlt2.x));
  }
}

// The first elementwise step of (c), on S while dP is computed: P times the
// softcap's factor (P without a softcap) into sc.  A thread's rows are
// queries row and row + 8 (lse in log2 units in registers); its columns,
// keys col0 + 8j (+1).
template <bool kCap, bool kMask>
__device__ __forceinline__ void dq_probs(float (&sc)[32], const float (&lse_r)[2],
                                         const Mask& mask, int row, int col0, float scale_l2,
                                         float scale_cap, float cap_l2) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    float x, fac = 1.f;
    if constexpr (kCap) {
      const float th = tanhf(sc[e] * scale_cap);
      x = cap_l2 * th;
      fac = 1.f - th * th;
    } else {
      x = sc[e] * scale_l2;
    }
    float p = exp2f(x - lse_r[r]);
    if constexpr (kMask) p = mask.ok(row + 8 * r, col0 + 8 * (e >> 2) + (e & 1)) ? p : 0.f;
    sc[e] = p * fac;
  }
}

// (b) dK, dV: the block owns keys [k0, k0 + 64 * kWG) of kv head (b, hk),
// warpgroup wg the 64 from k0 + 64 wg.
template <int D, int kWG, bool kAny>
__global__ void __launch_bounds__(128 * kWG, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Hq, int Hk,
               int d_run, Mask mask, float softcap, float scale) {
  const int d = kAny ? d_run : D;
  constexpr int kBk = 64 * kWG;
  constexpr int kDp = padded_cols<D>();
  constexpr int kBoxes = kDp / 64;
  constexpr uint32_t kKVBox = kBk * 128;   // bytes of one 64-column box
  constexpr uint32_t kQBox = kTile * 128;
  constexpr uint32_t kQTile = kBoxes * kQBox;
  extern __shared__ uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + kBoxes * kKVBox;
  const uint32_t q_s = v_s + kBoxes * kKVBox;  // stage s at q_s + s * kQTile
  const uint32_t do_s = q_s + 2 * kQTile;
  const uint32_t stats_s = do_s + 2 * kQTile;  // warpgroup w, stage s: 128 floats
  const uint32_t kv_full = stats_s + 1024 * kWG;
  const uint32_t full = kv_full + 8, empty = kv_full + 24;  // [2] each
  float* stats = reinterpret_cast<float*>(smem + (stats_s - base));

  const int hk = blockIdx.y, b = blockIdx.z, group = Hq / Hk;
  const int k0 = blockIdx.x * kBk;  // causal: the first key blocks are the heaviest
  const int kvh = b * Hk + hk;
  int qt_lo, qt_hi;
  mask.query_tiles(k0, kBk, kTile, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo, n_tiles = group * nq;
  // tile i of the loop: query tile qt_lo + i % nq of the group's head i / nq,
  // as a row of the maps' [B * Hq] heads
  auto tile_head = [&](int i) { return b * Hq + hk * group + i / nq; };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, t = tid % 128;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWG);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Tile i's Q and dO into stage i % 2 (thread 0 only).
  auto load_q = [&](int i) {
    const int s = i & 1, qh = tile_head(i), q0 = (qt_lo + i % nq) * kTile;
    mbar_expect_tx(full + 8 * s, 2 * kQTile);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(q_s + s * kQTile + x * kQBox, &tq, full + 8 * s, 64 * x, q0, qh);
      tma_load(do_s + s * kQTile + x * kQBox, &tdo, full + 8 * s, 64 * x, q0, qh);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(kv_full, 2 * kBoxes * kKVBox);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(k_s + x * kKVBox, &tk, kv_full, 64 * x, k0, kvh);
      tma_load(v_s + x * kKVBox, &tv, kv_full, 64 * x, k0, kvh);
    }
    load_q(0);
  }

  // Thread t of a warpgroup carries tile i's lse (t < 64) or delta (t >= 64)
  // of query row t % 64: +inf and 0 past Sq, so P is 0 on those columns.
  const float* stat_src = t < 64 ? lse : delta;
  auto stat = [&](int i) {
    const int qi = (qt_lo + i % nq) * kTile + t % 64;
    return qi < mask.Sq ? stat_src[static_cast<size_t>(tile_head(i)) * mask.Sq + qi]
                        : (t < 64 ? INFINITY : 0.f);
  };
  float next = n_tiles > 0 ? stat(0) : 0.f;

  float acc_dk[kDp / 2], acc_dv[kDp / 2];
#pragma unroll
  for (int e = 0; e < kDp / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const int kw0 = k0 + 64 * wg;                   // this warpgroup's keys
  const int key0 = kw0 + 16 * warp + lane / 4;    // this thread's rows: key0, key0 + 8
  const uint32_t k_wg = k_s + wg * 64 * 128, v_wg = v_s + wg * 64 * 128;

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int q0 = (qt_lo + i % nq) * kTile;
    if (tid == 0 && i + 1 < n_tiles) {
      // tile i - 1 used the stage tile i + 1 goes to: wait until every
      // consumer warp is done with it
      if (i >= 1) mbar_wait(empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
      load_q(i + 1);
    }
    __syncwarp();
    // this tile's lse (log2 units) and delta into the warpgroup's stage s
    // (read two tiles ago), the next tile's on their way from memory
    float* tile_stats = stats + (2 * wg + s) * 128;
    tile_stats[t] = t < 64 ? next * kLog2e : next;
    if (i + 1 < n_tiles) next = stat(i + 1);
    warpgroup_sync(wg);

    // S^T = K Q^T and dP^T = V dO^T: keys are rows, the tile's queries columns
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;  // overwritten (scale-d 0)
    mbar_wait(full + 8 * s, parity);
    __syncwarp();
    const uint32_t q_t = opaque(q_s + s * kQTile), do_t = opaque(do_s + s * kQTile);
    wgmma_fence();
    product_abt<D, kAny>(st, opaque(k_wg), kKVBox, q_t, kQBox, d);
    wgmma_commit();
    product_abt<D, kAny>(dpt, opaque(v_wg), kKVBox, do_t, kQBox, d);
    wgmma_commit();

    // P from S^T while dP^T runs, then dV += P^T dO while dS is formed, then
    // dK += dS^T Q
    wgmma_wait<1>();
    fence_regs(st);
    uint32_t pa[16];
    const bool masked = mask.cuts(q0, kw0);
    if (softcap > 0.f) {
      if (masked)
        dkdv_probs<true, true>(st, pa, tile_stats, mask, q0, key0, c_lane, scale_l2, scale_cap, cap_l2);
      else
        dkdv_probs<true, false>(st, pa, tile_stats, mask, q0, key0, c_lane, scale_l2, scale_cap, cap_l2);
    } else {
      if (masked)
        dkdv_probs<false, true>(st, pa, tile_stats, mask, q0, key0, c_lane, scale_l2, scale_cap, cap_l2);
      else
        dkdv_probs<false, false>(st, pa, tile_stats, mask, q0, key0, c_lane, scale_l2, scale_cap, cap_l2);
    }
    wgmma_fence();
    product_xb<D>(acc_dv, pa, do_t, kQBox);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dpt);
    dkdv_grads(st, dpt, tile_stats, c_lane);
    uint32_t dsa[16];
    to_fragments(dsa, dpt);
    wgmma_fence();
    product_xb<D>(acc_dk, dsa, q_t, kQBox);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= mask.Sk) continue;
    const size_t row = (static_cast<size_t>(kvh) * mask.Sk + key) * d + c_lane;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (kAny && 8 * j >= d) break;  // the row's own d columns only
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j) =
          __floats2bfloat162_rn(acc_dk[4 * j + 2 * r] * scale, acc_dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

// (c) dQ: the block owns query rows [q0, q0 + 64 * kWG) of head (b, h),
// warpgroup wg the 64 from q0 + 64 wg.
template <int D, int kWG, bool kAny>
__global__ void __launch_bounds__(128 * kWG, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int Hq, int Hk, int d_run, Mask mask,
             float softcap, float scale) {
  const int d = kAny ? d_run : D;
  constexpr int kBq = 64 * kWG;
  constexpr int kDp = padded_cols<D>();
  constexpr int kBoxes = kDp / 64;
  constexpr uint32_t kQBox = kBq * 128;   // bytes of one 64-column box
  constexpr uint32_t kKBox = kTile * 128;
  constexpr uint32_t kKTile = kBoxes * kKBox;
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + kBoxes * kQBox;
  const uint32_t k_s = do_s + kBoxes * kQBox;  // stage s at k_s + s * kKTile
  const uint32_t v_s = k_s + 2 * kKTile;
  const uint32_t qd_full = v_s + 2 * kKTile;
  const uint32_t full = qd_full + 8, empty = qd_full + 24;  // [2] each

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;  // heaviest query blocks first
  const int q_rows = min(kBq, mask.Sq - q0);
  const int qh = b * Hq + h, kvh = b * Hk + h / (Hq / Hk);
  int kt_lo, kt_hi;
  mask.key_tiles(q0, q_rows, kTile, &kt_lo, &kt_hi);
  const int n_tiles = kt_hi - kt_lo;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWG);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Key tile i of the loop (K and V) into stage i % 2 (thread 0 only).
  auto load_kv = [&](int i) {
    const int s = i & 1, j0 = (kt_lo + i) * kTile;
    mbar_expect_tx(full + 8 * s, 2 * kKTile);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(k_s + s * kKTile + x * kKBox, &tk, full + 8 * s, 64 * x, j0, kvh);
      tma_load(v_s + s * kKTile + x * kKBox, &tv, full + 8 * s, 64 * x, j0, kvh);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(qd_full, 2 * kBoxes * kQBox);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(q_s + x * kQBox, &tq, qd_full, 64 * x, q0, qh);
      tma_load(do_s + x * kQBox, &tdo, qd_full, 64 * x, q0, qh);
    }
    load_kv(0);
  }

  const int qw0 = q0 + 64 * wg;                  // this warpgroup's rows
  const int row0 = qw0 + 16 * warp + lane / 4;   // this thread's rows: row0, row0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const size_t at = static_cast<size_t>(qh) * mask.Sq + qi;
    lse_r[r] = qi < mask.Sq ? lse[at] * kLog2e : INFINITY;
    delta_r[r] = qi < mask.Sq ? delta[at] : 0.f;
  }
  float acc_dq[kDp / 2];
#pragma unroll
  for (int e = 0; e < kDp / 2; ++e) acc_dq[e] = 0.f;
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const uint32_t q_wg = q_s + wg * 64 * 128, do_wg = do_s + wg * 64 * 128;

  if (n_tiles > 0) mbar_wait(qd_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int j0 = (kt_lo + i) * kTile;
    if (tid == 0 && i + 1 < n_tiles) {
      if (i >= 1) mbar_wait(empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
      load_kv(i + 1);
    }
    __syncwarp();

    // S = Q K^T and dP = dO V^T: the warpgroup's queries are rows, the
    // tile's keys columns
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;  // overwritten (scale-d 0)
    mbar_wait(full + 8 * s, parity);
    __syncwarp();
    const uint32_t k_t = opaque(k_s + s * kKTile);
    wgmma_fence();
    product_abt<D, kAny>(sc, opaque(q_wg), kQBox, k_t, kKBox, d);
    wgmma_commit();
    product_abt<D, kAny>(dp, opaque(do_wg), kQBox, opaque(v_s + s * kKTile), kKBox, d);
    wgmma_commit();

    // P from S while dP runs, then dS
    wgmma_wait<1>();
    fence_regs(sc);
    const bool masked = j0 + kTile > mask.Sk || mask.cuts(qw0, j0);
    if (softcap > 0.f) {
      if (masked)
        dq_probs<true, true>(sc, lse_r, mask, row0, j0 + c_lane, scale_l2, scale_cap, cap_l2);
      else
        dq_probs<true, false>(sc, lse_r, mask, row0, j0 + c_lane, scale_l2, scale_cap, cap_l2);
    } else {
      if (masked)
        dq_probs<false, true>(sc, lse_r, mask, row0, j0 + c_lane, scale_l2, scale_cap, cap_l2);
      else
        dq_probs<false, false>(sc, lse_r, mask, row0, j0 + c_lane, scale_l2, scale_cap, cap_l2);
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = sc[e] * (dp[e] - delta_r[(e >> 1) & 1]);

    // dQ += dS K
    uint32_t dsa[16];
    to_fragments(dsa, dp);
    wgmma_fence();
    product_xb<D>(acc_dq, dsa, k_t, kKBox);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= mask.Sq) continue;
    __nv_bfloat16* out = dq + (static_cast<size_t>(qh) * mask.Sq + qi) * d + c_lane;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (kAny && 8 * j >= d) break;  // the row's own d columns only
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc_dq[4 * j + 2 * r] * scale, acc_dq[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ===================================================== f32: CUDA cores

constexpr int kT = 32;         // rows of either side a tile
constexpr int kCcThreads = 256;

template <int D>
constexpr int cc_smem_bytes() {
  return (4 * kT * (D + 1) + 2 * kT * (kT + 1) + 2 * kT) * 4;
}

// rows [0, kT) of a [rows, d] matrix into shared memory of stride D + 1,
// zeros from row `valid` on and in the columns past d.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int valid, int d) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kCcThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r < valid && c < d ? src[static_cast<size_t>(r) * d + c] : 0.f;
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
template <int D, bool kAny>
__global__ void __launch_bounds__(kCcThreads)
bwd_dkdv_cc(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hk, int d_run,
            Mask mask, float softcap, float scale) {
  const int d = kAny ? d_run : D;
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
  const size_t kv_off = (static_cast<size_t>(b) * Hk + hk) * mask.Sk * d;
  const int jl = threadIdx.x / 8, c0 = threadIdx.x % 8;

  load_tile_f32<D>(ks, k + kv_off + static_cast<size_t>(k0) * d, k_rows, d);
  load_tile_f32<D>(vs, v + kv_off + static_cast<size_t>(k0) * d, k_rows, d);
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
      load_tile_f32<D>(qs, q + (q_off + q0) * d, q_rows, d);
      load_tile_f32<D>(dos, dout + (q_off + q0) * d, q_rows, d);
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
        const float s = cap(dot_rows(ks + jl * ld, qs + il * ld, d) * scale, softcap, &factor);
        const float p = mask.ok(q0 + il, k0 + jl) ? expf(s - lse_s[il]) : 0.f;
        const float dp = dot_rows(vs + jl * ld, dos + il * ld, d);
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
    const size_t row = kv_off + static_cast<size_t>(k0 + jl) * d;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (kAny && 8 * c >= d) break;  // the row's own d columns only
      dk[row + c0 + 8 * c] = acc_dk[c] * scale;
      dv[row + c0 + 8 * c] = acc_dv[c];
    }
  }
}

// (c) dQ: the block owns query rows [q0, q0 + 32) of head (b, h).  Thread
// x: query x / 8 against keys x % 8 + 8c; of dQ, columns x % 8 + 8c.
template <int D, bool kAny>
__global__ void __launch_bounds__(kCcThreads)
bwd_dq_cc(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Hq, int Hk, int d_run, Mask mask, float softcap,
          float scale) {
  const int d = kAny ? d_run : D;
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
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / (Hq / Hk)) * mask.Sk * d;
  const int il = threadIdx.x / 8, c0 = threadIdx.x % 8;

  load_tile_f32<D>(qs, q + q_off * d, q_rows, d);
  load_tile_f32<D>(dos, dout + q_off * d, q_rows, d);
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
    load_tile_f32<D>(ks, k + kv_off + static_cast<size_t>(j0) * d, j_rows, d);
    load_tile_f32<D>(vs, v + kv_off + static_cast<size_t>(j0) * d, j_rows, d);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jl = c0 + 8 * c;
      float factor;
      const float s = cap(dot_rows(qs + il * ld, ks + jl * ld, d) * scale, softcap, &factor);
      const float p = mask.ok(q0 + il, j0 + jl) ? expf(s - lse_i) : 0.f;
      const float dp = dot_rows(dos + il * ld, vs + jl * ld, d);
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
    for (int c = 0; c < D / 8; ++c) {
      if (kAny && 8 * c >= d) break;  // the row's own d columns only
      dq[(q_off + il) * d + c0 + 8 * c] = acc_dq[c] * scale;
    }
  }
}

// =========================================================== launching

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Hq, Hk, d;
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

template <typename T, int D, bool kAny>
int launch_delta(const Args& a) {
  const int rows = a.B * a.Hq * a.mask.Sq;
  bwd_delta<T, D, kAny><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows, a.d);
  return static_cast<int>(cudaGetLastError());
}

// The own rows of a (b) and a (c) block: bf16 takes 128 (two warpgroups)
// unless that leaves fewer blocks than the card's n_sm SMs, then 64; f32
// takes kT.
void block_rows(int dtype, int B, int Hq, int Hk, int Sq, int Sk, int n_sm, int* dkdv,
                int* dq) {
  if (dtype == 0) {
    *dkdv = *dq = kT;
    return;
  }
  *dkdv = B * Hk * ((Sk + 127) / 128) < n_sm ? 64 : 128;
  *dq = B * Hq * ((Sq + 127) / 128) < n_sm ? 64 : 128;
}

// A 3-D map over bf16 [heads, rows, d] (innermost first: d, rows, heads)
// with boxes of 64 columns x box_rows rows x 1 head, 128-byte swizzle, out
// of bounds filled with zeros.
int encode(CUtensorMap* map, const void* ptr, int d, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return encode_bf16(map, ptr, 3, dims, strides, box);
}

// Maps of q and dO with box_q rows, of k and v with box_k rows, all of the
// head width's a.d columns.
int encode_all(const Args& a, int box_q, int box_k, CUtensorMap* tq, CUtensorMap* tk,
               CUtensorMap* tv, CUtensorMap* tdo) {
  int err = encode(tq, a.q, a.d, a.mask.Sq, a.B * a.Hq, box_q);
  if (err == 0) err = encode(tdo, a.dout, a.d, a.mask.Sq, a.B * a.Hq, box_q);
  if (err == 0) err = encode(tk, a.k, a.d, a.mask.Sk, a.B * a.Hk, box_k);
  if (err == 0) err = encode(tv, a.v, a.d, a.mask.Sk, a.B * a.Hk, box_k);
  return err;
}

template <int D, int kWG, bool kAny>
int launch_dkdv(const Args& a) {
  constexpr int kSmem = dkdv_smem_bytes<D, kWG>();
  static bool configured = false;
  int err = allow_smem(bwd_dkdv_wgmma<D, kWG, kAny>, kSmem, &configured);
  CUtensorMap tq, tk, tv, tdo;
  if (err == 0) err = encode_all(a, kTile, 64 * kWG, &tq, &tk, &tv, &tdo);
  if (err != 0) return err;
  bwd_dkdv_wgmma<D, kWG, kAny><<<dim3((a.mask.Sk + 64 * kWG - 1) / (64 * kWG), a.Hk, a.B),
                                 128 * kWG, kSmem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.Hq, a.Hk, a.d, a.mask, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kWG, bool kAny>
int launch_dq(const Args& a) {
  constexpr int kSmem = dq_smem_bytes<D, kWG>();
  static bool configured = false;
  int err = allow_smem(bwd_dq_wgmma<D, kWG, kAny>, kSmem, &configured);
  CUtensorMap tq, tk, tv, tdo;
  if (err == 0) err = encode_all(a, 64 * kWG, kTile, &tq, &tk, &tv, &tdo);
  if (err != 0) return err;
  bwd_dq_wgmma<D, kWG, kAny><<<dim3((a.mask.Sq + 64 * kWG - 1) / (64 * kWG), a.Hq, a.B),
                               128 * kWG, kSmem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), a.Hq, a.Hk, a.d,
      a.mask, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kAny>
int launch_wgmma(const Args& a) {
  int dev = 0, n_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  int dkdv_rows, dq_rows;
  block_rows(1, a.B, a.Hq, a.Hk, a.mask.Sq, a.mask.Sk, n_sm, &dkdv_rows, &dq_rows);
  err = launch_delta<__nv_bfloat16, D, kAny>(a);
  if (err == 0)
    err = dkdv_rows == 64 ? launch_dkdv<D, 1, kAny>(a) : launch_dkdv<D, 2, kAny>(a);
  if (err == 0) err = dq_rows == 64 ? launch_dq<D, 1, kAny>(a) : launch_dq<D, 2, kAny>(a);
  return err;
}

template <int D, bool kAny>
int launch_cc(const Args& a) {
  using T = float;
  constexpr int kSmem = cc_smem_bytes<D>();
  static bool dkdv_ok = false, dq_ok = false;
  int err = launch_delta<T, D, kAny>(a);
  if (err == 0) err = allow_smem(bwd_dkdv_cc<D, kAny>, kSmem, &dkdv_ok);
  if (err == 0) err = allow_smem(bwd_dq_cc<D, kAny>, kSmem, &dq_ok);
  if (err != 0) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  bwd_dkdv_cc<D, kAny><<<dim3((a.mask.Sk + kT - 1) / kT, a.Hk, a.B), kCcThreads, kSmem,
                         a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
                                     static_cast<T*>(a.dv), a.Hq, a.Hk, a.d, a.mask,
                                     a.softcap, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dq_cc<D, kAny><<<dim3((a.mask.Sq + kT - 1) / kT, a.Hq, a.B), kCcThreads, kSmem,
                       a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq),
                                   a.Hq, a.Hk, a.d, a.mask, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

struct Variant {
  int dtype, d, rows, other, threads, smem_dkdv, smem_dq;
  bool any;  // takes every width up to d with d % 8 == 0, not d alone
  int (*launch)(const Args&);
};

// Every instantiation, found by (dtype, D, rows): the launch plan
// (kernels/flash_attention.py kernel_plan_bwd) picks (dtype, D) and, by the
// rule of block_rows, the rows of each kernel's blocks; the other side's
// tile, threads and shared memory are the instantiation's own.  D = 64, 96
// and 128 have their own; every other D with D % 8 == 0 up to 128 takes the
// first `any` row whose width holds it (kernel_width in the plan).
constexpr Variant kVariants[] = {
    {1, 64, 64, kTile, 128, dkdv_smem_bytes<64, 1>(), dq_smem_bytes<64, 1>(), false, launch_wgmma<64, false>},
    {1, 64, 128, kTile, 256, dkdv_smem_bytes<64, 2>(), dq_smem_bytes<64, 2>(), false, launch_wgmma<64, false>},
    {1, 96, 64, kTile, 128, dkdv_smem_bytes<96, 1>(), dq_smem_bytes<96, 1>(), false, launch_wgmma<96, false>},
    {1, 96, 128, kTile, 256, dkdv_smem_bytes<96, 2>(), dq_smem_bytes<96, 2>(), false, launch_wgmma<96, false>},
    {1, 128, 64, kTile, 128, dkdv_smem_bytes<128, 1>(), dq_smem_bytes<128, 1>(), false, launch_wgmma<128, false>},
    {1, 128, 128, kTile, 256, dkdv_smem_bytes<128, 2>(), dq_smem_bytes<128, 2>(), false, launch_wgmma<128, false>},
    {0, 64, kT, kT, kCcThreads, cc_smem_bytes<64>(), cc_smem_bytes<64>(), false, launch_cc<64, false>},
    {0, 96, kT, kT, kCcThreads, cc_smem_bytes<96>(), cc_smem_bytes<96>(), false, launch_cc<96, false>},
    {0, 128, kT, kT, kCcThreads, cc_smem_bytes<128>(), cc_smem_bytes<128>(), false, launch_cc<128, false>},
    {1, 64, 64, kTile, 128, dkdv_smem_bytes<64, 1>(), dq_smem_bytes<64, 1>(), true, launch_wgmma<64, true>},
    {1, 64, 128, kTile, 256, dkdv_smem_bytes<64, 2>(), dq_smem_bytes<64, 2>(), true, launch_wgmma<64, true>},
    {1, 128, 64, kTile, 128, dkdv_smem_bytes<128, 1>(), dq_smem_bytes<128, 1>(), true, launch_wgmma<128, true>},
    {1, 128, 128, kTile, 256, dkdv_smem_bytes<128, 2>(), dq_smem_bytes<128, 2>(), true, launch_wgmma<128, true>},
    {0, 64, kT, kT, kCcThreads, cc_smem_bytes<64>(), cc_smem_bytes<64>(), true, launch_cc<64, true>},
    {0, 128, kT, kT, kCcThreads, cc_smem_bytes<128>(), cc_smem_bytes<128>(), true, launch_cc<128, true>},
};

const Variant* find(int dtype, int D, int rows) {
  if (D < 8 || D > 128 || D % 8 != 0) return nullptr;
  for (const Variant& x : kVariants)
    if (x.dtype == dtype && (x.any ? D <= x.d : D == x.d) && (rows < 0 || x.rows == rows))
      return &x;
  return nullptr;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (TMA + wgmma).
// The other side's rows a tile, threads and the shared memory of (b) and of
// (c) for blocks of `rows` own rows, or cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_geometry(int dtype, int D, int rows, int* other,
                                            int* threads, int* smem_dkdv, int* smem_dq) {
  const Variant* x = find(dtype, D, rows);
  if (x == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *other = x->other;
  *threads = x->threads;
  *smem_dkdv = x->smem_dkdv;
  *smem_dq = x->smem_dq;
  return 0;
}

// The own rows of the (b) and (c) blocks flash_attention_bwd launches for
// these shapes on a card of n_sm SMs (the launch reads its card's count).
extern "C" int flash_attention_bwd_blocks(int B, int Hq, int Hk, int Sq, int Sk, int dtype,
                                          int n_sm, int* dkdv_rows, int* dq_rows) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  block_rows(dtype, B, Hq, Hk, Sq, Sk, n_sm, dkdv_rows, dq_rows);
  return 0;
}

// q, o, dout, dq [B, Hq, Sq, D]; k, v, dk, dv [B, Hk, Sk, D]; lse and the
// scratch delta [B, Hq, Sq] f32.  window < 0: no sliding window.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Hq, int Hk, int Sq, int Sk,
                                   int D, int dtype, int causal, int window, float softcap,
                                   float scale, void* stream) {
  const Variant* x = find(dtype, D, -1);
  if (x == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hk, D,
               Mask{Sq, Sk, causal, window}, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  return x->launch(a);
}

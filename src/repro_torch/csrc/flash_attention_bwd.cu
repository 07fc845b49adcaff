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
// Three launches (more where a kernel's work is shared over blocks whose
// parts a combine launch adds up, below), no atomics, so two runs give
// bitwise the same gradients (the recompute of a checkpointed period
// relies on it):
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
//   (which its 1e-4 tolerance needs; no TF32).  Blocks of 256 threads own
//   64 rows and loop over 64-row tiles of the other side; the building
//   blocks are the forward's (cuda_cores.cuh): cp.async, the other side's
//   tiles two stages deep (tile i + 1 lands while tile i is computed),
//   register-blocked products with each step's loads a step ahead, row
//   strides padded by 4 floats.  What bounds it is the CUDA cores' FMAs
//   (67 TFLOP/s) fed from shared memory, and the grid at short Sq.
//   - (b): S^T and dP^T as 4 x 4 register blocks a thread (keys 4ty..4ty+3,
//     queries tx + 16j); P^T goes through one 64 x 64 shared tile into
//     dV += P^T dO, then dS^T through the same tile into dK += dS^T Q; dK
//     and dV stay in registers (4 keys x D / 16 columns each) over the whole
//     loop.  One __syncthreads a tile (tile in, the last one done); a warp
//     reads only the rows of P^T and dS^T it wrote, so between the products
//     it waits for itself (__syncwarp).  lse and delta of the tile's queries
//     come from device memory into registers while the tile lands.
//   - (c): S and dP as 4 x 4 blocks (queries 4ty.., keys tx + 16j), dS
//     through the shared tile (the warp's own rows) into dQ += dS K, dQ in
//     registers.  When the query blocks would leave SMs idle, the plan
//     (kernel_plan_bwd's dq split) gives each block's keys to up to 16
//     blocks, at least 2 key tiles each, within one wave: each writes its
//     unscaled dQ rows into
//     the caller's f32 scratch (split x B x Hq x Sq x D floats, ~4.3 MB at
//     most as blocks x split <= 132) and a fourth launch, dq_combine, adds
//     them in order (split 0 first) and scales.
//   - The softcap and the element masks are template arguments of the
//     element-wise step (cc_grads), picked per tile by uniform branches.
//   - Blocks are handed out heaviest first across all heads (key block 0
//     in (b), the last query block in (c)).
//   - Shared memory: six 64-row tiles and the 64 x 64 score tile, 215 KB at
//     D = 128 (one block an SM).  Other widths than 64, 96 and 128 run the
//     kAny instantiation of their class, as the bf16 kernels do: tiles
//     loaded zero past D, products to D (S, dP) or to the last 32-column
//     group holding D columns (dK, dV, dQ), D columns stored.
//
// * bf16 widths 136-256: the native kernels (below, by their own header).
// * bf16 widths past 256: bwd_dkdv_wgmma_wide, bwd_dq_wgmma_wide (column
//   slices and the item ring: flash_wide.cuh).  At D = 128 the bf16 dK/dV
//   kernel already holds its two 64 x 128 f32 accumulators, S^T, dP^T and P
//   in 246 registers, so a block owns 64 rows (keys in (b), queries in (c))
//   and one slice of w = 128 columns of dK and dV, or of dQ; the slices go
//   on the grids' x.  S and dP are formed over the whole width in pieces of
//   128 columns (items of two 64 x 128 tiles: K and Q, then V and dO, in
//   (b); Q and K, then dO and V, in (c)), then one item brings the slice's
//   own columns (dO and Q in (b), K in (c)) for the products that give the
//   slice.  So S and dP are formed ceil(D / 128) times each (the plan's
//   "slices"), and the bound stays the function's own count
//   (flash_bwd_work).  Items by TMA through a ring of three stages (97 KB;
//   dK/dV 1 KB more of lse and delta); bwd_delta reads the width at run
//   time.  A (b) block walks every query head of its GQA group.
// * f32 widths past 128: bwd_dkdv_cc_256, bwd_dq_cc_256 (the pieces, the
//   ring and the products are flash_wide.cuh's).  What bounds them is the
//   CUDA cores' 67 TFLOP/s over the function's five products of 2 D
//   operations a pair, which two kernels make seven (S and dP in each) and
//   the two walks of (b) below eight.  What held the column-slice kernels they
//   replace: S and dP formed once a 128-column slice in both kernels (4 x
//   slices + 3 full-width products for seven), every item waited for (two
//   stages), and grids of 40-80 blocks at short prompts, each walking every
//   tile.  The design:
//   - (b) runs as two launches of one kernel, dV then dK: a block owns 64
//     keys and the whole width of one of them (64 x 256 is 64 f32 a thread
//     at 256 threads, as the forward's O; both at once would be 128, too
//     many beside S^T and dP^T), so S^T is formed twice, once a walk, and
//     dP^T once (a 32-key block holding both ran its products on 2 x 4
//     register blocks at 0.19 loads an FMA and lost more than the
//     recompute costs: 25.2 against 22.1 ms at Qwen3-Next's f32 shape on
//     an H100).  The forward's
//     layout with keys for rows: a warp owns 8 keys across the query tile,
//     a thread a 4 x 4 block of S^T and dP^T and 4 keys x 4 columns of each
//     piece; P^T (dV) or dS^T (dK) goes through shared memory to dV +=
//     P^T dO or dK += dS^T Q.  Past 256 columns dK and dV go in ceil(D /
//     256) slices.
//   - The block's own rows (K and V in (b), Q and dO in (c)) are loaded
//     once into shared memory at the whole width up to 256 columns; the
//     other side streams through a ring of four stages of 64 x 64 pieces by
//     cp.async, three items in flight while one is used (a tile: the
//     pieces of S, of dP, then those of the block's outputs).  Past 256
//     columns the own rows come a piece at a time beside the other's.
//   - Short grids: dQ's keys split, and a dK/dV block's query tiles
//     shared, over as many blocks as bring each grid to two waves (the
//     plan's wave_split, at most 16); each share writes its f32 part and
//     dq_combine adds them in order (share 0 first): no atomics, two runs
//     bitwise equal.
//   Shared memory at 256 columns, both kernels: their own two tiles 133 KB,
//   the ring 68 KB, the score tile 17 KB (215 KB); 246 (b) and 240 (c)
//   registers, no spill.
// * Widths off the multiple of 8 run padded (the wrapper pads q, k, v, o
//   and dO with zero columns and slices dq, dk and dv back: zero columns of
//   v and dO give zero columns of dq, dk and dv, and add zeros to dP).
// * Every kernel reads its (batch, head) pair from the grid's y and z,
//   folded where a count passes 65,535 (grid_fold.cuh head_grid).
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns the first cudaGetLastError() that is not 0 (checked after
// each launch), the error of cudaFuncSetAttribute, or the codes kNoEncoder
// / kEncodeFailed of hopper.cuh.  The mbarrier, TMA and wgmma helpers are in
// hopper.cuh, shared with the forward and ssd_scan.cu.

#include <math.h>

#include "cuda_cores.cuh"
#include "flash_wide.cuh"
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
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n_heads,
               int Hq, int Hk, int d_run, Mask mask, float softcap, float scale) {
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

  const int kvh = head_pair();  // b * Hk + hk
  if (kvh >= n_heads) return;
  const int hk = kvh % Hk, b = kvh / Hk, group = Hq / Hk;
  const int k0 = blockIdx.x * kBk;  // causal: the first key blocks are the heaviest
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
             __nv_bfloat16* __restrict__ dq, int n_heads, int Hq, int Hk, int d_run,
             Mask mask, float softcap, float scale) {
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

  const int qh = head_pair();  // b * Hq + h
  if (qh >= n_heads) return;
  const int h = qh % Hq, b = qh / Hq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;  // heaviest query blocks first
  const int q_rows = min(kBq, mask.Sq - q0);
  const int kvh = b * Hk + h / (Hq / Hk);
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
// (the tile loads and products are cuda_cores.cuh's)

// Dynamic shared memory of bwd_dkdv_cc<D> and bwd_dq_cc<D>: six 64-row
// tiles (dK/dV: K, V and two stages of Q and dO; dQ: Q, dO and two stages of
// K and V) and one 64 x 64 score tile (dK/dV: P^T, then dS^T; dQ: dS).
template <int D>
constexpr int cc_smem_bytes() {
  return (6 * cc_tile<D>() + kCcRows * kLdS) * static_cast<int>(sizeof(float));
}

// dS (without the scale) into dp, from a 4 x 4 block's raw products s and
// dp: P = exp2(the capped, scaled s - lse), 0 where the mask hides the
// pair, and dS = P * (the softcap's factor) * (dp - delta), lse in log2
// units.  Element (r, j) pairs query q + q_step * (kT ? j : r) with key
// key + key_step * (kT ? r : j): kT, the block is transposed (rows are
// keys), so lse and delta go by column.  P itself goes to
// p_out[r * kLdS + 16j] unless p_out is null.  kCap and kMask are template
// arguments, so that a tile without a softcap or a mask runs no tanh and no
// comparison.
template <bool kCap, bool kMask, bool kT>
__device__ __forceinline__ void cc_grads(float (&s)[4][4], float (&dp)[4][4],
                                         const float (&lse_l2)[4], const float (&dlt)[4],
                                         const Mask& mask, int q, int q_step, int key,
                                         int key_step, float scale_l2, float scale_cap,
                                         float cap_l2, float* p_out) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = kT ? j : r;  // the query's index into lse and delta
      float x, fac = 1.f;
      if constexpr (kCap) {
        const float th = tanhf(s[r][j] * scale_cap);
        x = cap_l2 * th;
        fac = 1.f - th * th;
      } else {
        x = s[r][j] * scale_l2;
      }
      float p = fast_exp2(x - lse_l2[e]);
      if constexpr (kMask) {
        const int qi = q + q_step * (kT ? j : r), kj = key + key_step * (kT ? r : j);
        p = mask.ok(qi, kj) ? p : 0.f;
      }
      if (p_out != nullptr) p_out[r * kLdS + 16 * j] = p;
      dp[r][j] = p * fac * (dp[r][j] - dlt[e]);
    }
}

// cc_grads with kCap and kMask picked by two uniform branches.
template <bool kT>
__device__ __forceinline__ void cc_grads_any(bool cap, bool masked, float (&s)[4][4],
                                             float (&dp)[4][4], const float (&lse_l2)[4],
                                             const float (&dlt)[4], const Mask& mask, int q,
                                             int q_step, int key, int key_step, float scale_l2,
                                             float scale_cap, float cap_l2, float* p_out) {
  if (cap) {
    if (masked)
      cc_grads<true, true, kT>(s, dp, lse_l2, dlt, mask, q, q_step, key, key_step, scale_l2,
                               scale_cap, cap_l2, p_out);
    else
      cc_grads<true, false, kT>(s, dp, lse_l2, dlt, mask, q, q_step, key, key_step, scale_l2,
                                scale_cap, cap_l2, p_out);
  } else {
    if (masked)
      cc_grads<false, true, kT>(s, dp, lse_l2, dlt, mask, q, q_step, key, key_step, scale_l2,
                                scale_cap, cap_l2, p_out);
    else
      cc_grads<false, false, kT>(s, dp, lse_l2, dlt, mask, q, q_step, key, key_step, scale_l2,
                                 scale_cap, cap_l2, p_out);
  }
}

// (b) dK, dV: the block owns keys [k0, k0 + 64) of kv head (b, hk) and
// loops over the 64-row query tiles of its group's heads that see them, Q
// and dO two stages deep.  Thread (ty, tx): keys 4ty..4ty+3 of S^T and dP^T
// (queries tx + 16j) and of the dK and dV accumulators.
template <int D, bool kAny>
__global__ void __launch_bounds__(kCcThreads, 1)
bwd_dkdv_cc(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int n_heads, int Hq, int Hk,
            int d_run, Mask mask, float softcap, float scale) {
  const int d = kAny ? d_run : D;
  const int width = (d + 31) / 32 * 32;  // the columns acc_rows reads
  constexpr int kTile = cc_tile<D>();
  constexpr int kPairs = D / 16;
  extern __shared__ float4 smem_cc[];
  float* ks = reinterpret_cast<float*>(smem_cc);
  float* vs = ks + kTile;
  float* qs = vs + kTile;        // stage s at qs + s * kTile
  float* dos = qs + 2 * kTile;   // stage s at dos + s * kTile
  float* xs = dos + 2 * kTile;   // P^T, then dS^T: [key][query]

  int rest;
  const int k0 = heavy_first(&rest) * kCcRows;  // causal: the first key blocks are the heaviest
  if (rest >= n_heads) return;                  // rest: the pair b * Hk + hk
  const int hk = rest % Hk, b = rest / Hk, group = Hq / Hk;
  const int k_rows = min(kCcRows, mask.Sk - k0);
  const size_t kv_off = (static_cast<size_t>(b) * Hk + hk) * mask.Sk * d;
  int qt_lo, qt_hi;
  mask.query_tiles(k0, kCcRows, kCcRows, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo, n_tiles = group * nq;
  // tile i of the loop: query tile qt_lo + i % nq of the group's head i / nq,
  // whose rows start at row q_row(i) of the [B * Hq * Sq] rows
  auto q_first = [&](int i) { return (qt_lo + i % nq) * kCcRows; };
  auto q_row = [&](int i) {
    return (static_cast<size_t>(b) * Hq + hk * group + i / nq) * mask.Sq + q_first(i);
  };

  const int lane = threadIdx.x & 31, tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);

  auto load_q = [&](int i, int s) {
    const int rows = min(kCcRows, mask.Sq - q_first(i));
    load_tile_async<D, kAny>(qs + s * kTile, q + q_row(i) * d, rows, d, width);
    load_tile_async<D, kAny>(dos + s * kTile, dout + q_row(i) * d, rows, d, width);
  };
  if (n_tiles > 0) {
    load_tile_async<D, kAny>(ks, k + kv_off + static_cast<size_t>(k0) * d, k_rows, d, width);
    load_tile_async<D, kAny>(vs, v + kv_off + static_cast<size_t>(k0) * d, k_rows, d, width);
    load_q(0, 0);
  }
  cp_async_commit();

  float acc_dk[4][kPairs], acc_dv[4][kPairs];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kPairs; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1, q0 = q_first(i);
    // the lse (log2 units) and delta of this thread's queries q0 + tx + 16j:
    // +inf and 0 past Sq, so P is 0 there
    float lse_c[4], dlt_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = q0 + tx + 16 * j < mask.Sq;
      const size_t at = q_row(i) + tx + 16 * j;
      lse_c[j] = in ? lse[at] * kLog2e : INFINITY;
      dlt_c[j] = in ? delta[at] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every thread is done with tile i - 1 and xs
    if (i + 1 < n_tiles) load_q(i + 1, s ^ 1);  // lands while tile i is computed
    cp_async_commit();
    const float* q_t = qs + s * kTile;
    const float* do_t = dos + s * kTile;

    // S^T = K Q^T and dP^T = V dO^T: keys are rows, the tile's queries columns
    float st[4][4], dpt[4][4];
    dot_rows<D>(st, ks, q_t, ty, tx, d);
    dot_rows<D>(dpt, vs, do_t, ty, tx, d);
    // P^T into xs, dS^T (without the scale) into dpt: rows are keys
    // k0 + 4ty + r, columns queries q0 + tx + 16j
    cc_grads_any<true>(softcap > 0.f, mask.cuts(q0, k0), st, dpt, lse_c, dlt_c, mask,
                       q0 + tx, 16, k0 + 4 * ty, 1, scale_l2, scale_cap, cap_l2,
                       xs + 4 * ty * kLdS + tx);
    // P^T's and dS^T's rows (keys 4ty..4ty+3) are this warp's own where
    // they are written and where they are read: the warp waits for itself
    __syncwarp();
    const int q_end = rows_end(mask.Sq - q0);
    acc_rows<D, kAny>(acc_dv, xs, do_t, ty, tx, d, q_end);  // dV += P^T dO
    __syncwarp();  // the warp is done with P^T
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[(4 * ty + r) * kLdS + tx + 16 * j] = dpt[r][j];
    __syncwarp();  // dS^T is complete
    acc_rows<D, kAny>(acc_dk, xs, q_t, ty, tx, d, q_end);   // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (4 * ty + r >= k_rows) continue;
    const size_t row = kv_off + static_cast<size_t>(k0 + 4 * ty + r) * d;
#pragma unroll
    for (int g = 0; g < D / 32; ++g)
      if (!kAny || 2 * tx + 32 * g < d) {  // the row's own d columns only
        *reinterpret_cast<float2*>(dk + row + 2 * tx + 32 * g) =
            make_float2(acc_dk[r][2 * g] * scale, acc_dk[r][2 * g + 1] * scale);
        *reinterpret_cast<float2*>(dv + row + 2 * tx + 32 * g) =
            make_float2(acc_dv[r][2 * g], acc_dv[r][2 * g + 1]);
      }
  }
}

// (c) dQ: the block owns query rows [q0, q0 + 64) of head (b, h) and loops
// over split sp's share of the 64-key tiles they see, K and V two stages
// deep.  Thread (ty, tx): queries 4ty..4ty+3 of S and dP (keys tx + 16j) and
// of the dQ accumulator.  n_split > 1: the block's sum, without the scale,
// goes to part[sp] and dq_combine adds the splits up in order.
template <int D, bool kAny>
__global__ void __launch_bounds__(kCcThreads, 1)
bwd_dq_cc(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, float* __restrict__ part, int n_heads, int Hq, int Hk,
          int d_run, Mask mask, float softcap, float scale, int n_split) {
  const int d = kAny ? d_run : D;
  const int width = (d + 31) / 32 * 32;  // the columns acc_rows reads
  constexpr int kTile = cc_tile<D>();
  constexpr int kPairs = D / 16;
  extern __shared__ float4 smem_cc[];
  float* qs = reinterpret_cast<float*>(smem_cc);
  float* dos = qs + kTile;
  float* ks = dos + kTile;      // stage s at ks + s * kTile
  float* vs = ks + 2 * kTile;   // stage s at vs + s * kTile
  float* xs = vs + 2 * kTile;   // dS: [query][key]

  int rest;
  const int xi = heavy_first(&rest);  // the last query blocks are the heaviest
  if (rest >= n_heads) return;        // rest: the pair b * Hq + h
  const int q0 = (gridDim.x / n_split - 1 - xi / n_split) * kCcRows, sp = xi % n_split;
  const int h = rest % Hq, b = rest / Hq;
  const int q_rows = min(kCcRows, mask.Sq - q0);
  const size_t q_at = (static_cast<size_t>(b) * Hq + h) * mask.Sq + q0;
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / (Hq / Hk)) * mask.Sk * d;
  int lo, hi;
  mask.key_tiles(q0, q_rows, kCcRows, &lo, &hi);
  const int nk = (mask.Sk + kCcRows - 1) / kCcRows, per = (nk + n_split - 1) / n_split;
  lo = max(lo, sp * per);
  hi = min(hi, (sp + 1) * per);
  const int n_tiles = max(0, hi - lo);

  const int lane = threadIdx.x & 31, tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool in = 4 * ty + r < q_rows;
    lse_r[r] = in ? lse[q_at + 4 * ty + r] * kLog2e : INFINITY;
    delta_r[r] = in ? delta[q_at + 4 * ty + r] : 0.f;
  }

  auto load_kv = [&](int i, int s) {
    const int j0 = (lo + i) * kCcRows, rows = min(kCcRows, mask.Sk - j0);
    const size_t at = kv_off + static_cast<size_t>(j0) * d;
    load_tile_async<D, kAny>(ks + s * kTile, k + at, rows, d, width);
    load_tile_async<D, kAny>(vs + s * kTile, v + at, rows, d, width);
  };
  if (n_tiles > 0) {
    load_tile_async<D, kAny>(qs, q + q_at * d, q_rows, d, width);
    load_tile_async<D, kAny>(dos, dout + q_at * d, q_rows, d, width);
    load_kv(0, 0);
  }
  cp_async_commit();

  float acc[4][kPairs];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kPairs; ++c) acc[r][c] = 0.f;
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1, j0 = (lo + i) * kCcRows;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every thread is done with tile i - 1 and xs
    if (i + 1 < n_tiles) load_kv(i + 1, s ^ 1);  // lands while tile i is computed
    cp_async_commit();
    const float* k_t = ks + s * kTile;

    // S = Q K^T and dP = dO V^T: the block's queries are rows, the tile's
    // keys columns
    float sc[4][4], dp[4][4];
    dot_rows<D>(sc, qs, k_t, ty, tx, d);
    dot_rows<D>(dp, dos, vs + s * kTile, ty, tx, d);
    // dS (without the scale) into xs: rows are queries q0 + 4ty + r, columns
    // keys j0 + tx + 16j
    cc_grads_any<false>(softcap > 0.f, j0 + kCcRows > mask.Sk || mask.cuts(q0, j0), sc, dp,
                        lse_r, delta_r, mask, q0 + 4 * ty, 1, j0 + tx, 16, scale_l2, scale_cap,
                        cap_l2, nullptr);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[(4 * ty + r) * kLdS + tx + 16 * j] = dp[r][j];
    __syncwarp();  // dS's rows 4ty..4ty+3 are this warp's own, written and read
    acc_rows<D, kAny>(acc, xs, k_t, ty, tx, d, rows_end(mask.Sk - j0));  // dQ += dS K
  }

  const size_t rows_all = static_cast<size_t>(n_heads) * mask.Sq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (4 * ty + r >= q_rows) continue;
    const size_t row = q_at + 4 * ty + r;
    float* out = part == nullptr ? dq + row * d
                                 : part + (static_cast<size_t>(sp) * rows_all + row) * d;
    const float f = part == nullptr ? scale : 1.f;
#pragma unroll
    for (int g = 0; g < D / 32; ++g)
      if (!kAny || 2 * tx + 32 * g < d)  // the row's own d columns only
        *reinterpret_cast<float2*>(out + 2 * tx + 32 * g) =
            make_float2(acc[r][2 * g] * f, acc[r][2 * g + 1] * f);
  }
}

// dQ from bwd_dq_cc's key splits: scale * (part[0] + part[1] + ...), added
// in that order so that two runs are bitwise equal; n4 float4s a split.
__global__ void __launch_bounds__(256)
dq_combine(const float* __restrict__ part, float* __restrict__ dq, size_t n4, int n_split,
           float scale) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4* in = reinterpret_cast<const float4*>(part);
  float4 acc = in[i];
  for (int s = 1; s < n_split; ++s) {
    const float4 x = in[static_cast<size_t>(s) * n4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  reinterpret_cast<float4*>(dq)[i] =
      make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
}

// ================================================ widths past 128 columns
// (column slices and the item ring: flash_wide.cuh)

// (b) bf16: one warpgroup owns 64 keys [k0, k0 + 64) of kv head (b, hk) and
// one slice [c0, c0 + 128) of their dK and dV columns, and loops over the
// 64-row query tiles of its group's heads that see them.  A tile is
// n_pieces items of K and Q (S^T = K Q^T over the whole width, wgmma
// m64n64k16), n_pieces of V and dO (dP^T = V dO^T), and one of the slice's
// columns of dO and Q (dV += P^T dO and dK += dS^T Q, m64n128k16 on the
// register form); P and dS are formed in registers before the last item's
// products, as in the narrow kernel.
__global__ void __launch_bounds__(128, 1)
bwd_dkdv_wgmma_wide(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int n_heads, int Hq, int Hk, int d,
                    Mask mask, float softcap, float scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const WideRing ring{base, base + kWideStages * kWideStage};
  // two stages of 64 lse then 64 delta, after the barriers
  float* stats = reinterpret_cast<float*>(smem + (ring.bars + 64 - smem_u32(smem)));

  const int kvh = head_pair();  // b * Hk + hk
  if (kvh >= n_heads) return;
  const int hk = kvh % Hk, b = kvh / Hk, group = Hq / Hk;
  const int n = (d + kSlice - 1) / kSlice, x = blockIdx.x;
  // x = key block * n + slice; causal: the first key blocks are the heaviest
  const int k0 = x / n * 64, c0 = x % n * kSlice;
  int qt_lo, qt_hi;
  mask.query_tiles(k0, 64, kTile, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo, n_tiles = group * nq;
  const int per_tile = 2 * n + 1, n_items = n_tiles * per_tile;
  // tile t of the loop: query tile qt_lo + t % nq of the group's head t / nq
  auto tile_head = [&](int t) { return b * Hq + hk * group + t / nq; };
  auto tile_q0 = [&](int t) { return (qt_lo + t % nq) * kTile; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) ring.init(4);
  __syncthreads();

  // item j: piece p % n of K and Q (p < n), of V and dO (p < 2n), or the
  // slice's dO and Q
  auto load = [&](int j) {
    const int t = j / per_tile, p = j % per_tile, qh = tile_head(t), q0 = tile_q0(t);
    const int c = p < 2 * n ? p % n * kSlice : c0, nb = boxes(d, c);
    mbar_expect_tx(ring.full(j), 2 * nb * kWideBox);
    if (p < 2 * n) {
      tma_tile(ring.a(j), p < n ? &tk : &tv, ring.full(j), nb, c, k0, kvh);
      tma_tile(ring.b(j), p < n ? &tq : &tdo, ring.full(j), nb, c, q0, qh);
    } else {
      tma_tile(ring.a(j), &tdo, ring.full(j), nb, c, q0, qh);
      tma_tile(ring.b(j), &tq, ring.full(j), nb, c, q0, qh);
    }
  };
  if (tid == 0) ring.refill(-1, n_items, load);

  // thread tid carries tile t's lse (tid < 64) or delta (tid >= 64) of query
  // row tid % 64: +inf and 0 past Sq, so P is 0 on those columns
  const float* stat_src = tid < 64 ? lse : delta;
  auto stat = [&](int t) {
    const int qi = tile_q0(t) + tid % 64;
    return qi < mask.Sq ? stat_src[static_cast<size_t>(tile_head(t)) * mask.Sq + qi]
                        : (tid < 64 ? INFINITY : 0.f);
  };
  float next = n_tiles > 0 ? stat(0) : 0.f;

  float acc_dk[kSlice / 2], acc_dv[kSlice / 2];
#pragma unroll
  for (int e = 0; e < kSlice / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
  float st[32], dpt[32];
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's rows: key0, key0 + 8

  for (int i = 0; i < n_items; ++i) {
    const int t = i / per_tile, p = i % per_tile;
    if (tid == 0) ring.refill(i, n_items, load);
    __syncwarp();
    float* tile_stats = stats + (t & 1) * 128;
    if (p == 0) {
      // this tile's lse (log2 units) and delta into stage t % 2 (read two
      // tiles ago), the next tile's on their way from memory
      tile_stats[tid] = tid < 64 ? next * kLog2e : next;
      if (t + 1 < n_tiles) next = stat(t + 1);
      __syncthreads();
    }
    mbar_wait(ring.full(i), ring.parity(i));
    __syncwarp();
    if (p < 2 * n) {
      // S^T (+)= K Q^T, then dP^T (+)= V dO^T, a piece at a time (two
      // branches: an accumulator picked at run time would go to local memory)
      if (p < n)
        piece_item(st, ring, i, min(kSlice, d - p * kSlice), p == 0);
      else
        piece_item(dpt, ring, i, min(kSlice, d - (p - n) * kSlice), p == n);
    } else {
      const int q0 = tile_q0(t);
      uint32_t pa[16];
      const bool masked = mask.cuts(q0, k0);
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
      piece_xb(acc_dv, pa, ring.a(i));  // dV += P^T dO
      wgmma_commit();
      dkdv_grads(st, dpt, tile_stats, c_lane);
      uint32_t dsa[16];
      to_fragments(dsa, dpt);
      wgmma_fence();
      piece_xb(acc_dk, dsa, ring.b(i));  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    ring.release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= mask.Sk) continue;
    const size_t row = (static_cast<size_t>(kvh) * mask.Sk + key) * d + c0 + c_lane;
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      if (c0 + 8 * j >= d) break;  // the row's own d columns only
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j) = __floats2bfloat162_rn(
          acc_dk[4 * j + 2 * r] * scale, acc_dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

// (c) bf16: one warpgroup owns 64 query rows of head (b, h) and one slice of
// 128 dQ columns, and loops over the 64-key tiles they see: n_pieces items
// of Q and K (S), n_pieces of dO and V (dP), and one of the slice's columns
// of K (dQ += dS K).
__global__ void __launch_bounds__(128, 1)
bwd_dq_wgmma_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int n_heads,
                  int Hq, int Hk, int d, Mask mask, float softcap, float scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const WideRing ring{base, base + kWideStages * kWideStage};

  const int qh = head_pair();  // b * Hq + h
  if (qh >= n_heads) return;
  const int h = qh % Hq, b = qh / Hq;
  const int kvh = b * Hk + h / (Hq / Hk);
  const int n = (d + kSlice - 1) / kSlice;
  const int q0 = (gridDim.x / n - 1 - static_cast<int>(blockIdx.x) / n) * 64;  // heaviest first
  const int c0 = static_cast<int>(blockIdx.x) % n * kSlice;
  const int q_rows = min(64, mask.Sq - q0);
  int kt_lo, kt_hi;
  mask.key_tiles(q0, q_rows, kTile, &kt_lo, &kt_hi);  // 64-key tiles
  const int per_tile = 2 * n + 1, n_items = (kt_hi - kt_lo) * per_tile;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) ring.init(4);
  __syncthreads();

  // item j: piece p % n of Q and K (p < n), of dO and V (p < 2n), or the
  // slice's columns of K
  auto load = [&](int j) {
    const int p = j % per_tile, j0 = (kt_lo + j / per_tile) * kTile;
    const int c = p < 2 * n ? p % n * kSlice : c0, nb = boxes(d, c);
    if (p < 2 * n) {
      mbar_expect_tx(ring.full(j), 2 * nb * kWideBox);
      tma_tile(ring.a(j), p < n ? &tq : &tdo, ring.full(j), nb, c, q0, qh);
      tma_tile(ring.b(j), p < n ? &tk : &tv, ring.full(j), nb, c, j0, kvh);
    } else {
      mbar_expect_tx(ring.full(j), nb * kWideBox);
      tma_tile(ring.b(j), &tk, ring.full(j), nb, c, j0, kvh);
    }
  };
  if (tid == 0) ring.refill(-1, n_items, load);

  const int row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const size_t at = static_cast<size_t>(qh) * mask.Sq + qi;
    lse_r[r] = qi < mask.Sq ? lse[at] * kLog2e : INFINITY;
    delta_r[r] = qi < mask.Sq ? delta[at] : 0.f;
  }
  float acc_dq[kSlice / 2];
#pragma unroll
  for (int e = 0; e < kSlice / 2; ++e) acc_dq[e] = 0.f;
  float sc[32], dp[32];
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);

  for (int i = 0; i < n_items; ++i) {
    const int p = i % per_tile, j0 = (kt_lo + i / per_tile) * kTile;
    if (tid == 0) ring.refill(i, n_items, load);
    __syncwarp();
    mbar_wait(ring.full(i), ring.parity(i));
    __syncwarp();
    if (p < 2 * n) {
      // S (+)= Q K^T, then dP (+)= dO V^T, a piece at a time
      if (p < n)
        piece_item(sc, ring, i, min(kSlice, d - p * kSlice), p == 0);
      else
        piece_item(dp, ring, i, min(kSlice, d - (p - n) * kSlice), p == n);
    } else {
      const bool masked = j0 + kTile > mask.Sk || mask.cuts(q0, j0);
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
#pragma unroll
      for (int e = 0; e < 32; ++e) dp[e] = sc[e] * (dp[e] - delta_r[(e >> 1) & 1]);
      uint32_t dsa[16];
      to_fragments(dsa, dp);
      wgmma_fence();
      piece_xb(acc_dq, dsa, ring.b(i));  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dq);
    }
    ring.release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= mask.Sq) continue;
    __nv_bfloat16* out = dq + (static_cast<size_t>(qh) * mask.Sq + qi) * d + c0 + c_lane;
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      if (c0 + 8 * j >= d) break;  // the row's own d columns only
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc_dq[4 * j + 2 * r] * scale, acc_dq[4 * j + 2 * r + 1] * scale);
    }
  }
}

// f32: bwd_dkdv_cc_256 and bwd_dq_cc_256, over the whole width (the design
// is in this file's header; the pieces, the ring and the products are
// flash_wide.cuh's).
//
// Dynamic shared memory of bwd_dkdv_cc_256 and bwd_dq_cc_256: the ring's
// stages (a piece of the other side's rows, and beside it one of the
// block's own where those are not resident), the block's own two tiles at
// the whole width where they are (f32_resident: K and V, or Q and dO), and
// a 64 x 64 score tile (P^T or dS^T, or dS).
constexpr int cc_256_smem_bytes(int d) {
  const int stage = (f32_resident(d) ? 1 : 2) * kCcRows * kLdPiece;
  const int own = f32_resident(d) ? 2 * kCcRows * f32_ld(d) : 0;
  return (kF32Stages * stage + own + kCcRows * kLdS) * static_cast<int>(sizeof(float));
}

// (b) f32, one of two launches: keys [k0, k0 + 64) of kv head (b, hk) and
// the block's pieces of their dV columns (want_dk 0) or of their dK columns
// (want_dk 1), over share sh of n_share of the 64-row query tiles of the
// group's heads that see them (n_share > 1: the share's sum, dK without the
// scale, goes to part, [n_share][B * Hk * Sk * d], and dq_combine adds the
// shares up in order).  A query tile is n_pieces items of S^T (Q's piece
// p, and K's where K is not resident: S^T += K_p Q_p^T), for dK n_pieces
// more of dP^T (dO's and V's), then P^T (dV) or dS^T (dK) into shared
// memory, then one item for each of the block's pieces g (dV_g += P^T dO_g,
// or dK_g += dS^T Q_g).  The forward's layout with keys for rows: warp w
// owns keys 8w..8w+7, lane (ly, lx) = (lane / 16, lane % 16) the keys 8w +
// 4ly + i (i < 4), the queries lx + 16j (j < 4) of S^T and dP^T, and the
// columns 4lx..4lx+3 of each of the block's pieces of dV or dK, in
// registers over the whole walk.
__global__ void __launch_bounds__(kCcThreads, 1)
bwd_dkdv_cc_256(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ out, float* __restrict__ part, int n_heads, int Hq, int Hk,
                int d, Mask mask, float softcap, float scale, int want_dk, int n_share) {
  constexpr int kOwn = kF32Cols / kPiece;  // pieces of dV or dK a block holds, at most
  const bool res = f32_resident(d);
  const int n_pieces = f32_pieces(d), n_slices = f32_slices(d);
  const int stage = (res ? 1 : 2) * kCcRows * kLdPiece;
  const int ldk = res ? f32_ld(d) : kLdPiece;
  extern __shared__ float4 smem_cc[];
  float* ring = reinterpret_cast<float*>(smem_cc);  // stage s at ring + s * stage
  float* ks = ring + kF32Stages * stage;            // K and V at the whole width (res)
  float* vs = ks + (res ? kCcRows * ldk : 0);
  float* xs = vs + (res ? kCcRows * ldk : 0);       // P^T or dS^T: [key][query]

  int rest;
  const int xi = heavy_first(&rest);  // causal: the first key blocks are the heaviest
  if (rest >= n_heads) return;        // rest: the pair b * Hk + hk
  const int per = n_slices * n_share;  // xi = (key block, slice, share)
  const int k0 = xi / per * kCcRows, sh = xi % n_share;
  const int g0 = xi % per / n_share * f32_slice_pieces(d);  // the block's first piece
  const int n_own = min(f32_slice_pieces(d), n_pieces - g0);
  const int hk = rest % Hk, b = rest / Hk, group = Hq / Hk;
  const int k_rows = min(kCcRows, mask.Sk - k0);
  const size_t kv_off = static_cast<size_t>(rest) * mask.Sk * d;
  const float* k_blk = k + kv_off + static_cast<size_t>(k0) * d;
  const float* v_blk = v + kv_off + static_cast<size_t>(k0) * d;
  int qt_lo, qt_hi;
  mask.query_tiles(k0, kCcRows, kCcRows, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo, n_tiles = group * nq;
  const int per_share = (n_tiles + n_share - 1) / n_share;
  const int t0 = min(n_tiles, sh * per_share), t1 = min(n_tiles, t0 + per_share);
  const int n_dots = (want_dk ? 2 : 1) * n_pieces;  // items of S^T (and dP^T) a tile
  const int per_tile = n_dots + n_own, n_items = (t1 - t0) * per_tile;
  // tile t of the walk: query tile qt_lo + t % nq of the group's head t /
  // nq, whose rows start at row q_row(t) of the [B * Hq * Sq] rows; the
  // share walks tiles [t0, t1)
  auto q_first = [&](int t) { return (qt_lo + t % nq) * kCcRows; };
  auto q_row = [&](int t) {
    return (static_cast<size_t>(b) * Hq + hk * group + t / nq) * mask.Sq + q_first(t);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = 8 * warp + 4 * (lane >> 4);  // keys row0 + i
  const int lx = lane & 15;                      // queries lx + 16j, columns 4lx + 64g

  // item j into stage s: Q's piece p for S^T, dO's for dP^T (each beside K's
  // or V's piece where those are not resident), then the pieces g0 + g of
  // dO (dV) or of Q (dK)
  auto load = [&](int j, int s) {
    const int t = t0 + j / per_tile, p = j % per_tile;
    const bool dot = p < n_dots, of_dp = dot && p >= n_pieces;
    const int c = (dot ? p % n_pieces : g0 + p - n_dots) * kPiece;
    const float* src = of_dp || (!dot && !want_dk) ? dout : q;
    float* a = ring + s * stage;
    load_f32_piece<kCcRows>(a, src + q_row(t) * d + c, d, min(kCcRows, mask.Sq - q_first(t)),
                            d - c);
    if (!res && dot)
      load_f32_piece<kCcRows>(a + kCcRows * kLdPiece, (of_dp ? v_blk : k_blk) + c, d, k_rows,
                              d - c);
  };
  if (res && n_items > 0) {
    load_f32_rows<kCcRows>(ks, ldk, k_blk, d, k_rows, d, ldk - 4);
    if (want_dk) load_f32_rows<kCcRows>(vs, ldk, v_blk, d, k_rows, d, ldk - 4);
  }
#pragma unroll
  for (int j = 0; j < kF32Stages - 1; ++j) {
    if (j < n_items) load(j, j);
    cp_async_commit();
  }

  float acc[kOwn][4][4], st[4][4], dpt[4][4];
  float lse_c[4], dlt_c[4];
#pragma unroll
  for (int g = 0; g < kOwn; ++g) zero_block(acc[g]);
  zero_block(dpt);  // the dV walk forms no dP^T: cc_grads reads zeros
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;

  for (int i = 0; i < n_items; ++i) {
    const int t = t0 + i / per_tile, p = i % per_tile, q0 = q_first(t);
    if (p == 0) {
      // the lse (log2 units) and delta of this thread's queries q0 + lx +
      // 16j: +inf and 0 past Sq, so P is 0 there; read while the pieces land
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = q0 + lx + 16 * j < mask.Sq;
        const size_t at = q_row(t) + lx + 16 * j;
        lse_c[j] = in ? lse[at] * kLog2e : INFINITY;
        dlt_c[j] = in ? delta[at] : 0.f;
      }
    }
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // item i is in; every thread is done with item i - 1
    if (i + kF32Stages - 1 < n_items) load(i + kF32Stages - 1, (i + kF32Stages - 1) % kF32Stages);
    cp_async_commit();  // (empty past the last item: the wait's count stays right)
    const float* a = ring + (i % kF32Stages) * stage;
    if (p < n_dots) {
      // S^T += K_p Q_p^T, then (dK) dP^T += V_p dO_p^T: keys are rows (two
      // calls, so that st and dpt stay in registers)
      const int pp = p % n_pieces, n = min(kPiece, d - pp * kPiece);
      const float* kp = res ? (p < n_pieces ? ks : vs) + pp * kPiece : a + kCcRows * kLdPiece;
      if (p < n_pieces) {
        if (pp == 0) zero_block(st);
        dot_piece<4, 4, 1, 16>(st, kp + row0 * ldk, ldk, a + lx * kLdPiece, kLdPiece, n);
      } else {
        if (pp == 0) zero_block(dpt);
        dot_piece<4, 4, 1, 16>(dpt, kp + row0 * ldk, ldk, a + lx * kLdPiece, kLdPiece, n);
      }
      if (p < n_dots - 1) continue;
      // P^T (dV) or dS^T without the scale (dK) into xs: rows are keys k0 +
      // row0 + i, columns queries q0 + lx + 16j; the next item's barrier
      // makes them the block's
      cc_grads_any<true>(softcap > 0.f, mask.cuts(q0, k0), st, dpt, lse_c, dlt_c, mask, q0 + lx,
                         16, k0 + row0, 1, scale_l2, scale_cap, cap_l2,
                         want_dk ? nullptr : xs + row0 * kLdS + lx);
      if (want_dk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) xs[(row0 + r) * kLdS + lx + 16 * j] = dpt[r][j];
      }
      continue;
    }
    // dV_g += P^T dO_g or dK_g += dS^T Q_g: keys row0 + i, columns 4lx of piece g
    const int g = p - n_dots, q_end = rows_end(mask.Sq - q0);
#pragma unroll
    for (int gg = 0; gg < kOwn; ++gg)
      if (gg == g) acc_piece<4, 1>(acc[gg], xs + row0 * kLdS, kLdS, a + 4 * lx, kLdPiece, q_end);
  }

  // every share writes its part, a share without tiles zeros
  const size_t n_all = static_cast<size_t>(n_heads) * mask.Sk * d;
  float* dst = n_share == 1 ? out : part + sh * n_all;
  const float f = n_share == 1 && want_dk ? scale : 1.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= k_rows) continue;
    const size_t row = kv_off + static_cast<size_t>(k0 + row0 + r) * d;
#pragma unroll
    for (int g = 0; g < kOwn; ++g) {
      const int c = (g0 + g) * kPiece + 4 * lx;
      if (g < n_own && c < d)  // the row's own d columns only
        *reinterpret_cast<float4*>(dst + row + c) =
            make_float4(acc[g][r][0] * f, acc[g][r][1] * f, acc[g][r][2] * f, acc[g][r][3] * f);
    }
  }
}

// (c) f32: 64 query rows of head (b, h), the block's pieces of their dQ
// columns, key split sp of n_split (the narrow kernel's part and
// dq_combine).  A key tile is n_pieces items of S (K's piece p, and Q's
// where Q is not resident), n_pieces of dP (V's, and dO's), then dS into
// shared memory, then one item of K for each of the block's pieces g (dQ_g
// += dS K_g).  The forward's layout: warp w owns rows 8w..8w+7, lane (ly,
// lx) = (lane / 16, lane % 16) the rows 8w + 4ly + i (i < 4), the keys lx +
// 16j (j < 4) and the columns 4lx..4lx+3 of each piece.
__global__ void __launch_bounds__(kCcThreads, 1)
bwd_dq_cc_256(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ part, int n_heads, int Hq, int Hk, int d,
              Mask mask, float softcap, float scale, int n_split) {
  constexpr int kOwn = kF32Cols / kPiece;  // pieces of dQ a block holds, at most
  const bool res = f32_resident(d);
  const int n_pieces = f32_pieces(d), n_slices = f32_slices(d);
  const int stage = (res ? 1 : 2) * kCcRows * kLdPiece;
  const int ldq = res ? f32_ld(d) : kLdPiece;
  extern __shared__ float4 smem_cc[];
  float* ring = reinterpret_cast<float*>(smem_cc);  // stage s at ring + s * stage
  float* qs = ring + kF32Stages * stage;            // Q and dO at the whole width (res)
  float* dos = qs + (res ? kCcRows * ldq : 0);
  float* xs = dos + (res ? kCcRows * ldq : 0);      // dS: [query][key]

  int rest;
  const int xi = heavy_first(&rest);  // the last query blocks are the heaviest
  if (rest >= n_heads) return;        // rest: the pair b * Hq + h
  const int per = n_slices * n_split;
  const int q0 = (gridDim.x / per - 1 - xi / per) * kCcRows, sp = xi % n_split;
  const int g0 = xi % per / n_split * f32_slice_pieces(d);  // the block's first piece
  const int n_own = min(f32_slice_pieces(d), n_pieces - g0);
  const int h = rest % Hq, b = rest / Hq;
  const int q_rows = min(kCcRows, mask.Sq - q0);
  const size_t q_at = static_cast<size_t>(rest) * mask.Sq + q0;
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / (Hq / Hk)) * mask.Sk * d;
  int lo, hi;
  mask.key_tiles(q0, q_rows, kCcRows, &lo, &hi);
  const int nk = (mask.Sk + kCcRows - 1) / kCcRows, per_split = (nk + n_split - 1) / n_split;
  lo = max(lo, sp * per_split);
  hi = min(hi, (sp + 1) * per_split);
  const int per_tile = 2 * n_pieces + n_own, n_items = max(0, hi - lo) * per_tile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = 8 * warp + 4 * (lane >> 4);  // rows row0 + i
  const int lx = lane & 15;                      // keys lx + 16j, columns 4lx + 64g
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool in = row0 + r < q_rows;
    lse_r[r] = in ? lse[q_at + row0 + r] * kLog2e : INFINITY;
    delta_r[r] = in ? delta[q_at + row0 + r] : 0.f;
  }

  // item j into stage s: K's piece p for S, V's for dP (each beside Q's or
  // dO's piece where those are not resident), then K's pieces g0 + g for dQ
  auto load = [&](int j, int s) {
    const int p = j % per_tile, j0 = (lo + j / per_tile) * kCcRows;
    const int kind = p < n_pieces ? 0 : p < 2 * n_pieces ? 1 : 2;
    const int c = (kind == 0 ? p : kind == 1 ? p - n_pieces : g0 + p - 2 * n_pieces) * kPiece;
    float* a = ring + s * stage;
    load_f32_piece<kCcRows>(a, (kind == 1 ? v : k) + kv_off + static_cast<size_t>(j0) * d + c, d,
                            min(kCcRows, mask.Sk - j0), d - c);
    if (!res && kind < 2)
      load_f32_piece<kCcRows>(a + kCcRows * kLdPiece, (kind == 0 ? q : dout) + q_at * d + c, d,
                              q_rows, d - c);
  };
  if (res && n_items > 0) {
    load_f32_rows<kCcRows>(qs, ldq, q + q_at * d, d, q_rows, d, ldq - 4);
    load_f32_rows<kCcRows>(dos, ldq, dout + q_at * d, d, q_rows, d, ldq - 4);
  }
#pragma unroll
  for (int j = 0; j < kF32Stages - 1; ++j) {
    if (j < n_items) load(j, j);
    cp_async_commit();
  }

  float acc[kOwn][4][4], sc[4][4], dp[4][4];
#pragma unroll
  for (int g = 0; g < kOwn; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][r][e] = 0.f;
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;

  for (int i = 0; i < n_items; ++i) {
    const int p = i % per_tile, j0 = (lo + i / per_tile) * kCcRows;
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // item i is in; every thread is done with item i - 1
    if (i + kF32Stages - 1 < n_items) load(i + kF32Stages - 1, (i + kF32Stages - 1) % kF32Stages);
    cp_async_commit();  // (empty past the last item: the wait's count stays right)
    const float* a = ring + (i % kF32Stages) * stage;
    if (p < 2 * n_pieces) {
      // S += Q_p K_p^T, then dP += dO_p V_p^T: queries are rows
      // (two calls, so that sc and dp stay in registers)
      const int pp = p < n_pieces ? p : p - n_pieces, n = min(kPiece, d - pp * kPiece);
      const float* qp = res ? (p < n_pieces ? qs : dos) + pp * kPiece : a + kCcRows * kLdPiece;
      if (p < n_pieces) {
        if (pp == 0) zero_block(sc);
        dot_piece<4, 4, 1, 16>(sc, qp + row0 * ldq, ldq, a + lx * kLdPiece, kLdPiece, n);
      } else {
        if (pp == 0) zero_block(dp);
        dot_piece<4, 4, 1, 16>(dp, qp + row0 * ldq, ldq, a + lx * kLdPiece, kLdPiece, n);
      }
      if (p < 2 * n_pieces - 1) continue;
      // dS (without the scale) into xs: rows are queries q0 + row0 + i,
      // columns keys j0 + lx + 16j
      cc_grads_any<false>(softcap > 0.f, j0 + kCcRows > mask.Sk || mask.cuts(q0, j0), sc, dp,
                          lse_r, delta_r, mask, q0 + row0, 1, j0 + lx, 16, scale_l2, scale_cap,
                          cap_l2, nullptr);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) xs[(row0 + r) * kLdS + lx + 16 * j] = dp[r][j];
      __syncwarp();  // dS's rows are this warp's own, where written and read
      continue;
    }
    // dQ_g += dS K_g over the tile's keys, rows row0 + i, columns 4lx of piece g
    const int g = p - 2 * n_pieces, k_end = rows_end(mask.Sk - j0);
#pragma unroll
    for (int gg = 0; gg < kOwn; ++gg)
      if (gg == g) acc_piece<4, 1>(acc[gg], xs + row0 * kLdS, kLdS, a + 4 * lx, kLdPiece, k_end);
  }

  const size_t rows_all = static_cast<size_t>(n_heads) * mask.Sq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= q_rows) continue;
    const size_t row = q_at + row0 + r;
    float* out = part == nullptr ? dq + row * d
                                 : part + (static_cast<size_t>(sp) * rows_all + row) * d;
    const float f = part == nullptr ? scale : 1.f;
#pragma unroll
    for (int g = 0; g < kOwn; ++g) {
      const int c = (g0 + g) * kPiece + 4 * lx;
      if (g < n_own && c < d)  // the row's own d columns only
        *reinterpret_cast<float4*>(out + c) = make_float4(acc[g][r][0] * f, acc[g][r][1] * f,
                                                          acc[g][r][2] * f, acc[g][r][3] * f);
    }
  }
}

// ============================== bf16 widths 136-256: the native kernels
//
// No column slices: every product over the head's whole width (up to 256
// columns, 64-column boxes, ceil(d / 64) of them loaded), each formed once
// a tile.  Two warpgroups a block, 256 threads; thread 0 issues the TMA
// loads, as the narrow kernels'.  Columns of an accumulator past the loaded
// boxes read stale shared memory and are never stored.
//
// (b) bwd_dkdv_wgmma_256: a block owns 64 keys of kv head (b, hk), K and V
// resident, and streams 64-row tiles of Q and dO (two stages) of the query
// heads of its GQA group in its share (head_split shares a group, each a
// block of its own, where the grid would fill fewer than two waves).
// Warpgroup 0 forms S^T = K Q^T, P^T and owns dV += P^T dO (64 x 256 f32,
// 128 registers a thread); warpgroup 1 forms dP^T = V dO^T and owns
// dK += dS^T Q.  P^T times the softcap's factor passes from 0 to 1 through
// shared memory in f32 (16 KB, two buffers, named barriers ready and
// consumed), so each product is formed once a tile.  One share writes dK
// (scaled) and dV in bf16; with shares, each writes its unscaled f32 part
// and dkdv_combine adds the parts in share order.
// (c) bwd_dq_wgmma_256: a block owns 128 query rows, 64 a warpgroup, Q and
// dO resident; K in two stages, V in one (released as soon as dP is in, and
// the next one loaded while dS and dQ += dS K run).  S and dP over the whole
// width, dQ (64 x 256 f32) in registers.
constexpr int kNatCols = 256;
constexpr int kNatBoxes = kNatCols / 64;
constexpr uint32_t kNatBox = 64 * 128;              // a 64-row box
constexpr uint32_t kNatTile = kNatBoxes * kNatBox;  // a 64-row tile, 32 KB
constexpr int kNatThreads = 256;

// 1 KB of alignment, K, V, two stages of Q and dO, two f32 P^T buffers,
// each warpgroup's two stages of 64 lse or delta, five mbarriers.
constexpr int dkdv_256_smem_bytes() {
  return 1024 + static_cast<int>(6 * kNatTile) + 2 * 32 * 128 * 4 + 4 * 64 * 4 + 64;
}
// 1 KB of alignment, Q and dO of 128 rows, two stages of K, one of V, seven
// mbarriers, the rows' lse and delta.
constexpr int dq_256_smem_bytes() {
  return 1024 + static_cast<int>(4 * kNatTile + 3 * kNatTile) + 64 + 2 * 128 * 4;
}

// Named barriers between the two warpgroups of a native block (ids 3-6;
// 1 and 2 are warpgroup_sync's): one warpgroup arrives, the other waits.
// The id is an immediate, so that ptxas reserves seven barriers.
template <int kId>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, 256;" ::"n"(kId) : "memory");
}
template <int kId>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, 256;" ::"n"(kId) : "memory");
}

// acc (64 x 64) = A B^T over d columns, A and B two 64-row tiles of 64-column
// boxes of `box` bytes, K-major.
__device__ __forceinline__ void product_abt_256(float (&acc)[32], uint32_t a, uint32_t a_box,
                                                uint32_t b, int d) {
#pragma unroll
  for (int kk = 0; kk < kNatCols / 16; ++kk) {
    if (16 * kk >= d) break;
    wgmma_ss_n64(acc, k_major(a, a_box, kk), k_major(b, kNatBox, kk), kk > 0);
  }
}

// acc (64 x 256) += X B, X (64 x 64) as bf16 A fragments, B a 64-row tile,
// MN-major.
__device__ __forceinline__ void product_xb_256(float (&acc)[128], const uint32_t (&x)[16],
                                               uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n256(acc, x + 4 * kk, mn_major(b, kNatBox, kk));
}

__global__ void __launch_bounds__(kNatThreads, 1)
bwd_dkdv_wgmma_256(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int n_heads, int Hq,
                   int Hk, int d, Mask mask, float softcap, float scale, int head_split) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + kNatTile;
  const uint32_t q_s = v_s + kNatTile;         // stage s at q_s + s * kNatTile
  const uint32_t do_s = q_s + 2 * kNatTile;
  const uint32_t p_s = do_s + 2 * kNatTile;    // buffer s: 32 x 128 floats
  const uint32_t stats_s = p_s + 2 * 32 * 128 * 4;  // warpgroup w, stage s: 64 floats
  const uint32_t kv_full = stats_s + 4 * 64 * 4;
  const uint32_t full = kv_full + 8, empty = kv_full + 24;  // [2] each
  float* pbuf = reinterpret_cast<float*>(smem + (p_s - base));
  float* stats = reinterpret_cast<float*>(smem + (stats_s - base));

  const int kvh = head_pair();  // b * Hk + hk
  if (kvh >= n_heads) return;
  const int hk = kvh % Hk, b = kvh / Hk, group = Hq / Hk;
  const int share = blockIdx.x % head_split;
  const int k0 = blockIdx.x / head_split * 64;  // causal: the first key blocks are the heaviest
  const int per = (group + head_split - 1) / head_split;
  const int h_lo = min(group, share * per), h_hi = min(group, h_lo + per);
  int qt_lo, qt_hi;
  mask.query_tiles(k0, 64, kTile, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo, n_tiles = (h_hi - h_lo) * nq;
  const int nb = (d + 63) / 64;
  auto tile_head = [&](int i) { return b * Hq + hk * group + h_lo + i / nq; };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, t = tid % 128;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_q = [&](int i) {  // tile i's Q and dO into stage i % 2 (thread 0)
    const int s = i & 1, qh = tile_head(i), q0 = (qt_lo + i % nq) * kTile;
    mbar_expect_tx(full + 8 * s, 2 * nb * kNatBox);
    for (int x = 0; x < nb; ++x) {
      tma_load(q_s + s * kNatTile + x * kNatBox, &tq, full + 8 * s, 64 * x, q0, qh);
      tma_load(do_s + s * kNatTile + x * kNatBox, &tdo, full + 8 * s, 64 * x, q0, qh);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(kv_full, 2 * nb * kNatBox);
    for (int x = 0; x < nb; ++x) {
      tma_load(k_s + x * kNatBox, &tk, kv_full, 64 * x, k0, kvh);
      tma_load(v_s + x * kNatBox, &tv, kv_full, 64 * x, k0, kvh);
    }
    load_q(0);
  }

  // Thread t < 64 of warpgroup 0 carries tile i's lse of query row t, of
  // warpgroup 1 its delta: +inf and 0 past Sq, so P is 0 on those columns.
  const float* stat_src = wg == 0 ? lse : delta;
  auto stat = [&](int i) {
    const int qi = (qt_lo + i % nq) * kTile + t;
    return qi < mask.Sq ? stat_src[static_cast<size_t>(tile_head(i)) * mask.Sq + qi]
                        : (wg == 0 ? INFINITY : 0.f);
  };
  float next = n_tiles > 0 && t < 64 ? stat(0) : 0.f;

  float acc[kNatCols / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int e = 0; e < kNatCols / 2; ++e) acc[e] = 0.f;
  float st[32];  // S^T, then P^T (0); dP^T, then dS^T (1)
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = 0.f;  // overwritten (scale-d 0)
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's rows: key0, key0 + 8

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const int q0 = (qt_lo + i % nq) * kTile;
    if (tid == 0 && i + 1 < n_tiles) {
      // tile i - 1 used the stage tile i + 1 goes to
      if (i >= 1) mbar_wait(empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
      load_q(i + 1);
    }
    __syncwarp();
    // this tile's lse (log2 units) or delta into the warpgroup's stage s
    // (read two tiles ago), the next tile's on their way from memory
    float* tile_stats = stats + (2 * wg + s) * 64;
    if (t < 64) {
      tile_stats[t] = wg == 0 ? next * kLog2e : next;
      if (i + 1 < n_tiles) next = stat(i + 1);
    }
    warpgroup_sync(wg);

    mbar_wait(full + 8 * s, (i >> 1) & 1);
    __syncwarp();
    const uint32_t q_t = opaque(q_s + s * kNatTile), do_t = opaque(do_s + s * kNatTile);
    wgmma_fence();
    if (wg == 0)
      product_abt_256(st, opaque(k_s), kNatBox, q_t, d);  // S^T = K Q^T
    else
      product_abt_256(st, opaque(v_s), kNatBox, do_t, d);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    float* pb = pbuf + s * 32 * 128;
    uint32_t fa[16];
    if (wg == 0) {
      // P^T (keys are rows, the tile's queries columns), P^T times the
      // softcap's factor to warpgroup 1, then dV += P^T dO
      if (i >= 2) {  // warpgroup 1 is done with buffer s
        if (s == 0) named_sync<5>(); else named_sync<6>();
      }
      const bool masked = mask.cuts(q0, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lse2 = *reinterpret_cast<const float2*>(tile_stats + 8 * j + c_lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float p[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * hh + c;
            float x, fac = 1.f;
            if (softcap > 0.f) {
              const float th = tanhf(st[e] * scale_cap);
              x = cap_l2 * th;
              fac = 1.f - th * th;
            } else {
              x = st[e] * scale_l2;
            }
            p[c] = exp2f(x - (c ? lse2.y : lse2.x));
            if (masked && !mask.ok(q0 + 8 * j + c_lane + c, key0 + 8 * hh)) p[c] = 0.f;
            pb[e * 128 + t] = p[c] * fac;
          }
          fa[2 * j + hh] = pack_bf16(p[0], p[1]);
        }
      }
      if (s == 0) named_arrive<3>(); else named_arrive<4>();  // buffer s holds P^T
      wgmma_fence();
      product_xb_256(acc, fa, do_t);  // dV += P^T dO
      wgmma_commit();
    } else {
      // dS^T = P^T (dP^T - delta), then dK += dS^T Q
      if (s == 0) named_sync<3>(); else named_sync<4>();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dlt2 = *reinterpret_cast<const float2*>(tile_stats + 8 * j + c_lane);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e)
          st[e] = pb[e * 128 + t] * (st[e] - (e & 1 ? dlt2.y : dlt2.x));
      }
      if (i + 2 < n_tiles) {  // buffer s is free for tile i + 2
        if (s == 0) named_arrive<5>(); else named_arrive<6>();
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) fa[e] = pack_bf16(st[2 * e], st[2 * e + 1]);
      wgmma_fence();
      product_xb_256(acc, fa, q_t);  // dK += dS^T Q
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  const size_t n_all = static_cast<size_t>(n_heads) * mask.Sk * d;
  const float f = head_split == 1 && wg == 1 ? scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= mask.Sk) continue;
    const size_t row = (static_cast<size_t>(kvh) * mask.Sk + key) * d + c_lane;
    __nv_bfloat16* out = wg == 0 ? dv : dk;
    float* pout = part + (static_cast<size_t>(wg) * head_split + share) * n_all;
#pragma unroll
    for (int j = 0; j < kNatCols / 8; ++j) {
      if (8 * j >= d) break;  // the row's own d columns only
      const float2 v2 = make_float2(acc[4 * j + 2 * r] * f, acc[4 * j + 2 * r + 1] * f);
      if (head_split == 1)
        *reinterpret_cast<__nv_bfloat162*>(out + row + 8 * j) = __float22bfloat162_rn(v2);
      else
        *reinterpret_cast<float2*>(pout + row + 8 * j) = v2;
    }
  }
}

// dV and dK (times scale) in bf16 from the shares' f32 parts, added in share
// order: part [2 (dV, dK)][shares][n], n = B * Hk * Sk * d, 4 elements a
// thread.
__global__ void __launch_bounds__(256)
dkdv_combine(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, size_t n, int shares, float scale) {
  const size_t e = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (e >= 2 * n) return;
  const int which = e >= n;  // 0 dV, 1 dK
  const size_t i = e - which * n;
  const float* src = part + static_cast<size_t>(which) * shares * n + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < shares; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
  }
  const float f = which ? scale : 1.f;
  __nv_bfloat16* out = (which ? dk : dv) + i;
  *reinterpret_cast<uint2*>(out) =
      make_uint2(pack_bf16(acc.x * f, acc.y * f), pack_bf16(acc.z * f, acc.w * f));
}

__global__ void __launch_bounds__(kNatThreads, 1)
bwd_dq_wgmma_256(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int n_heads, int Hq, int Hk, int d, Mask mask,
                 float softcap, float scale) {
  constexpr uint32_t kQBox = 128 * 128;  // a 128-row box of Q or dO
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + kNatBoxes * kQBox;
  const uint32_t k_s = do_s + kNatBoxes * kQBox;  // stage s at k_s + s * kNatTile
  const uint32_t v_s = k_s + 2 * kNatTile;
  const uint32_t qd_full = v_s + kNatTile;
  const uint32_t k_full = qd_full + 8, k_empty = qd_full + 24;  // [2] each
  const uint32_t v_full = qd_full + 40, v_empty = qd_full + 48;
  // the block's rows' lse (log2 units) and delta: in shared memory, not in
  // registers, which dQ (128 a thread), S, dP and dS fill
  float* rows_lse = reinterpret_cast<float*>(smem + (qd_full + 64 - smem_u32(smem)));
  float* rows_delta = rows_lse + 128;

  const int qh = head_pair();  // b * Hq + h
  if (qh >= n_heads) return;
  const int h = qh % Hq, b = qh / Hq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;  // heaviest query blocks first
  const int q_rows = min(128, mask.Sq - q0);
  const int kvh = b * Hk + h / (Hq / Hk);
  int kt_lo, kt_hi;
  mask.key_tiles(q0, q_rows, kTile, &kt_lo, &kt_hi);  // the block's 128 rows
  const int n_tiles = kt_hi - kt_lo;
  const int nb = (d + 63) / 64;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival per warp
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  auto load_k = [&](int i) {  // key tile i's K into stage i % 2 (thread 0)
    const int s = i & 1, j0 = (kt_lo + i) * kTile;
    mbar_expect_tx(k_full + 8 * s, nb * kNatBox);
    for (int x = 0; x < nb; ++x)
      tma_load(k_s + s * kNatTile + x * kNatBox, &tk, k_full + 8 * s, 64 * x, j0, kvh);
  };
  auto load_v = [&](int i) {  // key tile i's V (thread 0)
    const int j0 = (kt_lo + i) * kTile;
    mbar_expect_tx(v_full, nb * kNatBox);
    for (int x = 0; x < nb; ++x) tma_load(v_s + x * kNatBox, &tv, v_full, 64 * x, j0, kvh);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(qd_full, 2 * nb * kQBox);
    for (int x = 0; x < nb; ++x) {
      tma_load(q_s + x * kQBox, &tq, qd_full, 64 * x, q0, qh);
      tma_load(do_s + x * kQBox, &tdo, qd_full, 64 * x, q0, qh);
    }
    load_k(0);
    load_v(0);
  }

  const int qw0 = q0 + 64 * wg;                 // this warpgroup's rows
  const int row0 = qw0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int rl = 64 * wg + 16 * warp + lane / 4;  // row0 within the block
  if (tid < 128) {
    const int qi = q0 + tid;
    const size_t at = static_cast<size_t>(qh) * mask.Sq + qi;
    rows_lse[tid] = qi < mask.Sq ? lse[at] * kLog2e : INFINITY;
    rows_delta[tid] = qi < mask.Sq ? delta[at] : 0.f;
  }
  __syncthreads();
  float acc_dq[kNatCols / 2];
#pragma unroll
  for (int e = 0; e < kNatCols / 2; ++e) acc_dq[e] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;  // overwritten (scale-d 0)
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const uint32_t q_wg = q_s + wg * 64 * 128, do_wg = do_s + wg * 64 * 128;

  if (n_tiles > 0) mbar_wait(qd_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const int j0 = (kt_lo + i) * kTile;
    if (tid == 0 && i + 1 < n_tiles) {
      if (i >= 1) mbar_wait(k_empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
      load_k(i + 1);
    }
    __syncwarp();
    // S = Q K^T and dP = dO V^T: the warpgroup's queries are rows
    mbar_wait(k_full + 8 * s, (i >> 1) & 1);
    const uint32_t k_t = opaque(k_s + s * kNatTile);
    wgmma_fence();
    product_abt_256(sc, opaque(q_wg), kQBox, k_t, d);
    wgmma_commit();
    mbar_wait(v_full, i & 1);
    product_abt_256(dp, opaque(do_wg), kQBox, opaque(v_s), d);
    wgmma_commit();

    // P from S while dP runs, then dS
    wgmma_wait<1>();
    fence_regs(sc);
    const bool masked = j0 + kTile > mask.Sk || mask.cuts(qw0, j0);
    const float lse_r[2] = {rows_lse[rl], rows_lse[rl + 8]};
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
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty);  // V is free: the next one loads
    if (tid == 0 && i + 1 < n_tiles) {
      mbar_wait(v_empty, i & 1);
      load_v(i + 1);
    }
    __syncwarp();
    const float delta_r[2] = {rows_delta[rl], rows_delta[rl + 8]};
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = sc[e] * (dp[e] - delta_r[(e >> 1) & 1]);

    // dQ += dS K
    uint32_t dsa[16];
    to_fragments(dsa, dp);
    wgmma_fence();
    product_xb_256(acc_dq, dsa, k_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(dsa);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= mask.Sq) continue;
    __nv_bfloat16* out = dq + (static_cast<size_t>(qh) * mask.Sq + qi) * d + c_lane;
#pragma unroll
    for (int j = 0; j < kNatCols / 8; ++j) {
      if (8 * j >= d) break;  // the row's own d columns only
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc_dq[4 * j + 2 * r] * scale, acc_dq[4 * j + 2 * r + 1] * scale);
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
  float* scratch;  // f32 dQ key splits: dq_split * B * Hq * Sq * d floats,
                   // then dK/dV shares: 2 * dkdv_split * B * Hk * Sk * d
  int dq_split;
  int dkdv_split;  // shares of a dK/dV block's work: the native bf16 kernels'
                   // of a GQA group's heads, the f32 whole-width ones' of
                   // a key block's query tiles

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
// unless that leaves fewer blocks than the card's n_sm SMs, then 64; f32,
// and bf16 past 256 columns (the wide kernels), take 64.
void block_rows(int dtype, int B, int Hq, int Hk, int Sq, int Sk, int D, int n_sm, int* dkdv,
                int* dq) {
  if (dtype == 1 && D > 128 && D <= kNatCols) {  // the native kernels
    *dkdv = 64;
    *dq = 128;
    return;
  }
  if (dtype == 0 || D > 128) {
    *dkdv = *dq = kCcRows;
    return;
  }
  *dkdv = 1LL * B * Hk * ((Sk + 127) / 128) < n_sm ? 64 : 128;
  *dq = 1LL * B * Hq * ((Sq + 127) / 128) < n_sm ? 64 : 128;
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
  bwd_dkdv_wgmma<D, kWG, kAny><<<head_grid((a.mask.Sk + 64 * kWG - 1) / (64 * kWG), a.Hk, a.B),
                                 128 * kWG, kSmem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.B * a.Hk, a.Hq, a.Hk, a.d, a.mask, a.softcap,
      a.scale);
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
  bwd_dq_wgmma<D, kWG, kAny><<<head_grid((a.mask.Sq + 64 * kWG - 1) / (64 * kWG), a.Hq, a.B),
                               128 * kWG, kSmem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), a.B * a.Hq, a.Hq,
      a.Hk, a.d, a.mask, a.softcap, a.scale);
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
  block_rows(1, a.B, a.Hq, a.Hk, a.mask.Sq, a.mask.Sk, a.d, n_sm, &dkdv_rows, &dq_rows);
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
  const int split = a.dq_split;
  if (split < 1 || split > kMaxSplit || (split > 1 && a.scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_delta<T, D, kAny>(a);
  if (err == 0) err = allow_smem(bwd_dkdv_cc<D, kAny>, kSmem, &dkdv_ok);
  if (err == 0) err = allow_smem(bwd_dq_cc<D, kAny>, kSmem, &dq_ok);
  if (err != 0) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  bwd_dkdv_cc<D, kAny><<<head_grid((a.mask.Sk + kCcRows - 1) / kCcRows, a.Hk, a.B), kCcThreads,
                         kSmem, a.stream>>>(q, k, v, dout, a.lse, a.delta,
                                            static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                            a.B * a.Hk, a.Hq, a.Hk, a.d, a.mask, a.softcap,
                                            a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dq_cc<D, kAny><<<head_grid((a.mask.Sq + kCcRows - 1) / kCcRows * split, a.Hq, a.B),
                       kCcThreads, kSmem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), split > 1 ? a.scratch : nullptr,
      a.B * a.Hq, a.Hq, a.Hk, a.d, a.mask, a.softcap, a.scale, split);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || split == 1) return err;
  const size_t n4 = static_cast<size_t>(a.B) * a.Hq * a.mask.Sq * a.d / 4;
  dq_combine<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, a.stream>>>(
      a.scratch, static_cast<T*>(a.dq), n4, split, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Past 128 columns: the wide kernels, 64-row blocks, one slice of 128
// columns a block (the grids' x counts slices).
int launch_wide_wgmma(const Args& a) {
  constexpr int kDkdv = wide_smem_bytes(1024), kDq = wide_smem_bytes(0);
  static bool dkdv_ok = false, dq_ok = false;
  int err = launch_delta<__nv_bfloat16, 128, true>(a);
  if (err == 0) err = allow_smem(bwd_dkdv_wgmma_wide, kDkdv, &dkdv_ok);
  if (err == 0) err = allow_smem(bwd_dq_wgmma_wide, kDq, &dq_ok);
  CUtensorMap tq, tk, tv, tdo;
  if (err == 0) err = encode_all(a, 64, 64, &tq, &tk, &tv, &tdo);
  if (err != 0) return err;
  const int n = (a.d + kSlice - 1) / kSlice;
  bwd_dkdv_wgmma_wide<<<head_grid((a.mask.Sk + 63) / 64 * n, a.Hk, a.B), 128, kDkdv, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.B * a.Hk, a.Hq, a.Hk, a.d, a.mask, a.softcap, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dq_wgmma_wide<<<head_grid((a.mask.Sq + 63) / 64 * n, a.Hq, a.B), 128, kDq, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), a.B * a.Hq, a.Hq, a.Hk,
      a.d, a.mask, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 widths 136-256: the native kernels (dK/dV over 64-key blocks in
// head_split shares, dQ over 128-row blocks), and dkdv_combine where the
// shares write parts.
int launch_wgmma_256(const Args& a) {
  constexpr int kDkdv = dkdv_256_smem_bytes(), kDq = dq_256_smem_bytes();
  static bool dkdv_ok = false, dq_ok = false;
  const int hs = a.dkdv_split;
  if (hs < 1 || (hs > 1 && a.scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_delta<__nv_bfloat16, 128, true>(a);
  if (err == 0) err = allow_smem(bwd_dkdv_wgmma_256, kDkdv, &dkdv_ok);
  if (err == 0) err = allow_smem(bwd_dq_wgmma_256, kDq, &dq_ok);
  CUtensorMap tq, tk, tv, tdo;
  if (err == 0) err = encode_all(a, 64, 64, &tq, &tk, &tv, &tdo);
  if (err != 0) return err;
  bwd_dkdv_wgmma_256<<<head_grid((a.mask.Sk + 63) / 64 * hs, a.Hk, a.B), kNatThreads, kDkdv,
                       a.stream>>>(tq, tk, tv, tdo, a.lse, a.delta,
                                   static_cast<__nv_bfloat16*>(a.dk),
                                   static_cast<__nv_bfloat16*>(a.dv), a.scratch, a.B * a.Hk,
                                   a.Hq, a.Hk, a.d, a.mask, a.softcap, a.scale, hs);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (hs > 1) {
    const size_t n = static_cast<size_t>(a.B) * a.Hk * a.mask.Sk * a.d;
    dkdv_combine<<<static_cast<unsigned>((2 * n / 4 + 255) / 256), 256, 0, a.stream>>>(
        a.scratch, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), n, hs,
        a.scale);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  CUtensorMap tq2, tdo2;  // Q and dO in boxes of the dQ block's 128 rows
  err = encode(&tq2, a.q, a.d, a.mask.Sq, a.B * a.Hq, 128);
  if (err == 0) err = encode(&tdo2, a.dout, a.d, a.mask.Sq, a.B * a.Hq, 128);
  if (err != 0) return err;
  bwd_dq_wgmma_256<<<head_grid((a.mask.Sq + 127) / 128, a.Hq, a.B), kNatThreads, kDq,
                     a.stream>>>(tq2, tk, tv, tdo2, a.lse, a.delta,
                                 static_cast<__nv_bfloat16*>(a.dq), a.B * a.Hq, a.Hq, a.Hk, a.d,
                                 a.mask, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// f32 past 128 columns: the whole-width kernels (dV, then dK, over 64-key
// blocks in dkdv_split shares of their query tiles; dQ over 64-row blocks
// in dq_split shares of their keys; each a slice of the columns past 256),
// each shared one followed by dq_combine.
int launch_cc_256(const Args& a) {
  using T = float;
  // the most any width asks for (the streamed layout just past kF32Cols)
  constexpr int kMost = cc_256_smem_bytes(kF32Cols) > cc_256_smem_bytes(kF32Cols + 8)
                            ? cc_256_smem_bytes(kF32Cols)
                            : cc_256_smem_bytes(kF32Cols + 8);
  static bool dkdv_ok = false, dq_ok = false;
  const int split = a.dq_split, shares = a.dkdv_split;
  if (split < 1 || split > kMaxSplit || shares < 1 || shares > kMaxSplit ||
      ((split > 1 || shares > 1) && a.scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_delta<T, 128, true>(a);
  if (err == 0) err = allow_smem(bwd_dkdv_cc_256, kMost, &dkdv_ok);
  if (err == 0) err = allow_smem(bwd_dq_cc_256, kMost, &dq_ok);
  if (err != 0) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  const int n = f32_slices(a.d);
  // the scratch: dQ's key splits (where split), then dK's and dV's shares
  const size_t n_q = static_cast<size_t>(a.B) * a.Hq * a.mask.Sq * a.d;
  const size_t n_kv = static_cast<size_t>(a.B) * a.Hk * a.mask.Sk * a.d;
  float* kv_part = a.scratch + (split > 1 ? split * n_q : 0);
  for (int want_dk = 0; want_dk < 2; ++want_dk) {  // dV, then dK
    T* out = static_cast<T*>(want_dk ? a.dk : a.dv);
    float* part = shares > 1 ? kv_part + want_dk * shares * n_kv : nullptr;
    bwd_dkdv_cc_256<<<head_grid((a.mask.Sk + kCcRows - 1) / kCcRows * n * shares, a.Hk, a.B),
                      kCcThreads, cc_256_smem_bytes(a.d), a.stream>>>(
        q, k, v, dout, a.lse, a.delta, out, part, a.B * a.Hk, a.Hq, a.Hk, a.d, a.mask,
        a.softcap, a.scale, want_dk, shares);
    err = static_cast<int>(cudaGetLastError());
    if (err == 0 && shares > 1) {
      dq_combine<<<static_cast<unsigned>((n_kv / 4 + 255) / 256), 256, 0, a.stream>>>(
          part, out, n_kv / 4, shares, want_dk ? a.scale : 1.f);
      err = static_cast<int>(cudaGetLastError());
    }
    if (err != 0) return err;
  }
  bwd_dq_cc_256<<<head_grid((a.mask.Sq + kCcRows - 1) / kCcRows * n * split, a.Hq, a.B),
                  kCcThreads, cc_256_smem_bytes(a.d), a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), split > 1 ? a.scratch : nullptr,
      a.B * a.Hq, a.Hq, a.Hk, a.d, a.mask, a.softcap, a.scale, split);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || split == 1) return err;
  dq_combine<<<static_cast<unsigned>((n_q / 4 + 255) / 256), 256, 0, a.stream>>>(
      a.scratch, static_cast<T*>(a.dq), n_q / 4, split, a.scale);
  return static_cast<int>(cudaGetLastError());
}

struct Variant {
  int dtype, d, rows, other, threads, smem_dkdv, smem_dq;
  bool any;  // takes every width up to d with d % 8 == 0 (d = 0: past 128), not d alone
  int (*launch)(const Args&);
  int (*smem_dkdv_of)(int);  // the shared memory of head width D, where it depends on it
  int (*smem_dq_of)(int);
};

// Every instantiation, found by (dtype, D, rows): the launch plan
// (kernels/flash_attention.py kernel_plan_bwd) picks (dtype, D) and, by the
// rule of block_rows, the rows of each kernel's blocks; the other side's
// tile, threads and shared memory are the instantiation's own.  D = 64, 96
// and 128 have their own; every other D with D % 8 == 0 up to 128 takes the
// first `any` row whose width holds it (kernel_width in the plan); bf16
// widths 136-256 the native row (d 256), bf16 past 256 the wide row, and f32
// past 128 the whole-width row (both d = 0; its shared memory depends on D).
constexpr Variant kVariants[] = {
    {1, 64, 64, kTile, 128, dkdv_smem_bytes<64, 1>(), dq_smem_bytes<64, 1>(), false, launch_wgmma<64, false>},
    {1, 64, 128, kTile, 256, dkdv_smem_bytes<64, 2>(), dq_smem_bytes<64, 2>(), false, launch_wgmma<64, false>},
    {1, 96, 64, kTile, 128, dkdv_smem_bytes<96, 1>(), dq_smem_bytes<96, 1>(), false, launch_wgmma<96, false>},
    {1, 96, 128, kTile, 256, dkdv_smem_bytes<96, 2>(), dq_smem_bytes<96, 2>(), false, launch_wgmma<96, false>},
    {1, 128, 64, kTile, 128, dkdv_smem_bytes<128, 1>(), dq_smem_bytes<128, 1>(), false, launch_wgmma<128, false>},
    {1, 128, 128, kTile, 256, dkdv_smem_bytes<128, 2>(), dq_smem_bytes<128, 2>(), false, launch_wgmma<128, false>},
    {0, 64, kCcRows, kCcRows, kCcThreads, cc_smem_bytes<64>(), cc_smem_bytes<64>(), false,
     launch_cc<64, false>},
    {0, 96, kCcRows, kCcRows, kCcThreads, cc_smem_bytes<96>(), cc_smem_bytes<96>(), false,
     launch_cc<96, false>},
    {0, 128, kCcRows, kCcRows, kCcThreads, cc_smem_bytes<128>(), cc_smem_bytes<128>(), false,
     launch_cc<128, false>},
    {1, 64, 64, kTile, 128, dkdv_smem_bytes<64, 1>(), dq_smem_bytes<64, 1>(), true, launch_wgmma<64, true>},
    {1, 64, 128, kTile, 256, dkdv_smem_bytes<64, 2>(), dq_smem_bytes<64, 2>(), true, launch_wgmma<64, true>},
    {1, 128, 64, kTile, 128, dkdv_smem_bytes<128, 1>(), dq_smem_bytes<128, 1>(), true, launch_wgmma<128, true>},
    {1, 128, 128, kTile, 256, dkdv_smem_bytes<128, 2>(), dq_smem_bytes<128, 2>(), true, launch_wgmma<128, true>},
    {0, 64, kCcRows, kCcRows, kCcThreads, cc_smem_bytes<64>(), cc_smem_bytes<64>(), true,
     launch_cc<64, true>},
    {0, 128, kCcRows, kCcRows, kCcThreads, cc_smem_bytes<128>(), cc_smem_bytes<128>(), true,
     launch_cc<128, true>},
    {1, 0, 64, kTile, 128, wide_smem_bytes(1024), wide_smem_bytes(0), true, launch_wide_wgmma},
    {0, 0, kCcRows, kCcRows, kCcThreads, 0, 0, true, launch_cc_256, cc_256_smem_bytes,
     cc_256_smem_bytes},
    {1, kNatCols, 64, kTile, kNatThreads, dkdv_256_smem_bytes(), dq_256_smem_bytes(), true,
     launch_wgmma_256},
};

// Whether row x runs head width D of dtype: bf16 widths 136-256 the native
// row (d 256: dK/dV blocks of 64 keys, dQ blocks of 128 queries, either
// asked for), bf16 past 256 the wide row and f32 past 128 the whole-width
// row (both d 0), narrower ones as the table's comment says.
bool takes(const Variant& x, int dtype, int D, int rows) {
  if (D > kNatCols || (D > 128 && dtype == 0)) return x.d == 0 && (rows < 0 || x.rows == rows);
  if (D > 128) return x.d == kNatCols && (rows < 0 || rows == 64 || rows == 128);
  return x.d != 0 && x.d <= 128 && (x.any ? D <= x.d : D == x.d) && (rows < 0 || x.rows == rows);
}

const Variant* find(int dtype, int D, int rows) {
  if (D < 8 || D % 8 != 0) return nullptr;
  for (const Variant& x : kVariants)
    if (x.dtype == dtype && takes(x, dtype, D, rows)) return &x;
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
  *smem_dkdv = x->smem_dkdv_of != nullptr ? x->smem_dkdv_of(D) : x->smem_dkdv;
  *smem_dq = x->smem_dq_of != nullptr ? x->smem_dq_of(D) : x->smem_dq;
  return 0;
}

// The own rows of the (b) and (c) blocks flash_attention_bwd launches for
// these shapes (D the head width it is given) on a card of n_sm SMs (the
// launch reads its card's count).
extern "C" int flash_attention_bwd_blocks(int B, int Hq, int Hk, int Sq, int Sk, int D,
                                          int dtype, int n_sm, int* dkdv_rows, int* dq_rows) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  block_rows(dtype, B, Hq, Hk, Sq, Sk, D, n_sm, dkdv_rows, dq_rows);
  return 0;
}

// q, o, dout, dq [B, Hq, Sq, D]; k, v, dk, dv [B, Hk, Sk, D]; lse and the
// scratch delta [B, Hq, Sq] f32.  window < 0: no sliding window.  dq_split
// (the launch plan's; 1 for bf16): f32 dQ blocks split each query block's
// keys dq_split ways and a fourth launch adds the splits up, through
// scratch: f32, dq_split * B * Hq * Sq * D floats (null when dq_split is 1).
// dkdv_split (the plan's; 1 but for the whole-width kernels past 128
// columns): the dK/dV shares, of a GQA group's heads (bf16 136-256) or of a
// key block's query tiles (f32), whose f32 parts go through scratch, 2 *
// dkdv_split * B * Hk * Sk * D floats after those of the dQ split.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, float* scratch, int B, int Hq, int Hk,
                                   int Sq, int Sk, int D, int dtype, int causal, int window,
                                   float softcap, float scale, int dq_split, int dkdv_split,
                                   void* stream) {
  const Variant* x = find(dtype, D, -1);
  if (x == nullptr || (dtype != 0 && dq_split != 1) ||
      (x->launch != launch_wgmma_256 && x->launch != launch_cc_256 && dkdv_split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hk, D,
               Mask{Sq, Sk, causal, window}, softcap, scale, scratch, dq_split, dkdv_split,
               static_cast<cudaStream_t>(stream)};
  return x->launch(a);
}

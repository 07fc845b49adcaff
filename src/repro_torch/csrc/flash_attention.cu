// Flash attention (forward), hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py:99 flash_attention_pallas, the
// TPU kernel of the JAX package (body _flash_kernel).  For q [B, Hq, Sq, D]
// and k, v [B, Hk, Sk, D], query head h reads kv head h / (Hq / Hk) (GQA, no
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
// Output in the input type.  On request (a non-null lse) also the row's
// log-sum-exp in natural-log units, f32 [B, Hq, Sq]: lse = m + log(l) over
// the capped, masked logits, +inf for a row whose keys are all masked (so
// exp(s - lse) is 0 there).  The backward (flash_attention_bwd.cu) reads it;
// serving passes null and writes nothing more.
//
// What bounds it.  Attention does 4 * D operations per valid (query, key)
// pair and moves q, k, v and o once: at the serving prefill (Sq = Sk = 512,
// D = 128) that is ~128 operations per byte, and at 8192 tokens ~2,000, so
// the H100 is bound by arithmetic, not by its 3.35 TB/s, at every shape the
// serving path gives it.  For bf16 that arithmetic belongs on the tensor
// cores (989 TFLOP/s); the CUDA cores give 67 TFLOP/s in f32, fed from
// shared memory at 128 bytes a clock an SM against 128 FMAs: each operand
// read from shared memory has to feed several FMAs from registers, and the
// short prompts of the f32 paths (a few query tiles a head) have to be cut
// finer than query tiles to fill 132 SMs.
//
// Two kernels up to 128 columns; the launch plan
// (kernels/flash_attention.py kernel_plan) picks one by dtype, and its
// query tile; the entry point finds the instantiation, which brings its own
// key tile, threads and shared memory (flash_attention_geometry reports
// them):
//
// * bf16: flash_fwd_wgmma<D, WG>, on the tensor cores.  A block of WG
//   warpgroups (128 threads each) owns 64 * WG query rows, 64 per
//   warpgroup, and loops over key tiles of 128.
//   - TMA: one thread loads Q once and each K and V tile into a ring of two
//     shared-memory stages, completing on mbarriers, so tile j + 1 is in
//     flight while tile j is computed; an "empty" mbarrier per stage, on
//     which every consumer warp arrives after its P . V, lets the stage be
//     refilled.  The maps are 3-D over [B * H, S, D]: rows past S (the
//     ragged edges of Sq and Sk) are zero-filled by the hardware, never
//     read from the next head.  A box is 64 columns (128 bytes, the most the
//     128-byte swizzle takes), so D = 128 loads as two boxes and D = 96 as
//     two with columns 96-127 zero-filled.
//   - Narrow and in-between widths: every D with D % 8 == 0 up to 128 runs.
//     64, 96 and 128 have instantiations of their own; any other D runs the
//     instantiation of its class (kAny: 64 columns for D < 64, 128 for
//     64 < D < 128) with D read at run time.  The tensor maps have D
//     columns, so TMA zero-fills the box's columns past D (a box wider than
//     the tensor, as the SSD kernel's P and N of 16 load); S = Q K^T stops
//     at the first 16-column slice past D, P V runs on the class's columns
//     (zeros past D), and the store writes D columns of each row and no
//     more, so the next row of a contiguous [B, H, S, D] output is never
//     touched.  The scale is the caller's (D^-0.5 of the real D).
//   - S = Q K^T: wgmma m64n128k16, Q and K both K-major from shared memory.
//   - The online softmax in the S accumulator registers: a row's 128
//     columns spread over the 4 threads of a quad, reduced with two
//     shuffles; exp2 with scale * log2(e) folded in; element masks only on
//     the tiles that need them (ragged Sk, the causal diagonal, the
//     window's first tiles); the loop's bounds skip whole tiles, as the
//     TPU kernel's grid does.
//   - O += P V: P goes to bf16 in registers, where the S accumulator's
//     layout is the A-fragment layout of wgmma's register operand; V is
//     [keys, D], MN-major for B (the transpose bit).  O stays in registers
//     for the whole loop, rescaled there by exp(m - m').
//   - Blocks: 128-row tiles (two warpgroups) fill the card at long
//     prompts; when B * Hq * ceil(Sq / 128) < 132 SMs the plan drops to
//     64-row tiles (one warpgroup).  Query tiles run heaviest first.
//   Shared memory at D = 128 and 128-row tiles: Q 32 KB + K 2 x 32 KB +
//   V 2 x 32 KB = 160 KB, one block an SM.  A simple first design: no
//   producer warp of its own, no overlap of one warpgroup's softmax with
//   the other's products beyond what the scheduler finds.
//
// * f32: flash_fwd_f32<D>, on the CUDA cores in f32 FMAs, which its 2e-5
//   tolerance needs (no TF32).  One block of 256 threads per 64-row query
//   tile loops over key tiles of 64; the building blocks are
//   cuda_cores.cuh's.
//   - Loads: 16-byte cp.async, K and V in two stages each, so key tile
//     j + 1 lands while tile j is computed; one __syncthreads a tile (tile
//     in, the last one done), and a __syncwarp between softmax and P V: a
//     warp reads only the rows of P it wrote.  Rows past Sq and Sk and the
//     columns past D are zero-filled.
//   - Register blocks: warp w owns 16 rows of the tile (w % 4) and one half
//     of every key tile (w / 4, 32 keys), with an online softmax and an O
//     of its own; the two halves of each row are put together once, after
//     the loop, half 0's first.  A lane owns 4 rows x 4 keys of S (a row's
//     max and sum reduce over 8 lanes with shuffles) and 4 rows x D / 8
//     columns of O.  For each 16-byte chunk of depth, S = Q K^T reads 4 Q
//     and 4 K chunks, one bank wavefront each (a warp touches 4 Q and 8 K
//     rows, consecutive), for 64 FMAs; O += P V one chunk of 4 P rows and
//     D / 32 V chunks a key (one wavefront each) for 16 D / 8 FMAs.  P is
//     the warp's own (rows and keys), so only the warp waits between
//     softmax and P V.  Row strides are padded by 4 floats (P by 8) against
//     bank conflicts, and each step's loads go out a step ahead of its FMAs.
//   - exp2 with scale * log2(e) folded in; element masks only on the tiles
//     that need them; the loop's bounds skip whole tiles.
//   - Filling the card: blocks are handed out heaviest query tiles first
//     across all heads.  When B * Hq * ceil(Sq / 64) blocks would leave SMs
//     idle, the plan (kernel_plan's split) gives each query tile's keys to
//     up to 16 blocks, at least 2 key tiles each, within one wave; each
//     writes its rows' unnormalised O, m and l into the caller's f32
//     scratch (split x B x Hq x Sq x (D + 2) floats, ~4.3 MB at most as
//     blocks x split <= 132), and fwd_combine puts the splits together in
//     order (split 0 first), so two runs are bitwise equal.
//   - Shared memory: Q, two K and two V stages and P, 183 KB at D = 128 (one
//     block an SM), 103 KB at D = 64.  Other widths than 64, 96 and 128 run
//     flash_fwd_f32<64 or 128, kAny>: the tiles are loaded zero past D, S
//     stops at D, P V at the first multiple of 16 columns at or past it (a
//     16-column tail group, 2 columns a lane, after the full 32-column
//     ones), and the store writes D columns.
//
// * bf16 widths 136-256: flash_fwd_wgmma_256 (below, by its own kernel).
// * bf16 widths past 256 (flash_fwd_wgmma_wide; the column slices and the
//   item ring are flash_wide.cuh's).  A block owns 64 query rows and one
//   slice of w = 128 output columns (O 64 f32 a thread), the slices on the
//   grid's x beside the query tiles.  S is formed over the whole width by
//   ceil(D / 128) pieces of 128 columns (more wgmma k-steps), so it is
//   formed ceil(D / 128) times in all, once a slice: the plan's "slices",
//   its recompute factor.  Key tiles of 64, so that S (32 f32 a thread)
//   and O fit beside each other; items through a ring of three stages of
//   two 64 x 128 tiles (97 KB, two blocks an SM).  A simple first design: a
//   stage is waited for before its products.
// * f32 widths past 128: flash_fwd_f32_256 (the pieces, the ring and the
//   products are flash_wide.cuh's).  What bounds it is the CUDA cores'
//   67 TFLOP/s: 4 D FMAs a (query, key) pair, fed from shared memory.  What
//   held the column-slice design it replaces: S formed once a 128-column
//   slice (slices + 1 full-width products for the function's 2), Q's pieces
//   brought again with every key tile, every item waited for (two stages),
//   and the two key halves of a block each keeping an O and merging at the
//   end.  The design:
//   - A block owns 64 query rows and the whole width: O of 64 x 256 is 64
//     f32 a thread at 256 threads, as the narrow D 128 kernel holds, so S is
//     formed once a key tile.  Past 256 columns the output goes in ceil(D /
//     256) slices of at most 4 pieces of 64 columns (S once a slice).
//   - Warp w owns rows 8w..8w+7 across every key of a tile: a row's max and
//     sum reduce over the 16 lanes that hold it, with no exchange between
//     warps and no merge at the end.  A thread's 4 x 4 block of S (rows
//     8w + 4ly + i, keys lx + 16j) and of each piece of O (columns 4lx..)
//     costs 8 float4 loads for 64 FMAs: 2 rows of Q (one wavefront) and 16
//     consecutive rows of K (two).
//   - Q is loaded once a block into shared memory at the whole width (66.5
//     KB at 256 columns); K and V stream through a ring of four stages of
//     64 x 64 pieces (17 KB each) by cp.async, three items in flight while
//     one is used: a key tile is ceil(D / 64) items of S, the softmax, then
//     one item of V for each of the block's pieces of O.  Past 256 columns
//     Q comes a piece at a time beside K's (items of two pieces).
//   - Short grids: a query tile's keys split over up to 16 blocks, as many
//     as bring the grid to two waves (kernel_plan's wave_split), and
//     fwd_combine adds them up in order (split 0 first), so two runs are
//     bitwise equal; the heaviest query tiles go first.
//   Shared memory at 256 columns: Q 66.5 KB, the ring 68 KB, P 17 KB (150
//   KB, one block an SM; 220 registers, no spill).
// * Head widths off the multiple of 8: the wrapper pads q, k and v with
//   zero columns to the next multiple of 8 and slices the output back
//   (kernels/flash_attention.py), since TMA and cp.async need 16-byte row
//   strides; zero columns add exact zeros to q.k.  The scale is the
//   caller's (D^-0.5 of the real D).
// * The grid: every kernel's (batch, head) pair comes from the grid's y and
//   z, folded where B or Hq passes 65,535 (grid_fold.cuh head_grid).
//
// The C entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (or the error of cudaFuncSetAttribute, or
// the codes kNoEncoder / kEncodeFailed of hopper.cuh) so the Python wrapper
// can raise.  The mbarrier, TMA and wgmma helpers, and the encoding of the
// tensor maps (cuTensorMapEncodeTiled found with dlsym, so the library links
// nothing beyond the runtime), are in hopper.cuh, shared with ssd_scan.cu.

#include <math.h>

#include "cuda_cores.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ===================================================== bf16: tensor cores

constexpr int kBk = 128;  // keys per tile (the N of S = Q K^T)

// Dynamic shared memory of flash_fwd_wgmma<D, WG>: 1 KB to align the base
// to the 128-byte swizzle's 1024-byte pattern, Q, two K and two V stages,
// and the mbarriers.
template <int D, int kWG>
constexpr int wgmma_smem_bytes() {
  constexpr int dp = D <= 64 ? 64 : 128;
  return 1024 + (64 * kWG + 4 * kBk) * dp * 2 + 64;
}

// Wait until at most N committed groups of wgmma of this warpgroup are
// still running (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A shared-memory address the compiler must treat as new at each use, so
// that it builds the wgmma descriptors from it where they are used instead
// of holding every descriptor of the loop in registers (112 of them in the
// native kernel: Q's 16 k-steps, K's of both stages, V's).
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator layout of wgmma m64nN is in hopper.cuh.  kAny: the head
// width is d_run (d_run % 8 == 0, d_run <= D), else D.
template <int D, int kWG, bool kAny>
__global__ void __launch_bounds__(128 * kWG, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int n_heads,
                int Hq, int Hk, int Sq, int Sk, int d_run, int causal, int window,
                float softcap, float scale) {
  const int d = kAny ? d_run : D;
  constexpr int kBq = 64 * kWG;
  constexpr int kDp = D <= 64 ? 64 : 128;  // columns in shared memory
  constexpr int kBoxes = kDp / 64;
  constexpr uint32_t kQBox = kBq * 128;    // bytes of one 64-column box
  constexpr uint32_t kKVBox = kBk * 128;
  constexpr uint32_t kKVTile = kBoxes * kKVBox;
  constexpr int kNo = kDp / 2;             // O accumulator floats a thread
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kBoxes * kQBox;  // stage s at k_s + s * kKVTile
  const uint32_t v_s = k_s + 2 * kKVTile;
  const uint32_t q_full = v_s + 2 * kKVTile;  // then k_full[2], v_full[2], empty[2]
  const uint32_t k_full = q_full + 8, v_full = q_full + 24, empty = q_full + 40;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest query tiles first
  const int qh = head_pair();  // b * Hq + h
  if (qh >= n_heads) return;
  const int h = qh % Hq, b = qh / Hq;
  const int kh = b * Hk + h / (Hq / Hk);
  const int q0 = qt * kBq;
  const int q_rows = min(kBq, Sq - q0);
  const int offset = Sk - Sq;

  // Key tiles this query tile can see: the loop's bounds are the TPU
  // kernel's whole-tile skip.
  const int row_lo = q0 + offset;
  const int row_hi = q0 + q_rows - 1 + offset;
  const int nk = (Sk + kBk - 1) / kBk;
  int kt_hi = nk;
  if (causal) kt_hi = row_hi < 0 ? 0 : min(nk, row_hi / kBk + 1);
  int kt_lo = 0;
  if (window >= 0) {
    const int first_col = row_lo - window + 1;
    kt_lo = first_col <= 0 ? 0 : first_col / kBk;
  }
  const int n_tiles = kt_hi - kt_lo;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWG);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Key tile i of the loop into stage i % 2 (thread 0 only).
  auto load_kv = [&](int i) {
    const int s = i & 1, k0 = (kt_lo + i) * kBk;
    mbar_expect_tx(k_full + 8 * s, kKVTile);
    for (int x = 0; x < kBoxes; ++x)
      tma_load(k_s + s * kKVTile + x * kKVBox, &tk, k_full + 8 * s, 64 * x, k0, kh);
    mbar_expect_tx(v_full + 8 * s, kKVTile);
    for (int x = 0; x < kBoxes; ++x)
      tma_load(v_s + s * kKVTile + x * kKVBox, &tv, v_full + 8 * s, 64 * x, k0, kh);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(q_full, kBoxes * kQBox);
    for (int x = 0; x < kBoxes; ++x)
      tma_load(q_s + x * kQBox, &tq, q_full, 64 * x, q0, qh);
    load_kv(0);
  }

  float acc_o[kNo];
#pragma unroll
  for (int i = 0; i < kNo; ++i) acc_o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4 + offset;  // and row0 + 8
  const uint32_t q_wg = q_s + wg * 64 * 128;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int k0 = (kt_lo + i) * kBk;
    if (tid == 0 && i + 1 < n_tiles) {
      // tile i - 1 used the stage tile i + 1 goes to: wait until every
      // consumer warp is done with it
      if (i >= 1) mbar_wait(empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
      load_kv(i + 1);
    }
    __syncwarp();

    // S = Q K^T
    float acc_s[2 * kBk / 4];
#pragma unroll
    for (int e = 0; e < 2 * kBk / 4; ++e) acc_s[e] = 0.f;  // overwritten (scale-d 0)
    mbar_wait(k_full + 8 * s, parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kAny && 16 * kk >= d) break;     // the slices past d are zeros
      const uint32_t col = (kk % 4) * 32;  // bytes into a 128-byte row
      wgmma_ss_n128(acc_s,
                    gmma_desc(q_wg + (kk / 4) * kQBox + col, 16),
                    gmma_desc(k_s + s * kKVTile + (kk / 4) * kKVBox + col, 16),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_s);

    // scale (log2 units), softcap, mask
    if (softcap > 0.f) {
#pragma unroll
      for (int e = 0; e < 2 * kBk / 4; ++e) acc_s[e] = cap_l2 * tanhf(acc_s[e] * scale_cap);
    } else {
#pragma unroll
      for (int e = 0; e < 2 * kBk / 4; ++e) acc_s[e] *= scale_l2;
    }
    const bool need_mask = k0 + kBk > Sk || (causal && k0 + kBk - 1 > row_lo) ||
                           (window >= 0 && k0 <= row_hi - window);
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < 2 * kBk / 4; ++e) {
        const int col = k0 + 8 * (e / 4) + c_lane + (e & 1);
        const int row = row0 + 8 * ((e / 2) & 1);
        const bool ok = col < Sk && (!causal || col <= row) && (window < 0 || col > row - window);
        acc_s[e] = ok ? acc_s[e] : kNeg;
      }
    }

    // online softmax of rows row0 (r = 0) and row0 + 8 (r = 1)
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int e = 0; e < 2 * kBk / 4; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], acc_s[e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 2 * kBk / 4; ++e) {
      const int r = (e / 2) & 1;
      const float p = acc_s[e] > 0.5f * kNeg ? exp2f(acc_s[e] - m[r]) : 0.f;
      l[r] += p;  // this thread's columns; the quad adds up at the end
      acc_s[e] = p;
    }
    // P as wgmma's A fragment: slice kk (keys 16kk..16kk+15) is the
    // accumulator's blocks 2kk and 2kk + 1
    uint32_t pa[kBk / 4];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      pa[4 * kk + 0] = pack_bf16(acc_s[8 * kk + 0], acc_s[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(acc_s[8 * kk + 2], acc_s[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(acc_s[8 * kk + 4], acc_s[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(acc_s[8 * kk + 6], acc_s[8 * kk + 7]);
    }
#pragma unroll
    for (int e = 0; e < kNo; ++e) acc_o[e] *= alpha[(e / 2) & 1];

    // O += P V
    mbar_wait(v_full + 8 * s, parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint64_t dv = gmma_desc(v_s + s * kKVTile + kk * 16 * 128, kKVBox);
      if constexpr (kDp == 64)
        wgmma_rs_n64(acc_o, pa + 4 * kk, dv);
      else
        wgmma_rs_n128(acc_o, pa + 4 * kk, dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  float inv[2], l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l_row[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 64 * wg + 16 * warp + lane / 4 + 8 * r;
    if (rr < q_rows) {
      // m and l are in log2 units: lse = (m + log2 l) / log2(e)
      if (lse != nullptr && lane % 4 == 0)
        lse[static_cast<size_t>(qh) * Sq + q0 + rr] =
            l_row[r] > 0.f ? (m[r] + log2f(l_row[r])) / kLog2e : INFINITY;
      __nv_bfloat16* orow = o + (static_cast<size_t>(qh) * Sq + q0 + rr) * d + c_lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (kAny && 8 * j >= d) break;  // the row's own d columns only
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv[r], acc_o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
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

template <int D, int kWG, bool kAny>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 float* /*part: f32 only*/, int B, int Hq, int Hk, int Sq, int Sk, int d,
                 int causal, int window, float softcap, float scale, int /*n_split: 1*/,
                 cudaStream_t stream) {
  constexpr int kSmem = wgmma_smem_bytes<D, kWG>();
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<D, kWG, kAny>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, d, Sq, B * Hq, 64 * kWG);
  if (err == 0) err = encode(&tk, k, d, Sk, B * Hk, kBk);
  if (err == 0) err = encode(&tv, v, d, Sk, B * Hk, kBk);
  if (err != 0) return err;
  const dim3 grid = head_grid((Sq + 64 * kWG - 1) / (64 * kWG), Hq, B);
  flash_fwd_wgmma<D, kWG, kAny><<<grid, 128 * kWG, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B * Hq, Hq, Hk, Sq, Sk, d, causal,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ======================================================= f32: CUDA cores
// (the tile loads and products are cuda_cores.cuh's)

// Row stride of the forward's P (floats): the 4 rows a warp reads or
// writes at once fall on 4 different groups of 8 banks.
constexpr int kLdP = kCcRows + 8;

// Dynamic shared memory of flash_fwd_f32<D>: Q, two K and two V stages of
// 64 rows, and P.
template <int D>
constexpr int f32_smem_bytes() {
  return (5 * cc_tile<D>() + kCcRows * kLdP) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Scores in log2 units (scale, then the softcap with kCap), and kNeg where
// the mask hides the pair (kMask: the tile needs element masks): rows
// row + kRS r, keys col + kCS j.  kCap and kMask are template arguments, so
// that a tile without a softcap or a mask runs no tanh and no comparison.
template <bool kCap, bool kMask, int kRS = 4, int kCS = 8>
__device__ __forceinline__ void fwd_scores(float (&sc)[4][4], int row, int col, int Sk,
                                           int causal, int window, float scale_l2, float cap_l2,
                                           float scale_cap) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = kCap ? cap_l2 * tanhf(sc[r][j] * scale_cap) : sc[r][j] * scale_l2;
      if constexpr (kMask) {
        const int c = col + kCS * j, rw = row + kRS * r;
        const bool ok = c < Sk && (!causal || c <= rw) && (window < 0 || c > rw - window);
        x = ok ? x : kNeg;
      }
      sc[r][j] = x;
    }
}

// kAny: the head width is d_run (d_run % 8 == 0, d_run <= D), else D; the
// tiles keep D columns (zeros past d_run) and the store writes d_run.
// n_split > 1: the block takes one key split of one query tile and writes
// its O unnormalised, and its rows' m (log2 units) and l, into part for
// fwd_combine; else O (and lse) directly.
//
// Warp w owns rows 16 (w % 4).. of the query tile and half w / 4 of every
// key tile (32 keys), with an online softmax and an O of its own for them;
// the two halves of each row are put together at the end.  Lane (ly, lx) =
// (lane / 8, lane % 8) owns rows 16 (w % 4) + ly + 4i (i < 4), of S the
// keys 32 (w / 4) + lx + 8j (j < 4), of O the columns 4lx + 32g (+0..3).
template <int D, bool kAny>
__global__ void __launch_bounds__(kCcThreads, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              float* __restrict__ part, int n_heads, int Hq, int Hk, int Sq, int Sk, int d_run,
              int causal, int window, float softcap, float scale, int n_split) {
  const int dw = kAny ? d_run : D;
  const int width = (dw + 15) / 16 * 16;  // the columns acc_quads reads
  const int used_groups = quad_groups(dw) + (quad_tail(dw) ? 1 : 0);
  constexpr int kLd = D + 4;
  constexpr int kTile = cc_tile<D>();
  constexpr int kQuads = D / 8;  // accumulator floats of a row a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile;      // stage s at ks + s * kTile
  float* vs = ks + 2 * kTile;  // stage s at vs + s * kTile
  float* ps = vs + 2 * kTile;

  int rest;
  const int xi = heavy_first(&rest);  // the last query tiles are the heaviest
  if (rest >= n_heads) return;        // rest: the pair b * Hq + h
  const int qt = gridDim.x / n_split - 1 - xi / n_split, sp = xi % n_split;
  const int h = rest % Hq, b = rest / Hq;
  const int qh = rest;
  const int q0 = qt * kCcRows;
  const int q_rows = min(kCcRows, Sq - q0);
  const int offset = Sk - Sq;
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / (Hq / Hk)) * Sk * dw;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = warp >> 2;                              // key half of a tile
  const int row0 = 16 * (warp & 3) + (lane >> 3);          // rows row0 + 4i
  const int key0 = 32 * half + (lane & 7);                 // keys key0 + 8j
  const int col0 = 4 * (lane & 7);                         // columns col0 + 32g

  // Key tiles this query tile can see (the loop's bounds are the TPU
  // kernel's whole-tile skip), cut to split sp's share of the key axis.
  const int row_lo = q0 + offset;
  const int row_hi = q0 + q_rows - 1 + offset;
  const int nk = (Sk + kCcRows - 1) / kCcRows;
  int kt_hi = nk;
  if (causal) kt_hi = row_hi < 0 ? 0 : min(nk, row_hi / kCcRows + 1);
  int kt_lo = 0;
  if (window >= 0) {
    const int first_col = row_lo - window + 1;
    kt_lo = first_col <= 0 ? 0 : first_col / kCcRows;
  }
  const int per = (nk + n_split - 1) / n_split;
  kt_lo = max(kt_lo, sp * per);
  kt_hi = min(kt_hi, (sp + 1) * per);
  const int n_tiles = max(0, kt_hi - kt_lo);

  // key tile i of the loop (K and V) into stage s
  auto load_kv = [&](int i, int s) {
    const int k0 = (kt_lo + i) * kCcRows, rows = min(kCcRows, Sk - k0);
    const size_t at = kv_off + static_cast<size_t>(k0) * dw;
    load_tile_async<D, kAny>(ks + s * kTile, k + at, rows, dw, width);
    load_tile_async<D, kAny>(vs + s * kTile, v + at, rows, dw, width);
  };
  if (n_tiles > 0) {
    load_tile_async<D, kAny>(qs, q + (static_cast<size_t>(qh) * Sq + q0) * dw, q_rows, dw, width);
    load_kv(0, 0);
  }
  cp_async_commit();

  float acc[4][kQuads];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kQuads; ++c) acc[i][c] = 0.f;
  }
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1, k0 = (kt_lo + i) * kCcRows;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every thread is done with tile i - 1
    if (i + 1 < n_tiles) load_kv(i + 1, s ^ 1);  // lands while tile i is computed
    cp_async_commit();

    // S = Q K^T for rows row0 + 4r, keys k0 + key0 + 8j
    float sc[4][4];
    dot_4x4<D, 4, 8>(sc, qs + row0 * kLd, ks + s * kTile + key0 * kLd, dw);

    // scale (log2 units), softcap, mask, then this half's online softmax
    const bool need_mask = k0 + kCcRows > Sk || (causal && k0 + kCcRows - 1 > row_lo) ||
                           (window >= 0 && k0 <= row_hi - window);
    const int row = q0 + row0 + offset, col = k0 + key0;
    if (softcap > 0.f) {
      if (need_mask)
        fwd_scores<true, true>(sc, row, col, Sk, causal, window, scale_l2, cap_l2, scale_cap);
      else
        fwd_scores<true, false>(sc, row, col, Sk, causal, window, scale_l2, cap_l2, scale_cap);
    } else {
      if (need_mask)
        fwd_scores<false, true>(sc, row, col, Sk, causal, window, scale_l2, cap_l2, scale_cap);
      else
        fwd_scores<false, false>(sc, row, col, Sk, causal, window, scale_l2, cap_l2, scale_cap);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float mx = fmaxf(fmaxf(sc[r][0], sc[r][1]), fmaxf(sc[r][2], sc[r][3]));
      const float m_new = fmaxf(m[r], group8_max(mx));
      const float alpha = fast_exp2(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[r][j] > 0.5f * kNeg ? fast_exp2(sc[r][j] - m_new) : 0.f;
        psum += p;
        ps[(row0 + 4 * r) * kLdP + key0 + 8 * j] = p;
      }
      // each thread keeps its own keys' part of l; alpha is the same on the
      // 8 lanes of a row, so the parts add up at the end
      l[r] = alpha * l[r] + psum;
      // only the column groups acc_quads fills (all of them but for kAny)
#pragma unroll
      for (int g = 0; g < D / 32; ++g)
        if (!kAny || g < used_groups)
#pragma unroll
          for (int c = 4 * g; c < 4 * g + 4; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
    // P's rows and keys here are this warp's own, in S and in P V: the warp
    // waits for itself only (V came in with K at the top)
    __syncwarp();

    // O += P V over this half's keys, for rows row0 + 4r, columns col0 + 32g
    acc_quads<D, kAny, 4, kLdP>(acc, ps + row0 * kLdP + 32 * half,
                                vs + s * kTile + 32 * half * kLd + col0, dw,
                                half_end(Sk - k0 - 32 * half));
  }

  // The two halves of each row put together, half 0's first: the warps of
  // half 1 leave m, l and O in the K stages, those of half 0 take them.
#pragma unroll
  for (int r = 0; r < 4; ++r) l[r] = group8_sum(l[r]);
  __syncthreads();  // every warp is done with the tiles
  float* o1 = ks;          // [64, kLd]: half 1's O
  float* ml1 = ks + kTile;  // [64, 2]: half 1's m and l
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int g = 0; g < D / 32; ++g)
        *reinterpret_cast<float4*>(o1 + (row0 + 4 * r) * kLd + col0 + 32 * g) =
            make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]);
      if ((lane & 7) == 0) {
        ml1[2 * (row0 + 4 * r)] = m[r];
        ml1[2 * (row0 + 4 * r) + 1] = l[r];
      }
    }
  }
  __syncthreads();
  if (half == 1) return;

  const size_t rows_all = static_cast<size_t>(n_heads) * Sq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rr = row0 + 4 * r;
    if (rr >= q_rows) continue;
    const float m1 = ml1[2 * rr], l1 = ml1[2 * rr + 1];
    const float mm = fmaxf(m[r], m1);
    const float a0 = fast_exp2(m[r] - mm), a1 = fast_exp2(m1 - mm);
    const float l_row = fmaf(a1, l1, a0 * l[r]);
    const size_t row = static_cast<size_t>(qh) * Sq + q0 + rr;
    float* out;
    float f;
    if (part == nullptr) {
      // m and l are in log2 units: lse = (m + log2 l) / log2(e)
      if (lse != nullptr && (lane & 7) == 0)
        lse[row] = l_row > 0.f ? (mm + log2f(l_row)) / kLog2e : INFINITY;
      out = o + row * dw;
      f = 1.f / fmaxf(l_row, 1e-30f);
    } else {
      const size_t at = static_cast<size_t>(sp) * rows_all + row;
      if ((lane & 7) == 0) {
        float* ml = part + static_cast<size_t>(n_split) * rows_all * dw;
        ml[2 * at] = mm;
        ml[2 * at + 1] = l_row;
      }
      out = part + at * dw;
      f = 1.f;
    }
    // acc's layout (acc_quads): full groups at columns col0 + 32g, then,
    // for a kAny width, a 16-column tail at 32g + 2 (lane % 8)
    const int groups = kAny ? quad_groups(dw) : D / 32;
    const bool tail = kAny && quad_tail(dw);
#pragma unroll
    for (int g = 0; g < D / 32; ++g) {
      const float4 x1 = *reinterpret_cast<const float4*>(o1 + rr * kLd + col0 + 32 * g);
      const float4 y = make_float4(fmaf(a1, x1.x, a0 * acc[r][4 * g]) * f,
                                   fmaf(a1, x1.y, a0 * acc[r][4 * g + 1]) * f,
                                   fmaf(a1, x1.z, a0 * acc[r][4 * g + 2]) * f,
                                   fmaf(a1, x1.w, a0 * acc[r][4 * g + 3]) * f);
      // the row's own dw columns only
      if (g < groups && (!kAny || col0 + 32 * g < dw))
        *reinterpret_cast<float4*>(out + col0 + 32 * g) = y;
      else if (tail && g == groups && 32 * g + 2 * (lane & 7) < dw)
        *reinterpret_cast<float2*>(out + 32 * g + 2 * (lane & 7)) = make_float2(y.x, y.y);
    }
  }
}

// The key splits of flash_fwd_f32 (and flash_fwd_f32_256) put together in
// a fixed order (split 0 first), so two runs are bitwise equal: one warp a
// row, a lane 4 columns of each 128.  part holds [n_split, rows, dw]
// unnormalised O, then [n_split, rows, 2] (m in log2 units, l); a split
// that saw no key of a row has m = kNeg and l = 0, and a row no split saw
// gives 0 and lse +inf.
__global__ void __launch_bounds__(256)
fwd_combine(const float* __restrict__ part, float* __restrict__ o, float* __restrict__ lse,
            int rows, int dw, int n_split) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* ml = part + static_cast<size_t>(n_split) * rows * dw;
  float mx = kNeg;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, ml[2 * (static_cast<size_t>(s) * rows + row)]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t at = static_cast<size_t>(s) * rows + row;
    l = fmaf(exp2f(ml[2 * at] - mx), ml[2 * at + 1], l);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int c = 4 * lane; c < dw; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const size_t at = static_cast<size_t>(s) * rows + row;
      const float w = exp2f(ml[2 * at] - mx);
      const float4 x = *reinterpret_cast<const float4*>(part + at * dw + c);
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
    *reinterpret_cast<float4*>(o + static_cast<size_t>(row) * dw + c) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
  if (lse != nullptr && lane == 0) lse[row] = l > 0.f ? (mx + log2f(l)) / kLog2e : INFINITY;
}

template <int D, bool kAny>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, float* part,
               int B, int Hq, int Hk, int Sq, int Sk, int d, int causal, int window,
               float softcap, float scale, int n_split, cudaStream_t stream) {
  constexpr int kSmem = f32_smem_bytes<D>();
  if (n_split < 1 || n_split > kMaxSplit || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // once per instantiation, at its first launch (outside any graph capture)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D, kAny>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid = head_grid((Sq + kCcRows - 1) / kCcRows * n_split, Hq, B);
  flash_fwd_f32<D, kAny><<<grid, kCcThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, n_split > 1 ? part : nullptr, B * Hq, Hq, Hk, Sq, Sk, d,
      causal, window, softcap, scale, n_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 1) return err;
  const int rows = B * Hq * Sq;
  fwd_combine<<<(rows + 7) / 8, 256, 0, stream>>>(part, static_cast<float*>(o), lse, rows, d,
                                                  n_split);
  return static_cast<int>(cudaGetLastError());
}

// ================================================ widths past 128 columns
// (column slices and the item ring: flash_wide.cuh)

// bf16: one warpgroup owns 64 query rows and one slice of 128 output
// columns; key tiles of 64.  A key tile is n_pieces items (Q and K, 128
// columns each: S = Q K^T on wgmma m64n64k16 over the whole width) and one
// item of V's slice (O += P V on the register form, m64n128k16).  The
// online softmax and the masks are the narrow kernel's on a 64-key tile.
__global__ void __launch_bounds__(128, 1)
flash_fwd_wgmma_wide(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int n_heads, int Hq, int Hk, int Sq, int Sk,
                     int d, int causal, int window, float softcap, float scale) {
  constexpr int kB = 64;  // query rows of a block, keys of a tile
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const WideRing ring{base, base + kWideStages * kWideStage};

  const int qh = head_pair();  // b * Hq + h
  if (qh >= n_heads) return;
  const int h = qh % Hq, b = qh / Hq;
  const int kh = b * Hk + h / (Hq / Hk);
  const int n_slices = (d + kSlice - 1) / kSlice;  // also the pieces of S
  const int qt = gridDim.x / n_slices - 1 - static_cast<int>(blockIdx.x) / n_slices;
  const int c0 = static_cast<int>(blockIdx.x) % n_slices * kSlice;  // this block's columns
  const int q0 = qt * kB;
  const int q_rows = min(kB, Sq - q0);
  const int offset = Sk - Sq;

  const int row_lo = q0 + offset;
  const int row_hi = q0 + q_rows - 1 + offset;
  const int nk = (Sk + kB - 1) / kB;
  int kt_hi = nk;
  if (causal) kt_hi = row_hi < 0 ? 0 : min(nk, row_hi / kB + 1);
  int kt_lo = 0;
  if (window >= 0) {
    const int first_col = row_lo - window + 1;
    kt_lo = first_col <= 0 ? 0 : first_col / kB;
  }
  const int per_tile = n_slices + 1;
  const int n_items = (kt_hi - kt_lo) * per_tile;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) ring.init(4);
  __syncthreads();

  // item j: piece p < n_slices of Q and K, or (p == n_slices) V's slice
  auto load = [&](int j) {
    const int p = j % per_tile, k0 = (kt_lo + j / per_tile) * kB;
    if (p < n_slices) {
      const int nb = boxes(d, p * kSlice);
      mbar_expect_tx(ring.full(j), 2 * nb * kWideBox);
      tma_tile(ring.a(j), &tq, ring.full(j), nb, p * kSlice, q0, qh);
      tma_tile(ring.b(j), &tk, ring.full(j), nb, p * kSlice, k0, kh);
    } else {
      const int nb = boxes(d, c0);
      mbar_expect_tx(ring.full(j), nb * kWideBox);
      tma_tile(ring.b(j), &tv, ring.full(j), nb, c0, k0, kh);
    }
  };
  if (tid == 0) ring.refill(-1, n_items, load);

  float acc_o[kSlice / 2];
#pragma unroll
  for (int i = 0; i < kSlice / 2; ++i) acc_o[i] = 0.f;
  float acc_s[2 * kB / 4];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const int row0 = q0 + 16 * warp + lane / 4 + offset;  // and row0 + 8

  for (int i = 0; i < n_items; ++i) {
    if (tid == 0) ring.refill(i, n_items, load);
    __syncwarp();
    const int p = i % per_tile, k0 = (kt_lo + i / per_tile) * kB;
    mbar_wait(ring.full(i), ring.parity(i));
    __syncwarp();
    if (p < n_slices) {
      piece_item(acc_s, ring, i, min(kSlice, d - p * kSlice), p == 0);  // S (+)= Q K^T
    } else {
      // scale (log2 units), softcap, mask, online softmax, O += P V
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < 2 * kB / 4; ++e) acc_s[e] = cap_l2 * tanhf(acc_s[e] * scale_cap);
      } else {
#pragma unroll
        for (int e = 0; e < 2 * kB / 4; ++e) acc_s[e] *= scale_l2;
      }
      const bool need_mask = k0 + kB > Sk || (causal && k0 + kB - 1 > row_lo) ||
                             (window >= 0 && k0 <= row_hi - window);
      if (need_mask) {
#pragma unroll
        for (int e = 0; e < 2 * kB / 4; ++e) {
          const int col = k0 + 8 * (e / 4) + c_lane + (e & 1);
          const int row = row0 + 8 * ((e / 2) & 1);
          const bool ok = col < Sk && (!causal || col <= row) && (window < 0 || col > row - window);
          acc_s[e] = ok ? acc_s[e] : kNeg;
        }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int e = 0; e < 2 * kB / 4; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], acc_s[e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[kB / 4];
#pragma unroll
      for (int e = 0; e < 2 * kB / 4; e += 2) {
        const int r = (e / 2) & 1;
        const float p0 = acc_s[e] > 0.5f * kNeg ? exp2f(acc_s[e] - m[r]) : 0.f;
        const float p1 = acc_s[e + 1] > 0.5f * kNeg ? exp2f(acc_s[e + 1] - m[r]) : 0.f;
        l[r] += p0 + p1;
        pa[e / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int e = 0; e < kSlice / 2; ++e) acc_o[e] *= alpha[(e / 2) & 1];
      wgmma_fence();
      piece_xb(acc_o, pa, ring.b(i));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_o);
    }
    ring.release(i);
  }

  float inv[2], l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l_row[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 16 * warp + lane / 4 + 8 * r;
    if (rr >= q_rows) continue;
    if (c0 == 0 && lse != nullptr && lane % 4 == 0)
      lse[static_cast<size_t>(qh) * Sq + q0 + rr] =
          l_row[r] > 0.f ? (m[r] + log2f(l_row[r])) / kLog2e : INFINITY;
    __nv_bfloat16* orow = o + (static_cast<size_t>(qh) * Sq + q0 + rr) * d + c0 + c_lane;
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      if (c0 + 8 * j >= d) break;  // the row's own d columns only
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv[r], acc_o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

int launch_wgmma_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                      float* /*part: f32 only*/, int B, int Hq, int Hk, int Sq, int Sk, int d,
                      int causal, int window, float softcap, float scale, int /*n_split: 1*/,
                      cudaStream_t stream) {
  constexpr int kSmem = wide_smem_bytes(0);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, d, Sq, B * Hq, 64);
  if (err == 0) err = encode(&tk, k, d, Sk, B * Hk, 64);
  if (err == 0) err = encode(&tv, v, d, Sk, B * Hk, 64);
  if (err != 0) return err;
  const dim3 grid = head_grid((Sq + 63) / 64 * ((d + kSlice - 1) / kSlice), Hq, B);
  flash_fwd_wgmma_wide<<<grid, 128, kSmem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                                     lse, B * Hq, Hq, Hk, Sq, Sk, d, causal,
                                                     window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// f32: flash_fwd_f32_256, a block of 64 query rows over the whole width
// (the design is in this file's header; the pieces, the ring and the
// products are flash_wide.cuh's).
//
// Dynamic shared memory: the ring's stages (a piece of K or V, and beside
// K's a piece of Q where Q is not resident), Q at the whole width where it
// is (f32_resident), and P.
constexpr int f32_256_smem_bytes(int d) {
  const int stage = (f32_resident(d) ? 1 : 2) * kCcRows * kLdPiece;
  const int own = f32_resident(d) ? kCcRows * f32_ld(d) : 0;
  return (kF32Stages * stage + own + kCcRows * kLdS) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Warp w owns rows 8w..8w+7 of the query tile across every key of a tile,
// with one online softmax and one O for them: lane (ly, lx) = (lane / 16,
// lane % 16) owns rows 8w + 4ly + i (i < 4), of S the keys lx + 16j (j <
// 4), of O the columns 4lx..4lx+3 of each of the block's pieces.  A key
// tile is n_pieces items of S (K's piece p, and Q's where Q is not
// resident: S += Q_p K_p^T), the softmax after the last, then one item of
// V for each of the block's own pieces g (O_g += P V_g).  Key splits as
// the narrow kernel's, fwd_combine putting them together.
__global__ void __launch_bounds__(kCcThreads, 1)
flash_fwd_f32_256(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  float* __restrict__ part, int n_heads, int Hq, int Hk, int Sq, int Sk, int d,
                  int causal, int window, float softcap, float scale, int n_split) {
  constexpr int kOwn = kF32Cols / kPiece;  // pieces of O a block holds, at most
  const bool res = f32_resident(d);
  const int n_pieces = f32_pieces(d), n_slices = f32_slices(d);
  const int stage = (res ? 1 : 2) * kCcRows * kLdPiece;
  const int ldq = res ? f32_ld(d) : kLdPiece;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // stage s at ring + s * stage
  float* qs = ring + kF32Stages * stage;          // Q at the whole width (res)
  float* ps = qs + (res ? kCcRows * ldq : 0);     // P: [query][key]

  int rest;
  const int xi = heavy_first(&rest);  // the last query tiles are the heaviest
  if (rest >= n_heads) return;        // rest: the pair b * Hq + h
  const int per = n_slices * n_split;
  const int qt = gridDim.x / per - 1 - xi / per, sp = xi % n_split;
  const int g0 = xi % per / n_split * f32_slice_pieces(d);  // the block's first piece
  const int n_own = min(f32_slice_pieces(d), n_pieces - g0);
  const int h = rest % Hq, b = rest / Hq, qh = rest;
  const int q0 = qt * kCcRows;
  const int q_rows = min(kCcRows, Sq - q0);
  const int offset = Sk - Sq;
  const size_t kv_off = (static_cast<size_t>(b) * Hk + h / (Hq / Hk)) * Sk * d;
  const float* q_tile = q + (static_cast<size_t>(qh) * Sq + q0) * d;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = 8 * warp + 4 * (lane >> 4);  // rows row0 + i
  const int lx = lane & 15;                      // keys lx + 16j, columns 4lx + 64g

  const int row_lo = q0 + offset;
  const int row_hi = q0 + q_rows - 1 + offset;
  const int nk = (Sk + kCcRows - 1) / kCcRows;
  int kt_hi = nk;
  if (causal) kt_hi = row_hi < 0 ? 0 : min(nk, row_hi / kCcRows + 1);
  int kt_lo = 0;
  if (window >= 0) {
    const int first_col = row_lo - window + 1;
    kt_lo = first_col <= 0 ? 0 : first_col / kCcRows;
  }
  const int per_split = (nk + n_split - 1) / n_split;
  kt_lo = max(kt_lo, sp * per_split);
  kt_hi = min(kt_hi, (sp + 1) * per_split);
  const int per_tile = n_pieces + n_own;
  const int n_items = max(0, kt_hi - kt_lo) * per_tile;

  // item j into stage s: piece p < n_pieces of K (and of Q unless it is
  // resident), else V's piece g0 + p - n_pieces
  auto load = [&](int j, int s) {
    const int p = j % per_tile, k0 = (kt_lo + j / per_tile) * kCcRows;
    const int c = (p < n_pieces ? p : g0 + p - n_pieces) * kPiece;
    float* a = ring + s * stage;
    load_f32_piece<kCcRows>(a, (p < n_pieces ? k : v) + kv_off + static_cast<size_t>(k0) * d + c,
                            d, min(kCcRows, Sk - k0), d - c);
    if (!res && p < n_pieces)
      load_f32_piece<kCcRows>(a + kCcRows * kLdPiece, q_tile + c, d, q_rows, d - c);
  };
  if (res && n_items > 0) load_f32_rows<kCcRows>(qs, ldq, q_tile, d, q_rows, d, ldq - 4);
#pragma unroll
  for (int j = 0; j < kF32Stages - 1; ++j) {
    if (j < n_items) load(j, j);
    cp_async_commit();
  }

  float acc[kOwn][4][4];  // [piece][row][column]
  float m[4], l[4], sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kOwn; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][i][e] = 0.f;
  }
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;

  for (int i = 0; i < n_items; ++i) {
    const int p = i % per_tile, k0 = (kt_lo + i / per_tile) * kCcRows;
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // item i is in; every thread is done with item i - 1
    if (i + kF32Stages - 1 < n_items) load(i + kF32Stages - 1, (i + kF32Stages - 1) % kF32Stages);
    cp_async_commit();  // (empty past the last item: the wait's count stays right)
    const float* a = ring + (i % kF32Stages) * stage;
    if (p < n_pieces) {
      // S += Q K^T over piece p: rows row0 + i, keys k0 + lx + 16j
      if (p == 0) zero_block(sc);
      const float* qp = res ? qs + p * kPiece : a + kCcRows * kLdPiece;
      dot_piece<4, 4, 1, 16>(sc, qp + row0 * ldq, ldq, a + lx * kLdPiece, kLdPiece,
                             min(kPiece, d - p * kPiece));
      if (p < n_pieces - 1) continue;
      // the whole width is in: scale (log2 units), softcap, mask, then the
      // rows' online softmax (a row's 64 keys are its 16 lanes')
      const bool need_mask = k0 + kCcRows > Sk || (causal && k0 + kCcRows - 1 > row_lo) ||
                             (window >= 0 && k0 <= row_hi - window);
      const int row = q0 + row0 + offset, col = k0 + lx;
      if (softcap > 0.f) {
        if (need_mask)
          fwd_scores<true, true, 1, 16>(sc, row, col, Sk, causal, window, scale_l2, cap_l2,
                                        scale_cap);
        else
          fwd_scores<true, false, 1, 16>(sc, row, col, Sk, causal, window, scale_l2, cap_l2,
                                         scale_cap);
      } else {
        if (need_mask)
          fwd_scores<false, true, 1, 16>(sc, row, col, Sk, causal, window, scale_l2, cap_l2,
                                         scale_cap);
        else
          fwd_scores<false, false, 1, 16>(sc, row, col, Sk, causal, window, scale_l2, cap_l2,
                                          scale_cap);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float mx = fmaxf(fmaxf(sc[r][0], sc[r][1]), fmaxf(sc[r][2], sc[r][3]));
        const float m_new = fmaxf(m[r], group16_max(mx));
        const float alpha = fast_exp2(m[r] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pr = sc[r][j] > 0.5f * kNeg ? fast_exp2(sc[r][j] - m_new) : 0.f;
          psum += pr;
          ps[(row0 + r) * kLdS + lx + 16 * j] = pr;
        }
        // each thread keeps its own keys' part of l; alpha is the same on
        // the 16 lanes of a row, so the parts add up at the end
        l[r] = alpha * l[r] + psum;
#pragma unroll
        for (int g = 0; g < kOwn; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][r][e] *= alpha;
        m[r] = m_new;
      }
      __syncwarp();  // P's rows are this warp's own, where written and read
      continue;
    }
    // O_g += P V_g over the tile's keys, rows row0 + i, columns 4lx of piece g
    const int g = p - n_pieces, k_end = rows_end(Sk - k0);
#pragma unroll
    for (int gg = 0; gg < kOwn; ++gg)
      if (gg == g)
        acc_piece<4, 1>(acc[gg], ps + row0 * kLdS, kLdS, a + 4 * lx, kLdPiece, k_end);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) l[r] = group16_sum(l[r]);
  const size_t rows_all = static_cast<size_t>(n_heads) * Sq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rr = row0 + r;
    if (rr >= q_rows) continue;
    const size_t row = static_cast<size_t>(qh) * Sq + q0 + rr;
    float* out;
    float f;
    if (part == nullptr) {
      // m and l are in log2 units: lse = (m + log2 l) / log2(e)
      if (g0 == 0 && lse != nullptr && lx == 0)
        lse[row] = l[r] > 0.f ? (m[r] + log2f(l[r])) / kLog2e : INFINITY;
      out = o + row * d;
      f = 1.f / fmaxf(l[r], 1e-30f);
    } else {
      const size_t at = static_cast<size_t>(sp) * rows_all + row;
      if (g0 == 0 && lx == 0) {
        float* ml = part + static_cast<size_t>(n_split) * rows_all * d;
        ml[2 * at] = m[r];
        ml[2 * at + 1] = l[r];
      }
      out = part + at * d;
      f = 1.f;
    }
#pragma unroll
    for (int g = 0; g < kOwn; ++g) {
      const int c = (g0 + g) * kPiece + 4 * lx;
      if (g < n_own && c < d)  // the row's own d columns only
        *reinterpret_cast<float4*>(out + c) = make_float4(acc[g][r][0] * f, acc[g][r][1] * f,
                                                          acc[g][r][2] * f, acc[g][r][3] * f);
    }
  }
}

int launch_f32_256(const void* q, const void* k, const void* v, void* o, float* lse, float* part,
                   int B, int Hq, int Hk, int Sq, int Sk, int d, int causal, int window,
                   float softcap, float scale, int n_split, cudaStream_t stream) {
  // the most any width asks for (the streamed layout just past kF32Cols)
  constexpr int kMost = f32_256_smem_bytes(kF32Cols) > f32_256_smem_bytes(kF32Cols + 8)
                            ? f32_256_smem_bytes(kF32Cols)
                            : f32_256_smem_bytes(kF32Cols + 8);
  if (n_split < 1 || n_split > kMaxSplit || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_256, cudaFuncAttributeMaxDynamicSharedMemorySize, kMost);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid = head_grid((Sq + kCcRows - 1) / kCcRows * f32_slices(d) * n_split, Hq, B);
  flash_fwd_f32_256<<<grid, kCcThreads, f32_256_smem_bytes(d), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, n_split > 1 ? part : nullptr, B * Hq, Hq, Hk, Sq, Sk, d,
      causal, window, softcap, scale, n_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 1) return err;
  const int rows = B * Hq * Sq;
  fwd_combine<<<(rows + 7) / 8, 256, 0, stream>>>(part, static_cast<float*>(o), lse, rows, d,
                                                  n_split);
  return static_cast<int>(cudaGetLastError());
}

// ============================== bf16 widths 136-256: the native kernel
//
// flash_fwd_wgmma_256<WG>: a block of 64 WG query rows and the head's
// whole width (up to 256 columns: O of 64 x 256 f32 in one warpgroup's
// registers, 128 a thread, so no slices), key tiles of 64.  WG warpgroups
// own 64 query rows each and share every K and V tile (128-row blocks of
// two, or 64-row blocks of one where those would leave SMs idle, as the
// narrow kernel's rule picks); thread 0
// issues the TMA loads: Q once for the block, each key tile's K and V into
// two stages, each stage with a full and an empty mbarrier for K and for
// V (K_{i+1} at the top of tile i, V_{i+1} as soon as V_{i-1} is
// released).  No producer warp of its own: with one (or a producer
// warpgroup handing its registers on by setmaxnreg) ptxas (CUDA 12.8) gave
// the block 168 registers a thread and spilled O; 256 threads leave 255.
// S = Q K^T is formed once a key tile over the whole width (m64n64k16, 16
// k-steps at 256), O += P V on m64n256k16 (on m64n64k16 a 64-column box
// where fewer than four boxes hold the width).  A warpgroup overlaps the
// softmax of tile i with the P V of tile i - 1: it issues S_i and then
// P_{i-1} V_{i-1}, waits for S_i alone (wgmma_wait<1>), forms P_i, and only
// then waits for the product and rescales O by exp(m_{i-1} - m_i).
// Shared memory at 128 rows: Q 64 KB, K and V 2 x 32 KB each: 197,760
// bytes, one block an SM (164,992 at 64 rows).  Widths below 256 load ceil(d / 64) boxes of each tile; S
// stops at the first 16-column slice past d, and the columns of O past
// the loaded boxes (never stored) read stale shared memory.
constexpr int kNatCols = 256;               // columns of O and of a tile
constexpr int kNatBoxes = kNatCols / 64;    // 64-column boxes
constexpr int kNatBk = 64;                  // keys a tile
constexpr uint32_t kNatKBox = 64 * 128;     // a 64-row box of K or V
constexpr uint32_t kNatKTile = kNatBoxes * kNatKBox;

// 1 KB of alignment, Q of 64 WG rows, two stages of K and of V, nine
// mbarriers.
template <int kWG>
constexpr int native_smem_bytes() {
  return 1024 + static_cast<int>(kNatBoxes * 64 * kWG * 128 + 4 * kNatKTile) + 128;
}

template <int kWG>
__global__ void __launch_bounds__(128 * kWG, 1)
flash_fwd_wgmma_256(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int n_heads, int Hq, int Hk, int Sq, int Sk, int d,
                    int causal, int window, float softcap, float scale) {
  constexpr int kBq = 64 * kWG;               // query rows of a block
  constexpr uint32_t kNatQBox = kBq * 128;    // a box of Q
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kNatBoxes * kNatQBox;  // stage s at k_s + s * kNatKTile
  const uint32_t v_s = k_s + 2 * kNatKTile;
  const uint32_t q_full = v_s + 2 * kNatKTile;  // then k_full[2], v_full[2], k_empty[2], v_empty[2]
  const uint32_t k_full = q_full + 8, v_full = q_full + 24;
  const uint32_t k_empty = q_full + 40, v_empty = q_full + 56;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest query tiles first
  const int qh = head_pair();                 // b * Hq + h
  if (qh >= n_heads) return;
  const int h = qh % Hq, b = qh / Hq;
  const int kh = b * Hk + h / (Hq / Hk);
  const int q0 = qt * kBq;
  const int q_rows = min(kBq, Sq - q0);
  const int offset = Sk - Sq;
  const int nk = (Sk + kNatBk - 1) / kNatBk;
  int kt_hi = nk;
  if (causal) {
    const int row_hi = q0 + q_rows - 1 + offset;
    kt_hi = row_hi < 0 ? 0 : min(nk, row_hi / kNatBk + 1);
  }
  int kt_lo = 0;
  if (window >= 0) {
    const int first_col = q0 + offset - window + 1;
    kt_lo = first_col <= 0 ? 0 : first_col / kNatBk;
  }
  const int n_tiles = kt_hi - kt_lo;
  const int nb = (d + 63) / 64;  // boxes of a row that hold columns of the head

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kWG);  // one arrival per warp
      mbar_init(v_empty + 8 * s, 4 * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Key tile i's K (or V) into stage i % 2 (thread 0 only).
  auto load_k = [&](int i) {
    const int s = i & 1, k0 = (kt_lo + i) * kNatBk;
    mbar_expect_tx(k_full + 8 * s, nb * kNatKBox);
    for (int x = 0; x < nb; ++x)
      tma_load(k_s + s * kNatKTile + x * kNatKBox, &tk, k_full + 8 * s, 64 * x, k0, kh);
  };
  auto load_v = [&](int i) {
    const int s = i & 1, k0 = (kt_lo + i) * kNatBk;
    mbar_expect_tx(v_full + 8 * s, nb * kNatKBox);
    for (int x = 0; x < nb; ++x)
      tma_load(v_s + s * kNatKTile + x * kNatKBox, &tv, v_full + 8 * s, 64 * x, k0, kh);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(q_full, nb * kNatQBox);
    for (int x = 0; x < nb; ++x) tma_load(q_s + x * kNatQBox, &tq, q_full, 64 * x, q0, qh);
    for (int i = 0; i < 2 && i < n_tiles; ++i) {
      load_k(i);
      load_v(i);
    }
  }

  // warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = warp / 4, wwarp = warp % 4;
  float acc_o[kNatCols / 2];
#pragma unroll
  for (int e = 0; e < kNatCols / 2; ++e) acc_o[e] = 0.f;
  float acc_s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc_s[e] = 0.f;  // overwritten (scale-d 0)
  uint32_t pa[16];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float scale_l2 = scale * kLog2e;
  const float cap_l2 = softcap * kLog2e, scale_cap = scale / softcap;
  const int c_lane = 2 * (lane % 4);
  const int wrow_lo = q0 + 64 * wg + offset, wrow_hi = wrow_lo + 63;  // the warpgroup's rows
  const int row0 = wrow_lo + 16 * wwarp + lane / 4;  // this thread's rows: row0, row0 + 8
  const uint32_t q_wg = q_s + wg * 64 * 128;

  // S = Q K_i^T, issued and committed
  auto issue_s = [&](int i) {
    const int s = i & 1;
    mbar_wait(k_full + 8 * s, (i >> 1) & 1);
    const uint32_t ks = opaque(k_s + s * kNatKTile), qs = opaque(q_wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNatCols / 16; ++kk) {
      if (16 * kk >= d) break;  // the slices past d are zeros
      wgmma_ss_n64(acc_s, k_major(qs, kNatQBox, kk), k_major(ks, kNatKBox, kk), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_i with P in pa, issued and committed
  auto issue_pv = [&](int i) {
    const int s = i & 1;
    mbar_wait(v_full + 8 * s, (i >> 1) & 1);
    const uint32_t vs = opaque(v_s + s * kNatKTile);
    wgmma_fence();
    if (nb == kNatBoxes) {
#pragma unroll
      for (int kk = 0; kk < kNatBk / 16; ++kk)
        wgmma_rs_n256(acc_o, pa + 4 * kk, mn_major(vs, kNatKBox, kk));
    } else {  // a box of 64 columns at a time: three boxes hold d (136-192)
#pragma unroll
      for (int kk = 0; kk < kNatBk / 16; ++kk) {
        wgmma_rs_n64_box<0>(acc_o, pa + 4 * kk, mn_major(vs, kNatKBox, kk));
        wgmma_rs_n64_box<1>(acc_o, pa + 4 * kk, mn_major(vs + kNatKBox, kNatKBox, kk));
        wgmma_rs_n64_box<2>(acc_o, pa + 4 * kk, mn_major(vs + 2 * kNatKBox, kNatKBox, kk));
      }
    }
    wgmma_commit();
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // scale (log2 units), softcap, mask and the online softmax of tile i's S
  // (waited for): P into pn, the row maxima moved, l rescaled and summed;
  // alpha = exp(m_old - m_new) for O
  auto softmax = [&](int i, uint32_t (&pn)[16], float (&alpha)[2]) {
    const int k0 = (kt_lo + i) * kNatBk;
    if (softcap > 0.f) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_s[e] = cap_l2 * tanhf(acc_s[e] * scale_cap);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_s[e] *= scale_l2;
    }
    const bool need_mask = k0 + kNatBk > Sk || (causal && k0 + kNatBk - 1 > wrow_lo) ||
                           (window >= 0 && k0 <= wrow_hi - window);
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = k0 + 8 * (e / 4) + c_lane + (e & 1);
        const int row = row0 + 8 * ((e / 2) & 1);
        const bool ok = col < Sk && (!causal || col <= row) && (window < 0 || col > row - window);
        acc_s[e] = ok ? acc_s[e] : kNeg;
      }
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], acc_s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e / 2) & 1;
      const float p0 = acc_s[e] > 0.5f * kNeg ? exp2f(acc_s[e] - m[r]) : 0.f;
      const float p1 = acc_s[e + 1] > 0.5f * kNeg ? exp2f(acc_s[e + 1] - m[r]) : 0.f;
      l[r] += p0 + p1;
      pn[e / 2] = pack_bf16(p0, p1);
    }
  };

  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    float alpha[2];
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(acc_s);
    release(k_empty);
    softmax(0, pa, alpha);  // O is zero: nothing to rescale
    for (int i = 1; i < n_tiles; ++i) {
      // K_{i+1} into the stage K_{i-1} (released at tile i - 1) used
      if (tid == 0 && i + 1 < n_tiles) {
        mbar_wait(k_empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
        load_k(i + 1);
      }
      __syncwarp();
      issue_s(i);
      issue_pv(i - 1);
      wgmma_wait<1>();  // S_i is in; P_{i-1} V_{i-1} may still run
      fence_regs(acc_s);
      release(k_empty + 8 * (i & 1));
      uint32_t pn[16];
      softmax(i, pn, alpha);
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(pa);
      release(v_empty + 8 * ((i - 1) & 1));
      // V_{i+1} into the stage V_{i-1}, released just now, used
      if (tid == 0 && i + 1 < n_tiles) {
        mbar_wait(v_empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
        load_v(i + 1);
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kNatCols / 2; ++e) acc_o[e] *= alpha[(e / 2) & 1];
#pragma unroll
      for (int e = 0; e < 16; ++e) pa[e] = pn[e];
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(pa);
  }

  float inv[2], l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l_row[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 64 * wg + 16 * wwarp + lane / 4 + 8 * r;
    if (rr >= q_rows) continue;
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<size_t>(qh) * Sq + q0 + rr] =
          l_row[r] > 0.f ? (m[r] + log2f(l_row[r])) / kLog2e : INFINITY;
    __nv_bfloat16* orow = o + (static_cast<size_t>(qh) * Sq + q0 + rr) * d + c_lane;
#pragma unroll
    for (int j = 0; j < kNatCols / 8; ++j) {
      if (8 * j >= d) break;  // the row's own d columns only
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv[r], acc_o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int kWG>
int launch_wgmma_256(const void* q, const void* k, const void* v, void* o, float* lse,
                     float* /*part: f32 only*/, int B, int Hq, int Hk, int Sq, int Sk, int d,
                     int causal, int window, float softcap, float scale, int /*n_split: 1*/,
                     cudaStream_t stream) {
  constexpr int kSmem = native_smem_bytes<kWG>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_256<kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, d, Sq, B * Hq, 64 * kWG);
  if (err == 0) err = encode(&tk, k, d, Sk, B * Hk, kNatBk);
  if (err == 0) err = encode(&tv, v, d, Sk, B * Hk, kNatBk);
  if (err != 0) return err;
  const dim3 grid = head_grid((Sq + 64 * kWG - 1) / (64 * kWG), Hq, B);
  flash_fwd_wgmma_256<kWG><<<grid, 128 * kWG, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B * Hq, Hq, Hk, Sq, Sk, d, causal, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ========================================================== entry point

using Launch = int (*)(const void*, const void*, const void*, void*, float*, float*, int, int,
                       int, int, int, int, int, int, float, float, int, cudaStream_t);

struct Variant {
  int dtype, d, block_q, block_k, threads, smem;
  bool any;  // takes every width up to d with d % 8 == 0 (d = 0: past 128), not d alone
  Launch launch;
  int (*smem_of)(int);  // the shared memory of head width D, where it depends on it
};

// Every instantiation, found by (dtype, D, block_q): the launch plan
// (kernels/flash_attention.py kernel_plan) picks those three; the key tile,
// threads and shared memory are the instantiation's own.  D = 64, 96 and
// 128 have their own; every other D with D % 8 == 0 up to 128 takes the
// first `any` row whose width holds it (kernel_width in the plan); bf16
// widths 136-256 the native row (d 256), bf16 past 256 the wide row, and f32
// past 128 the whole-width row (both d = 0; its shared memory depends on D).
constexpr Variant kVariants[] = {
    {1, 64, 64, kBk, 128, wgmma_smem_bytes<64, 1>(), false, launch_wgmma<64, 1, false>},
    {1, 64, 128, kBk, 256, wgmma_smem_bytes<64, 2>(), false, launch_wgmma<64, 2, false>},
    {1, 96, 64, kBk, 128, wgmma_smem_bytes<96, 1>(), false, launch_wgmma<96, 1, false>},
    {1, 96, 128, kBk, 256, wgmma_smem_bytes<96, 2>(), false, launch_wgmma<96, 2, false>},
    {1, 128, 64, kBk, 128, wgmma_smem_bytes<128, 1>(), false, launch_wgmma<128, 1, false>},
    {1, 128, 128, kBk, 256, wgmma_smem_bytes<128, 2>(), false, launch_wgmma<128, 2, false>},
    {0, 64, kCcRows, kCcRows, kCcThreads, f32_smem_bytes<64>(), false, launch_f32<64, false>},
    {0, 96, kCcRows, kCcRows, kCcThreads, f32_smem_bytes<96>(), false, launch_f32<96, false>},
    {0, 128, kCcRows, kCcRows, kCcThreads, f32_smem_bytes<128>(), false, launch_f32<128, false>},
    {1, 64, 64, kBk, 128, wgmma_smem_bytes<64, 1>(), true, launch_wgmma<64, 1, true>},
    {1, 64, 128, kBk, 256, wgmma_smem_bytes<64, 2>(), true, launch_wgmma<64, 2, true>},
    {1, 128, 64, kBk, 128, wgmma_smem_bytes<128, 1>(), true, launch_wgmma<128, 1, true>},
    {1, 128, 128, kBk, 256, wgmma_smem_bytes<128, 2>(), true, launch_wgmma<128, 2, true>},
    {0, 64, kCcRows, kCcRows, kCcThreads, f32_smem_bytes<64>(), true, launch_f32<64, true>},
    {0, 128, kCcRows, kCcRows, kCcThreads, f32_smem_bytes<128>(), true, launch_f32<128, true>},
    {1, 0, 64, 64, 128, wide_smem_bytes(0), true, launch_wgmma_wide},
    {0, 0, kCcRows, kCcRows, kCcThreads, 0, true, launch_f32_256, f32_256_smem_bytes},
    {1, kNatCols, 64, kNatBk, 128, native_smem_bytes<1>(), true, launch_wgmma_256<1>},
    {1, kNatCols, 128, kNatBk, 256, native_smem_bytes<2>(), true, launch_wgmma_256<2>},
};

// Whether row x runs head width D of dtype: bf16 widths 136-256 the native
// row (d 256), bf16 past 256 and f32 past 128 the row of d 0, narrower ones
// as the table's comment says.
bool takes(const Variant& x, int dtype, int D) {
  if (D > kNatCols || (D > 128 && dtype == 0)) return x.d == 0;
  if (D > 128) return x.d == kNatCols;
  return x.d != 0 && x.d <= 128 && (x.any ? D <= x.d : D == x.d);
}

const Variant* find(int dtype, int D, int block_q) {
  if (D < 8 || D % 8 != 0) return nullptr;
  for (const Variant& x : kVariants)
    if (x.dtype == dtype && x.block_q == block_q && takes(x, dtype, D)) return &x;
  return nullptr;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel).  The key tile, threads and shared memory of the instantiation
// (dtype, D, block_q), or cudaErrorInvalidValue if there is none.
extern "C" int flash_attention_geometry(int dtype, int D, int block_q, int* block_k,
                                        int* threads, int* smem) {
  const Variant* x = find(dtype, D, block_q);
  if (x == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *block_k = x->block_k;
  *threads = x->threads;
  *smem = x->smem_of != nullptr ? x->smem_of(D) : x->smem;
  return 0;
}

// window < 0: no sliding window.  lse: null, or f32 [B, Hq, Sq] for the
// rows' log-sum-exp.  (dtype, D, block_q, n_split) are the launch plan's;
// n_split > 1 (f32 only) splits each query tile's keys over n_split blocks
// and puts them together in a second launch, through part: f32 scratch of
// n_split * B * Hq * Sq * (D + 2) floats.  D past 128 runs block_q 64 but
// for the native bf16 kernel's 128.  What no instantiation takes (D % 8 != 0: the wrapper pads
// the head axis) is refused with cudaErrorInvalidValue before anything is
// launched.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, float* part, int B, int Hq, int Hk, int Sq,
                                   int Sk, int D, int dtype, int causal, int window,
                                   float softcap, float scale, int block_q, int n_split,
                                   void* stream) {
  const Variant* x = find(dtype, D, block_q);
  if (x == nullptr || (dtype != 0 && n_split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return x->launch(q, k, v, o, lse, part, B, Hq, Hk, Sq, Sk, D, causal, window, softcap, scale,
                   n_split, static_cast<cudaStream_t>(stream));
}

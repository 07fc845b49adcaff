// Pieces shared by the flash kernels (flash_attention.cu and
// flash_attention_bwd.cu) for head widths past 128 columns.
//
// Column slices.  Attention's outputs split by columns: columns [c0, c0 +
// w) of O, dQ, dK and dV need only the same columns of V, dO, Q or K; the
// full head width enters only through the two contractions S = Q K^T and
// dP = dO V^T.  A kernel for a width past 128 gives each block one slice of
// kSlice output columns (the grid's x counts slices), and forms S (and dP)
// over the whole width in pieces of kSlice columns brought through the same
// ring as every other tile.  So S is formed ceil(D / kSlice) times, once a
// slice (the plans' "slices"): the recompute that keeps a block's
// accumulators at the 128 columns the narrow kernels hold.
//
// A wide kernel's loop runs over items: each key (or query) tile of the
// loop is a fixed sequence of items, a piece of each contraction, then the
// slice's own tile(s).  An item is at most two tiles of 64 rows x 128
// columns.  bf16 items come by TMA into a ring of kWideStages stages of
// two tiles each (64-column boxes, 128-byte swizzle, as hopper.cuh's
// descriptors name them), with a full and an empty mbarrier a stage; f32
// items by cp.async into two stages of two tiles (load_piece_async).
//
// The grid fold (head_grid, head_pair) is grid_fold.cuh's, shared with
// the SSD kernels.

#pragma once

#include "cuda_cores.cuh"
#include "grid_fold.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSlice = 128;          // output columns of a block, columns of a piece
constexpr int kWideStages = 3;       // bf16 ring stages
constexpr uint32_t kWideBox = 64 * 128;         // bytes of a 64-row, 64-column bf16 box
constexpr uint32_t kWideTile = 2 * kWideBox;    // a 64 x 128 bf16 tile
constexpr uint32_t kWideStage = 2 * kWideTile;  // an item: two tiles

// Dynamic shared memory of a bf16 wide kernel: 1 KB to align the ring to
// the swizzle's 1024-byte pattern, the ring, 64 bytes of mbarriers (full
// and empty of each stage), and `extra` bytes after them.
__host__ __device__ constexpr int wide_smem_bytes(int extra) {
  return 1024 + kWideStages * static_cast<int>(kWideStage) + 64 + extra;
}

// The bf16 ring of a wide kernel: item i sits in stage i % kWideStages,
// tiles a(i) and b(i); its full barrier completes when TMA has written it,
// its empty barrier when every consumer warp is done with it.
struct WideRing {
  uint32_t base, bars;  // ring, then kWideStages full and kWideStages empty barriers
  __device__ __forceinline__ uint32_t a(int i) const {
    return base + (i % kWideStages) * kWideStage;
  }
  __device__ __forceinline__ uint32_t b(int i) const { return a(i) + kWideTile; }
  __device__ __forceinline__ uint32_t full(int i) const { return bars + 8 * (i % kWideStages); }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return bars + 8 * (kWideStages + i % kWideStages);
  }
  __device__ __forceinline__ uint32_t parity(int i) const { return (i / kWideStages) & 1; }
  // thread 0, before the block's __syncthreads: `consumers` warps free a stage
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
    mbar_init_fence();
  }
  // Thread 0 at the top of item i (i = -1: before the loop): load item
  // i + kWideStages - 1 into the stage item i - 1 used, once every consumer
  // warp is done with it.  load(j) issues item j's TMA loads on full(j).
  template <typename Load>
  __device__ __forceinline__ void refill(int i, int n_items, Load load) const {
    if (i < 0) {
      for (int j = 0; j < kWideStages - 1 && j < n_items; ++j) load(j);
      return;
    }
    const int j = i + kWideStages - 1;
    if (j >= n_items) return;
    if (i >= 1) mbar_wait(empty(i - 1), parity(i - 1));
    load(j);
  }
  // A consumer warp after its last read of item i.
  __device__ __forceinline__ void release(int i) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(i));
  }
};

// Boxes [0, n) of 64 columns of a 64-row tile at column c, row r, head h
// of map into dst (completing on bar, whose transaction count the caller
// set); n is 1 where the tile's columns past 64 lie beyond the head width.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int n, int c, int r, int h) {
  for (int x = 0; x < n; ++x) tma_load(dst + x * kWideBox, map, bar, c + 64 * x, r, h);
}
// The boxes a tile of the columns from c of a head width d needs.
__device__ __forceinline__ int boxes(int d, int c) { return d - c > 64 ? 2 : 1; }

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

// acc (64 x 64) (+)= A B^T over the first w columns (w <= 128) of two 64 x
// 128 tiles, both K-major; acc is overwritten when `first`.
__device__ __forceinline__ void piece_abt(float (&acc)[32], uint32_t a, uint32_t b, int w,
                                          bool first) {
#pragma unroll
  for (int kk = 0; kk < kSlice / 16; ++kk) {
    if (16 * kk >= w) break;
    wgmma_ss_n64(acc, k_major(a, kWideBox, kk), k_major(b, kWideBox, kk), !first || kk > 0);
  }
}

// acc (+)= the product of item i's two tiles over their first w columns
// (overwritten when `first`), waited for.
__device__ __forceinline__ void piece_item(float (&acc)[32], const WideRing& ring, int i, int w,
                                           bool first) {
  if (first) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;  // overwritten (scale-d 0)
  }
  wgmma_fence();
  piece_abt(acc, ring.a(i), ring.b(i), w, first);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// acc (64 x 128) += X B, X (64 x 64) as bf16 A fragments, B a 64 x 128
// tile, MN-major.
__device__ __forceinline__ void piece_xb(float (&acc)[64], const uint32_t (&x)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128(acc, x + 4 * kk, mn_major(b, kWideBox, kk));
}

// ---- f32: a 64 x 128 tile of row stride kLdWide floats
constexpr int kLdWide = kSlice + 4;
constexpr int kWideTileF = kCcRows * kLdWide;  // floats

// Rows [0, rows) of columns [0, w) of an f32 matrix (row r at src + r *
// stride, 16-byte aligned, w % 4 == 0) into a 64 x 128 tile at dst, by
// cp.async; every other element of the tile is zero-filled without a
// read.  The caller commits.
__device__ __forceinline__ void load_piece_async(float* dst, const float* src, int64_t stride,
                                                 int rows, int w) {
#pragma unroll
  for (int it = 0; it < kCcRows * (kSlice / 4) / kCcThreads; ++it) {
    const int e = static_cast<int>(threadIdx.x) + it * kCcThreads;
    const int r = e / (kSlice / 4), c = (e % (kSlice / 4)) * 4;
    const bool in = r < rows && c < w;
    cp_async16(dst + r * kLdWide + c, in ? src + r * stride + c : src, in ? 16 : 0);
  }
}

}  // namespace

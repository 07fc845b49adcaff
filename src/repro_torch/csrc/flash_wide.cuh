// Pieces shared by the flash kernels (flash_attention.cu and
// flash_attention_bwd.cu) for head widths past 128 columns.
//
// bf16 past 256 columns: column slices.  Attention's outputs split by
// columns: columns [c0, c0 + w) of O, dQ, dK and dV need only the same
// columns of V, dO, Q or K; the full head width enters only through the two
// contractions S = Q K^T and dP = dO V^T.  A bf16 kernel for a width past
// 256 gives each block one slice of kSlice output columns (the grid's x
// counts slices), and forms S (and dP) over the whole width in pieces of
// kSlice columns brought through the same ring as every other tile.  So S
// is formed ceil(D / kSlice) times, once a slice (the plans' "slices"): the
// recompute that keeps a block's accumulators at the 128 columns the narrow
// kernels hold.  Its loop runs over items: each key (or query) tile of the
// loop is a fixed sequence of items, a piece of each contraction, then the
// slice's own tile(s).  An item is at most two tiles of 64 rows x 128
// columns, by TMA into a ring of kWideStages stages of two tiles each
// (64-column boxes, 128-byte swizzle, as hopper.cuh's descriptors name
// them), with a full and an empty mbarrier a stage.
//
// f32 past 128 columns: the whole-width kernels on the CUDA cores
// (flash_fwd_f32_256, bwd_dkdv_cc_256, bwd_dq_cc_256; their designs are in
// the two sources' headers).  A head of padded width d is f32_pieces(d)
// pieces of kPiece columns.  A block's accumulators hold at most kF32Cols
// columns (64 f32 a thread at 256 threads), so up to 256 columns a block
// owns the whole width and forms S (and dP) once a tile; past 256 the
// outputs go in f32_slices(d) = ceil(d / 256) slices of f32_slice_pieces(d)
// pieces each.  The rows a block owns (Q in the forward, Q and dO in dQ, K
// and V in dK/dV) stay in shared memory for the whole block up to
// kF32Cols columns (f32_resident); past it they come a piece at a time
// beside the other side's piece.  Everything else streams through a ring
// of kF32Stages stages of cp.async tiles of kPiece columns, an item of one
// (or, beside a piece of the block's own rows, two) tiles a stage.
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

// ---- f32: the whole-width kernels
constexpr int kPiece = 64;             // columns of a piece
constexpr int kLdPiece = kPiece + 4;   // row stride of a piece in the ring (floats)
constexpr int kF32Cols = 256;          // columns of a block's accumulators
constexpr int kF32Stages = 4;          // ring stages

__host__ __device__ constexpr int f32_pieces(int d) { return (d + kPiece - 1) / kPiece; }
__host__ __device__ constexpr int f32_slices(int d) { return (d + kF32Cols - 1) / kF32Cols; }
// The pieces of a slice (the last slice may have fewer): slices as even as
// whole pieces allow, so that no block of the grid owns a sliver.
__host__ __device__ constexpr int f32_slice_pieces(int d) {
  return (f32_pieces(d) + f32_slices(d) - 1) / f32_slices(d);
}
__host__ __device__ constexpr bool f32_resident(int d) { return d <= kF32Cols; }
// Row stride (floats) of a block's own rows held at the whole width: the
// pieces side by side and 4 floats of pad, so that the 16-byte chunks a warp
// reads from 8 consecutive rows fall on 8 different groups of 4 banks.
__host__ __device__ constexpr int f32_ld(int d) { return kPiece * f32_pieces(d) + 4; }

// cp.async of a tile of kRows rows and `cols` columns (a multiple of 4) at
// dst (row stride ld floats): element (r, c) from src[r * stride + c] where
// r < rows and c < w, a zero elsewhere (w, the head width left from the
// tile's first column, is a multiple of 8 or past cols: a 16-byte chunk is
// all in or all out).  The caller commits.
template <int kRows>
__device__ __forceinline__ void load_f32_rows(float* dst, int ld, const float* src, int64_t stride,
                                              int rows, int w, int cols) {
  const int per = cols / 4;
  for (int e = threadIdx.x; e < kRows * per; e += kCcThreads) {
    const int r = e / per, c = (e - r * per) * 4;
    const bool in = r < rows && c < w;
    cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, in ? 16 : 0);
  }
}
// One piece (kPiece columns, row stride kLdPiece) of kRows rows.
template <int kRows>
__device__ __forceinline__ void load_f32_piece(float* dst, const float* src, int64_t stride,
                                               int rows, int w) {
#pragma unroll
  for (int it = 0; it < kRows * (kPiece / 4) / kCcThreads; ++it) {
    const int e = static_cast<int>(threadIdx.x) + it * kCcThreads;
    const int r = e / (kPiece / 4), c = (e % (kPiece / 4)) * 4;
    const bool in = r < rows && c < w;
    cp_async16(dst + r * kLdPiece + c, in ? src + r * stride + c : src, in ? 16 : 0);
  }
}

template <int kI, int kJ>
__device__ __forceinline__ void zero_block(float (&s)[kI][kJ]) {
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
}

// s[i][j] += the dot product of row i * kAS of a (row stride lda) and row
// j * kBS of b (row stride ldb) over their first n columns (a multiple of
// 4; a piece's, or fewer at the head width's edge), a and b pointing at the
// thread's first rows: S = Q K^T, dP = dO V^T and their transposes, a piece
// at a time.  Each step's loads go out a step ahead of its FMAs (the last
// step's read the 4 floats after column n, of the next piece or the pad,
// and drop them); the trip count is a bound, not a break.
template <int kI, int kJ, int kAS, int kBS>
__device__ __forceinline__ void dot_piece(float (&s)[kI][kJ], const float* a, int lda,
                                          const float* b, int ldb, int n) {
  float4 x[kI], y[kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i) x[i] = *reinterpret_cast<const float4*>(a + kAS * i * lda);
#pragma unroll
  for (int j = 0; j < kJ; ++j) y[j] = *reinterpret_cast<const float4*>(b + kBS * j * ldb);
#pragma unroll 2
  for (int c = 0; c < n; c += 4) {
    float4 xn[kI], yn[kJ];
#pragma unroll
    for (int i = 0; i < kI; ++i)
      xn[i] = *reinterpret_cast<const float4*>(a + kAS * i * lda + c + 4);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      yn[j] = *reinterpret_cast<const float4*>(b + kBS * j * ldb + c + 4);
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
#pragma unroll
    for (int i = 0; i < kI; ++i) x[i] = xn[i];
#pragma unroll
    for (int j = 0; j < kJ; ++j) y[j] = yn[j];
  }
}

// acc[i][e] += sum over k < k_end (a multiple of 4) of x[kXS * i][k] *
// y[k][e] (e < 4): x at the thread's first row of a score tile (row stride
// ldx: P, dS or their transposes), y at the thread's 4 columns of a piece
// (row stride ldy): O += P V, dQ += dS K, dV += P^T dO and dK += dS^T Q,
// a piece of columns at a time.  x's loads a step ahead (the last one into
// the pad), y's all issued before a step's FMAs.
template <int kI, int kXS>
__device__ __forceinline__ void acc_piece(float (&acc)[kI][4], const float* x, int ldx,
                                          const float* y, int ldy, int k_end) {
  float4 p[kI];
#pragma unroll
  for (int i = 0; i < kI; ++i) p[i] = *reinterpret_cast<const float4*>(x + kXS * i * ldx);
#pragma unroll 2
  for (int k = 0; k < k_end; k += 4) {
    float4 pn[kI], w[4];
#pragma unroll
    for (int i = 0; i < kI; ++i)
      pn[i] = *reinterpret_cast<const float4*>(x + kXS * i * ldx + k + 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) w[kk] = *reinterpret_cast<const float4*>(y + (k + kk) * ldy);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const float a = kk == 0 ? p[i].x : kk == 1 ? p[i].y : kk == 2 ? p[i].z : p[i].w;
        acc[i][0] = fmaf(a, w[kk].x, acc[i][0]);
        acc[i][1] = fmaf(a, w[kk].y, acc[i][1]);
        acc[i][2] = fmaf(a, w[kk].z, acc[i][2]);
        acc[i][3] = fmaf(a, w[kk].w, acc[i][3]);
      }
#pragma unroll
    for (int i = 0; i < kI; ++i) p[i] = pn[i];
  }
}

}  // namespace

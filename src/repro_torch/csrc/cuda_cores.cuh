// f32 building blocks of the CUDA-core kernels: the flash kernels' f32
// variants (flash_attention.cu's flash_fwd_f32, flash_attention_bwd.cu's
// bwd_dkdv_cc and bwd_dq_cc) and the SSD scan's f32 kernels (ssd_scan.cu,
// ssd_scan_bwd.cu, through ssd_cuda_cores.cuh): cp.async tile loads into
// shared memory, and the register-blocked products of 64-row tiles, all in
// f32 FMAs (no TF32).
//
// A tile is 64 rows of an f32 [rows, d] matrix in shared memory with a row
// stride of D + 4 floats (D the instantiation's width, d <= D the head
// width); its rows past the matrix's edge are zeros, and so are its columns
// from d up to the last one a product reads.  The 4-float pad puts the
// 16-byte chunks that a warp reads from 8 consecutive rows on 8 different
// groups of 4 banks.
//
// A block has 256 threads.  The products take the thread's first rows and
// the row steps of its 4 x 4 block of scores.  In the backward's layout
// (dot_rows, acc_rows) thread (ty, tx), ty = 2 * warp + lane / 16 and
// tx = lane % 16, owns rows 4ty..4ty+3 of every product: of a 64 x 64 score
// tile the columns tx + 16j (j < 4), of a 64 x D accumulator the column
// pairs 2tx + 32g (+0, +1), g < D / 32; a warp's loads touch 2 rows of one
// operand (broadcast) and 16 consecutive rows, or 128 consecutive bytes, of
// the other.  The forward's layout (flash_attention.cu) gives each warp 16
// rows and half the keys of a tile, so that its loads touch 4 and 8
// consecutive rows (acc_quads: 4 columns a chunk).

#pragma once

#include "hopper.cuh"

namespace {

constexpr int kCcRows = 64;         // rows of every tile: queries or keys
constexpr int kCcThreads = 256;
constexpr int kLdS = kCcRows + 4;   // row stride of a 64 x 64 score tile
constexpr int kMaxSplit = 16;       // key splits of one block's rows, at most

// Floats of one 64-row tile of width D.
template <int D>
__host__ __device__ constexpr int cc_tile() {
  return kCcRows * (D + 4);
}

// One 16-byte cp.async into shared memory; with bytes == 0 it writes zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait for every cp.async this thread issued (a __syncthreads after it makes
// every thread's copies visible to the block).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows [0, rows) of src (row stride d) into the tile at dst: cp.async only,
// the caller commits.  kAny: the columns [d, width) are zero-filled (d % 8
// == 0, so a 16-byte chunk is all in or all out) and the columns past width
// (a multiple of 4, the most the products read) are left as they are; else
// d == width == D.
template <int D, bool kAny>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, int rows, int d,
                                                int width) {
  constexpr int kVecs = D / 4;  // 16-byte chunks a row; D / 16 a thread
#pragma unroll
  for (int it = 0; it < kCcRows * kVecs / kCcThreads; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * kCcThreads;
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    if (kAny && c >= width) continue;
    const bool in = r < rows && (!kAny || c < d);
    cp_async16(dst + r * (D + 4) + c, in ? src + static_cast<size_t>(r) * d + c : src,
               in ? 16 : 0);
  }
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22; results
// below 2^-126 flush to 0, which no f32 tolerance of these kernels sees).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s[i][j] = (row kAStep * i of a) . (row kBStep * j of b) over the first n
// columns (n = D, or the head width d under kAny: the columns past it are
// zeros), a and b pointing at the thread's first rows of two tiles, as
// S = Q K^T, dP = dO V^T and their transposes need them.  Each step's
// loads are issued a step ahead of its FMAs (the last step's read the
// row's 4 pad floats, or zeros past d, and drop them), and the trip count
// is a bound, not a break.
template <int D, int kAStep, int kBStep>
__device__ __forceinline__ void dot_4x4(float (&s)[4][4], const float* a, const float* b, int n) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  float4 x[4], y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + kAStep * i * kLd);
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + kBStep * j * kLd);
#pragma unroll 2
  for (int c = 0; c < n; c += 4) {
    float4 xn[4], yn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xn[i] = *reinterpret_cast<const float4*>(a + kAStep * i * kLd + c + 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yn[j] = *reinterpret_cast<const float4*>(b + kBStep * j * kLd + c + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = xn[i];
      y[i] = yn[i];
    }
  }
}

// dot_4x4 in the backward's layout: rows 4ty + i of a, tx + 16j of b.
template <int D>
__device__ __forceinline__ void dot_rows(float (&s)[4][4], const float* a, const float* b, int ty,
                                         int tx, int n) {
  dot_4x4<D, 1, 16>(s, a + 4 * ty * (D + 4), b + tx * (D + 4), n);
}

// acc[i][2g + e] += sum over k < k_end of a[4ty + i][k] * b[k][2tx + 32g + e]
// for the first kG column groups: a a 64 x 64 score tile (row stride kLdS:
// P, dS or their transposes), b a 64-row tile (V, K, dO or Q), as
// O += P V, dQ += dS K, dV += P^T dO and dK += dS^T Q need them.  k_end (a
// multiple of 4) stops at the tile's last valid row: a's columns past it
// are zeros.  A step's loads of a (a step ahead, the last one into the
// pad) and of b are all issued before its FMAs.
template <int D, int kG>
__device__ __forceinline__ void acc_rows_g(float (&acc)[4][D / 16], const float* a,
                                           const float* b, int ty, int tx, int k_end) {
  constexpr int kLd = D + 4;
  const float* ar = a + 4 * ty * kLdS;
  const float* bc = b + 2 * tx;
  float4 x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(ar + i * kLdS);
#pragma unroll 2
  for (int k = 0; k < k_end; k += 4) {
    float4 xn[4];
    float2 y[4][kG];
#pragma unroll
    for (int i = 0; i < 4; ++i) xn[i] = *reinterpret_cast<const float4*>(ar + i * kLdS + k + 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < kG; ++g)
        y[kk][g] = *reinterpret_cast<const float2*>(bc + (k + kk) * kLd + 32 * g);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = kk == 0 ? x[i].x : kk == 1 ? x[i].y : kk == 2 ? x[i].z : x[i].w;
          acc[i][2 * g] = fmaf(p, y[kk][g].x, acc[i][2 * g]);
          acc[i][2 * g + 1] = fmaf(p, y[kk][g].y, acc[i][2 * g + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = xn[i];
  }
}

// acc_rows_g over the column groups that hold the first d columns: all
// D / 32 of them, or (kAny) ceil(d / 32), each count its own straight-line
// loop.  kernel_width sends the kAny widths 72-120 to the 128 class and
// 8-56 to the 64 one, so ceil(d / 32) is D / 32 or one less.
template <int D, bool kAny>
__device__ __forceinline__ void acc_rows(float (&acc)[4][D / 16], const float* a, const float* b,
                                         int ty, int tx, int d, int k_end) {
  if (!kAny || (d + 31) / 32 == D / 32)
    acc_rows_g<D, D / 32>(acc, a, b, ty, tx, k_end);
  else
    acc_rows_g<D, D / 32 - 1>(acc, a, b, ty, tx, k_end);
}

// acc[i][4g + e] += sum over k < k_end of a[kAStep * i][k] * b[k][32g + e]
// for the first kG column groups, and, with kTail, acc[i][4kG + e] for the
// 16 columns 32kG + 2lx + e (e < 2) after them; a points at the thread's
// first row of a score tile of row stride kLdA, b at column 4lx of a 64-row
// tile (lx = lane % 8, the forward's O += P V: a full group's 4 columns are
// one 16-byte chunk, the tail's 2 one 8-byte chunk).  Loads as acc_rows_g.
template <int D, int kG, bool kTail, int kAStep, int kLdA>
__device__ __forceinline__ void acc_quads_g(float (&acc)[4][D / 8], const float* a, const float* b,
                                            int k_end) {
  constexpr int kLd = D + 4;
  // the tail's 8-byte chunk: column 32kG + 2lx of the row b's column 4lx is in
  const float* bt = b - ((threadIdx.x & 7) * 2) + 32 * kG;
  float4 x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + kAStep * i * kLdA);
#pragma unroll 2
  for (int k = 0; k < k_end; k += 4) {
    float4 xn[4], y[4][kG > 0 ? kG : 1];
    float2 yt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xn[i] = *reinterpret_cast<const float4*>(a + kAStep * i * kLdA + k + 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        y[kk][g] = *reinterpret_cast<const float4*>(b + (k + kk) * kLd + 32 * g);
      if constexpr (kTail) yt[kk] = *reinterpret_cast<const float2*>(bt + (k + kk) * kLd);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = kk == 0 ? x[i].x : kk == 1 ? x[i].y : kk == 2 ? x[i].z : x[i].w;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          acc[i][4 * g] = fmaf(p, y[kk][g].x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p, y[kk][g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, y[kk][g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, y[kk][g].w, acc[i][4 * g + 3]);
        }
        if constexpr (kTail) {
          acc[i][4 * kG] = fmaf(p, yt[kk].x, acc[i][4 * kG]);
          acc[i][4 * kG + 1] = fmaf(p, yt[kk].y, acc[i][4 * kG + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = xn[i];
  }
}

// The column groups that hold a head width of d (d % 8 == 0, d <= D): full
// 32-column groups, and a 16-column tail where d % 32 is 16 or less.
__host__ __device__ constexpr int quad_groups(int d) { return d % 32 > 16 ? (d + 31) / 32 : d / 32; }
__host__ __device__ constexpr bool quad_tail(int d) { return d % 32 != 0 && d % 32 <= 16; }

// acc_quads_g with the layout of quad_groups(d) and quad_tail(d) (kAny),
// each its own straight-line loop, or with all D / 32 groups.  A kAny width
// (see acc_rows) has D / 32 - 2 full groups or more.
template <int D, int kG, int kAStep, int kLdA>
__device__ __forceinline__ void acc_quads_upto(int groups, bool tail, float (&acc)[4][D / 8],
                                               const float* a, const float* b, int k_end) {
  if constexpr (kG > D / 32 - 2 && kG > 0) {
    if (groups < kG) {
      acc_quads_upto<D, kG - 1, kAStep, kLdA>(groups, tail, acc, a, b, k_end);
      return;
    }
  }
  if constexpr (kG < D / 32) {
    if (tail) {
      acc_quads_g<D, kG, true, kAStep, kLdA>(acc, a, b, k_end);
      return;
    }
  }
  acc_quads_g<D, kG, false, kAStep, kLdA>(acc, a, b, k_end);
}
template <int D, bool kAny, int kAStep, int kLdA>
__device__ __forceinline__ void acc_quads(float (&acc)[4][D / 8], const float* a, const float* b,
                                          int d, int k_end) {
  if constexpr (kAny)
    acc_quads_upto<D, D / 32, kAStep, kLdA>(quad_groups(d), quad_tail(d), acc, a, b, k_end);
  else
    acc_quads_g<D, D / 32, false, kAStep, kLdA>(acc, a, b, k_end);
}

// Rows [0, valid) of a 64-row tile rounded up to a multiple of 4: the
// k_end of acc_rows.
__device__ __forceinline__ int rows_end(int valid) { return (min(valid, kCcRows) + 3) & ~3; }
// The same for the 32 rows of half a tile.
__device__ __forceinline__ int half_end(int valid) { return (max(0, min(valid, 32)) + 3) & ~3; }

// Wait until at most kPending of the cp.async groups this thread committed
// are still in flight (a __syncthreads after it makes every thread's copies
// visible to the block).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Rows [0, rows) of an f32 matrix of width w (a multiple of 4; row r at
// src + r * stride floats, 16-byte aligned) into dst (row stride ld floats):
// cp.async of 16 bytes, the rows from `valid` on zero-filled without a
// read.  The caller commits.
__device__ __forceinline__ void load_rows_async(float* dst, int ld, const float* src,
                                                int64_t stride, int rows, int valid, int w) {
  const int per = w / 4;
  for (int e = threadIdx.x; e < rows * per; e += kCcThreads) {
    const int r = e / per, c = (e - r * per) * 4;
    const bool in = r < valid;
    cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, in ? 16 : 0);
  }
}

// ---- the SSD kernels' products (ssd_scan.cu, ssd_scan_bwd.cu, f32)
// A block of kCcThreads threads computes a 64 x 16J output tile: thread
// (ty, tx) = (tid / 16, tid % 16) holds rows 4ty + i (i < 4) and columns
// tx + 16j (j < J) in acc[i][j], so warp w holds rows 8w .. 8w + 7.  The
// operands are f32 tiles in shared memory with rows 16 bytes longer than
// their width (a multiple of 4), so a warp's float4 loads from consecutive
// rows fall on distinct banks and its loads of one row's 16 consecutive
// columns are one wavefront.  k ranges are multiples of 4.

template <int J>
__device__ __forceinline__ void zero_tile(float (&acc)[4][J]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum over k in [k0, k1) of a[4ty + i][k] b[k][tx + 16j]:
// a's rows along k (one float4 a row per 4 k), b's rows along the columns.
template <int J>
__device__ __forceinline__ void mm_rows(float (&acc)[4][J], const float* a, int lda,
                                        const float* b, int ldb, int k0, int k1) {
  const float* ar = a + 4 * (threadIdx.x / 16) * lda;
  const float* bc = b + threadIdx.x % 16;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(ar + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float y[J];
#pragma unroll
      for (int j = 0; j < J; ++j) y[j] = bc[(k + kk) * ldb + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = kk == 0 ? x[i].x : kk == 1 ? x[i].y : kk == 2 ? x[i].z : x[i].w;
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(p, y[j], acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum over k in [k0, k1) of at[k][4ty + i] b[k][tx + 16j]: a
// stored transposed, a thread's 4 rows one float4 a k.
template <int J>
__device__ __forceinline__ void mm_cols(float (&acc)[4][J], const float* at, int ldt,
                                        const float* b, int ldb, int k0, int k1) {
  const float* ac = at + 4 * (threadIdx.x / 16);
  const float* bc = b + threadIdx.x % 16;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(ac + k * ldt);
    float y[J];
#pragma unroll
    for (int j = 0; j < J; ++j) y[j] = bc[k * ldb + 16 * j];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      acc[0][j] = fmaf(x.x, y[j], acc[0][j]);
      acc[1][j] = fmaf(x.y, y[j], acc[1][j]);
      acc[2][j] = fmaf(x.z, y[j], acc[2][j]);
      acc[3][j] = fmaf(x.w, y[j], acc[3][j]);
    }
  }
}

// acc[i][j] += sum over k < K of a[4ty + i][k] b[tx + 16j][k]: dot
// products of rows, both along k (float4 loads).
template <int J>
__device__ __forceinline__ void mm_dots(float (&acc)[4][J], const float* a, int lda,
                                        const float* b, int ldb, int K) {
  const float* ar = a + 4 * (threadIdx.x / 16) * lda;
  const float* br = b + (threadIdx.x % 16) * ldb;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 x[4], y[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(ar + i * lda + k);
#pragma unroll
    for (int j = 0; j < J; ++j) y[j] = *reinterpret_cast<const float4*>(br + 16 * j * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// The sum of v over the 16 lanes of a tile row (the lanes of one ty).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's place in a grid whose heaviest work has the lowest index
// along x: blocks are numbered x fastest, so the x index goes slowest here
// and every head's heaviest tiles are handed out first.  Returns the
// number of blocks before this one with a smaller x (block id / (Y * Z)),
// and in *rest the rest of its linear id.
__device__ __forceinline__ int heavy_first(int* rest) {
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int yz = gridDim.y * gridDim.z;
  *rest = lin % yz;
  return lin / yz;
}

}  // namespace

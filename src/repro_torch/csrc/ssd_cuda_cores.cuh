// What the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// share: the chunk's cumsum of dt A, and the f32 chunk states on the CUDA
// cores (cuda_cores.cuh's 64-row products and cp.async tile loads), which
// the forward's first phase and the backward's first launch both run.

#pragma once

#include "cuda_cores.cuh"

namespace {

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

// Floats of shared memory of a chunk-states block: the group's [QT, N]
// rows, two stages of a head's [QT, P] rows (rows 16 bytes longer than
// their width), dt, cum and the row scale.
__host__ __device__ constexpr int states_cc_floats(int P, int N, int QT) {
  return QT * (N + 4) + 2 * QT * (P + 4) + 3 * QT;
}

// Where a block's rows come from: the first row (b, t0) of a head-major
// tensor, its row and head strides in elements.
struct Rows {
  const float* p;
  int64_t row, head;
};

// The chunk states of a run of nh heads from h0, one block of kCcThreads
// threads: for each head h, out + h * out_head gets the f32 [P, N]
//   sum_j (scale_j a_j)^T m_j
// over the chunk's rows j, a_j the head's row of x or dy, m_j the group's
// row of B or C, scale_j = exp(seg - cum_j) dt_j (kW) or exp(cum_j); cum
// the chunk_cumsum of the head's dt A (rows past the chunk: dt = 0),
// written to cum_out + h * cum_head unless cum_out is null.  rows: the
// chunk's rows with data (past S: zeros, dt = 0), Q its length, QT its
// tile (64 or 128).  m loads once; a by cp.async into two stages, the next
// head's in flight while one is computed.  Rows p of the state: a 64-row
// tile at a time, threads past P idle (whole warps).
template <int P, int N, bool kW>
__device__ __forceinline__ void chunk_states_run(float* smem, Rows a, Rows m, Rows dt,
                                                 const float* A, float* cum_out,
                                                 int64_t cum_head, float* out, int64_t out_head,
                                                 int h0, int nh, int rows, int Q, int QT) {
  constexpr int LP = P + 4, LN = N + 4;
  float* sM = smem;
  float* sA = sM + QT * LN;  // stage s at sA + s * QT * LP
  float* sDt = sA + 2 * QT * LP;
  float* sCum = sDt + QT;
  float* sS = sCum + QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ty = tid / 16, tx = tid % 16;

  load_rows_async(sM, LN, m.p, m.row, QT, rows, N);
  for (int s = 0; s < 2; ++s) {
    if (s < nh) load_rows_async(sA + s * QT * LP, LP, a.p + (h0 + s) * a.head, a.row, QT, rows, P);
    cp_async_commit();
  }
  float pdt = tid < rows ? dt.p[tid * dt.row + h0 * dt.head] : 0.f;
  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    float* sa = sA + (k & 1) * QT * LP;
    if (tid < QT) sDt[tid] = pdt;
    if (k + 1 < nh) pdt = tid < rows ? dt.p[tid * dt.row + (h + 1) * dt.head] : 0.f;
    __syncthreads();
    if (warp == 0) chunk_cumsum(sDt, sCum, A[h], QT, lane);
    __syncthreads();
    const float seg = sCum[QT - 1];
    if (tid < QT) {
      sS[tid] = kW ? expf(seg - sCum[tid]) * sDt[tid] : (tid < Q ? expf(sCum[tid]) : 0.f);
      if (cum_out != nullptr && tid < Q) cum_out[h * cum_head + tid] = sCum[tid];
    }
    cp_async_wait<1>();  // this head's rows are in; the next head's may still be in flight
    __syncthreads();
    for (int e = tid; e < QT * P / 4; e += kCcThreads) {
      const int r = e / (P / 4), c = (e - r * (P / 4)) * 4;
      float4* v = reinterpret_cast<float4*>(sa + r * LP + c);
      const float f = sS[r];
      *v = make_float4(v->x * f, v->y * f, v->z * f, v->w * f);
    }
    __syncthreads();
    float* o = out + h * out_head;
#pragma unroll
    for (int pt = 0; pt < (P + 63) / 64; ++pt) {
      if (64 * pt + 4 * ty >= P) continue;  // rows past P: whole warps
      float acc[4][N / 16];
      zero_tile(acc);
      mm_cols(acc, sa + 64 * pt, LP, sM, LN, 0, QT);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < N / 16; ++j) o[(64 * pt + 4 * ty + i) * N + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();  // the stage is free
    if (k + 2 < nh) load_rows_async(sa, LP, a.p + (h + 2) * a.head, a.row, QT, rows, P);
    cp_async_commit();
  }
}

}  // namespace

// The grid fold of the flash and SSD kernels.
//
// A kernel's grid puts its tiles (query or key tiles and column slices in
// flash, chunks in the SSD scan) on x, which holds 2^31 - 1, and its pairs
// (batch, head) on y and z, which hold 65,535 each (the SSD scan's f32
// kernels and its backward count runs of a group's heads on y in place of
// heads): (Y, B) while both fit, else the pair's index n = b * Y + y
// folded as n = blockIdx.y + gridDim.y * blockIdx.z (head_grid), which is
// y + Y * b in both forms.  A block past the last pair returns.
// kernels/build.py head_grid gives the same grid to the launch plans.

#pragma once

#include <cuda_runtime.h>

namespace {

// The grid's y and z for Y x B pairs (see the header).
inline dim3 head_grid(unsigned x, int Y, int B) {
  if (Y <= 65535 && B <= 65535) return dim3(x, Y, B);
  const long long n = static_cast<long long>(Y) * B;
  const unsigned y = n < 65535 ? static_cast<unsigned>(n) : 65535u;
  return dim3(x, y, static_cast<unsigned>((n + y - 1) / y));
}

// The block's pair index, b * Y + y (flash: at most 2^31 - 1 pairs a launch).
__device__ __forceinline__ int head_pair() {
  return static_cast<int>(blockIdx.y + gridDim.y * blockIdx.z);
}

// The block's pair (y, b) of Y x B pairs under head_grid; false for a block
// past the last pair.  Where the grid's y is Y (unfolded, or folded with Y
// = 65,535) the pair is (blockIdx.y, blockIdx.z) without a division;
// else the index n < 65,535^2 < 2^32 is divided in 32 bits (Y x B may pass
// 2^31).
__device__ __forceinline__ bool fold_pair(int Y, int B, int& y, int& b) {
  if (gridDim.y == static_cast<unsigned>(Y)) {
    y = static_cast<int>(blockIdx.y);
    b = static_cast<int>(blockIdx.z);
    return b < B;
  }
  const unsigned n = blockIdx.y + gridDim.y * blockIdx.z;
  if (n >= static_cast<unsigned long long>(Y) * B) return false;
  y = static_cast<int>(n % static_cast<unsigned>(Y));
  b = static_cast<int>(n / static_cast<unsigned>(Y));
  return true;
}

}  // namespace

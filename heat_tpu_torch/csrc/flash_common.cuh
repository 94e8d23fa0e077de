// Tile staging and row reductions shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu).
#pragma once

#include "common.cuh"

// Stage `rows` rows of a (rows, d) tile of T into shared memory as fp32
// times `mul`, each row padded with zeros to DP columns (row stride DP + 4
// floats) and the rows from `rows` to ROWS zero-filled. `vec`: d == DP and
// 16-byte aligned rows, so each thread moves 16 bytes at a time. NT threads
// share the work.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int rows, int d, int vec, float mul) {
  constexpr int LD = DP + 4;
  if (vec) {
    constexpr int VE = 16 / static_cast<int>(sizeof(T));
    constexpr int PER_ROW = DP / VE;
    for (int e = threadIdx.x; e < ROWS * PER_ROW; e += NT) {
      const int r = e / PER_ROW;
      const int c = (e % PER_ROW) * VE;
      alignas(16) T buf[VE];
      if (r < rows) {
        *reinterpret_cast<uint4*>(buf) =
            *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r) * DP + c);
      }
      float f[VE];
#pragma unroll
      for (int i = 0; i < VE; ++i) f[i] = r < rows ? to_acc<float>(buf[i]) * mul : 0.f;
#pragma unroll
      for (int i = 0; i < VE; i += 4)
        *reinterpret_cast<float4*>(dst + r * LD + c + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
      const int r = e / DP;
      const int c = e % DP;
      dst[r * LD + c] =
          (r < rows && c < d) ? to_acc<float>(src[static_cast<int64_t>(r) * d + c]) * mul : 0.f;
    }
  }
}

// Max and sum over the 8 lanes of a row group (lanes 8g .. 8g + 7 of a warp).
__device__ __forceinline__ float row_max8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// cdist_tile: fused pairwise L2 distances, (m, d) x (n, d) -> (m, n).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:189 cdist_tile
// (body _cdist_kernel, :174): row norms x^2 and y^2, the -2*x*y^T product,
// clamp at 0, optional sqrt, cast to the output dtype, in one pass.
//
// What bounds it on an H100: at the cdist benchmark shape (40,000 x 40,000
// x 18, f32) the 6.4 GB output write (~1.9 ms at 3.35 TB/s) against ~0.9 ms
// of fp32 FMA work; at the KMeans seeding/predict shape (2^23 x 64 against
// <= 8 centroids) the 2.1 GB read of X. Both are memory-bound, so the design
// reads every input element from device memory once per output tile,
// produces each output element in registers and writes it once.
//
// Design: one block per (BM x BN) output tile; the x and y tiles stream
// through shared memory in BK-wide slices of the feature axis; each thread
// keeps a TM x TN register block of dot products, read from shared memory
// and written to the output with vector accesses. The products and norms
// run in fp32 FMA (fp64 for fp64): the TPU kernel runs its product at
// HIGHEST precision, and TF32 tensor cores would not match it. The row
// norms are summed from the same shared slices, so X is not read twice.
// Ragged m, n and d are masked in the kernel; nothing is padded in memory.
// The tile shape follows n: 256 x 8 for n <= 8 (the centroid case of
// seeding and predict, so few threads idle), 64 x 64 otherwise.
#include "common.cuh"

namespace {

constexpr int BK = 8;

template <typename T, typename O, typename A, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
cdist_kernel(const T* __restrict__ x, const T* __restrict__ y, O* __restrict__ out,
             int64_t m, int64_t n, int64_t d, int do_sqrt, int vec_store) {
  constexpr int TX = BN / TN;
  constexpr int NT = (BM / TM) * TX;
  static_assert(BM <= NT && BN <= NT, "one thread per row norm");
  __shared__ __align__(16) A xs[BK][BM];
  __shared__ __align__(16) A ys[BK][BN];
  __shared__ A xn[BM];
  __shared__ A yn[BN];

  const int t = threadIdx.x;
  const int tx = t % TX;
  const int ty = t / TX;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  A acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = A(0);
  A xsq = A(0), ysq = A(0);

  for (int64_t k0 = 0; k0 < d; k0 += BK) {
    for (int e = t; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int64_t gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < m && gk < d) ? to_acc<A>(x[gr * d + gk]) : A(0);
    }
    for (int e = t; e < BN * BK; e += NT) {
      const int c = e / BK, kk = e % BK;
      const int64_t gc = col0 + c, gk = k0 + kk;
      ys[kk][c] = (gc < n && gk < d) ? to_acc<A>(y[gc * d + gk]) : A(0);
    }
    __syncthreads();
    if (t < BM) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) xsq += xs[kk][t] * xs[kk][t];
    }
    if (t < BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) ysq += ys[kk][t] * ys[kk][t];
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      alignas(16) A a[TM];
      alignas(16) A b[TN];
      copy_vec<A, TM>(a, &xs[kk][ty * TM]);
      copy_vec<A, TN>(b, &ys[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  if (t < BM) xn[t] = xsq;
  if (t < BN) yn[t] = ysq;
  __syncthreads();

  const int64_t gc0 = col0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty * TM + i;
    if (gr >= m || gc0 >= n) continue;
    alignas(16) O v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      A e = xn[ty * TM + i] + yn[tx * TN + j] - A(2) * acc[i][j];
      e = e < A(0) ? A(0) : e;  // NaN stays NaN, as jnp.maximum keeps it
      if (do_sqrt) e = acc_sqrt(e);
      v[j] = from_acc<O>(e);
    }
    O* dst = out + gr * n + gc0;
    if (vec_store && gc0 + TN <= n) {
      copy_vec<O, TN>(dst, v);
    } else {
      for (int j = 0; j < TN && gc0 + j < n; ++j) dst[j] = v[j];
    }
  }
}

template <typename T, typename O, typename A, int BM, int BN, int TM, int TN>
void launch_tile(const T* x, const T* y, O* out, int64_t m, int64_t n, int64_t d, int do_sqrt,
                 cudaStream_t stream) {
  // vector stores of TN outputs need every row start aligned like them
  constexpr int align = TN * sizeof(O) < 16 ? TN * sizeof(O) : 16;
  const int vec_store = (n * sizeof(O)) % align == 0 &&
                        reinterpret_cast<uintptr_t>(out) % align == 0;
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  cdist_kernel<T, O, A, BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, y, out, m, n, d, do_sqrt, vec_store);
}

template <typename T, typename O, typename A>
cudaError_t launch(const void* x, const void* y, void* out, int64_t m, int64_t n,
                   int64_t d, int do_sqrt, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  O* op = static_cast<O*>(out);
  if (n <= 8) {
    launch_tile<T, O, A, 256, 8, 4, 2>(xp, yp, op, m, n, d, do_sqrt, stream);
  } else {
    launch_tile<T, O, A, 64, 64, 4, 4>(xp, yp, op, m, n, d, do_sqrt, stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_out(const void* x, const void* y, void* out, int64_t m, int64_t n,
                       int64_t d, int out_dtype, int do_sqrt, cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch<T, float, float>(x, y, out, m, n, d, do_sqrt, s);
    case kBF16: return launch<T, __nv_bfloat16, float>(x, y, out, m, n, d, do_sqrt, s);
    case kF16: return launch<T, __half, float>(x, y, out, m, n, d, do_sqrt, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Inputs x (m, d) and y (n, d) are contiguous and of one dtype, on card
// `device`; f64 inputs take an f64 output and f64 accumulation, every other
// pair accumulates in f32. Returns the launch's cudaError_t.
extern "C" int heat_cdist_tile(const void* x, const void* y, void* out, int64_t m,
                               int64_t n, int64_t d, int in_dtype, int out_dtype,
                               int do_sqrt, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF64:
      if (out_dtype != kF64) return cudaErrorInvalidValue;
      return launch<double, double, double>(x, y, out, m, n, d, do_sqrt, s);
    case kF32: return launch_out<float>(x, y, out, m, n, d, out_dtype, do_sqrt, s);
    case kBF16: return launch_out<__nv_bfloat16>(x, y, out, m, n, d, out_dtype, do_sqrt, s);
    case kF16: return launch_out<__half>(x, y, out, m, n, d, out_dtype, do_sqrt, s);
    default: return cudaErrorInvalidValue;
  }
}

// cdist_tile: fused pairwise L2 distances, (m, d) x (n, d) -> (m, n).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:189 cdist_tile
// (body _cdist_kernel, :174): row norms x^2 and y^2, the -2*x*y^T product,
// clamp at 0 (NaN stays NaN), optional sqrt, cast to the output dtype, in one
// pass. Ragged m, n and d are masked in the kernel; nothing is padded in
// memory.
//
// What bounds it on an H100: at the cdist benchmark shape (40,000 x 40,000
// x 18, f32) the 6.4 GB output write (~1.9 ms at 3.35 TB/s), against ~0.9 ms
// of fp32 FMA work that has to run under it; at the KMeans seeding/predict
// shape (2^23 x 64 against <= 8 centroids) the 2.1 GB read of X (~0.64 ms).
// Both are memory-bound. The products and norms run in fp32 FMA (fp64 for
// fp64): the TPU kernel runs its product at HIGHEST precision, and TF32
// tensor cores would not match it. Every sum over the feature axis (x^2,
// y^2, each x.y) is one FMA chain in feature order, so the design does not
// change the arithmetic of the kernel it replaced.
//
// Design: two persistent kernels, each with as many blocks as fit on the card
// at once, streaming their input through a ring of shared-memory stages
// filled by cp.async (common.cuh: TileStager), so the copies of the next
// stages are in flight while a stage is computed; a stage's rows are padded
// to an odd number of 16-byte vectors, so neighbouring rows lie in other
// bank groups, and staged as they lie in memory (16-byte pieces where the
// tensor's address and row length allow, else 8, 4 or, for a 2-byte type at
// an odd offset, 2 by plain loads).
//
// - n <= 8 (k-means++ seeding and predict: distances to the centroids):
//   cdist_rows_kernel, kmeans_step's scoring pass with a store. 256 threads
//   walk X in tiles of up to 128 rows (tile t goes to block t mod grid),
//   two tiles in the ring; y and y^2 sit in shared memory as the
//   accumulation type (rows padded to an odd number of vectors); two
//   threads take each row, each half of the columns: the row read as
//   16-byte vectors, the dot products in registers, the distances written
//   as contiguous streaming stores (st.global.cs). X is read once.
// - n > 8 (the self-distance matrix): cdist_wide_kernel. The output is cut
//   into 128 x 128 tiles (64 x 64 for fp64) in row-panel order, tile t
//   going to block t mod grid, so the blocks running at once write
//   neighbouring tiles of the same rows; each (tile, 32-feature slice) is
//   one ring stage holding both operands' slices, three stages deep (X and
//   Y are read from L2 after their first use: Y is 2.9 MB at 40,000 x 18).
//   Warp w takes rows w + 8 i of a tile, lane l columns 4 l .. 4 l + 3
//   (2 for fp64), a 16 x 4 register block (8 x 2): per 16 bytes of
//   features, a broadcast load of each row and one load of each column feed
//   4 x 16 x 4 FMAs; the lanes' column rows are skewed by one vector every
//   4 rows of the Y slice, so a quarter-warp reads 8 bank groups. The norms
//   are carried from slice to slice in shared memory. A store of a warp is
//   one run of 128 outputs of a row (512 bytes in fp32), a streaming store.
//   What holds it back at 40,000^2 x 18: the products do not hide under the
//   output's write (PERF.md, section 5).
//
// The float square root is acc_sqrt (common.cuh): sqrtf's result without its
// branch to a slow path, so an output tile's epilogue is straight-line code.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kNMax = 8;            // columns of the rows kernel
constexpr int kRowThreads = 256;    // rows kernel: two threads a row, 128 rows a tile at most
constexpr int kStages = 2;          // ring stages of the rows kernel
constexpr int kWideStages = 3;      // ring stages of the wide kernel
constexpr int kWideThreads = 256;   // wide kernel: 8 warps of row groups
constexpr int kSliceElems = 32;     // features a slice of the wide kernel's ring

template <typename A> struct Wide;  // register block of the wide kernel
template <> struct Wide<float> { static constexpr int TM = 16, TN = 4, MIN_BLOCKS = 2; };
template <> struct Wide<double> { static constexpr int TM = 8, TN = 2, MIN_BLOCKS = 2; };

// U consecutive values of T at a shared address aligned to their size, in
// the accumulation type
template <typename T, typename A, int U>
__device__ __forceinline__ void load_unit(A* out, const unsigned char* p) {
  alignas(16) T v[U];
  copy_vec<T, U>(v, reinterpret_cast<const T*>(p));
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = to_acc<A>(v[u]);
}

// N consecutive outputs as streaming stores (st.global.cs) of 16, 8 or 4
// bytes; dst aligned to min(N * sizeof(O), 16)
template <typename O, int N>
__device__ __forceinline__ void store_cs(O* dst, const O* v) {
  constexpr int bytes = N * static_cast<int>(sizeof(O));
  if constexpr (bytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < bytes / 16; ++q)
      __stcs(reinterpret_cast<uint4*>(dst) + q, reinterpret_cast<const uint4*>(v)[q]);
  } else if constexpr (bytes == 8) {
    __stcs(reinterpret_cast<uint2*>(dst), *reinterpret_cast<const uint2*>(v));
  } else if constexpr (bytes == 4) {
    __stcs(reinterpret_cast<unsigned*>(dst), *reinterpret_cast<const unsigned*>(v));
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = v[q];
  }
}

template <typename A, typename O>
__device__ __forceinline__ O finish(A x2, A y2, A dot, int do_sqrt) {
  A e = x2 + y2 - A(2) * dot;
  e = e < A(0) ? A(0) : e;  // NaN stays NaN, as jnp.maximum keeps it
  if (do_sqrt) e = acc_sqrt(e);
  return from_acc<O>(e);
}

// ---- n <= 8: two threads a row ------------------------------------------

struct RowsLayout {
  int vt, dv, sv, dy;  // T values a vector; vectors a row; ring row stride; y row stride
  __host__ __device__ RowsLayout(int64_t d, int t_bytes) {
    vt = 16 / t_bytes;
    const int64_t v = (d + vt - 1) / vt;
    dv = v < 1 ? 1 : static_cast<int>(v);
    sv = dv % 2 == 0 ? dv + 1 : dv;
    // y rows in the accumulation type (fp64 for fp64, else fp32), padded to
    // an odd number of 16-byte vectors: a warp reads two rows at once
    const int a_per_vec = t_bytes == 8 ? 2 : 4;
    dy = dv * vt;
    if ((dy / a_per_vec) % 2 == 0) dy += a_per_vec;
  }
  // ring[kStages][tile_rows][sv] (16-byte vectors) | ys[kNMax][dy] | y2[kNMax]
  __host__ __device__ size_t ring_bytes(int tile_rows) const {
    return (size_t)kStages * tile_rows * sv * 16;
  }
  __host__ __device__ size_t bytes(int tile_rows, int a_bytes) const {
    return ring_bytes(tile_rows) + (size_t)kNMax * (dy + 1) * a_bytes;
  }
};

template <typename T, typename O, typename A>
__global__ void __launch_bounds__(kRowThreads)
cdist_rows_kernel(const T* __restrict__ x, const T* __restrict__ y, O* __restrict__ out,
                  int64_t m, int n, int d, int do_sqrt, int vec_store, int tile_rows,
                  int piece) {
  constexpr int VT = 16 / sizeof(T);
  constexpr int VA = 16 / sizeof(A);
  constexpr int NH = kNMax / 2;  // columns a thread computes
  using VecA = typename std::conditional<sizeof(A) == 4, float4, double2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const RowsLayout L(d, sizeof(T));
  const int dv = L.dv, sv = L.sv, dy = L.dy;
  uint4* ring = reinterpret_cast<uint4*>(smem);
  A* ys = reinterpret_cast<A*>(smem + L.ring_bytes(tile_rows));
  A* y2 = ys + (size_t)kNMax * dy;
  const int t = threadIdx.x;
  const int row = t >> 1, c0 = (t & 1) * NH;  // this thread's row and first column

  for (int e = t; e < kNMax * dy; e += kRowThreads) {
    const int cc = e / dy, j = e - cc * dy;
    ys[e] = cc < n && j < d ? to_acc<A>(y[(size_t)cc * d + j]) : A(0);
  }

  const int64_t num_tiles = (m + tile_rows - 1) / tile_rows;
  const int64_t mine = blockIdx.x < num_tiles ? (num_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const TileStager stager(dv * 16, kRowThreads, piece);
  const int64_t row_bytes = (int64_t)d * sizeof(T);
  auto issue = [&](int64_t i) {
    if (i < mine) {
      const int64_t r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
      const int rows = m - r0 < tile_rows ? static_cast<int>(m - r0) : tile_rows;
      stager.issue(reinterpret_cast<unsigned char*>(ring + (i % kStages) * tile_rows * sv),
                   sv * 16, 0, reinterpret_cast<const unsigned char*>(x + r0 * d), row_bytes,
                   rows, static_cast<int>(row_bytes));
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  __syncthreads();
  if (t < kNMax) {
    A s = A(0);
    for (int j = 0; j < dy; ++j) s += ys[t * dy + j] * ys[t * dy + j];
    y2[t] = s;
  }

  for (int64_t i = 0; i < mine; ++i) {
    issue(i + kStages - 1);
    const int64_t r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const int rows = m - r0 < tile_rows ? static_cast<int>(m - r0) : tile_rows;
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (row < rows && c0 < n) {
      const uint4* xr = ring + (i % kStages) * tile_rows * sv + row * sv;
      A x2 = A(0), dot[NH];
#pragma unroll
      for (int u = 0; u < NH; ++u) dot[u] = A(0);
      for (int j = 0; j < dv; ++j) {
        A a[VT];
        load_unit<T, A, VT>(a, reinterpret_cast<const unsigned char*>(xr + j));
#pragma unroll
        for (int u = 0; u < VT; ++u) x2 += a[u] * a[u];
#pragma unroll
        for (int cu = 0; cu < NH; ++cu) {  // columns past n are zeros: no test
          alignas(16) A b[VT];
#pragma unroll
          for (int q = 0; q < VT / VA; ++q)
            reinterpret_cast<VecA*>(b)[q] =
                reinterpret_cast<const VecA*>(ys + (c0 + cu) * dy + j * VT)[q];
#pragma unroll
          for (int u = 0; u < VT; ++u) dot[cu] += a[u] * b[u];
        }
      }
      alignas(16) O v[NH];
#pragma unroll
      for (int cu = 0; cu < NH; ++cu) v[cu] = finish<A, O>(x2, y2[c0 + cu], dot[cu], do_sqrt);
      O* dst = out + (r0 + row) * n + c0;
      if (vec_store) {  // n is a multiple of NH
        store_cs<O, NH>(dst, v);
      } else {
#pragma unroll
        for (int cu = 0; cu < NH; ++cu)
          if (c0 + cu < n) dst[cu] = v[cu];
      }
    }
    __syncthreads();  // the slot is free again
  }
  cp_async_wait<0>();
}

// ---- n > 8: register-blocked tiles ----------------------------------------

template <typename T>
struct WideLayout {
  int slices, dv, sv;  // slices of the feature axis; 16-byte vectors a slice's row,
                       // and its odd stride in the ring
  __host__ __device__ WideLayout(int64_t d) {
    const int64_t s = (d + kSliceElems - 1) / kSliceElems;
    slices = s < 1 ? 1 : static_cast<int>(s);
    const int64_t width = d < kSliceElems ? d : kSliceElems;  // features a slice at most
    dv = static_cast<int>((width * sizeof(T) + 15) / 16);
    dv = dv < 1 ? 1 : dv;
    sv = dv % 2 == 0 ? dv + 1 : dv;
  }
};

template <typename T, typename A>
struct WideShape {
  static constexpr int TM = Wide<A>::TM, TN = Wide<A>::TN;
  // kWideThreads / 32 warps of row groups, 32 lanes of columns
  static constexpr int BM = kWideThreads / 32 * TM, BN = 32 * TN;
  // a stage: the X slice [BM][sv] | the Y slice [BN][sv] with a vector of
  // skew every TN rows (16-byte vectors); then x^2 [BM] | y^2 [BN]
  __host__ __device__ static size_t stage_bytes(int sv) {
    return ((size_t)(BM + BN) * sv + BN / TN) * 16;
  }
  __host__ __device__ static size_t bytes(int sv) {
    return kWideStages * stage_bytes(sv) + (size_t)(BM + BN) * sizeof(A);
  }
};

template <typename T, typename O, typename A>
__global__ void __launch_bounds__(kWideThreads, Wide<A>::MIN_BLOCKS)
cdist_wide_kernel(const T* __restrict__ x, const T* __restrict__ y, O* __restrict__ out,
                  int64_t m, int64_t n, int d, int do_sqrt, int vec_store, int piece_x,
                  int piece_y) {
  constexpr int stages = kWideStages;
  using S = WideShape<T, A>;
  constexpr int TM = S::TM, TN = S::TN, BM = S::BM, BN = S::BN;
  constexpr int WARPS = kWideThreads / 32;
  constexpr int U = 16 / sizeof(T);  // features a 16-byte load takes
  extern __shared__ __align__(16) unsigned char smem[];
  const WideLayout<T> L(d);
  const int sv = L.sv, ns = L.slices;
  const size_t stage_bytes = S::stage_bytes(sv);
  A* norms = reinterpret_cast<A*>(smem + stages * stage_bytes);  // x^2 [BM] | y^2 [BN]

  // warp w takes rows w + WARPS i of a tile, lane l columns l * TN + j: a
  // store of a warp is one run of 32 * TN outputs of a row
  const int t = threadIdx.x, tx = t % 32, ty = t / 32;

  // this block's tiles, blockIdx.x, + gridDim.x, ... in row-panel order,
  // and its items (tile, slice): the blocks running at once write
  // neighbouring tiles of the same rows
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = (m + BM - 1) / BM * tiles_n;
  const int64_t mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t items = mine * ns;
  const int64_t row_bytes = (int64_t)d * sizeof(T);
  auto issue = [&](int64_t q) {
    if (q < items) {
      const TileStager sx(L.dv * 16, kWideThreads, piece_x), sy(L.dv * 16, kWideThreads, piece_y);
      const int64_t u = blockIdx.x + q / ns * gridDim.x;
      const int s = static_cast<int>(q % ns);
      const int64_t row0 = u / tiles_n * BM, col0 = u % tiles_n * BN;
      const int64_t lo = (int64_t)s * kSliceElems;
      const int left = static_cast<int>(((d - lo) < kSliceElems ? d - lo : kSliceElems) *
                                        (int64_t)sizeof(T));
      unsigned char* st = smem + (q % stages) * stage_bytes;
      const int rx = m - row0 < BM ? static_cast<int>(m - row0) : BM;
      const int ry = n - col0 < BN ? static_cast<int>(n - col0) : BN;
      sx.issue(st, sv * 16, 0, reinterpret_cast<const unsigned char*>(x + row0 * d + lo),
               row_bytes, rx, left);
      sy.issue(st + (size_t)BM * sv * 16, sv * 16, TN,
               reinterpret_cast<const unsigned char*>(y + col0 * d + lo), row_bytes, ry, left);
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) issue(s);

  A acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = A(0);

  for (int64_t q = 0; q < items; ++q) {
    issue(q + stages - 1);
    const int s = static_cast<int>(q % ns);
    const int64_t lo = (int64_t)s * kSliceElems;
    const int64_t width = d - lo < kSliceElems ? d - lo : kSliceElems;
    const int units = static_cast<int>((width + U - 1) / U);
    const unsigned char* xs = smem + (q % stages) * stage_bytes;
    const unsigned char* ys = xs + (size_t)BM * sv * 16;
    // this lane's Y rows: skewed by one vector every TN rows, so the 8 lanes
    // of a quarter-warp read 8 bank groups
    const unsigned char* yl = ys + (size_t)tx * (TN * sv + 1) * 16;
    cp_async_wait<stages - 1>();
    __syncthreads();

    for (int k = 0; k < units; ++k) {
      A b[TN][U];
#pragma unroll
      for (int j = 0; j < TN; ++j) load_unit<T, A, U>(b[j], yl + ((size_t)j * sv + k) * 16);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        A a[U];  // the same row in every lane: a broadcast
        load_unit<T, A, U>(a, xs + ((size_t)(ty + WARPS * i) * sv + k) * 16);
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int u = 0; u < U; ++u) acc[i][j] += a[u] * b[j][u];
      }
    }
    // the norms of the tile's rows and columns, each one FMA chain over the
    // features, carried from slice to slice in shared memory
    for (int r = t; r < BM + BN; r += kWideThreads) {
      const unsigned char* row = r < BM ? xs + (size_t)r * sv * 16
                                        : ys + ((size_t)(r - BM) * sv + (r - BM) / TN) * 16;
      A nrm = s == 0 ? A(0) : norms[r];
      for (int k = 0; k < units; ++k) {
        A a[U];
        load_unit<T, A, U>(a, row + k * 16);
#pragma unroll
        for (int u = 0; u < U; ++u) nrm += a[u] * a[u];
      }
      norms[r] = nrm;
    }
    __syncthreads();  // the stage is free again; the norms are in
    if (s != ns - 1) continue;

    const int64_t u = blockIdx.x + q / ns * gridDim.x;
    const int64_t row0 = u / tiles_n * BM, col0 = u % tiles_n * BN;
    const int64_t gc = col0 + tx * TN;
    A y2[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) y2[j] = norms[BM + tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gr = row0 + ty + WARPS * i;
      if (gr < m && gc < n) {
        const A x2 = norms[ty + WARPS * i];
        alignas(16) O v[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) v[j] = finish<A, O>(x2, y2[j], acc[i][j], do_sqrt);
        O* dst = out + gr * n + gc;
        if (vec_store && gc + TN <= n) {
          store_cs<O, TN>(dst, v);
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (gc + j < n) dst[j] = v[j];
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = A(0);
    }
  }
  cp_async_wait<0>();
}

// ---- launch and plan ------------------------------------------------------

template <typename T, typename O, typename A>
cudaError_t raise_rows() {
  static std::atomic<uint32_t> done{0};
  return raise_smem_limit_max(reinterpret_cast<const void*>(cdist_rows_kernel<T, O, A>), done);
}
template <typename T, typename O, typename A>
cudaError_t raise_wide() {
  static std::atomic<uint32_t> done{0};
  return raise_smem_limit_max(reinterpret_cast<const void*>(cdist_wide_kernel<T, O, A>), done);
}

// The path, the tile rows of the rows kernel (0: the wide kernel) and the
// grid on the current card: n <= 8 takes the rows kernel with the largest of
// 128..8 tile rows whose ring fits a block, else the wide kernel; the grid
// is as many blocks as are resident at once, at most one per tile.
template <typename T, typename O, typename A>
cudaError_t plan(int64_t m, int64_t n, int64_t d, int device, int* grid, int* tile_rows) {
  int sms, optin, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int tr = 0;
  int64_t tiles;
  if (n <= kNMax) {
    const RowsLayout L(d, sizeof(T));
    tr = kRowThreads / 2;
    while (tr >= 8 && L.bytes(tr, sizeof(A)) > (size_t)optin) tr /= 2;
    if (tr < 8) tr = 0;
  }
  if (tr > 0) {
    err = raise_rows<T, O, A>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cdist_rows_kernel<T, O, A>, kRowThreads,
          RowsLayout(d, sizeof(T)).bytes(tr, sizeof(A)));
    tiles = (m + tr - 1) / tr;
  } else {
    using S = WideShape<T, A>;
    err = raise_wide<T, O, A>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cdist_wide_kernel<T, O, A>, kWideThreads,
          S::bytes(WideLayout<T>(d).sv));
    tiles = (m + S::BM - 1) / S::BM * ((n + S::BN - 1) / S::BN);
  }
  if (err != cudaSuccess) return err;
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  *tile_rows = tr;
  *grid = static_cast<int>(tiles < 1 ? 1 : (tiles < resident ? tiles : resident));
  return cudaSuccess;
}

template <typename T, typename O, typename A>
cudaError_t launch(const void* x, const void* y, void* out, int64_t m, int64_t n, int64_t d,
                   int do_sqrt, int grid, int tile_rows, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  O* op = static_cast<O*>(out);
  const int64_t row_bytes = d * (int64_t)sizeof(T);
  cudaError_t err;
  if (tile_rows > 0) {
    if (n > kNMax || tile_rows > kRowThreads / 2) return cudaErrorInvalidValue;
    err = raise_rows<T, O, A>();
    if (err != cudaSuccess) return err;
    // a thread's kNMax / 2 outputs as one vector store: every row start and
    // half-row aligned like them
    constexpr int align = kNMax / 2 * sizeof(O) < 16 ? kNMax / 2 * sizeof(O) : 16;
    const int vec_store = n % (kNMax / 2) == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
    cdist_rows_kernel<T, O, A>
        <<<grid, kRowThreads, RowsLayout(d, sizeof(T)).bytes(tile_rows, sizeof(A)),
           stream>>>(xp, yp, op, m, static_cast<int>(n), static_cast<int>(d), do_sqrt,
                     vec_store, tile_rows, piece_bytes(x, row_bytes));
  } else {
    using S = WideShape<T, A>;
    err = raise_wide<T, O, A>();
    if (err != cudaSuccess) return err;
    // vector stores of TN outputs need every row start aligned like them
    constexpr int align = S::TN * sizeof(O) < 16 ? S::TN * sizeof(O) : 16;
    const int vec_store = (n * sizeof(O)) % align == 0 &&
                          reinterpret_cast<uintptr_t>(out) % align == 0;
    cdist_wide_kernel<T, O, A>
        <<<grid, kWideThreads, S::bytes(WideLayout<T>(d).sv), stream>>>(
            xp, yp, op, m, n, static_cast<int>(d), do_sqrt, vec_store, piece_bytes(x, row_bytes),
            piece_bytes(y, row_bytes));
  }
  return cudaGetLastError();
}

// Runs F<T, O, A> for the dtype pair: f64 inputs take an f64 output and f64
// accumulation, every other pair accumulates in f32.
template <template <typename, typename, typename> class F, typename... Args>
cudaError_t dispatch(int in_dtype, int out_dtype, Args... args) {
  auto out_of = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    switch (out_dtype) {
      case kF32: return F<T, float, float>::run(args...);
      case kBF16: return F<T, __nv_bfloat16, float>::run(args...);
      case kF16: return F<T, __half, float>::run(args...);
      default: return cudaErrorInvalidValue;
    }
  };
  switch (in_dtype) {
    case kF64:
      if (out_dtype != kF64) return cudaErrorInvalidValue;
      return F<double, double, double>::run(args...);
    case kF32: return out_of(float{});
    case kBF16: return out_of(__nv_bfloat16{});
    case kF16: return out_of(__half{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename O, typename A>
struct Plan {
  static cudaError_t run(int64_t m, int64_t n, int64_t d, int device, int* grid, int* tr) {
    return plan<T, O, A>(m, n, d, device, grid, tr);
  }
};
template <typename T, typename O, typename A>
struct Launch {
  static cudaError_t run(const void* x, const void* y, void* out, int64_t m, int64_t n,
                         int64_t d, int do_sqrt, int grid, int tr, cudaStream_t s) {
    return launch<T, O, A>(x, y, out, m, n, d, do_sqrt, grid, tr, s);
  }
};

}  // namespace

// The grid and tile rows (0: the wide kernel) of heat_cdist_tile for this
// shape and dtype pair on card `device`; the wrapper caches them per shape.
extern "C" int heat_cdist_tile_plan(int64_t m, int64_t n, int64_t d, int in_dtype,
                                    int out_dtype, int* grid, int* tile_rows, int device) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  return dispatch<Plan>(in_dtype, out_dtype, m, n, d, device, grid, tile_rows);
}

// Inputs x (m, d) and y (n, d) are contiguous and of one dtype, on card
// `device`; grid and tile_rows as heat_cdist_tile_plan gave them. Returns
// the launch's cudaError_t.
extern "C" int heat_cdist_tile(const void* x, const void* y, void* out, int64_t m, int64_t n,
                               int64_t d, int in_dtype, int out_dtype, int do_sqrt, int grid,
                               int tile_rows, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  return dispatch<Launch>(in_dtype, out_dtype, x, y, out, m, n, d, do_sqrt, grid, tile_rows,
                          static_cast<cudaStream_t>(stream));
}

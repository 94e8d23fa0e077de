// kmeans_step: one Lloyd partial over a local X shard in ONE pass over X.
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:858
// kmeans_step_tile (-> _kmeans_step_tile :882 -> _kmeans_kernel :724): for
// each row, scores = c^2 - 2*x*c^T, the first-index argmin, and over the
// rows whose mask is set the per-cluster sums (k, d), counts (k,) and the
// inertia sum(min score + x^2). Each row's label is written only when the
// caller passes a labels buffer, for checks; the Lloyd step passes none.
//
// What bounds it on an H100: reading X. At 2^23 x 64 f32 that is 2.15 GB,
// ~0.64 ms at 3.35 TB/s, against 4*n*d*k = 17 GFLOP (~0.26 ms of fp32 FMA),
// so the step is memory-bound and the one promise of the TPU kernel is kept:
// X is read from device memory once per step.
//
// Design. Pass 1: a grid of 128-thread blocks, as many as fit on the card at
// once, walks X in tiles of up to 128 rows (tile t goes to block t mod
// grid). A tile is staged in shared memory once, each row padded with zeros
// to whole 16-byte vectors; the centroids and c^2 sit in shared memory for
// the whole pass. Each thread scores one
// row: 16-byte loads of the row, broadcast loads of the centroids, k running
// dot products in registers, first-index argmin with strict <. Counts come
// from warp ballots (exact integers) and the inertia from a fixed shuffle
// tree, per warp; then the block folds the tile's rows into its partial
// sums, each 16-byte column of each row group owned by one thread. No
// element has two writers and every order is fixed, so there are no atomics
// and repeated runs are bitwise equal. Each block writes its partial
// (k*d + k + 1 values) to a workspace row. Pass 2: one thread per output
// element sums the workspace column over the blocks in block order and
// stores it in x's dtype (heat_tpu casts its outputs the same way,
// :925-926). Counts are exact integers inside a block and cast to x's dtype
// for the workspace: exact up to 2^24 rows per cluster per shard in f32,
// heat_tpu's limit too.
//
// Large k*d (the centroids and the groups' partial sums do not fit one
// block's shared memory next to an 8-row tile): kmeans_stream_kernel keeps
// the X tile in shared memory as above and streams the centroids through it
// in chunks of kc, in ascending order; the threads of a row (several where
// the tile is short) score strided centroids of the chunk and combine their
// bests (lower score, then lower index), and the row keeps a running best
// across chunks with strict <, so ties still go to the lowest index. The
// block's partial sums and counts live in its own workspace row in device
// memory: the tile's valid rows are ordered by label (stably), and one
// thread per (run of one label, 16-byte column) sums the run's rows in row
// order and adds them to the row's element, which no other thread touches.
// X is still read once; the centroids are re-read from L2 once per tile.
// The plan picks this path by shape alone.
//
// None of the TPU kernel's Mosaic workarounds are carried over (the three
// sums_mode variants, the block-rows knob, the 1e15 centroid padding, the
// 8x128 broadcast outputs): the card needs none of them.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int KB = 4;  // centroids a thread of the streaming path scores at once
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float vdot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ double vdot(double2 a, double2 b) { return a.x * b.x + a.y * b.y; }
__device__ __forceinline__ void vadd(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ void vadd(double2& a, double2 b) { a.x += b.x; a.y += b.y; }

// Shared-memory layout of one pass-1 block. Rows are padded to dv vectors of
// 16 bytes; the tile's row stride sv is odd in vectors, so the 8 rows a
// quarter-warp reads hit 8 different bank groups.
struct Layout {
  int vw, dv, sv, groups;
  __host__ __device__ Layout(int d, int acc_bytes) {
    vw = 16 / acc_bytes;
    dv = (d + vw - 1) / vw;
    sv = dv % 2 == 0 ? dv + 1 : dv;
    groups = dv >= kThreads ? 1 : kThreads / dv;
  }
  // xs[tile_rows][sv] | cs[k][dv] | acc[groups][k][dv]   (16-byte vectors)
  // c2[k] | inertia[kWarps]                              (accumulation type)
  // counts[kWarps][k] (uint32) | lab[tile_rows] (int) | valid[tile_rows] (byte)
  __host__ __device__ size_t bytes(int k, int tile_rows, int acc_bytes) const {
    const size_t vecs = (size_t)tile_rows * sv + (size_t)k * dv + (size_t)groups * k * dv;
    return vecs * 16 + (size_t)(k + kWarps) * acc_bytes + (size_t)kWarps * k * 4 +
           (size_t)tile_rows * 4 + tile_rows;
  }
};

// KMAX == 8: k <= 8, the k dot products live in registers; KMAX == 0: any
// k, one centroid at a time.
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads)
kmeans_partial_kernel(const T* __restrict__ x, const T* __restrict__ c,
                      const uint8_t* __restrict__ mask, T* __restrict__ ws,
                      int* __restrict__ labels, int64_t n, int d, int k, int tile_rows,
                      int vec_load) {
  using A = T;
  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, sizeof(A));
  const int dv = L.dv, sv = L.sv, G = L.groups;
  V* xs = reinterpret_cast<V*>(smem);
  V* cs = xs + (size_t)tile_rows * sv;
  V* acc = cs + (size_t)k * dv;
  A* c2 = reinterpret_cast<A*>(acc + (size_t)G * k * dv);
  A* inertw = c2 + k;
  unsigned* cntw = reinterpret_cast<unsigned*>(inertw + kWarps);
  int* lab = reinterpret_cast<int*>(cntw + kWarps * k);
  uint8_t* valid = reinterpret_cast<uint8_t*>(lab + tile_rows);

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const V vzero = {};
  for (int e = t; e < tile_rows * sv; e += kThreads) xs[e] = vzero;  // padding stays 0
  for (int e = t; e < G * k * dv; e += kThreads) acc[e] = vzero;
  for (int e = t; e < kWarps * k; e += kThreads) cntw[e] = 0u;
  A* csa = reinterpret_cast<A*>(cs);
  for (int e = t; e < k * dv * VW; e += kThreads) {
    const int cc = e / (dv * VW), j = e - cc * (dv * VW);
    csa[e] = j < d ? c[(size_t)cc * d + j] : A(0);
  }
  __syncthreads();
  for (int cc = t; cc < k; cc += kThreads) {
    A s = A(0);
    for (int j = 0; j < dv; ++j) s += vdot(cs[cc * dv + j], cs[cc * dv + j]);
    c2[cc] = s;
  }
  A inertia = A(0);  // lane 0 of each warp
  __syncthreads();

  const int64_t num_tiles = (n + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * tile_rows;
    const int rows = n - r0 < tile_rows ? static_cast<int>(n - r0) : tile_rows;
    if (vec_load) {  // d % VW == 0 and x 16-byte aligned: the tile is whole vectors
      const V* src = reinterpret_cast<const V*>(x) + r0 * dv;
      for (int e = t; e < rows * dv; e += kThreads) {
        const int r = e / dv, j = e - r * dv;
        xs[r * sv + j] = src[e];
      }
    } else {
      const T* src = x + r0 * d;
      A* xsa = reinterpret_cast<A*>(xs);
      for (int r = warp; r < rows; r += kWarps)
        for (int j = lane; j < d; j += 32) xsa[(size_t)r * sv * VW + j] = src[(int64_t)r * d + j];
    }
    for (int r = t; r < rows; r += kThreads)
      valid[r] = mask == nullptr ? 1 : (mask[r0 + r] != 0);
    __syncthreads();

    // assignment: thread t scores row t (tile_rows <= kThreads)
    const bool live = t < rows && valid[t];
    int best_c = 0;
    A term = A(0);
    if (t < rows) {
      const V* xr = xs + t * sv;
      A x2 = A(0), best;
      if constexpr (KMAX > 0) {
        A dot[KMAX];
#pragma unroll
        for (int cc = 0; cc < KMAX; ++cc) dot[cc] = A(0);
        for (int j = 0; j < dv; ++j) {
          const V xv = xr[j];
          x2 += vdot(xv, xv);
#pragma unroll
          for (int cc = 0; cc < KMAX; ++cc)
            if (cc < k) dot[cc] += vdot(xv, cs[cc * dv + j]);
        }
        best = c2[0] - A(2) * dot[0];
#pragma unroll
        for (int cc = 1; cc < KMAX; ++cc) {
          if (cc < k) {
            const A score = c2[cc] - A(2) * dot[cc];
            if (score < best) {
              best = score;
              best_c = cc;
            }
          }
        }
      } else {
        for (int j = 0; j < dv; ++j) x2 += vdot(xr[j], xr[j]);
        for (int cc = 0; cc < k; ++cc) {
          A dot = A(0);
          for (int j = 0; j < dv; ++j) dot += vdot(xr[j], cs[cc * dv + j]);
          const A score = c2[cc] - A(2) * dot;
          if (cc == 0 || score < best) {
            best = score;
            best_c = cc;
          }
        }
      }
      lab[t] = best_c;
      if (labels != nullptr) labels[r0 + t] = best_c;
      term = best + x2;
    }
    A v = live ? term : A(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) inertia += v;
    for (int cc = 0; cc < k; ++cc) {
      const unsigned b = __ballot_sync(kFull, live && best_c == cc);
      if (lane == 0) cntw[warp * k + cc] += __popc(b);
    }
    __syncthreads();

    // fold: thread (g, j) owns vector column j of row group g's sums
    for (int e = t; e < G * dv; e += kThreads) {
      const int g = e / dv, j = e - g * dv;
      V* accg = acc + (size_t)g * k * dv + j;
      for (int r = g; r < rows; r += G)
        if (valid[r]) vadd(accg[lab[r] * dv], xs[r * sv + j]);
    }
    __syncthreads();
  }

  if (lane == 0) inertw[warp] = inertia;
  __syncthreads();
  T* w = ws + (size_t)blockIdx.x * (k * d + k + 1);
  const A* acca = reinterpret_cast<const A*>(acc);
  const int dp = dv * VW;
  for (int e = t; e < k * d; e += kThreads) {
    const int cc = e / d, j = e - cc * d;
    A s = A(0);
    for (int g = 0; g < G; ++g) s += acca[((size_t)g * k + cc) * dp + j];
    w[e] = s;
  }
  for (int cc = t; cc < k; cc += kThreads) {
    unsigned s = 0;
    for (int wp = 0; wp < kWarps; ++wp) s += cntw[wp * k + cc];
    w[k * d + cc] = static_cast<A>(s);
  }
  if (t == 0) {
    A s = A(0);
    for (int wp = 0; wp < kWarps; ++wp) s += inertw[wp];
    w[k * d + k] = s;
  }
}

// Shared-memory layout of one block of the streaming path: the X tile as
// in Layout, one chunk of kc centroids and their c^2, the tile's labels and
// its valid rows ordered by label.
struct StreamLayout {
  int dv, sv;
  __host__ __device__ StreamLayout(int d, int acc_bytes) {
    const Layout L(d, acc_bytes);
    dv = L.dv;
    sv = L.sv;
  }
  // xs[tile_rows][sv] | cs[kc][sv]                (16-byte vectors; the odd
  //   stride sv also spreads the centroids a row's threads read over banks)
  // c2[kc] | inertia[kWarps]                      (accumulation type)
  // lab[tile_rows] | order[tile_rows] (int) | valid[tile_rows] (byte)
  __host__ __device__ size_t bytes(int kc, int tile_rows, int acc_bytes) const {
    return ((size_t)tile_rows + kc) * sv * 16 + (size_t)(kc + kWarps) * acc_bytes +
           (size_t)tile_rows * 9;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
kmeans_stream_kernel(const T* __restrict__ x, const T* __restrict__ c,
                     const uint8_t* __restrict__ mask, T* __restrict__ ws,
                     int* __restrict__ labels, int64_t n, int d, int k, int tile_rows, int kc,
                     int vec_load) {
  using A = T;
  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const StreamLayout L(d, sizeof(A));
  const int dv = L.dv, sv = L.sv;
  V* xs = reinterpret_cast<V*>(smem);
  V* cs = xs + (size_t)tile_rows * sv;
  A* c2 = reinterpret_cast<A*>(cs + (size_t)kc * sv);
  A* inertw = c2 + kc;
  int* lab = reinterpret_cast<int*>(inertw + kWarps);
  int* order = lab + tile_rows;
  uint8_t* valid = reinterpret_cast<uint8_t*>(order + tile_rows);

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  // tpr consecutive threads (a power of two up to 32) score one row
  const int tpr = min(32, kThreads / tile_rows);
  const int row = t / tpr, sub = t % tpr;
  const int width = k * d + k + 1;
  A* w = ws + (size_t)blockIdx.x * width;  // this block's sums, counts, inertia
  for (int e = t; e < width; e += kThreads) w[e] = A(0);
  const V vzero = {};
  for (int e = t; e < tile_rows * sv; e += kThreads) xs[e] = vzero;  // padding stays 0
  A inertia = A(0);  // lane 0 of each warp
  __syncthreads();

  const int64_t num_tiles = (n + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * tile_rows;
    const int rows = n - r0 < tile_rows ? static_cast<int>(n - r0) : tile_rows;
    if (vec_load) {
      const V* src = reinterpret_cast<const V*>(x) + r0 * dv;
      for (int e = t; e < rows * dv; e += kThreads) {
        const int r = e / dv, j = e - r * dv;
        xs[r * sv + j] = src[e];
      }
    } else {
      const T* src = x + r0 * d;
      A* xsa = reinterpret_cast<A*>(xs);
      for (int r = warp; r < rows; r += kWarps)
        for (int j = lane; j < d; j += 32) xsa[(size_t)r * sv * VW + j] = src[(int64_t)r * d + j];
    }
    for (int r = t; r < rows; r += kThreads)
      valid[r] = mask == nullptr ? 1 : (mask[r0 + r] != 0);

    // assignment: the row's threads score centroids sub, sub + tpr, ... of
    // each chunk, in the shared path's arithmetic
    const bool scorer = row < rows;
    const V* xr = xs + (size_t)row * sv;
    A best = A(0), x2 = A(0);
    int best_c = -1;
    for (int c0 = 0; c0 < k; c0 += kc) {
      const int kcur = min(kc, k - c0);
      __syncthreads();  // the tile is staged; the previous chunk's readers are done
      if (vec_load) {  // d % VW == 0 and c 16-byte aligned: whole vectors
        const V* src = reinterpret_cast<const V*>(c) + (size_t)c0 * dv;
        for (int e = t; e < kcur * dv; e += kThreads) {
          const int cc = e / dv, j = e - cc * dv;
          cs[cc * sv + j] = src[e];
        }
      } else {
        A* csa = reinterpret_cast<A*>(cs);
        for (int e = t; e < kcur * dv * VW; e += kThreads) {
          const int cc = e / (dv * VW), j = e - cc * (dv * VW);
          csa[(size_t)cc * sv * VW + j] = j < d ? c[(size_t)(c0 + cc) * d + j] : A(0);
        }
      }
      __syncthreads();
      for (int cc = t; cc < kcur; cc += kThreads) {
        A s = A(0);
        for (int j = 0; j < dv; ++j) s += vdot(cs[cc * sv + j], cs[cc * sv + j]);
        c2[cc] = s;
      }
      __syncthreads();
      if (scorer) {
        if (c0 == 0 && sub == 0)
          for (int j = 0; j < dv; ++j) x2 += vdot(xr[j], xr[j]);
        // KB centroids cc, cc + tpr, ... at a time share each load of the row
        for (int cc = sub; cc < kcur; cc += KB * tpr) {
          A dot[KB];
#pragma unroll
          for (int u = 0; u < KB; ++u) dot[u] = A(0);
          for (int j = 0; j < dv; ++j) {
            const V xv = xr[j];
#pragma unroll
            for (int u = 0; u < KB; ++u)
              if (cc + u * tpr < kcur) dot[u] += vdot(xv, cs[(cc + u * tpr) * sv + j]);
          }
#pragma unroll
          for (int u = 0; u < KB; ++u) {
            if (cc + u * tpr >= kcur) break;
            const A score = c2[cc + u * tpr] - A(2) * dot[u];
            if (best_c < 0 || score < best) {
              best = score;
              best_c = c0 + cc + u * tpr;
            }
          }
        }
      }
    }
    // combine the row's threads: the lower score, then the lower index
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off >= tpr) break;
      const A ob = __shfl_xor_sync(kFull, best, off);
      const int oc = __shfl_xor_sync(kFull, best_c, off);
      if (oc >= 0 && (best_c < 0 || ob < best || (ob == best && oc < best_c))) {
        best = ob;
        best_c = oc;
      }
    }
    const bool live = scorer && sub == 0 && valid[row];
    if (scorer && sub == 0) {
      lab[row] = best_c;
      if (labels != nullptr) labels[r0 + row] = best_c;
    }
    A v = live ? best + x2 : A(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) inertia += v;
    const int nv = __syncthreads_count(t < rows && valid[t]);

    // the tile's valid rows ordered by label, rows of one label in row order
    for (int r = t; r < rows; r += kThreads) {
      if (!valid[r]) continue;
      const int l = lab[r];
      int rank = 0;
      for (int q = 0; q < rows; ++q) rank += valid[q] && (lab[q] < l || (lab[q] == l && q < r));
      order[rank] = r;
    }
    __syncthreads();

    // fold: item (p, j), p the first ordered row of a label's run, sums
    // column vector j of the run's rows and adds it to the block's sums
    for (int e = t; e < nv * dv; e += kThreads) {
      const int p = e / dv, j = e - p * dv;
      const int l = lab[order[p]];
      if (p > 0 && lab[order[p - 1]] == l) continue;
      V s = xs[order[p] * sv + j];
      int q = p + 1;
      for (; q < nv && lab[order[q]] == l; ++q) vadd(s, xs[order[q] * sv + j]);
      const A* sa = reinterpret_cast<const A*>(&s);
      A* dst = w + (size_t)l * d + j * VW;
#pragma unroll
      for (int u = 0; u < VW; ++u)
        if (j * VW + u < d) dst[u] += sa[u];
      if (j == 0) w[k * d + l] += static_cast<A>(q - p);
    }
    __syncthreads();
  }

  if (lane == 0) inertw[warp] = inertia;
  __syncthreads();
  if (t == 0) {
    A s = A(0);
    for (int wp = 0; wp < kWarps; ++wp) s += inertw[wp];
    w[k * d + k] = s;
  }
}

template <typename T>
__global__ void kmeans_reduce_kernel(const T* __restrict__ ws, T* __restrict__ out,
                                     int blocks, int width) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  T s = T(0);
  for (int b = 0; b < blocks; ++b) s += ws[(size_t)b * width + e];
  out[e] = s;
}

template <typename T, int KMAX>
cudaError_t launch_partial(const T* x, const T* c, const uint8_t* mask, T* ws, int* labels,
                           int64_t n, int d, int k, int grid, int tile_rows,
                           cudaStream_t stream) {
  const size_t smem = Layout(d, sizeof(T)).bytes(k, tile_rows, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kmeans_partial_kernel<T, KMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec_load = d % Vec<T>::n == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kmeans_partial_kernel<T, KMAX><<<grid, kThreads, smem, stream>>>(x, c, mask, ws, labels, n,
                                                                    d, k, tile_rows, vec_load);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream(const T* x, const T* c, const uint8_t* mask, T* ws, int* labels,
                          int64_t n, int d, int k, int grid, int tile_rows, int kc,
                          cudaStream_t stream) {
  const size_t smem = StreamLayout(d, sizeof(T)).bytes(kc, tile_rows, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kmeans_stream_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec_load = d % Vec<T>::n == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(c) % 16 == 0;
  kmeans_stream_kernel<T><<<grid, kThreads, smem, stream>>>(x, c, mask, ws, labels, n, d, k,
                                                            tile_rows, kc, vec_load);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* c, const uint8_t* mask, void* ws, void* out,
                   int* labels, int64_t n, int d, int k, int grid, int tile_rows, int chunk,
                   cudaStream_t stream) {
  if (tile_rows > kThreads || tile_rows < 1 || chunk < 0) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* cp = static_cast<const T*>(c);
  T* wp = static_cast<T*>(ws);
  cudaError_t err;
  if (chunk > 0)
    err = launch_stream<T>(xp, cp, mask, wp, labels, n, d, k, grid, tile_rows, chunk, stream);
  else if (k <= 8)
    err = launch_partial<T, 8>(xp, cp, mask, wp, labels, n, d, k, grid, tile_rows, stream);
  else
    err = launch_partial<T, 0>(xp, cp, mask, wp, labels, n, d, k, grid, tile_rows, stream);
  if (err != cudaSuccess) return err;
  const int width = k * d + k + 1;
  kmeans_reduce_kernel<T><<<(width + 255) / 256, 256, 0, stream>>>(wp, static_cast<T*>(out),
                                                                    grid, width);
  return cudaGetLastError();
}

template <typename T, int KMAX>
cudaError_t occupancy_k(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kmeans_partial_kernel<T, KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kmeans_partial_kernel<T, KMAX>,
                                                       kThreads, smem);
}

template <typename T>
cudaError_t occupancy(int k, bool stream, size_t smem, int* per_sm) {
  if (stream) {
    cudaError_t err = cudaFuncSetAttribute(kmeans_stream_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kmeans_stream_kernel<T>,
                                                         kThreads, smem);
  }
  if (k <= 8) return occupancy_k<T, 8>(smem, per_sm);
  return occupancy_k<T, 0>(smem, per_sm);
}

}  // namespace

// Pick the path, the tile rows and the grid, by shape alone. The shared path
// (chunk = 0) takes the largest of 128..8 tile rows whose shared memory fits
// a block next to the k*d centroids and partial sums. Where not even 8 rows
// fit, the streaming path takes the largest of 128..1 rows whose tile fills
// at most half the block's shared memory and a chunk of as many centroids
// as fit the rest (at most k). The grid: blocks resident on card `device`
// at once, at most one per tile. Returns -1 only where one row of d values
// does not fit half a block's shared memory.
extern "C" int heat_kmeans_step_plan(int64_t n, int d, int k, int dtype, int* tile_rows,
                                     int* grid, int* chunk, int device) {
  DeviceScope scope(device);
  cudaError_t err = scope.error();
  int sms, optin;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int acc_bytes = dtype == kF64 ? 8 : 4;
  const Layout L(d, acc_bytes);
  int tr = kThreads, kc = 0;
  while (tr >= 8 && L.bytes(k, tr, acc_bytes) > (size_t)optin) tr /= 2;
  size_t smem = L.bytes(k, tr, acc_bytes);
  if (tr < 8) {
    const StreamLayout S(d, acc_bytes);
    tr = kThreads;
    while (tr > 1 && 2 * S.bytes(0, tr, acc_bytes) > (size_t)optin) tr /= 2;
    if (2 * S.bytes(0, tr, acc_bytes) > (size_t)optin) return -1;
    const size_t per_centroid = (size_t)S.sv * 16 + acc_bytes;
    const size_t room = ((size_t)optin - S.bytes(0, tr, acc_bytes)) / per_centroid;
    kc = static_cast<int>(room < (size_t)k ? room : (size_t)k);
    smem = S.bytes(kc, tr, acc_bytes);
  }
  int per_sm = 0;
  if (dtype == kF64)
    err = occupancy<double>(k, kc > 0, smem, &per_sm);
  else
    err = occupancy<float>(k, kc > 0, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + tr - 1) / tr;
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  *tile_rows = tr;
  *chunk = kc;
  *grid = static_cast<int>(tiles < 1 ? 1 : (tiles < resident ? tiles : resident));
  return cudaSuccess;
}

// x (n, d) and centroids (k, d) contiguous, f32 or f64, on card `device`;
// mask (n,) bytes or NULL for all rows; ws holds grid * (k*d + k + 1)
// values; out (k*d + k + 1) receives sums, counts, inertia in x's dtype;
// labels (n,) int32 receives each row's cluster, or is NULL; grid,
// tile_rows and chunk as heat_kmeans_step_plan gave them. Returns the
// cudaError_t.
extern "C" int heat_kmeans_step(const void* x, const void* c, const void* mask, void* ws,
                                void* out, void* labels, int64_t n, int d, int k, int dtype,
                                int grid, int tile_rows, int chunk, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* lab = static_cast<int*>(labels);
  switch (dtype) {
    case kF32: return launch<float>(x, c, m, ws, out, lab, n, d, k, grid, tile_rows, chunk, s);
    case kF64: return launch<double>(x, c, m, ws, out, lab, n, d, k, grid, tile_rows, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* heat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

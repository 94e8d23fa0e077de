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
// Design. Pass 1: a persistent grid of 256-thread blocks, as many as fit on
// the card at once, walks X in tiles of up to 128 rows (tile t goes to block
// t mod grid). The tiles stream through a ring of kStages slots in shared
// memory filled by cp.async (common.cuh: TileStager), copies that bypass
// the registers: those of tile i + 1 are in flight while tile i is scored
// and folded. Each row is staged as it lies in memory (16-byte pieces
// where x's address and row length allow, else 8 or 4) into a slot row
// padded with zeros to dv whole 16-byte vectors; the slot's row stride is odd
// in vectors, so the rows a quarter-warp reads lie in 8 different bank
// groups (a bulk copy of the tile would land the rows unpadded, 256 bytes
// apart at d = 64, all in one bank group). The centroids (rows padded the
// same way) and c^2 sit in shared memory for the whole pass. Two threads
// score each row, each half of the centroids: 16-byte loads of the row,
// broadcast loads of the centroids, its dot products in registers, the
// first-index argmin with strict <, then the pair's (the lower score, then
// the lower index). A row's arithmetic is the same as one thread's over all
// k: every sum over the feature axis keeps its order. Counts come from warp
// ballots (exact integers) and the inertia from a fixed shuffle tree, per
// warp; then each warp folds the 16 rows it scored into its own partial
// sums, lane p adding 8-byte piece p of each valid row: for k <= 8 and rows
// of at most 256 bytes in registers, cluster by cluster over the rows of
// each one's ballot (no indexing by the label), else in the warp's region
// of shared memory. The centroid rows past k are zeros, so the scoring loop
// tests nothing but its end. No element has two writers and every order is
// fixed, so there are no atomics and repeated runs are bitwise equal. Each
// block writes its partial (k*d + k + 1 values; the warps' sums added in
// warp order) to a workspace row. Pass 2: one thread per output element
// sums the workspace column over the blocks in block order and stores it in
// x's dtype (heat_tpu casts its outputs the same way, :925-926). Counts are
// exact integers inside a block and cast to x's dtype for the workspace:
// exact up to 2^24 rows per cluster per shard in f32, heat_tpu's limit too.
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

constexpr int kThreads = 128;  // the streaming path's block
constexpr int kWarps = kThreads / 32;
constexpr int kPThreads = 256;  // the shared path's block: two threads a row
constexpr int kPWarps = kPThreads / 32;
constexpr int kMaxTileRows = kPThreads / 2;
constexpr int KB = 4;  // centroids a thread of the streaming path scores at once
constexpr int kStages = 2;  // tiles in the shared path's ring
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
// 16 bytes; the row stride sv of the tiles and the centroids is odd in
// vectors, so the 8 rows a quarter-warp reads hit 8 different bank groups.
// The partial sums are kept per warp: each warp folds the
// 16 rows it scored. On the register path (KMAX > 0) they live in registers
// and take the ring's place only after the last tile.
struct Layout {
  int vw, dv, sv;
  __host__ __device__ Layout(int d, int acc_bytes) {
    vw = 16 / acc_bytes;
    dv = (d + vw - 1) / vw;
    sv = dv % 2 == 0 ? dv + 1 : dv;
  }
  __host__ __device__ size_t ring_bytes(int tile_rows) const {
    return (size_t)kStages * tile_rows * sv * 16;
  }
  __host__ __device__ size_t acc_bytes(int k) const { return (size_t)kPWarps * k * dv * 16; }
  // ring[kStages][tile_rows][sv] and acc[kPWarps][k][dv] (KMAX > 0: acc over the
  // ring) | cs[kc][sv]                                  (16-byte vectors)
  // c2[kc] | inertia[kPWarps]                           (accumulation type)
  // counts[kPWarps][k] (uint32)
  __host__ __device__ size_t front_bytes(int k, int tile_rows, bool reg_sums) const {
    const size_t ring = ring_bytes(tile_rows), acc = acc_bytes(k);
    return reg_sums ? (ring > acc ? ring : acc) : ring + acc;
  }
  // centroid rows in shared memory: on the register path always 8, the rows
  // past k zeros, so the scoring loop has no test of k
  __host__ __device__ static int centroid_rows(int k, bool reg_sums) {
    return reg_sums && k < 8 ? 8 : k;
  }
  __host__ __device__ size_t bytes(int k, int tile_rows, bool reg_sums, int acc_bytes_) const {
    const int kc = centroid_rows(k, reg_sums);
    return front_bytes(k, tile_rows, reg_sums) + (size_t)kc * sv * 16 +
           (size_t)(kc + kPWarps) * acc_bytes_ + (size_t)kPWarps * k * 4;
  }
};

// k <= 8 and a row of at most 32 pieces of 8 bytes: the k dot products of a
// row, and a lane's k partial sums of one piece, live in registers
__host__ __device__ inline bool register_path(int k, int d, int acc_bytes) {
  return k <= 8 && d * acc_bytes <= 32 * 8;
}

// 8 bytes of a row: what a lane folds at once
template <typename T> struct Piece;
template <> struct Piece<float> { using type = float2; };
template <> struct Piece<double> { using type = double; };
__device__ __forceinline__ void vadd(float2& a, float2 b) { a.x += b.x; a.y += b.y; }
__device__ __forceinline__ void vadd(double& a, double b) { a += b; }

// The better of two (score, index) candidates, index -1 for none: the lower
// score, then the lower index (NaN never replaces a candidate).
template <typename A>
__device__ __forceinline__ void take_better(A& best, int& best_c, A other, int other_c) {
  if (other_c >= 0 &&
      (best_c < 0 || other < best || (other == best && other_c < best_c))) {
    best = other;
    best_c = other_c;
  }
}

// KMAX == 8: register_path(); KMAX == 0: any k, one centroid at a time, the
// partial sums in shared memory. Two threads score each row, each half of
// the centroids (KMAX == 8: centroids 0-3 and 4-7; else every second one);
// warp w scores rows 16w .. 16w + 15 of a tile and folds them.
template <typename T, int KMAX>
__global__ void __launch_bounds__(kPThreads)
kmeans_partial_kernel(const T* __restrict__ x, const T* __restrict__ c,
                      const uint8_t* __restrict__ mask, T* __restrict__ ws,
                      int* __restrict__ labels, int64_t n, int d, int k, int tile_rows,
                      int piece) {
  using A = T;
  using V = typename Vec<T>::type;
  using P = typename Piece<T>::type;
  constexpr int VW = Vec<T>::n;
  constexpr bool kRegSums = KMAX > 0;
  constexpr int KH = KMAX / 2;  // centroids a thread scores on the register path
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, sizeof(A));
  const int dv = L.dv, sv = L.sv;
  V* ring = reinterpret_cast<V*>(smem);
  P* acc = reinterpret_cast<P*>(kRegSums ? ring : ring + (size_t)kStages * tile_rows * sv);
  const int kc = Layout::centroid_rows(k, kRegSums);
  V* cs = reinterpret_cast<V*>(smem + L.front_bytes(k, tile_rows, kRegSums));
  A* c2 = reinterpret_cast<A*>(cs + (size_t)kc * sv);
  A* inertw = c2 + kc;
  unsigned* cntw = reinterpret_cast<unsigned*>(inertw + kPWarps);

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int row = t >> 1, sub = t & 1;  // the row this thread scores, and its half
  const int pieces = dv * 2;            // 8-byte pieces a padded row
  P* accw = acc + (size_t)warp * k * pieces;  // this warp's sums: [k][pieces]
  if constexpr (!kRegSums)
    for (int e = t; e < kPWarps * k * pieces; e += kPThreads) acc[e] = P{};
  for (int e = t; e < kPWarps * k; e += kPThreads) cntw[e] = 0u;
  A* csa = reinterpret_cast<A*>(cs);
  for (int e = t; e < kc * sv * VW; e += kPThreads) {
    const int cc = e / (sv * VW), j = e - cc * (sv * VW);
    csa[e] = cc < k && j < d ? c[(size_t)cc * d + j] : A(0);
  }

  // the ring: this block's tiles are blockIdx.x, + gridDim.x, ...; tile i
  // lands in slot i % kStages, kStages - 1 tiles ahead of the one scored
  const int64_t num_tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t mine = blockIdx.x < num_tiles ? (num_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const TileStager stager(dv * 16, kPThreads, piece);
  const int64_t row_bytes = (int64_t)d * sizeof(T);
  auto issue = [&](int64_t i) {
    if (i < mine) {
      const int64_t r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
      const int rows = n - r0 < tile_rows ? static_cast<int>(n - r0) : tile_rows;
      stager.issue(reinterpret_cast<unsigned char*>(ring + (i % kStages) * tile_rows * sv),
                   sv * 16, 0, reinterpret_cast<const unsigned char*>(x + r0 * d), row_bytes,
                   rows, static_cast<int>(row_bytes));
    }
    cp_async_commit();  // one group per tile, empty past the last
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  __syncthreads();
  for (int cc = t; cc < kc; cc += kPThreads) {
    A s = A(0);
    for (int j = 0; j < dv; ++j) s += vdot(cs[cc * sv + j], cs[cc * sv + j]);
    c2[cc] = s;
  }
  P sums[kRegSums ? KMAX : 1];
  unsigned cnt[kRegSums ? KMAX : 1];
#pragma unroll
  for (int cc = 0; cc < (kRegSums ? KMAX : 1); ++cc) {
    sums[cc] = P{};
    cnt[cc] = 0u;
  }
  // the mask of this thread's row, one tile ahead
  auto mask_of = [&](int64_t i) -> bool {
    if (i >= mine) return false;
    const int64_t r = (blockIdx.x + i * gridDim.x) * tile_rows + row;
    return row < tile_rows && r < n && (mask == nullptr || mask[r] != 0);
  };
  bool valid_next = mask_of(0);
  A inertia = A(0);  // lane 0 of each warp

  for (int64_t i = 0; i < mine; ++i) {
    issue(i + kStages - 1);  // into the slot tile i - 1 left
    const bool valid = valid_next;
    valid_next = mask_of(i + 1);
    const int64_t r0 = (blockIdx.x + i * gridDim.x) * tile_rows;
    const int rows = n - r0 < tile_rows ? static_cast<int>(n - r0) : tile_rows;
    const V* xs = ring + (i % kStages) * tile_rows * sv;
    cp_async_wait<kStages - 1>();  // this thread's copies of tile i have landed
    __syncthreads();                 // and every thread's

    // assignment: each half's first-index argmin, then the pair's
    A best = A(0), x2 = A(0);
    int best_c = -1;
    if (row < rows) {
      const V* xr = xs + row * sv;
      if constexpr (KMAX > 0) {
        A dot[KH];
#pragma unroll
        for (int u = 0; u < KH; ++u) dot[u] = A(0);
        const V* cb = cs + sub * KH * sv;  // this half's centroids (zeros past k)
        for (int j = 0; j < dv; ++j) {
          const V xv = xr[j];
          V cv[KH];
#pragma unroll
          for (int u = 0; u < KH; ++u) cv[u] = cb[u * sv + j];
          x2 += vdot(xv, xv);
#pragma unroll
          for (int u = 0; u < KH; ++u) dot[u] += vdot(xv, cv[u]);
        }
#pragma unroll
        for (int u = 0; u < KH; ++u) {
          const int cc = sub * KH + u;
          if (cc < k) {
            const A score = c2[cc] - A(2) * dot[u];
            if (best_c < 0 || score < best) {
              best = score;
              best_c = cc;
            }
          }
        }
      } else {
        for (int j = 0; j < dv; ++j) x2 += vdot(xr[j], xr[j]);
        for (int cc = sub; cc < k; cc += 2) {
          A dot = A(0);
          for (int j = 0; j < dv; ++j) dot += vdot(xr[j], cs[cc * sv + j]);
          const A score = c2[cc] - A(2) * dot;
          if (best_c < 0 || score < best) {
            best = score;
            best_c = cc;
          }
        }
      }
    }
    take_better(best, best_c, __shfl_xor_sync(kFull, best, 1),
                __shfl_xor_sync(kFull, best_c, 1));
    const bool live = sub == 0 && row < rows && valid;
    if (sub == 0 && row < rows && labels != nullptr) labels[r0 + row] = best_c;
    A v = live ? best + x2 : A(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) inertia += v;
    // fold: the warp adds its valid rows to its sums, each cluster's in a
    // fixed order (register path: from the last row; shared-memory path: from
    // the first), lane p taking 8-byte piece p (p + 32, ... on the
    // shared-memory path); bit 2q of a ballot is row q of the warp
    const P* xp = reinterpret_cast<const P*>(xs) + (size_t)warp * 16 * sv * 2;
    if constexpr (kRegSums) {
#pragma unroll
      for (int cc = 0; cc < KMAX; ++cc) {
        if (cc < k) {
          unsigned rows_cc = __ballot_sync(kFull, live && best_c == cc);
          cnt[cc] += __popc(rows_cc);
          if (lane < pieces) {
            // the cluster's rows from the last, two loads in flight at once
            while (rows_cc != 0) {
              const int b0 = 31 - __clz(rows_cc);
              rows_cc ^= 1u << b0;
              const P v0 = xp[(b0 >> 1) * sv * 2 + lane];
              if (rows_cc == 0) {
                vadd(sums[cc], v0);
                break;
              }
              const int b1 = 31 - __clz(rows_cc);
              rows_cc ^= 1u << b1;
              const P v1 = xp[(b1 >> 1) * sv * 2 + lane];
              vadd(sums[cc], v0);
              vadd(sums[cc], v1);
            }
          }
        }
      }
    } else {
      for (int cc = 0; cc < k; ++cc) {
        const unsigned b = __ballot_sync(kFull, live && best_c == cc);
        if (lane == 0) cntw[warp * k + cc] += __popc(b);
      }
      const int lab = live ? best_c : -1;
      for (int q = 0; q < 16; ++q) {
        const int l = __shfl_sync(kFull, lab, 2 * q);
        if (l < 0) continue;  // masked or past the tile: the same in every lane
        for (int p = lane; p < pieces; p += 32) vadd(accw[l * pieces + p], xp[q * sv * 2 + p]);
      }
    }
    __syncthreads();  // the slot is free again
  }

  cp_async_wait<0>();
  if (lane == 0) inertw[warp] = inertia;
  if constexpr (kRegSums) {  // the sums take the ring's place
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < KMAX; ++cc) {
      if (cc < k) {
        if (lane < pieces) accw[cc * pieces + lane] = sums[cc];
        if (lane == 0) cntw[warp * k + cc] = cnt[cc];
      }
    }
  }
  __syncthreads();
  T* w = ws + (size_t)blockIdx.x * (k * d + k + 1);
  const A* acca = reinterpret_cast<const A*>(acc);
  const int dp = dv * VW;
  for (int e = t; e < k * d; e += kPThreads) {
    const int cc = e / d, j = e - cc * d;
    A s = A(0);
    for (int g = 0; g < kPWarps; ++g) s += acca[((size_t)g * k + cc) * dp + j];
    w[e] = s;
  }
  for (int cc = t; cc < k; cc += kPThreads) {
    unsigned s = 0;
    for (int wp = 0; wp < kPWarps; ++wp) s += cntw[wp * k + cc];
    w[k * d + cc] = static_cast<A>(s);
  }
  if (t == 0) {
    A s = A(0);
    for (int wp = 0; wp < kPWarps; ++wp) s += inertw[wp];
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

// Each kernel's shared-memory ceiling, raised once per card
template <typename T, int KMAX>
cudaError_t raise_partial() {
  static std::atomic<uint32_t> done{0};
  return raise_smem_limit_max(reinterpret_cast<const void*>(kmeans_partial_kernel<T, KMAX>),
                              done);
}
template <typename T>
cudaError_t raise_stream() {
  static std::atomic<uint32_t> done{0};
  return raise_smem_limit_max(reinterpret_cast<const void*>(kmeans_stream_kernel<T>), done);
}

template <typename T, int KMAX>
cudaError_t launch_partial(const T* x, const T* c, const uint8_t* mask, T* ws, int* labels,
                           int64_t n, int d, int k, int grid, int tile_rows,
                           cudaStream_t stream) {
  cudaError_t err = raise_partial<T, KMAX>();
  if (err != cudaSuccess) return err;
  const size_t smem =
      Layout(d, sizeof(T)).bytes(k, tile_rows, KMAX > 0, sizeof(T));
  const int piece = piece_bytes(x, (int64_t)d * sizeof(T));
  kmeans_partial_kernel<T, KMAX><<<grid, kPThreads, smem, stream>>>(
      x, c, mask, ws, labels, n, d, k, tile_rows, piece);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream(const T* x, const T* c, const uint8_t* mask, T* ws, int* labels,
                          int64_t n, int d, int k, int grid, int tile_rows, int kc,
                          cudaStream_t stream) {
  cudaError_t err = raise_stream<T>();
  if (err != cudaSuccess) return err;
  const size_t smem = StreamLayout(d, sizeof(T)).bytes(kc, tile_rows, sizeof(T));
  const int vec_load = d % Vec<T>::n == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(c) % 16 == 0;
  kmeans_stream_kernel<T><<<grid, kThreads, smem, stream>>>(x, c, mask, ws, labels, n, d, k,
                                                            tile_rows, kc, vec_load);
  return cudaGetLastError();
}

// chunk > 0: the streaming path; else the shared path with a ring of
// kStages tiles (KMAX = 8 where register_path() holds)
template <typename T>
cudaError_t launch(const void* x, const void* c, const uint8_t* mask, void* ws, void* out,
                   int* labels, int64_t n, int d, int k, int grid, int tile_rows, int chunk,
                   cudaStream_t stream) {
  if (tile_rows > kMaxTileRows || tile_rows < 1 || chunk < 0)
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* cp = static_cast<const T*>(c);
  T* wp = static_cast<T*>(ws);
  cudaError_t err;
  if (chunk > 0)
    err = launch_stream<T>(xp, cp, mask, wp, labels, n, d, k, grid, tile_rows, chunk, stream);
  else if (register_path(k, d, sizeof(T)))
    err = launch_partial<T, 8>(xp, cp, mask, wp, labels, n, d, k, grid, tile_rows, stream);
  else
    err = launch_partial<T, 0>(xp, cp, mask, wp, labels, n, d, k, grid, tile_rows, stream);
  if (err != cudaSuccess) return err;
  const int width = k * d + k + 1;
  kmeans_reduce_kernel<T><<<(width + 255) / 256, 256, 0, stream>>>(wp, static_cast<T*>(out),
                                                                    grid, width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int k, int d, bool stream, size_t smem, int* per_sm) {
  cudaError_t err;
  if (stream) {
    err = raise_stream<T>();
    return err != cudaSuccess ? err
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    per_sm, kmeans_stream_kernel<T>, kThreads, smem);
  }
  if (register_path(k, d, sizeof(T))) {
    err = raise_partial<T, 8>();
    return err != cudaSuccess ? err
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    per_sm, kmeans_partial_kernel<T, 8>, kPThreads, smem);
  }
  err = raise_partial<T, 0>();
  return err != cudaSuccess ? err
                            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                  per_sm, kmeans_partial_kernel<T, 0>, kPThreads, smem);
}

}  // namespace

// Pick the path, the tile rows and the grid, by shape
// alone. The shared path (chunk = 0) takes the largest of 128..8 tile rows
// whose ring of kStages tiles fits a block next to the k*d centroids and
// partial sums. Where not even 8 rows fit, the streaming path takes the
// largest of 128..1 rows whose tile fills at most half the block's shared
// memory and a chunk of as many centroids as fit the rest (at most k). The
// grid: blocks resident on card `device` at once, at most one per tile.
// Returns -1 only where one row of d values does not fit half a block's
// shared memory. The wrapper caches the plan per shape and card.
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
  const bool reg = register_path(k, d, acc_bytes);
  int tr = kMaxTileRows, kc = 0;
  while (tr >= 8 && L.bytes(k, tr, reg, acc_bytes) > (size_t)optin) tr /= 2;
  size_t smem = L.bytes(k, tr, reg, acc_bytes);
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
    err = occupancy<double>(k, d, kc > 0, smem, &per_sm);
  else
    err = occupancy<float>(k, d, kc > 0, smem, &per_sm);
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
    case kF32:
      return launch<float>(x, c, m, ws, out, lab, n, d, k, grid, tile_rows, chunk, s);
    case kF64:
      return launch<double>(x, c, m, ws, out, lab, n, d, k, grid, tile_rows, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* heat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// flash_bwd: the flash-attention backward, two kernels that recompute the
// probabilities from the forward's saved log-sum-exp (lse). Both run here
// for float16; heat_flash_bwd_dkv and heat_flash_bwd_dq route bf16 and
// float32, by dtype alone, to the tensor-core kernels of
// flash_bwd_dkv_sm90.cu and flash_bwd_dq_sm90.cu.
//
// Replaces the TPU kernels launched by heat_tpu/core/pallas_kernels.py:549
// _flash_bwd_impl:
//   - flash_bwd_dkv_kernel for _flash_bwd_dkv_kernel (:412, pallas_call
//     :592): dK and dV of one key tile, accumulated over the query tiles;
//   - flash_bwd_dq_kernel for _flash_bwd_dq_kernel (:488, pallas_call :618):
//     dQ of one query tile, accumulated over the key tiles.
// For q, dout (BH, Sq, D), k, v (BH, Sk, D), lse and dmb (BH, Sq) float32,
// with s = k . (q * scale), both compute
//   p  = exp(s - lse) where the pair is visible and lse is finite, else 0,
//   dp = v . dout,   ds = p * (dp + dmb),
//   dV = P^T dout,   dK = scale * dS^T q,   dQ = scale * dS k,
// where dmb = dlse - rowsum(dout * out) is computed by the caller, as
// heat_tpu computes it outside its kernels (:571-573). What they keep of the
// TPU kernels: only the Sk real keys count; the causal mask is end-aligned
// (key col is visible to query row iff col <= row + Sk - Sq); the finite-lse
// gate gives p = 0 on rows that saw no key; tiles wholly above the causal
// diagonal are skipped; products in fp32 FMA on fp32 copies of the tiles
// (heat_tpu runs them at HIGHEST precision: no TF32, no bf16 products).
// Empty rows follow the dense backward (:668-686) exactly: a skipped pair
// has p = 0, and 0 x a non-finite dmb is NaN there, so a skipped query row
// with a non-finite dmb makes the key tile's dK NaN, and a query row whose
// tile skipped keys gets a NaN dQ where its dmb is not finite. Nothing else
// of a skipped tile can reach the result.
//
// What bounds them on an H100: at the training path's shapes (8 x 16 heads,
// head dim 64, 1024 rows, causal) the product work per live (query, key)
// pair is 4 dot products of length D for dK/dV (s, dp, and one row each of
// dV and dK) and 3 for dQ, 8 * D and 6 * D FLOPs, against ~100 MB of
// traffic: over the fp32 CUDA-core rate the products take ~15x as long as
// the bytes. So, as in the forward, every intermediate (s, p, dp, ds and the
// accumulators) stays on chip and each tile of Q, dO, K and V is read once
// per partner tile. Neither kernel uses atomics: each output row is written
// once by the one block that owns it, so runs are bitwise repeatable.
//
// Design (fp32 FMA on the CUDA cores):
// 128 threads, 16 row groups of 8 lanes, 64 x 64 tiles, as the forward.
//   dK/dV: one block per (batch*head, 64-key tile), the earliest keys (the
//   most live query tiles under the causal mask) first. K and V stay in
//   shared memory; the query tiles from the diagonal on stream through with
//   their dO, lse and dmb. A thread owns 4 keys and 8 queries of the
//   transposed score tile (s and dp in registers), writes P^T and dS^T to
//   shared memory, then accumulates 4 keys x DP/8 columns of both dK and dV
//   in registers.
//   dQ: one block per (batch*head, 64-row query tile), the heaviest causal
//   tiles first. Q (times scale) and dO stay in shared memory; the live key
//   tiles stream through. A thread owns 4 queries and 8 keys of the score
//   tile, writes dS to shared memory, and accumulates 4 rows x DP/8 columns
//   of dQ in registers.
// Head dims pad to DP in {32, 64, 128} with zeros in shared memory only;
// rows and keys past the ends are masked in the kernels.
#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NT = 128;     // threads: 16 row groups x 8 lanes
constexpr int LP = 64 + 2;  // row stride of the P^T, dS^T and dS tiles

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return static_cast<size_t>(2 * BK * (DP + 4) + 2 * BQ * (DP + 4) + 2 * BK * LP + 2 * BQ) *
         sizeof(float);
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return static_cast<size_t>(2 * BQ * (DP + 4) + 2 * BK * (DP + 4) + BQ * LP) * sizeof(float);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dmb, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, int d, float scale, int causal, int vec) {
  constexpr int LD = DP + 4;   // row stride of the Q, dO, K and V tiles (floats)
  constexpr int NG = DP / 32;  // 4-column groups of dK and dV each thread owns
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;   // q * scale
  float* os = qs + BQ * LD;   // dout
  float* pt = os + BQ * LD;   // P^T (BK x LP)
  float* dt = pt + BK * LP;   // dS^T (BK x LP)
  float* lse_s = dt + BK * LP;
  float* dmb_s = lse_s + BQ;

  const int t = threadIdx.x;
  const int tx = t & 7;   // lane: queries tx + 8j of the tile, columns g*32 + tx*4 + e
  const int ty = t >> 3;  // row group: keys ty*4 .. ty*4 + 3 of the tile
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int offset = sk - sq;
  const T* qb = q + bh * sq * d;
  const T* ob = dout + bh * sq * d;
  const float* lseb = lse + bh * sq;
  const float* dmbb = dmb + bh * sq;

  load_tile<T, DP, BK, NT>(ks, k + (bh * sk + k0) * d, min(BK, sk - k0), d, vec, 1.f);
  load_tile<T, DP, BK, NT>(vs, v + (bh * sk + k0) * d, min(BK, sk - k0), d, vec, 1.f);

  // causal: query rows below k0 - offset see none of these keys, so their
  // tiles are skipped; the dense backward's 0 x dmb on those pairs is NaN
  // where dmb is not finite
  const int qt0 = causal ? max(0, k0 - offset) / BQ : 0;
  int poison = 0;
  for (int r = t; r < min(qt0 * BQ, sq); r += NT) poison |= !isfinite(dmbb[r]);
  poison = __syncthreads_or(poison);

  float acc_k[4][NG * 4], acc_v[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nqt = (sq + BQ - 1) / BQ;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done with qs, os, pt, dt and the stats
    load_tile<T, DP, BQ, NT>(qs, qb + static_cast<int64_t>(q0) * d, min(BQ, sq - q0), d, vec, scale);
    load_tile<T, DP, BQ, NT>(os, ob + static_cast<int64_t>(q0) * d, min(BQ, sq - q0), d, vec, 1.f);
    if (t < BQ) {
      const bool in = q0 + t < sq;
      lse_s[t] = in ? lseb[q0 + t] : 0.f;
      dmb_s[t] = in ? dmbb[q0 + t] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T for keys ty*4 + i and queries tx + 8j
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = *reinterpret_cast<const float4*>(ks + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (tx + 8 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = dot4(qv, kv[i], s[i][j]);
      }
    }
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = *reinterpret_cast<const float4*>(vs + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 ov = *reinterpret_cast<const float4*>(os + (tx + 8 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[i][j] = dot4(ov, vv[i], dp[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = tx + 8 * j;
        const int row = q0 + qi;
        const float l = lse_s[qi];
        const bool ok = row < sq && col < sk && (!causal || col <= row + offset) && isfinite(l);
        const float p = ok ? expf(s[i][j] - l) : 0.f;
        pt[(ty * 4 + i) * LP + qi] = p;
        dt[(ty * 4 + i) * LP + qi] = row < sq ? p * (dp[i][j] + dmb_s[qi]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qi = 0; qi < BQ; ++qi) {
      float pv[4], dv_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty * 4 + i) * LP + qi];
        dv_[i] = dt[(ty * 4 + i) * LP + qi];
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 ov = *reinterpret_cast<const float4*>(os + qi * LD + g * 32 + tx * 4);
        const float4 qv = *reinterpret_cast<const float4*>(qs + qi * LD + g * 32 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][g * 4 + 0] = fmaf(pv[i], ov.x, acc_v[i][g * 4 + 0]);
          acc_v[i][g * 4 + 1] = fmaf(pv[i], ov.y, acc_v[i][g * 4 + 1]);
          acc_v[i][g * 4 + 2] = fmaf(pv[i], ov.z, acc_v[i][g * 4 + 2]);
          acc_v[i][g * 4 + 3] = fmaf(pv[i], ov.w, acc_v[i][g * 4 + 3]);
          acc_k[i][g * 4 + 0] = fmaf(dv_[i], qv.x, acc_k[i][g * 4 + 0]);
          acc_k[i][g * 4 + 1] = fmaf(dv_[i], qv.y, acc_k[i][g * 4 + 1]);
          acc_k[i][g * 4 + 2] = fmaf(dv_[i], qv.z, acc_k[i][g * 4 + 2]);
          acc_k[i][g * 4 + 3] = fmaf(dv_[i], qv.w, acc_k[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty * 4 + i;
    if (col >= sk) continue;
    T* krow = dk + (bh * sk + col) * d;
    T* vrow = dv + (bh * sk + col) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 32 + tx * 4 + e;
        if (c < d) {
          krow[c] = from_acc<T>(poison ? nan_f() : acc_k[i][g * 4 + e]);  // q was staged times scale
          vrow[c] = from_acc<T>(acc_v[i][g * 4 + e]);
        }
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dmb, T* __restrict__ dq, int sq, int sk, int d,
                    float scale, int causal, int vec) {
  constexpr int LD = DP + 4;
  constexpr int NG = DP / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // q * scale
  float* os = qs + BQ * LD;   // dout
  float* ks = os + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;  // dS (BQ x LP)

  const int t = threadIdx.x;
  const int tx = t & 7;   // lane: keys tx + 8j of the tile, columns g*32 + tx*4 + e
  const int ty = t >> 3;  // row group: query rows ty*4 .. ty*4 + 3 of the tile
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int offset = sk - sq;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  load_tile<T, DP, BQ, NT>(qs, q + (bh * sq + q0) * d, min(BQ, sq - q0), d, vec, scale);
  load_tile<T, DP, BQ, NT>(os, dout + (bh * sq + q0) * d, min(BQ, sq - q0), d, vec, 1.f);

  float lr[4], mr[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < sq ? lse[bh * sq + row] : 0.f;
    mr[i] = row < sq ? dmb[bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last row's diagonal are never visible
  const int kend = causal ? min(sk, q0 + BQ + offset) : sk;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with ks, vs and dss
    load_tile<T, DP, BK, NT>(ks, kb + static_cast<int64_t>(k0) * d, min(BK, sk - k0), d, vec, 1.f);
    load_tile<T, DP, BK, NT>(vs, vb + static_cast<int64_t>(k0) * d, min(BK, sk - k0), d, vec, 1.f);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = dot4(qv[i], kv, s[i][j]);
      }
    }
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = *reinterpret_cast<const float4*>(os + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + (tx + 8 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[i][j] = dot4(ov[i], vv, dp[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool ok = row < sq && col < sk && (!causal || col <= row + offset) && isfinite(lr[i]);
        const float p = ok ? expf(s[i][j] - lr[i]) : 0.f;
        dss[(ty * 4 + i) * LP + tx + 8 * j] = col < sk ? p * (dp[i][j] + mr[i]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + kk * LD + g * 32 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(dsv[i], kv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(dsv[i], kv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(dsv[i], kv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(dsv[i], kv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

  // keys from kend on were skipped: the dense backward pairs them at p = 0,
  // which is NaN where dmb is not finite
  const bool skipped = kend < sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const bool poison = skipped && !isfinite(mr[i]);
    T* qrow = dq + (bh * sq + row) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 32 + tx * 4 + e;
        if (c < d) qrow[c] = from_acc<T>(poison ? nan_f() : acc[i][g * 4 + e] * scale);
      }
  }
}

int aligned16(const void* a, const void* b, const void* c, const void* e) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c) % 16 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0;
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dmb, void* dk, void* dv, int64_t bh,
                       int sq, int sk, int d, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(dkv_smem_bytes<DP>());
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dkv_kernel<T, DP>),
                                     smem, smem_raised);
  if (err != cudaSuccess) return err;
  const int vec = d == DP && aligned16(q, k, v, dout);
  dim3 grid(static_cast<unsigned>(bh), (sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dmb, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      d, scale, causal, vec);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dmb, void* dq, int64_t bh, int sq, int sk,
                      int d, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(dq_smem_bytes<DP>());
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, DP>),
                                     smem, smem_raised);
  if (err != cudaSuccess) return err;
  const int vec = d == DP && aligned16(q, k, v, dout);
  dim3 grid(static_cast<unsigned>(bh), (sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dmb, static_cast<T*>(dq), sq, sk, d, scale, causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_d(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* dmb, void* dk, void* dv, int64_t bh, int sq, int sk, int d,
                  float scale, int causal, cudaStream_t s) {
  if (d <= 32) return launch_dkv<T, 32>(q, k, v, dout, lse, dmb, dk, dv, bh, sq, sk, d, scale, causal, s);
  if (d <= 64) return launch_dkv<T, 64>(q, k, v, dout, lse, dmb, dk, dv, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch_dkv<T, 128>(q, k, v, dout, lse, dmb, dk, dv, bh, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dq_d(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* dmb, void* dq, int64_t bh, int sq, int sk, int d, float scale,
                 int causal, cudaStream_t s) {
  if (d <= 32) return launch_dq<T, 32>(q, k, v, dout, lse, dmb, dq, bh, sq, sk, d, scale, causal, s);
  if (d <= 64) return launch_dq<T, 64>(q, k, v, dout, lse, dmb, dq, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch_dq<T, 128>(q, k, v, dout, lse, dmb, dq, bh, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* dmb, void* dk, void* dv,
                               int64_t bh, int sq, int sk, int d, float scale, int causal,
                               cudaStream_t s);
cudaError_t flash_bwd_dkv_sm90_f32(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* dmb, void* dk, void* dv,
                                   void* ws, int split, int64_t bh, int sq, int sk, int d,
                                   float scale, int causal, cudaStream_t s);
cudaError_t flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* dmb, void* dq, int64_t bh, int sq,
                              int sk, int d, float scale, int causal, cudaStream_t s);
cudaError_t flash_bwd_dq_sm90_f32(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* dmb, void* dq, void* ws,
                                  int split, int64_t bh, int sq, int sk, int d, float scale,
                                  int causal, cudaStream_t s);

// q, dout (bh, sq, d) and k, v (bh, sk, d), contiguous and of one dtype
// (f32, bf16 or f16) on card `device`; lse and dmb (bh, sq) float32. dk and
// dv (bh, sk, d) in that dtype. ws: for f32 the workspace of the split
// planes, 12 * bh * d8 * (sq + sk) bytes (d8: d rounded up to 8), 16-byte
// aligned; unused otherwise. The wrapper guarantees bh >= 1, 1 <= sq,
// 1 <= sk <= 65535 * 64 and 1 <= d <= 128. bf16 and f32 run on the tensor
// cores (flash_bwd_dkv_sm90.cu), f16 here. Returns the launch's cudaError_t.
extern "C" int heat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* dmb, void* dk, void* dv, void* ws,
                                  int split, int64_t bh, int sq, int sk, int d, int dtype,
                                  float scale, int causal, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* m = static_cast<const float*>(dmb);
  switch (dtype) {
    case kF32:
      return flash_bwd_dkv_sm90_f32(q, k, v, dout, l, m, dk, dv, ws, split, bh, sq, sk, d, scale,
                                    causal, s);
    case kBF16: return flash_bwd_dkv_sm90(q, k, v, dout, l, m, dk, dv, bh, sq, sk, d, scale, causal, s);
    case kF16: return dkv_d<__half>(q, k, v, dout, l, m, dk, dv, bh, sq, sk, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// The same inputs and workspace; dq (bh, sq, d) in their dtype. The wrapper
// guarantees bh >= 1, 1 <= sq <= 65535 * 64, 1 <= sk and 1 <= d <= 128.
// bf16 and f32 run on the tensor cores (flash_bwd_dq_sm90.cu), f16 here.
extern "C" int heat_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* dmb, void* dq, void* ws, int split,
                                 int64_t bh, int sq, int sk, int d, int dtype, float scale,
                                 int causal, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* m = static_cast<const float*>(dmb);
  switch (dtype) {
    case kF32:
      return flash_bwd_dq_sm90_f32(q, k, v, dout, l, m, dq, ws, split, bh, sq, sk, d, scale,
                                   causal, s);
    case kBF16: return flash_bwd_dq_sm90(q, k, v, dout, l, m, dq, bh, sq, sk, d, scale, causal, s);
    case kF16: return dq_d<__half>(q, k, v, dout, l, m, dq, bh, sq, sk, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

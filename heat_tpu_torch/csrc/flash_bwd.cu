// flash_bwd: the float16 flash-attention dQ kernel, recomputing the
// probabilities from the forward's saved log-sum-exp (lse), and the C entry
// points of both backward kernels. heat_flash_bwd_dkv routes every dtype it
// takes, and heat_flash_bwd_dq bf16 and float32, by dtype alone, to the
// tensor-core kernels of flash_bwd_dkv_sm90.cu and flash_bwd_dq_sm90.cu.
//
// flash_bwd_dq_kernel replaces the TPU kernel
// heat_tpu/core/pallas_kernels.py:488 _flash_bwd_dq_kernel (pallas_call
// :618, launched by _flash_bwd_impl :549) for float16: dQ of one query
// tile, accumulated over the key tiles. For q, dout (BH, Sq, D), k, v (BH,
// Sk, D), lse and dmb (BH, Sq) float32, with s = k . (q * scale):
//   p  = exp(s - lse) where the pair is visible and lse is finite, else 0,
//   dp = v . dout,   ds = p * (dp + dmb),   dQ = scale * dS k,
// where dmb = dlse - rowsum(dout * out) is computed by the caller, as
// heat_tpu computes it outside its kernels (:571-573). What it keeps of the
// TPU kernel: only the Sk real keys count; the causal mask is end-aligned
// (key col is visible to query row iff col <= row + Sk - Sq); the finite-lse
// gate gives p = 0 on rows that saw no key; tiles wholly above the causal
// diagonal are skipped; products in fp32 FMA on fp32 copies of the tiles
// (heat_tpu runs them at HIGHEST precision: no TF32, no bf16 products).
// Empty rows follow the dense backward (:668-686) exactly: a skipped pair
// has p = 0, and 0 x a non-finite dmb is NaN there, so a query row whose
// tile skipped keys gets a NaN dQ where its dmb is not finite. Nothing else
// of a skipped tile can reach the result.
//
// What bounds it on an H100: at the training path's shapes (8 x 16 heads,
// head dim 64, 1024 rows, causal) the product work per live (query, key)
// pair is 3 dot products of length D, 6 * D FLOPs, against ~85 MB of
// traffic: over the fp32 CUDA-core rate the products take ~15x as long as
// the bytes. So every intermediate (s, p, dp, ds and the accumulator) stays
// on chip and each K and V tile is read once per query tile. No atomics:
// each dQ row is written once by the one block that owns it, so runs are
// bitwise repeatable.
//
// Design (fp32 FMA on the CUDA cores): 128 threads, 16 row groups of 8
// lanes, 64 x 64 tiles, as the FMA forward (flash_fwd.cu). One block per
// (batch*head, 64-row query tile), the heaviest causal tiles first. Q (times
// scale) and dO stay in shared memory; the live key tiles stream through. A
// thread owns 4 queries and 8 keys of the score tile, writes dS to shared
// memory, and accumulates 4 rows x DP/8 columns of dQ in registers. Head
// dims pad to DP in {32, 64, 128} with zeros in shared memory only; rows and
// keys past the ends are masked in the kernel.
#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NT = 128;     // threads: 16 row groups x 8 lanes
constexpr int LP = 64 + 2;  // row stride of the dS tile (conflict-free writes and reads)

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
                               const float* lse, const float* dmb, void* dk, void* dv, void* ws,
                               int split, int64_t bh, int sq, int sk, int d, int dtype,
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
// 1 <= sk <= 65535 * 64 and 1 <= d <= 128. Every dtype runs on the tensor
// cores (flash_bwd_dkv_sm90.cu). Returns the launch's cudaError_t.
extern "C" int heat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* dmb, void* dk, void* dv, void* ws,
                                  int split, int64_t bh, int sq, int sk, int d, int dtype,
                                  float scale, int causal, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  return flash_bwd_dkv_sm90(q, k, v, dout, static_cast<const float*>(lse),
                            static_cast<const float*>(dmb), dk, dv, ws, split, bh, sq, sk, d,
                            dtype, scale, causal, static_cast<cudaStream_t>(stream));
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

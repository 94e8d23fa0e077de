// flash_fwd: blockwise attention forward with online softmax, returning the
// output and the per-row log-sum-exp (lse); the fp32-FMA kernel for float32
// inputs. heat_flash_attention routes bf16 and float16, by dtype alone, to
// the tensor-core kernel of flash_fwd_sm90.cu.
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:348 _flash_impl
// (body _flash_kernel :234, pallas_call :374): for q (BH, Sq, D) and k, v
// (BH, Sk, D), out = softmax((q * scale) k^T) v and lse = log sum exp of the
// scores, per row. What it keeps of the TPU kernel:
//   - scale before the product: s = (q * scale) . k, in fp32 FMA (the TPU
//     runs its products at HIGHEST precision; no TF32, no bf16 products);
//   - only the Sk real keys count, and the causal mask is end-aligned:
//     key col is visible to query row iff col <= row + (Sk - Sq);
//   - masked scores take -1e30 and their probabilities are zeroed
//     explicitly, so a row with no visible key ends with l == 0 and gives a
//     NaN output and a -inf lse, as dense softmax over all -inf does;
//   - key tiles wholly above the causal diagonal are skipped.
// Results do not depend on the caller's block_q/block_k (the card uses its
// own 64 x 64 tiles; the wrapper documents that it ignores them).
//
// What bounds it on an H100: at the serving path's shapes (16 heads, head
// dim 64, 1024 rows, causal) the product work, 4 * Sq * Sk * D / 2 FLOPs per
// head (2.1 GFLOP for one prefill), over the 67 TFLOP/s fp32 CUDA-core rate,
// is ~12x the time to move Q, K, V and O once. So the design keeps every
// intermediate (scores, probabilities, running max and sum, the output
// accumulator) on chip and reads each K/V tile once per query tile.
//
// Design (fp32 FMA on the CUDA cores, for float32, whose two float32
// operands the tensor-core kernel does not split yet): one block of 128
// threads per (batch*head, 64-row query tile), the heaviest causal tiles
// scheduled first. The query tile is staged in shared memory once, as fp32
// multiplied by scale; K and V tiles of 64 keys follow in turn. Threads form
// 16 row groups of 8 lanes: each thread owns 4 query rows, 8 of the tile's
// keys (scores in registers) and 4*(DP/32) output columns (the accumulator
// in registers). Row max and row sum are shuffle reductions over the 8
// lanes of a row, so every lane of a row holds the same running max and
// sum. Probabilities go through shared memory for
// the P.V product. Head dims are padded to DP in {32, 64, 128} with zeros in
// shared memory; nothing is padded in device memory. Rows and keys past the
// ends are masked in the kernel.
#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NT = 128;        // threads: 16 row groups x 8 lanes
constexpr int LP = BK + 2;     // row stride of the P tile (conflict-free writes and reads)
constexpr float kNegBig = -1e30f;  // the TPU kernel's _NEG_BIG (pallas_kernels.py:55)

template <int DP>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * (DP + 4) + 2 * BK * (DP + 4) + BQ * LP) * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int d,
                 float scale, int causal, int vec) {
  constexpr int LD = DP + 4;   // row stride of the Q, K and V tiles (floats)
  constexpr int NG = DP / 32;  // 4-column groups of the output each thread owns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;

  const int t = threadIdx.x;
  const int tx = t & 7;   // lane within the row group: keys tx + 8j, columns g*32 + tx*4 + e
  const int ty = t >> 3;  // row group: query rows ty*4 .. ty*4 + 3 of the tile
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int offset = sk - sq;                        // end-aligned causal diagonal
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  load_tile<T, DP, BQ, NT>(qs, qb + static_cast<int64_t>(q0) * d, min(BQ, sq - q0), d, vec, scale);

  float m[4], l[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last row's diagonal are never visible
  const int kend = causal ? min(sk, q0 + BQ + offset) : sk;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with ks, vs and ps
    load_tile<T, DP, BK, NT>(ks, kb + static_cast<int64_t>(k0) * d, min(BK, sk - k0), d, vec, 1.f);
    load_tile<T, DP, BK, NT>(vs, vb + static_cast<int64_t>(k0) * d, min(BK, sk - k0), d, vec, 1.f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[8];
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        ok[j] = col < sk && (!causal || col <= row + offset);
        if (!ok[j]) s[i][j] = kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * LP + tx + 8 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + kk * LD + g * 32 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pv[i], vv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pv[i], vv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pv[i], vv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pv[i], vv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

  const float nan = __int_as_float(0x7fc00000);
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const bool empty = l[i] == 0.f;
    T* orow = out + (bh * sq + row) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 32 + tx * 4 + e;
        if (col < d) orow[col] = from_acc<T>(empty ? nan : acc[i][g * 4 + e] / l[i]);
      }
    if (tx == 0) lse[bh * sq + row] = empty ? neg_inf : m[i] + logf(l[i]);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int64_t bh, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = static_cast<int>(smem_bytes<DP>());
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(flash_fwd_kernel<T, DP>),
                                     smem, smem_raised);
  if (err != cudaSuccess) return err;
  const int vec = d == DP && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  dim3 grid(static_cast<unsigned>(bh), (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, d, scale, causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* lse,
                     int64_t bh, int sq, int sk, int d, float scale, int causal,
                     cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t flash_fwd_sm90(const void* q, const void* k, const void* v, void* out, float* lse,
                           int64_t bh, int sq, int sk, int d, int dtype, float scale, int causal,
                           cudaStream_t s);

// q (bh, sq, d), k and v (bh, sk, d), contiguous and of one dtype (f32, bf16
// or f16) on card `device`; out (bh, sq, d) in that dtype and lse (bh, sq)
// float32. The wrapper guarantees bh >= 1, 1 <= sq <= 65535 * 64 and
// 1 <= d <= 128. bf16 and f16 run on the tensor cores (flash_fwd_sm90.cu),
// f32 here. Returns the launch's cudaError_t.
extern "C" int heat_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int64_t bh, int sq, int sk, int d, int dtype,
                                    float scale, int causal, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case kF32: return launch_d<float>(q, k, v, out, l, bh, sq, sk, d, scale, causal, s);
    case kBF16:
    case kF16: return flash_fwd_sm90(q, k, v, out, l, bh, sq, sk, d, dtype, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

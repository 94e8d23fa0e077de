// flash_bwd_dkv_sm90: dK and dV of the bf16 flash-attention backward on
// Hopper's tensor cores, recomputing the probabilities from the forward's
// saved log-sum-exp (lse).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:412
// _flash_bwd_dkv_kernel (pallas_call :592, launched by _flash_bwd_impl
// :549) for bf16 inputs; float32 and float16 stay on the fp32-FMA kernel of
// flash_bwd.cu, which routes here by dtype only. For q, dout (BH, Sq, D),
// k, v (BH, Sk, D), lse and dmb (BH, Sq) float32, with s = scale * k . q:
//   p  = exp(s - lse) where the pair is visible and lse is finite, else 0,
//   dp = v . dout,   ds = p * (dp + dmb),
//   dV = P^T dout,   dK = scale * dS^T q.
// The rules of the FMA kernel stay (flash_bwd.cu): only the Sk real keys
// count, the causal diagonal is end-aligned, the finite-lse gate, query
// tiles wholly below a key tile's diagonal are skipped, and a skipped query
// row with a non-finite dmb makes the key tile's dK NaN, as the dense
// backward's 0 x dmb does there. No atomics: each dK and dV row is written
// once by the block that owns it, so runs are bitwise repeatable.
//
// Precision (heat_tpu runs the products at HIGHEST with float32
// accumulation, pallas_kernels.py:445-472): S^T = K Q^T and dP^T = V dO^T
// take one bf16 wgmma pass each (exact products, fp32 sums); dV += P^T dO
// and dK += dS^T Q split the fp32 P^T and dS^T into three bf16 terms
// (sm90_common.cuh, split3) and take three passes each, smallest term
// first; the scale is applied to the fp32 scores and to dK at the end.
//
// What bounds it on an H100: at the training path's shape (8 x 16 heads of
// 64, 1024 rows, causal) the eight bf16 passes per live pair, 16 * D FLOPs,
// over the tensor-core rate take ~2.3x the time of moving the inputs and
// outputs once: bound by tensor-core operations. So every intermediate
// (S^T, dP^T, P^T, dS^T, the dK and dV accumulators) stays in registers,
// K and V are read once per block and each query tile once per key tile.
//
// Design: one block of 384 threads per (batch*head, 128-key tile), the
// earliest keys (most live query tiles) first: two consumer warpgroups of
// 64 keys each and one producer warpgroup, which hands most of its
// registers to them (setmaxnreg). The producer's elected lane loads K and
// V once and streams the query tiles from the diagonal on, with their dO,
// by TMA through a ring of NS stages (128-byte swizzle, zeros past every
// end); where TMA cannot address a row the whole warpgroup stages the same
// layout with plain loads. lse and dmb come in as plain loads, issued
// before the products that need them. A consumer warpgroup runs S^T and
// dP^T as m64n{BQ}k16 wgmmas (K, V and Q, dO all K-major), forms P^T and
// dS^T in the accumulators' registers (exp2 on the special-function unit;
// rows past Sq and rows with a non-finite lse take lse = +inf, so only
// tiles on an edge need masks), and feeds their split terms as register A
// fragments to m64n{DP}k16 wgmmas whose dO and Q operands are read MN-major
// from the same tiles, splitting dS^T while dV's passes run: nothing is
// transposed in memory. Head dims pad to DP in {64, 128} with zeros in
// shared memory only; at DP = 128 query tiles shrink to 32 rows so the
// accumulators fit the registers.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BKB = 128;  // keys per block (64 per consumer warpgroup)
constexpr int NS = 3;     // query-tile ring stages
constexpr int NT = 384;   // two consumer warpgroups and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Layout {
  static constexpr int BQ = DP == 64 ? 64 : 32;     // query rows per streamed tile
  static constexpr int KV_BYTES = BKB * DP * 2;     // the K or V tile
  static constexpr int Q_BYTES = BQ * DP * 2;       // one Q or dO tile
  static constexpr int STAGE = 2 * Q_BYTES;         // Q then dO
  static constexpr int SMEM = 2 * KV_BYTES + NS * STAGE + 1024;  // + alignment slack
};

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dmb, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int sk, int d, float scale,
                          int causal, int use_tma) {
  using L = Layout<DP>;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars<NS> bars;  // once: the K and V tiles; the ring: Q/dO tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = smem;
  uint8_t* vs = smem + L::KV_BYTES;
  uint8_t* ring = smem + 2 * L::KV_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKB;
  const int offset = sk - sq;
  // causal: query rows below k0 - offset see none of these keys
  const int qt0 = causal ? max(0, k0 - offset) / BQ : 0;
  const int nqt = (sq + BQ - 1) / BQ;
  const int ntiles = max(0, nqt - qt0);

  if (tid == 0) bars.init(use_tma);
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup --------------------------------------------
    // It hands its registers to the consumers; with TMA one lane works.
    setmaxnreg_dec<40>();
    const Src kv[2] = {{&tk, k, sk}, {&tv, v, sk}};
    const Src qdo[2] = {{&tq, q, sq}, {&tdo, dout, sq}};
    produce<DP, NS, BKB, 2, BQ, 2>(bars, use_tma, tid - 256, bh, d, ks, kv, k0, ring, qdo, qt0,
                                   ntiles);
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------
  setmaxnreg_inc<232>();
  const int wg = warp >> 2;      // 64-key half of the key tile
  const int kw = k0 + wg * 64;   // first key of this warpgroup
  const int key0 = kw + 16 * (warp & 3) + (lane >> 2);  // keys key0 and key0 + 8 of this thread
  // the first query tile that sees any of this warpgroup's keys
  const int my_qt = causal ? max(0, kw - offset) / BQ : 0;
  const float scale_log2 = scale * kLog2e;
  const float* lseb = lse + static_cast<int64_t>(bh) * sq;
  const float* dmbb = dmb + static_cast<int64_t>(bh) * sq;

  // skipped query rows: the dense backward's 0 x dmb there is NaN where dmb
  // is not finite (each warp scans them on its own)
  int poison = 0;
  for (int r = lane; r < min(my_qt * BQ, sq); r += 32) poison |= !isfinite(dmbb[r]);
  poison = __any_sync(0xffffffffu, poison);

  float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  mbar_wait(&bars.once, 0);
  const uint32_t k_addr = smem_u32(ks) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(vs) + wg * 64 * 128;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    const int qt = qt0 + t;
    const int q0 = qt * BQ;
    if (qt >= my_qt) {
      // lse (log2 domain) and dmb of this thread's query columns; a row past
      // sq or with a non-finite lse takes lse = +inf, so its p is exp2(-inf) = 0
      float ls[BQ / 4], mb[BQ / 4];
#pragma unroll
      for (int c = 0; c < BQ / 4; ++c) {
        const int row = q0 + 8 * (c >> 1) + 2 * (lane & 3) + (c & 1);
        const float x = row < sq ? lseb[row] : __int_as_float(0x7f800000);
        ls[c] = isfinite(x) ? x * kLog2e : __int_as_float(0x7f800000);
        mb[c] = row < sq ? dmbb[row] : 0.f;
      }
      mbar_wait(&bars.full[s], (t / NS) & 1);
      const uint32_t q_addr = smem_u32(ring + s * L::STAGE);
      const uint32_t o_addr = q_addr + L::Q_BYTES;

      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a 64-column block
        Wgmma<BQ>::ss(st, kmajor_desc(k_addr + (kk >> 2) * BKB * 128 + off),
                      kmajor_desc(q_addr + (kk >> 2) * BQ * 128 + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        Wgmma<BQ>::ss(dpt, kmajor_desc(v_addr + (kk >> 2) * BKB * 128 + off),
                      kmajor_desc(o_addr + (kk >> 2) * BQ * 128 + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // P^T into st, dS^T into dpt: register i holds key key0 + 8 * ((i / 2) % 2)
      // and query q0 + acc_col(i, lane), whose lse and dmb are ls/mb[c]
      const bool edge = (causal && kw + 63 > q0 + offset) || kw + 64 > sk;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 2 * (i >> 2) + (i & 1);
        float p = ex2(fmaf(st[i], scale_log2, -ls[c]));
        if (edge) {
          const int row = q0 + acc_col(i, lane);
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (!(key < sk && (!causal || key <= row + offset))) p = 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] + mb[c]);  // rows past sq have p = 0 and dmb = 0
      }

      uint32_t a1[BQ / 16][4], a2[BQ / 16][4], a3[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split3(st[8 * kk + 2 * j], st[8 * kk + 2 * j + 1], a1[kk][j], a2[kk][j], a3[kk][j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(acc_v, a3[kk], sw128_desc(o_addr + kk * 2048, BQ * 128));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(acc_v, a2[kk], sw128_desc(o_addr + kk * 2048, BQ * 128));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(acc_v, a1[kk], sw128_desc(o_addr + kk * 2048, BQ * 128));
      wgmma_commit();
      if constexpr (DP > 64) wgmma_wait<0>();  // frees the P^T terms' registers

      uint32_t b1[BQ / 16][4], b2[BQ / 16][4], b3[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split3(dpt[8 * kk + 2 * j], dpt[8 * kk + 2 * j + 1], b1[kk][j], b2[kk][j], b3[kk][j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(acc_k, b3[kk], sw128_desc(q_addr + kk * 2048, BQ * 128));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(acc_k, b2[kk], sw128_desc(q_addr + kk * 2048, BQ * 128));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<DP>::rs(acc_k, b1[kk], sw128_desc(q_addr + kk * 2048, BQ * 128));
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      mbar_wait(&bars.full[s], (t / NS) & 1);
    }
    if (lane == 0) mbar_arrive(&bars.empty[s]);
  }

  // ---- epilogue: dK (times scale, NaN where poisoned) and dV -------------
  const float nan = __int_as_float(0x7fc00000);
  const bool pairs = (d & 1) == 0 && (reinterpret_cast<uintptr_t>(dk) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(dv) & 3) == 0;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int key = key0 + 8 * ((i >> 1) & 1);
    const int col = acc_col(i, lane);
    if (key >= sk || col >= d) continue;
    const int64_t at = (static_cast<int64_t>(bh) * sk + key) * d + col;
    const float k0v = poison ? nan : acc_k[i] * scale;
    const float k1v = poison ? nan : acc_k[i + 1] * scale;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(k0v, k1v);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
    } else {
      dk[at] = __float2bfloat16(k0v);
      dv[at] = __float2bfloat16(acc_v[i]);
      if (col + 1 < d) {
        dk[at + 1] = __float2bfloat16(k1v);
        dv[at + 1] = __float2bfloat16(acc_v[i + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dmb, void* dk, void* dv, int64_t bh, int sq,
                   int sk, int d, float scale, int causal, cudaStream_t stream) {
  using L = Layout<DP>;
  constexpr int smem = L::SMEM;
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(flash_bwd_dkv_sm90_kernel<DP>), smem, smem_raised);
  if (err != cudaSuccess) return err;
  const int use_tma = tma_ok(q, d) && tma_ok(k, d) && tma_ok(v, d) && tma_ok(dout, d);
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  if (use_tma) {
    if ((err = make_tmap(&tq, q, bh, sq, d, L::BQ)) != cudaSuccess) return err;
    if ((err = make_tmap(&tdo, dout, bh, sq, d, L::BQ)) != cudaSuccess) return err;
    if ((err = make_tmap(&tk, k, bh, sk, d, BKB)) != cudaSuccess) return err;
    if ((err = make_tmap(&tv, v, bh, sk, d, BKB)) != cudaSuccess) return err;
  }
  dim3 grid(static_cast<unsigned>(bh), (sk + BKB - 1) / BKB);
  flash_bwd_dkv_sm90_kernel<DP><<<grid, NT, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, dmb,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq, sk, d, scale, causal,
      use_tma);
  return cudaGetLastError();
}

}  // namespace

// The bf16 case of heat_flash_bwd_dkv (flash_bwd.cu): the same arguments.
cudaError_t flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* dmb, void* dk, void* dv,
                               int64_t bh, int sq, int sk, int d, float scale, int causal,
                               cudaStream_t s) {
  if (d <= 64) return launch<64>(q, k, v, dout, lse, dmb, dk, dv, bh, sq, sk, d, scale, causal, s);
  if (d <= 128)
    return launch<128>(q, k, v, dout, lse, dmb, dk, dv, bh, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

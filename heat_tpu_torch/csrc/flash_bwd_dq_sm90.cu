// flash_bwd_dq_sm90: dQ of the bf16 flash-attention backward on Hopper's
// tensor cores, recomputing the probabilities from the forward's saved
// log-sum-exp (lse).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:488
// _flash_bwd_dq_kernel (pallas_call :618, launched by _flash_bwd_impl :549)
// for bf16 inputs; float32 and float16 stay on the fp32-FMA kernel of
// flash_bwd.cu, which routes here by dtype only. For q, dout (BH, Sq, D),
// k, v (BH, Sk, D), lse and dmb (BH, Sq) float32, with s = scale * q . k:
//   p  = exp(s - lse) where the pair is visible and lse is finite, else 0,
//   dp = dout . v,   ds = p * (dp + dmb),   dQ = scale * dS K.
// The rules of the FMA kernel stay (flash_bwd.cu): only the Sk real keys
// count, the causal diagonal is end-aligned, the finite-lse gate, key tiles
// wholly above the diagonal are skipped, and a query row whose skipped keys
// meet a non-finite dmb gets a NaN dQ, as the dense backward's 0 x dmb
// gives there. No atomics: each dQ row is written once by the block that
// owns it, so runs are bitwise repeatable.
//
// Precision (heat_tpu runs the products at HIGHEST with float32
// accumulation, pallas_kernels.py:510-533): S = Q K^T and dP = dO V^T take
// one bf16 wgmma pass each (exact products, fp32 sums); dQ += dS K splits
// the fp32 dS into three bf16 terms (sm90_common.cuh, split3) and takes
// three passes, smallest term first; the scale is applied to the fp32
// scores and to dQ at the end.
//
// What bounds it on an H100: at the training path's shape (8 x 16 heads of
// 64, 1024 rows, causal) the five bf16 passes per live pair, 10 * D FLOPs,
// over the tensor-core rate take ~1.7x the time of moving the inputs and
// the output once: bound by tensor-core operations. So every intermediate
// (S, dP, P, dS and the dQ accumulator) stays in registers, Q and dO are
// read once per block and each key tile once per query tile.
//
// Design: one block of 384 threads per (batch*head, 128-row query tile),
// the heaviest causal tiles first: two consumer warpgroups of 64 query rows
// each and one producer warpgroup, which hands most of its registers to
// them (setmaxnreg). The producer's elected lane loads Q and dO once and
// streams the live K/V tiles, from key 0 up to the diagonal, by TMA through
// a ring of NS stages (128-byte swizzle, zeros past every end); where TMA
// cannot address a row the whole warpgroup stages the same layout with
// plain loads. Each thread's two rows of lse and dmb come in as plain loads
// before the first product. A consumer warpgroup runs S and dP as
// m64n64k16 wgmmas (Q, dO, K and V all K-major), forms P and dS in the
// accumulators' registers (exp2 on the special-function unit; rows past Sq
// and rows with a non-finite lse take lse = +inf, so only tiles on an edge
// need masks), and feeds dS's split terms as register A fragments to
// m64n{DP}k16 wgmmas whose K operand is read MN-major from the same tile:
// nothing is transposed in memory. Tile t's S and dP run while tile t - 1's
// dS K is still on the tensor cores. Head dims pad to DP in {64, 128} with
// zeros in shared memory only; dQ stays in registers and is scaled and
// written once.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;  // query rows per block (64 per consumer warpgroup)
constexpr int BK = 64;   // keys per streamed tile
constexpr int NS = 4;    // K/V ring stages
constexpr int NT = 384;  // two consumer warpgroups and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Layout {
  static constexpr int Q_BYTES = BQ * DP * 2;   // the Q or the dO tile
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;    // K then V
  static constexpr int SMEM = 2 * Q_BYTES + NS * STAGE + 1024;  // + alignment slack
};

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dmb, __nv_bfloat16* __restrict__ dq, int sq,
                         int sk, int d, float scale, int causal, int use_tma) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars<NS> bars;  // once: the Q and dO tiles; the ring: K/V tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;                    // Q, then dO at qs + Q_BYTES
  uint8_t* ring = smem + 2 * L::Q_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int offset = sk - sq;                        // end-aligned causal diagonal
  // causal: keys past the tile's last row's diagonal are never visible
  const int kend = causal ? min(sk, q0 + BQ + offset) : sk;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  if (tid == 0) bars.init(use_tma);
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup --------------------------------------------
    // It hands its registers to the consumers; with TMA one lane works.
    setmaxnreg_dec<40>();
    if (ntiles == 0) return;  // no key is visible to any row of the tile
    const Src qdo[2] = {{&tq, q, sq}, {&tdo, dout, sq}};
    const Src kv[2] = {{&tk, k, sk}, {&tv, v, sk}};
    produce<DP, NS, BQ, 2, BK, 2>(bars, use_tma, tid - 256, bh, d, qs, qdo, q0, ring, kv, 0,
                                  ntiles);
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------
  setmaxnreg_inc<232>();
  const int wg = warp >> 2;        // 64-row half of the query tile
  const int qw = q0 + wg * 64;     // first query row of this warpgroup
  const int r0 = qw + 16 * (warp & 3) + (lane >> 2);  // rows r0 and r0 + 8 of this thread
  // keys past this warpgroup's last row's diagonal are never visible to it:
  // it computes the first nt_wg tiles and only releases the rest
  const int kend_wg = causal ? min(sk, qw + 64 + offset) : sk;
  const int nt_wg = kend_wg > 0 ? min(ntiles, (kend_wg + BK - 1) / BK) : 0;
  const float scale_log2 = scale * kLog2e;

  // lse (log2 domain) and dmb of this thread's two rows; a row past sq or
  // with a non-finite lse takes lse = +inf, so its p is exp2(-inf) = 0
  float ls[2], mb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const float x = row < sq ? lse[static_cast<int64_t>(bh) * sq + row] : 0.f;
    ls[h] = row < sq && isfinite(x) ? x * kLog2e : __int_as_float(0x7f800000);
    mb[h] = row < sq ? dmb[static_cast<int64_t>(bh) * sq + row] : 0.f;
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float st[BK / 2], dst[BK / 2];  // S then P; dP then dS, of one tile
  uint32_t a1[BK / 16][4], a2[BK / 16][4], a3[BK / 16][4];  // dS's split terms

  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  const uint32_t o_addr = q_addr + L::Q_BYTES;
  auto k_addr = [&](int t) { return smem_u32(ring + (t % NS) * L::STAGE); };

  // S = Q K^T and dP = dO V^T of tile t (one commit group)
  auto mma_sdp = [&](int t) {
    const uint32_t ka = k_addr(t), va = ka + L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // k16 step inside a 64-column block
      Wgmma<BK>::ss(st, kmajor_desc(q_addr + (kk >> 2) * BQ * 128 + off),
                    kmajor_desc(ka + (kk >> 2) * BK * 128 + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      Wgmma<BK>::ss(dst, kmajor_desc(o_addr + (kk >> 2) * BQ * 128 + off),
                    kmajor_desc(va + (kk >> 2) * BK * 128 + off), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K of tile t from the split terms, smallest first (one commit group)
  auto mma_dq = [&](int t) {
    const uint32_t ka = k_addr(t);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::rs(acc, a3[kk], sw128_desc(ka + kk * 2048, BK * 128));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::rs(acc, a2[kk], sw128_desc(ka + kk * 2048, BK * 128));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::rs(acc, a1[kk], sw128_desc(ka + kk * 2048, BK * 128));
    wgmma_commit();
  };
  // dS of tile t into dst: register i holds row r0 + 8 * ((i / 2) % 2) and
  // key k0 + acc_col(i, lane). A masked pair has p = 0, so its dS is
  // 0 * (dp + dmb), NaN where dmb is not finite, as in the dense backward;
  // keys past sk are not keys at all and give 0.
  auto form_ds = [&](int t) {
    const int k0 = t * BK;
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qw + offset);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = ex2(fmaf(st[i], scale_log2, -ls[h]));
      if (edge) {
        const int key = k0 + acc_col(i, lane);
        if (causal && key > r0 + 8 * h + offset) p = 0.f;
        dst[i] = key < sk ? p * (dst[i] + mb[h]) : 0.f;
      } else {
        dst[i] = p * (dst[i] + mb[h]);
      }
    }
  };
  auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split3(dst[8 * kk + 2 * j], dst[8 * kk + 2 * j + 1], a1[kk][j], a2[kk][j], a3[kk][j]);
  };

  // Software pipeline: tile t's S and dP run, and its dS is formed, while
  // tile t - 1's dS K is still on the tensor cores; the arithmetic and its
  // order are those of one tile at a time.
  if (nt_wg > 0) {
    mbar_wait(&bars.once, 0);
    mbar_wait(&bars.full[0], 0);
    wgmma_fence();
    mma_sdp(0);
    wgmma_wait<0>();
    form_ds(0);
    split();
    for (int t = 1; t < nt_wg; ++t) {
      mbar_wait(&bars.full[t % NS], (t / NS) & 1);
      wgmma_fence();
      mma_sdp(t);
      mma_dq(t - 1);
      wgmma_wait<1>();  // S and dP of tile t are in; dS K of tile t - 1 may still run
      form_ds(t);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&bars.empty[(t - 1) % NS]);
      split();
    }
    wgmma_fence();
    mma_dq(nt_wg - 1);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&bars.empty[(nt_wg - 1) % NS]);
  }
  for (int t = nt_wg; t < ntiles; ++t) {
    mbar_wait(&bars.full[t % NS], (t / NS) & 1);
    if (lane == 0) mbar_arrive(&bars.empty[t % NS]);
  }

  // ---- epilogue: dQ times scale, NaN where skipped keys meet a non-finite dmb
  const float nan = __int_as_float(0x7fc00000);
  const bool skipped = nt_wg * BK < sk;
  bool poison[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) poison[h] = skipped && !isfinite(mb[h]);
  const bool pairs = (d & 1) == 0 && (reinterpret_cast<uintptr_t>(dq) & 3) == 0;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = r0 + 8 * h;
    const int col = acc_col(i, lane);
    if (row >= sq || col >= d) continue;
    __nv_bfloat16* qrow = dq + (static_cast<int64_t>(bh) * sq + row) * d;
    const float x0 = poison[h] ? nan : acc[i] * scale;
    const float x1 = poison[h] ? nan : acc[i + 1] * scale;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(qrow + col) = __floats2bfloat162_rn(x0, x1);
    } else {
      qrow[col] = __float2bfloat16(x0);
      if (col + 1 < d) qrow[col + 1] = __float2bfloat16(x1);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dmb, void* dq, int64_t bh, int sq, int sk,
                   int d, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::SMEM;
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(flash_bwd_dq_sm90_kernel<DP>), smem, smem_raised);
  if (err != cudaSuccess) return err;
  const int use_tma = tma_ok(q, d) && tma_ok(k, d) && tma_ok(v, d) && tma_ok(dout, d);
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  if (use_tma) {
    if ((err = make_tmap(&tq, q, bh, sq, d, BQ)) != cudaSuccess) return err;
    if ((err = make_tmap(&tdo, dout, bh, sq, d, BQ)) != cudaSuccess) return err;
    if ((err = make_tmap(&tk, k, bh, sk, d, BK)) != cudaSuccess) return err;
    if ((err = make_tmap(&tv, v, bh, sk, d, BK)) != cudaSuccess) return err;
  }
  dim3 grid(static_cast<unsigned>(bh), (sq + BQ - 1) / BQ);
  flash_bwd_dq_sm90_kernel<DP><<<grid, NT, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, dmb,
      static_cast<__nv_bfloat16*>(dq), sq, sk, d, scale, causal, use_tma);
  return cudaGetLastError();
}

}  // namespace

// The bf16 case of heat_flash_bwd_dq (flash_bwd.cu): the same arguments.
cudaError_t flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* dmb, void* dq, int64_t bh, int sq,
                              int sk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64) return launch<64>(q, k, v, dout, lse, dmb, dq, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch<128>(q, k, v, dout, lse, dmb, dq, bh, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

// flash_fwd_sm90: the bf16 and float16 flash-attention forward on Hopper's
// tensor cores, returning the output and the per-row log-sum-exp (lse).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:348 _flash_impl
// (body _flash_kernel :234, pallas_call :374) for bf16 and float16 inputs;
// float32 stays on the fp32-FMA kernel of flash_fwd.cu, which routes here by
// dtype only. For q (BH, Sq, D) and k, v (BH, Sk, D), out = softmax(scale *
// q k^T) v and lse = log sum exp of the scores, per row. The rules of the
// FMA kernel stay: only the Sk real keys count; the causal diagonal is
// end-aligned (key col is visible to query row iff col <= row + Sk - Sq);
// masked pairs get probability 0 (their scores take -inf; the running max
// starts at the TPU kernel's -1e30), so a row that sees no key gives a NaN
// output and a -inf lse; key tiles wholly above the diagonal are skipped and
// the heaviest query tiles run first; the lse is float32.
//
// Precision (heat_tpu runs both products at HIGHEST with float32
// accumulation, pallas_kernels.py:277-278, :292-293): S = Q K^T takes one
// wgmma pass (bf16 and float16 products are exact in fp32, summed in fp32)
// and the scale is applied to the fp32 scores (bitwise (q * scale) k at
// D = 64, where the scale is 1/8); O += P V splits the fp32 probabilities
// into terms of V's type, smallest term first: three bf16 terms (split3),
// or, for float16, two float16 terms of 2^15 P (split2h; P <= 1, so 2^15 P
// stays below float16's 65,504, and its terms keep 22 bits down to P ~
// 2^-18 and P within 2^-40 below), the 2^15 divided out with the row sum
// at the end (exact).
//
// What bounds it on an H100: at the paths' shapes (16 heads of 64, 1024
// rows, causal) the four bf16 passes (three float16) per live (query, key)
// pair, 8 * D FLOPs (6 * D), over the 989 TFLOP/s tensor-core rate take
// ~2x the time of moving Q, K, V and O once, so the card's bound is
// tensor-core operations. Per 64 x 64 tile a warpgroup also spends ~10 ALU
// instructions and one exp2 a score (scale, max, exp2, sum, the split)
// between its wgmmas.
// The design keeps every intermediate in registers (scores, probabilities,
// running max and sum, the output accumulator), reads each K/V tile once per
// 128-row query tile, keeps the tensor cores fed from shared memory that TMA
// fills ahead of them, and overlaps one tile's softmax with the previous
// tile's P V.
//
// Design: one block of 384 threads per (batch*head, 128-row query tile):
// two consumer warpgroups of 64 query rows each and one producer
// warpgroup, which hands most of its registers to them (setmaxnreg). The
// producer's elected lane loads the Q tile once and streams 64-key K/V
// tiles by TMA (cp.async.bulk.tensor, 128-byte swizzle, zeros past every
// end) through a ring of NS stages guarded by full/empty mbarriers; where
// TMA cannot address a row (d % 8 != 0 or an unaligned base) the whole
// warpgroup stages the same layout with plain loads. A consumer warpgroup
// runs S = Q K^T as m64n64k16 wgmmas (both operands K-major in shared
// memory), masks and exponentiates in the accumulator's registers (row max
// and row sum over the 4 threads of a quad, in the log2 domain, exp2 on
// the special-function unit), turns the probabilities into register A
// fragments of the three split terms, and adds P V into the output
// accumulator with m64n{DP}k16 wgmmas whose V operand is read MN-major from
// the same K/V tile layout: nothing is transposed in memory. Head dims pad
// to DP in {64, 128} with zeros in shared memory only; nothing is padded in
// device memory. One template serves both types (T = __nv_bfloat16 or
// __half): only the wgmma type, the split and the output rounding differ.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;  // query rows per block (64 per consumer warpgroup)
constexpr int BK = 64;   // keys per tile
constexpr int NS = 4;    // K/V ring stages
constexpr int NT = 384;  // two consumer warpgroups and one producer warpgroup
constexpr float kNegBig = -1e30f;  // the TPU kernel's _NEG_BIG (pallas_kernels.py:55)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kPScale = 32768.f;  // float16: P's scale, 2^15, before its split

template <int DP>
struct Layout {
  static constexpr int Q_BYTES = BQ * DP * 2;         // the query tile
  static constexpr int KV_BYTES = BK * DP * 2;        // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;          // K then V
  static constexpr int SMEM = Q_BYTES + NS * STAGE + 1024;  // + alignment slack
};

// T: the inputs' and output's type, __nv_bfloat16 or __half
template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const T* __restrict__ q,
                      const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int sq, int sk, int d, float scale_log2, int causal,
                      int use_tma) {
  using L = Layout<DP>;
  constexpr bool H = kIsHalf<T>;
  constexpr int TERMS = H ? 2 : 3;  // P's terms: float16 (of 2^15 P), or bf16
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars<NS> bars;  // once: the Q tile; the ring: K/V tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;
  uint8_t* ring = smem + L::Q_BYTES;

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
    if (ntiles == 0) return;  // nothing to load: every row of the tile is empty
    const Src qsrc[1] = {{&tq, q, sq}};
    const Src kv[2] = {{&tk, k, sk}, {&tv, v, sk}};
    produce<DP, NS, BQ, 1, BK, 2>(bars, use_tma, tid - 256, bh, d, qs, qsrc, q0, ring, kv, 0,
                                  ntiles);
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------
  setmaxnreg_inc<232>();
  const int wg = warp >> 2;        // 64-row half of the query tile
  const int qw = q0 + wg * 64;     // first query row of this warpgroup
  const int r0 = qw + 16 * (warp & 3) + (lane >> 2);  // rows r0 and r0 + 8 of this thread
  // keys past this warpgroup's last row's diagonal are never visible to it
  const int kend_wg = causal ? min(sk, qw + 64 + offset) : sk;

  // this warpgroup computes the first nt_wg tiles; the rest lie wholly
  // above its diagonal and are only released
  const int nt_wg = kend_wg > 0 ? min(ntiles, (kend_wg + BK - 1) / BK) : 0;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegBig, kNegBig};  // running max, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float sc[BK / 2];                 // scores, then probabilities, of one tile
  uint32_t a[TERMS][BK / 16][4];    // P's split terms, the largest first

  if (ntiles > 0) mbar_wait(&bars.once, 0);
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  auto k_addr = [&](int t) { return smem_u32(ring + (t % NS) * L::STAGE); };

  // S = Q K^T of tile t into sc (one commit group)
  auto issue_s = [&](int t) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // k16 step inside a 64-column block
      Wgmma<BK, T>::ss(sc, kmajor_desc(q_addr + (kk >> 2) * BQ * 128 + off),
                       kmajor_desc(k_addr(t) + (kk >> 2) * BK * 128 + off), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile t from the split terms, smallest first (one commit group)
  auto issue_pv = [&](int t) {
    const uint32_t v_addr = k_addr(t) + L::KV_BYTES;
#pragma unroll
    for (int j = TERMS - 1; j >= 0; --j)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<DP, T>::rs(o, a[j][kk], sw128_desc(v_addr + kk * 2048, BK * 128));
    wgmma_commit();
  };
  // the online softmax of tile t in sc: scores in the log2 domain, masked
  // ones at -inf (their probabilities exp2(-inf) = 0; the running max starts
  // at -1e30, so a row with no visible key keeps l = 0), the running max
  // and sum, and the factor alpha by which the output so far must shrink
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int k0 = t * BK;
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qw + offset);
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int col = k0 + acc_col(i, lane);
        const int row = r0 + 8 * ((i >> 1) & 1);
        if (!(col < sk && (!causal || col <= row + offset))) x = __int_as_float(0xff800000);
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = ex2(sc[i] - m[(i >> 1) & 1]);
      sc[i] = p;
      l[(i >> 1) & 1] += p;
    }
  };
  // P as TERMS A fragments per k16 step: three bf16, or two float16 of 2^15 P
  auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = sc[8 * kk + 2 * j], p1 = sc[8 * kk + 2 * j + 1];
        if constexpr (H)
          split2h(p0 * kPScale, p1 * kPScale, a[0][kk][j], a[1][kk][j]);
        else
          split3(p0, p1, a[0][kk][j], a[1][kk][j], a[2][kk][j]);
      }
  };

  // Software pipeline: tile t's scores and softmax run while tile t - 1's
  // P V is still on the tensor cores; the output is rescaled once that is
  // done, so the arithmetic and its order are those of one tile at a time.
  if (nt_wg > 0) {
    float alpha[2];
    mbar_wait(&bars.full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    softmax(0, alpha);  // the output is still zero: nothing to rescale
    split();
    for (int t = 1; t < nt_wg; ++t) {
      mbar_wait(&bars.full[t % NS], (t / NS) & 1);
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      wgmma_wait<1>();  // S of tile t is in; P V of tile t - 1 may still run
      softmax(t, alpha);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&bars.empty[(t - 1) % NS]);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      split();
    }
    wgmma_fence();
    issue_pv(nt_wg - 1);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&bars.empty[(nt_wg - 1) % NS]);
  }
  for (int t = nt_wg; t < ntiles; ++t) {
    mbar_wait(&bars.full[t % NS], (t / NS) & 1);
    if (lane == 0) mbar_arrive(&bars.empty[t % NS]);
  }

  // ---- epilogue: normalise, write out and lse ----------------------------
  const float nan = __int_as_float(0x7fc00000);
  const float neg_inf = __int_as_float(0xff800000);
  float inv[2];
  bool empty[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    empty[h] = l[h] == 0.f;
    inv[h] = empty[h] ? nan : (H ? 1.f / kPScale : 1.f) / l[h];  // the 2^15 out too (exact)
    const int row = r0 + 8 * h;
    if ((lane & 3) == 0 && row < sq)
      lse[static_cast<int64_t>(bh) * sq + row] = empty[h] ? neg_inf : m[h] * kLn2 + logf(l[h]);
  }
  const bool pairs = (d & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = r0 + 8 * h;
    const int col = acc_col(i, lane);
    if (row >= sq || col >= d) continue;
    T* orow = out + (static_cast<int64_t>(bh) * sq + row) * d;
    const float x0 = empty[h] ? nan : o[i] * inv[h];
    const float x1 = empty[h] ? nan : o[i + 1] * inv[h];
    if (pairs) {
      *reinterpret_cast<uint32_t*>(orow + col) = pack2<T>(x0, x1);
    } else {
      orow[col] = from_acc<T>(x0);
      if (col + 1 < d) orow[col + 1] = from_acc<T>(x1);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int64_t bh, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Layout<DP>::SMEM;
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(flash_fwd_sm90_kernel<T, DP>), smem, smem_raised);
  if (err != cudaSuccess) return err;
  const int use_tma = tma_ok(q, d) && tma_ok(k, d) && tma_ok(v, d);
  CUtensorMap tq{}, tk{}, tv{};
  if (use_tma) {
    if ((err = make_tmap<T>(&tq, q, bh, sq, d, BQ)) != cudaSuccess) return err;
    if ((err = make_tmap<T>(&tk, k, bh, sk, d, BK)) != cudaSuccess) return err;
    if ((err = make_tmap<T>(&tv, v, bh, sk, d, BK)) != cudaSuccess) return err;
  }
  dim3 grid(static_cast<unsigned>(bh), (sq + BQ - 1) / BQ);
  flash_fwd_sm90_kernel<T, DP><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, d, scale * kLog2e, causal, use_tma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* lse,
                     int64_t bh, int sq, int sk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64) return launch<T, 64>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The bf16 and float16 cases of heat_flash_attention (flash_fwd.cu): the
// same arguments.
cudaError_t flash_fwd_sm90(const void* q, const void* k, const void* v, void* out, float* lse,
                           int64_t bh, int sq, int sk, int d, int dtype, float scale, int causal,
                           cudaStream_t s) {
  switch (dtype) {
    case kBF16: return launch_d<__nv_bfloat16>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
    case kF16: return launch_d<__half>(q, k, v, out, lse, bh, sq, sk, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// flash_fwd_sm90: the bf16, float16 and float32 flash-attention forward on
// Hopper's tensor cores, returning the output and the per-row log-sum-exp
// (lse).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:348 _flash_impl
// (body _flash_kernel :234, pallas_call :374), for every dtype
// heat_flash_attention takes. For q (BH, Sq, D) and k, v (BH, Sk, D), out =
// softmax(scale * q k^T) v and lse = log sum exp of the scores, per row. What
// it keeps of the TPU kernel: only the Sk real keys count; the causal
// diagonal is end-aligned (key col is visible to query row iff col <= row +
// Sk - Sq); masked pairs get probability 0 (their scores take -inf; the
// running max starts at the TPU kernel's -1e30), so a row that sees no key
// gives a NaN output and a -inf lse; key tiles wholly above the diagonal are
// skipped and the heaviest query tiles run first; the lse is float32.
// Results do not depend on the caller's block_q/block_k.
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
// at the end (exact). float32 inputs (F32): every product has two float32
// operands. A split pass (sm90_common.cuh, split_inputs) first writes q
// times the scale (one float32 rounding, as the TPU kernel scales q before
// its product), k and v as their three split3 planes into the caller's
// workspace; S and P V then take six passes each (the term pairs i + j <= 2,
// smallest first; sm90_common.cuh, pass_a/pass_b), with P split by split3 in
// registers, the scores times log2(e) alone, and out is written in float32.
// Six are the fewest that hold a row that sees one key, whose lse is that
// one score: four and five passes drop terms of 2^-16 |q||k|
// (tests/test_torch_sm90_precision.py).
//
// What bounds it on an H100: at the paths' shapes (16 heads of 64, 1024
// rows, causal) the four bf16 passes (three float16, twelve float32) per
// live (query, key) pair, 8 * D FLOPs (6 * D, 24 * D), over the 989 TFLOP/s
// tensor-core rate take ~2x the time of moving Q, K, V and O once (float32,
// four bytes an element: ~2.6x), so the card's bound is tensor-core
// operations. Per 64 x 64 tile a
// warpgroup also spends ~10 ALU instructions and one exp2 a score (scale,
// max, exp2, sum, the split) between its wgmmas.
// The design keeps every intermediate in registers (scores, probabilities,
// running max and sum, the output accumulator), reads each K/V tile once per
// query tile, keeps the tensor cores fed from shared memory that TMA fills
// ahead of them, and overlaps one tile's softmax with the previous tile's
// P V.
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
// fragments of their split terms, and adds P V into the output accumulator
// with m64n{DP}k16 wgmmas whose V operand is read MN-major from the same
// K/V tile layout: nothing is transposed in memory. Head dims pad to DP in
// {64, 128} with zeros in shared memory only; nothing is padded in device
// memory. float32's three planes per tile triple the shared memory: its
// ring has 3 stages, and at DP = 128 a block holds 64 query rows with one
// consumer warpgroup (256 threads, no register hand-over) and key tiles of
// 32, 193 KB either way. One template serves the three types (T =
// __nv_bfloat16, __half or float): the wgmma type, the passes, the split
// and the output differ.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kNegBig = -1e30f;  // the TPU kernel's _NEG_BIG (pallas_kernels.py:55)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kPScale = 32768.f;  // float16: P's scale, 2^15, before its split

// T: the inputs' and output's type: __nv_bfloat16, __half, or float (F32:
// the inputs as three bf16 planes, TERMS = 3); W: the wgmma operand type
template <typename T, int DP>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool H = kIsHalf<T>;
  using W = typename std::conditional<H, __half, __nv_bfloat16>::type;
  static constexpr bool kNarrow = F32 && DP == 128;  // 3 planes x 128 columns
  static constexpr int NC = kNarrow ? 1 : 2;         // consumer warpgroups
  static constexpr int NT = 128 * (NC + 1);          // and one producer warpgroup
  static constexpr int BQ = 64 * NC;                 // query rows per block
  static constexpr int BK = kNarrow ? 32 : 64;       // keys per tile
  static constexpr int NS = F32 ? 3 : 4;             // K/V ring stages
  static constexpr int TERMS = F32 ? 3 : 1;          // planes per input tile
  static constexpr int NP = F32 ? 6 : 1;             // passes of Q K^T
  static constexpr int P_TERMS = H ? 2 : 3;          // P's split terms
  static constexpr int Q_BYTES = BQ * DP * 2;        // one plane of the query tile
  static constexpr int KV_BYTES = BK * DP * 2;       // one plane of a K or V tile
  static constexpr int STAGE = 2 * TERMS * KV_BYTES;  // K's planes then V's
  static constexpr int SMEM = TERMS * Q_BYTES + NS * STAGE + 1024;  // + alignment slack
  using Maps = TMapsN<3 * TERMS>;                    // q's planes, k's, v's
};

template <typename T, int DP>
__global__ void __launch_bounds__(Layout<T, DP>::NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ typename Layout<T, DP>::Maps maps,
                      const void* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                      int sq, int sk, int d, float scale_log2, int causal, int use_tma) {
  using L = Layout<T, DP>;
  using W = typename L::W;
  constexpr bool F32 = L::F32, H = L::H;
  constexpr int BQ = L::BQ, BK = L::BK, NS = L::NS, NC = L::NC;
  constexpr int TM = L::TERMS, PT = L::P_TERMS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars<NS> bars;  // once: the Q tile; the ring: K/V tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;
  uint8_t* ring = smem + TM * L::Q_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int offset = sk - sq;                        // end-aligned causal diagonal
  // causal: keys past the tile's last row's diagonal are never visible
  const int kend = causal ? min(sk, q0 + BQ + offset) : sk;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  if (tid == 0) bars.init(use_tma, 4 * NC);
  __syncthreads();

  if (warp >= 4 * NC) {
    // ---- producer warpgroup --------------------------------------------
    // It hands its registers to the consumers; with TMA one lane works.
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (ntiles == 0) return;  // nothing to load: every row of the tile is empty
    // a float32 plane is never staged by plain loads (use_tma is set), so
    // its pointer is not read
    Src qsrc[TM], kv[2 * TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      qsrc[j] = {&maps.m[j], q, sq};
      kv[j] = {&maps.m[TM + j], k, sk};
      kv[TM + j] = {&maps.m[2 * TM + j], v, sk};
    }
    produce<DP, NS, BQ, TM, BK, 2 * TM>(bars, use_tma, tid - 128 * NC, bh, d, qs, qsrc, q0, ring,
                                        kv, 0, ntiles);
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------
  if constexpr (NC == 2) setmaxnreg_inc<232>();
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
  uint32_t a[PT][BK / 16][4];       // P's split terms, the largest first

  if (ntiles > 0) mbar_wait(&bars.once, 0);
  // plane j of this warpgroup's rows of Q; plane j of tile t's K and V
  auto q_addr = [&](int j) { return smem_u32(qs) + j * L::Q_BYTES + wg * 64 * 128; };
  auto k_addr = [&](int t, int j) { return smem_u32(ring + (t % NS) * L::STAGE) + j * L::KV_BYTES; };
  auto v_addr = [&](int t, int j) { return k_addr(t, TM + j); };

  // S = Q K^T of tile t into sc (one commit group): one pass (bf16,
  // float16), or six of the float32 operands' planes
  auto issue_s = [&](int t) {
#pragma unroll
    for (int p = 6 - L::NP; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a 64-column block
        Wgmma<BK, W>::ss(sc, kmajor_desc(q_addr(pass_a(p)) + (kk >> 2) * BQ * 128 + off),
                         kmajor_desc(k_addr(t, pass_b(p)) + (kk >> 2) * BK * 128 + off),
                         p > 6 - L::NP || kk > 0);
      }
    wgmma_commit();
  };
  // O += P V of tile t from the split terms, smallest first (one commit
  // group): P's terms against V's one plane, or the six passes of P's terms
  // and V's planes (float32)
  auto issue_pv = [&](int t) {
    if constexpr (F32) {
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<DP, W>::rs(o, a[pass_a(p)][kk],
                           sw128_desc(v_addr(t, pass_b(p)) + kk * 2048, BK * 128));
    } else {
#pragma unroll
      for (int j = PT - 1; j >= 0; --j)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<DP, W>::rs(o, a[j][kk], sw128_desc(v_addr(t, 0) + kk * 2048, BK * 128));
    }
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
  // P as PT A fragments per k16 step: three bf16, or two float16 of 2^15 P
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
  const bool pairs =
      (d & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)) == 0;
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
      if constexpr (F32)
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(orow + col) = pack2<T>(x0, x1);
    } else {
      orow[col] = from_acc<T>(x0);
      if (col + 1 < d) orow[col + 1] = from_acc<T>(x1);
    }
  }
}

// The bf16 and float16 kernels on q, k, v as they are (TMA where it can
// address them, else plain loads), or the float32 kernel on their split
// planes (q times the scale).
template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, void* ws,
                   int64_t bh, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using L = Layout<T, DP>;
  constexpr int smem = L::SMEM;
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(flash_fwd_sm90_kernel<T, DP>), smem, smem_raised);
  if (err != cudaSuccess) return err;
  typename L::Maps maps{};
  const void* src[3] = {q, k, v};
  int use_tma;
  float scale_log2 = scale * kLog2e;
  if constexpr (L::F32) {
    SplitInputs planes;
    err = split_inputs(q, k, v, nullptr, scale, ws, 1, bh, sq, sk, d, stream, &planes);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < 3; ++i) src[i] = planes.plane[i][0];
    use_tma = 1;  // the planes' rows are whole 16-byte chunks
    scale_log2 = kLog2e;  // the planes hold q times the scale
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        if ((err = make_tmap(&maps.m[3 * i + j], planes.plane[i][j], bh, i == 0 ? sq : sk,
                             planes.d8, i == 0 ? L::BQ : L::BK)) != cudaSuccess)
          return err;
  } else {
    use_tma = tma_ok(q, d) && tma_ok(k, d) && tma_ok(v, d);
    if (use_tma)
      for (int i = 0; i < 3; ++i)
        if ((err = make_tmap<T>(&maps.m[i], src[i], bh, i == 0 ? sq : sk, d,
                                i == 0 ? L::BQ : L::BK)) != cudaSuccess)
          return err;
  }
  dim3 grid(static_cast<unsigned>(bh), (sq + L::BQ - 1) / L::BQ);
  flash_fwd_sm90_kernel<T, DP><<<grid, L::NT, smem, stream>>>(
      maps, src[0], src[1], src[2], static_cast<T*>(out), lse, sq, sk, d, scale_log2, causal,
      use_tma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* lse, void* ws,
                     int64_t bh, int sq, int sk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64) return launch<T, 64>(q, k, v, out, lse, ws, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, out, lse, ws, bh, sq, sk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), contiguous and of one dtype (f32, bf16
// or f16) on card `device`; out (bh, sq, d) in that dtype and lse (bh, sq)
// float32. ws: for f32 the workspace of the split planes, 6 * bh * d8 * (sq +
// 2 sk) bytes (d8: d rounded up to 8), 16-byte aligned; unused otherwise.
// The wrapper guarantees bh >= 1, 1 <= sq <= 65535 * 64, 1 <= sk and
// 1 <= d <= 128. Returns the launch's cudaError_t.
extern "C" int heat_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    void* lse, void* ws, int64_t bh, int sq, int sk, int d,
                                    int dtype, float scale, int causal, int device,
                                    void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case kBF16:
      return launch_d<__nv_bfloat16>(q, k, v, out, l, ws, bh, sq, sk, d, scale, causal, s);
    case kF16: return launch_d<__half>(q, k, v, out, l, ws, bh, sq, sk, d, scale, causal, s);
    case kF32: return launch_d<float>(q, k, v, out, l, ws, bh, sq, sk, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

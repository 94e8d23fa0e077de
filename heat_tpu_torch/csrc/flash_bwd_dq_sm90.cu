// flash_bwd_dq_sm90: dQ of the bf16, float16 and float32 flash-attention
// backward on Hopper's tensor cores, recomputing the probabilities from the
// forward's saved log-sum-exp (lse).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:488
// _flash_bwd_dq_kernel (pallas_call :618, launched by _flash_bwd_impl :549),
// for every dtype heat_flash_bwd_dq takes. For q, dout (BH, Sq, D), k, v (BH,
// Sk, D), lse and dmb (BH, Sq) float32, with s = scale * q . k:
//   p  = exp(s - lse) where the pair is visible and lse is finite, else 0,
//   dp = dout . v,   ds = p * (dp + dmb),   dQ = scale * dS K,
// dmb = dlse - rowsum(dout * out) computed by the caller, as heat_tpu
// computes it outside its kernels (:571-573). The rules of heat_tpu's dense
// backward (:668-686) stay: only the Sk real keys count, the causal diagonal
// is end-aligned (key col is visible to query row iff col <= row + Sk - Sq),
// the finite-lse gate, key tiles wholly above the diagonal are skipped, and a
// query row whose skipped keys meet a non-finite dmb gets a NaN dQ, as the
// dense backward's 0 x dmb gives there. No atomics: each dQ row is written
// once by the block that owns it, so runs are bitwise repeatable.
//
// Precision (heat_tpu runs the products at HIGHEST with float32
// accumulation, pallas_kernels.py:510-533): S = Q K^T and dP = dO V^T take
// one bf16 wgmma pass each (exact products, fp32 sums); dQ += dS K splits
// the fp32 dS into three bf16 terms (sm90_common.cuh, split3) and takes
// three passes, smallest term first; the scale is applied to the fp32
// scores and to dQ at the end. float16 inputs: S and dP take one float16
// pass each, as bf16's; dS has no bound in either direction (gradients of
// 2^-14 and below, or past 65,504), so each query row keeps a running
// power-of-two exponent E of its largest |dS| so far, as the forward keeps
// its running max: per key tile E grows to the tile's row maximum's
// exponent (a max over the 4 threads of a quad, which hold the row), the
// row's fp32 dQ accumulator is multiplied by 2^(E_old - E) (exact), and the
// row times 2^(14 - E), below 2^15, splits into two float16 terms (split2h);
// dQ = scale * 2^(E - 14) * the accumulator. float32 inputs (F32): a split
// pass (sm90_common.cuh, split_inputs) first writes q, k, v and dout as their
// three split3 planes into the caller's workspace (or the caller passes the
// planes the dK/dV launch of the same backward wrote); S, dP and dQ then take
// six passes each (the term pairs i + j <= 2, smallest first), with dS split
// by split3 in registers, and dQ is written in float32.
//
// What bounds it on an H100: at the training path's shape (8 x 16 heads of
// 64, 1024 rows, causal) the five bf16 passes per live pair (four float16),
// 10 * D FLOPs, over the tensor-core rate take ~1.7x the time of moving the
// inputs and the output once: bound by tensor-core operations. So every
// intermediate (S, dP, P, dS and the dQ accumulator) stays in registers, Q
// and dO are read once per block and each key tile once per query tile.
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
// written once. float16 runs 4 passes per live pair. float32 runs 18, 3.6x
// the bf16 kernel's work, plus the split pass's traffic; three planes per
// tile triple the shared memory, so its ring has 2 stages, and at DP = 128 a
// block holds 64 query rows with one consumer warpgroup (256 threads, no
// register hand-over) and key tiles of 32: 192 KB either way. One template
// serves the three types (T = __nv_bfloat16, __half or float).
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;

// T: the inputs' and output's type: __nv_bfloat16, __half, or float (F32:
// the inputs as three bf16 planes, TERMS = 3); W: the wgmma operand type
template <int DP, typename T>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool H = kIsHalf<T>;
  using W = typename std::conditional<H, __half, __nv_bfloat16>::type;
  static constexpr bool kNarrow = F32 && DP == 128;  // 3 planes x 128 columns
  static constexpr int NC = kNarrow ? 1 : 2;         // consumer warpgroups
  static constexpr int NT = 128 * (NC + 1);          // and one producer warpgroup
  static constexpr int BQ = 64 * NC;                 // query rows per block
  static constexpr int BK = kNarrow ? 32 : 64;       // keys per streamed tile
  static constexpr int NS = F32 ? 2 : 4;             // K/V ring stages
  static constexpr int TERMS = F32 ? 3 : 1;          // planes per input tile
  static constexpr int NP = F32 ? 6 : 1;             // passes of a product
  static constexpr int DS_TERMS = H ? 2 : 3;         // dS's split terms
  static constexpr int Q_BYTES = BQ * DP * 2;        // one plane of the Q or the dO tile
  static constexpr int KV_BYTES = BK * DP * 2;       // one plane of a K or V tile
  static constexpr int STAGE = 2 * TERMS * KV_BYTES;  // K's planes then V's
  static constexpr int SMEM = 2 * TERMS * Q_BYTES + NS * STAGE + 1024;  // + alignment slack
};

template <int DP, typename T>
__global__ void __launch_bounds__(Layout<DP, T>::NT, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ TMaps maps, const void* __restrict__ q,
                         const void* __restrict__ k, const void* __restrict__ v,
                         const void* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dmb, T* __restrict__ dq, int sq, int sk,
                         int d, float scale, int causal, int use_tma) {
  using L = Layout<DP, T>;
  using W = typename L::W;
  constexpr bool F32 = L::F32, H = L::H;
  constexpr int BQ = L::BQ, BK = L::BK, NS = L::NS, NC = L::NC;
  constexpr int TM = L::TERMS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars<NS> bars;  // once: the Q and dO tiles; the ring: K/V tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;                        // Q's planes, then dO's
  uint8_t* ring = smem + 2 * TM * L::Q_BYTES;

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
    if (ntiles == 0) return;  // no key is visible to any row of the tile
    // maps: q's planes, k's, v's, dout's; a float32 plane is never staged by
    // plain loads (use_tma is set), so its pointer is not read
    Src qdo[2 * TM], kv[2 * TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      qdo[j] = {&maps.m[j], q, sq};
      qdo[TM + j] = {&maps.m[3 * TM + j], dout, sq};
      kv[j] = {&maps.m[TM + j], k, sk};
      kv[TM + j] = {&maps.m[2 * TM + j], v, sk};
    }
    produce<DP, NS, BQ, 2 * TM, BK, 2 * TM>(bars, use_tma, tid - 128 * NC, bh, d, qs, qdo, q0,
                                            ring, kv, 0, ntiles);
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------
  if constexpr (NC == 2) setmaxnreg_inc<232>();
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
  uint32_t a[L::DS_TERMS][BK / 16][4];  // dS's split terms, the largest first
  int eq[2] = {kEMin, kEMin};  // float16: the running exponents of rows r0, r0 + 8

  // plane j of this warpgroup's 64 rows of Q and of dO
  auto q_addr = [&](int j) { return smem_u32(qs) + j * L::Q_BYTES + wg * 64 * 128; };
  auto o_addr = [&](int j) { return smem_u32(qs) + (TM + j) * L::Q_BYTES + wg * 64 * 128; };
  // plane j of tile t's K and V
  auto k_addr = [&](int t, int j) { return smem_u32(ring + (t % NS) * L::STAGE) + j * L::KV_BYTES; };
  auto v_addr = [&](int t, int j) { return k_addr(t, TM + j); };

  // S = Q K^T and dP = dO V^T of tile t (one commit group): one pass
  // (bf16, float16), or six of the float32 operands' planes
  auto mma_sdp = [&](int t) {
#pragma unroll
    for (int p = 6 - L::NP; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a 64-column block
        Wgmma<BK, W>::ss(st, kmajor_desc(q_addr(pass_a(p)) + (kk >> 2) * BQ * 128 + off),
                         kmajor_desc(k_addr(t, pass_b(p)) + (kk >> 2) * BK * 128 + off),
                         p > 6 - L::NP || kk > 0);
      }
#pragma unroll
    for (int p = 6 - L::NP; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        Wgmma<BK, W>::ss(dst, kmajor_desc(o_addr(pass_a(p)) + (kk >> 2) * BQ * 128 + off),
                         kmajor_desc(v_addr(t, pass_b(p)) + (kk >> 2) * BK * 128 + off),
                         p > 6 - L::NP || kk > 0);
      }
    wgmma_commit();
  };
  // dQ += dS K of tile t from the split terms, smallest first (one commit
  // group): bf16, dS's three terms against K; float16, its two (scaled);
  // float32, the six passes of dS's terms and K's planes
  auto mma_dq = [&](int t) {
    if constexpr (F32) {
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<DP, W>::rs(acc, a[pass_a(p)][kk],
                           sw128_desc(k_addr(t, pass_b(p)) + kk * 2048, BK * 128));
    } else {
#pragma unroll
      for (int j = L::DS_TERMS - 1; j >= 0; --j)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<DP, W>::rs(acc, a[j][kk], sw128_desc(k_addr(t, 0) + kk * 2048, BK * 128));
    }
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
  // dS's terms as register A fragments (the accumulator is free: the last
  // dS K is done). float16: each row's running exponent first grows to its
  // largest |dS| of the tile, NaN aside (a max over the quad that holds the
  // row), the row of the accumulator shrinks by the growth, and the row
  // times 2^(14 - E) splits into two float16 terms
  auto split = [&]() {
    if constexpr (H) {
      float mx[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fabsf(dst[i]));
      float up[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const int e = max(eq[h], exponent_of(mx[h]));
        const float shrink = pow2(eq[h] - e);  // the accumulator to the new exponent
        eq[h] = e;
        up[h] = pow2(14 - e);                  // this tile's row below 2^15
#pragma unroll
        for (int i = 0; i < DP / 2; ++i)
          if (((i >> 1) & 1) == h) acc[i] *= shrink;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)  // registers 8kk + 2j, + 1 lie on row j % 2
          split2h(dst[8 * kk + 2 * j] * up[j & 1], dst[8 * kk + 2 * j + 1] * up[j & 1],
                  a[0][kk][j], a[1][kk][j]);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split3(dst[8 * kk + 2 * j], dst[8 * kk + 2 * j + 1], a[0][kk][j], a[1][kk][j],
                 a[2][kk][j]);
    }
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

  // ---- epilogue: dQ times scale (float16: and 2^(E - 14) of its row), NaN
  // where skipped keys meet a non-finite dmb
  const float nan = __int_as_float(0x7fc00000);
  const bool skipped = nt_wg * BK < sk;
  bool poison[2];
  float mul[2] = {scale, scale};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    poison[h] = skipped && !isfinite(mb[h]);
    if constexpr (H) mul[h] = pow2(eq[h] - 14) * scale;
  }
  const bool pairs =
      (d & 1) == 0 && (reinterpret_cast<uintptr_t>(dq) & (2 * sizeof(T) - 1)) == 0;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = r0 + 8 * h;
    const int col = acc_col(i, lane);
    if (row >= sq || col >= d) continue;
    T* qrow = dq + (static_cast<int64_t>(bh) * sq + row) * d;
    const float x0 = poison[h] ? nan : acc[i] * mul[h];
    const float x1 = poison[h] ? nan : acc[i + 1] * mul[h];
    if (pairs) {
      if constexpr (F32)
        *reinterpret_cast<float2*>(qrow + col) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(qrow + col) = pack2<T>(x0, x1);
    } else {
      qrow[col] = from_acc<T>(x0);
      if (col + 1 < d) qrow[col + 1] = from_acc<T>(x1);
    }
  }
}

// The bf16 and float16 kernels on q, k, v, dout as they are (TMA where it
// can address them, else plain loads), or the float32 kernel on their split
// planes.
template <int DP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dmb, void* dq, void* ws, int split, int64_t bh,
                   int sq, int sk, int d, float scale, int causal, cudaStream_t stream) {
  using L = Layout<DP, T>;
  constexpr int smem = L::SMEM;
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(flash_bwd_dq_sm90_kernel<DP, T>), smem, smem_raised);
  if (err != cudaSuccess) return err;
  TMaps maps{};
  const void* src[4] = {q, k, v, dout};
  int use_tma;
  if constexpr (L::F32) {
    SplitInputs planes;
    err = split_inputs(q, k, v, dout, 1.f, ws, split, bh, sq, sk, d, stream, &planes);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < 4; ++i) src[i] = planes.plane[i][0];
    use_tma = 1;  // the planes' rows are whole 16-byte chunks
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 3; ++j)
        if ((err = make_tmap(&maps.m[3 * i + j], planes.plane[i][j], bh, i == 1 || i == 2 ? sk : sq,
                             planes.d8, i == 1 || i == 2 ? L::BK : L::BQ)) != cudaSuccess)
          return err;
  } else {
    use_tma = tma_ok(q, d) && tma_ok(k, d) && tma_ok(v, d) && tma_ok(dout, d);
    if (use_tma)
      for (int i = 0; i < 4; ++i)
        if ((err = make_tmap<T>(&maps.m[i], src[i], bh, i == 1 || i == 2 ? sk : sq, d,
                                i == 1 || i == 2 ? L::BK : L::BQ)) != cudaSuccess)
          return err;
  }
  dim3 grid(static_cast<unsigned>(bh), (sq + L::BQ - 1) / L::BQ);
  flash_bwd_dq_sm90_kernel<DP, T><<<grid, L::NT, smem, stream>>>(
      maps, src[0], src[1], src[2], src[3], lse, dmb, static_cast<T*>(dq), sq, sk, d, scale,
      causal, use_tma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dmb, void* dq, void* ws, int split,
                     int64_t bh, int sq, int sk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64)
    return launch<64, T>(q, k, v, dout, lse, dmb, dq, ws, split, bh, sq, sk, d, scale, causal,
                         s);
  if (d <= 128)
    return launch<128, T>(q, k, v, dout, lse, dmb, dq, ws, split, bh, sq, sk, d, scale, causal,
                          s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The inputs of heat_flash_bwd_dkv (flash_bwd_dkv_sm90.cu) and its
// workspace; dq (bh, sq, d) in their dtype. The wrapper guarantees bh >= 1,
// 1 <= sq <= 65535 * 64, 1 <= sk and 1 <= d <= 128. Returns the launch's
// cudaError_t.
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
    case kBF16:
      return launch_d<__nv_bfloat16>(q, k, v, dout, l, m, dq, ws, split, bh, sq, sk, d, scale,
                                     causal, s);
    case kF16:
      return launch_d<__half>(q, k, v, dout, l, m, dq, ws, split, bh, sq, sk, d, scale, causal,
                              s);
    case kF32:
      return launch_d<float>(q, k, v, dout, l, m, dq, ws, split, bh, sq, sk, d, scale, causal,
                             s);
    default: return cudaErrorInvalidValue;
  }
}

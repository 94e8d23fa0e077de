// flash_bwd_dkv_sm90: dK and dV of the bf16, float16 and float32
// flash-attention backward on Hopper's tensor cores, recomputing the
// probabilities from the forward's saved log-sum-exp (lse).
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:412
// _flash_bwd_dkv_kernel (pallas_call :592, launched by _flash_bwd_impl
// :549), for every dtype heat_flash_bwd_dkv takes.
// For q, dout (BH, Sq, D), k, v (BH, Sk, D), lse and dmb (BH, Sq) float32,
// with s = scale * k . q:
//   p  = exp(s - lse) where the pair is visible and lse is finite, else 0,
//   dp = v . dout,   ds = p * (dp + dmb),
//   dV = P^T dout,   dK = scale * dS^T q.
// The rules of heat_tpu's dense backward (pallas_kernels.py:668-686) stay:
// only the Sk real keys count, the causal diagonal is end-aligned, the
// finite-lse gate, query tiles wholly below a key tile's diagonal are
// skipped, and a skipped query row with a non-finite dmb makes the key
// tile's dK NaN, as the dense backward's 0 x dmb does there. No atomics:
// each dK and dV row is written once by the block that owns it, so runs are
// bitwise repeatable.
//
// Precision (heat_tpu runs the products at HIGHEST with float32
// accumulation, pallas_kernels.py:445-472): S^T = K Q^T and dP^T = V dO^T
// take one bf16 wgmma pass each (exact products, fp32 sums); dV += P^T dO
// and dK += dS^T Q split the fp32 P^T and dS^T into three bf16 terms
// (sm90_common.cuh, split3) and take three passes each, smallest term
// first; the scale is applied to the fp32 scores and to dK at the end.
// float16 inputs: S^T and dP^T take one float16 pass each, as bf16's; dV
// splits 2^15 P^T (P <= 1) into two float16 terms (split2h) and takes two
// passes, the 2^15 divided out at the end; dS^T has no bound in either
// direction (gradients of 2^-14 and below, or past 65,504), so each key row
// keeps a running power-of-two exponent E of its largest |dS^T| so far, as
// the forward keeps its running max: per query tile E grows to the tile's
// row maximum's exponent, the row's fp32 dK accumulator is multiplied by
// 2^(E_old - E) (exact), and the row times 2^(14 - E), below 2^15, splits
// into two float16 terms; dK = scale * 2^(E - 14) * the accumulator. The row
// maximum is a max over the 4 threads of a quad.
// float32 inputs (F32): every product has two float32 operands. A split pass
// (sm90_common.cuh, split_inputs) first writes each of q, k, v and dout as
// its three split3 planes into the caller's workspace, padded to whole
// 16-byte rows; the kernel then runs S^T, dP^T, dV and dK in six passes
// each (the term pairs i + j <= 2, smallest first; sm90_common.cuh,
// pass_a/pass_b), with P^T and dS^T split by split3 in registers, and
// writes float32 dK and dV. The order of work is the bf16 kernel's, with
// three planes per tile.
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
// accumulators fit the registers. float16 runs 6 passes per live pair
// (bf16 8). float32 runs 24 passes per live pair, 3x the bf16 kernel's
// work, plus the split pass's traffic (its inputs read once, three bf16
// planes written once); three planes per tile triple the shared memory, so
// its ring has 2 stages and at DP = 128 a block holds 64 keys with one
// consumer warpgroup (256 threads, no register hand-over): 192 KB either
// way.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPScale = 32768.f;  // float16: P^T's scale, 2^15, before its split

// T: the inputs' and outputs' type: __nv_bfloat16, __half, or float (F32:
// the inputs as three bf16 planes, TERMS = 3); W: the wgmma operand type
template <int DP, typename T>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool H = kIsHalf<T>;
  using W = typename std::conditional<H, __half, __nv_bfloat16>::type;
  static constexpr int NC = F32 && DP == 128 ? 1 : 2;  // consumer warpgroups
  static constexpr int NT = 128 * (NC + 1);            // and one producer warpgroup
  static constexpr int BKB = 64 * NC;                  // keys per block
  static constexpr int NS = F32 ? 2 : 3;               // query-tile ring stages
  static constexpr int BQ = DP == 64 ? 64 : 32;        // query rows per streamed tile
  static constexpr int TERMS = F32 ? 3 : 1;            // planes per input tile
  static constexpr int NP = F32 ? 6 : 1;               // passes of a product
  static constexpr int KV_BYTES = BKB * DP * 2;        // one plane of the K or V tile
  static constexpr int Q_BYTES = BQ * DP * 2;          // one plane of a Q or dO tile
  static constexpr int STAGE = 2 * TERMS * Q_BYTES;    // Q's planes then dO's
  static constexpr int SMEM = 2 * TERMS * KV_BYTES + NS * STAGE + 1024;  // + alignment slack
};

template <int DP, typename T>
__global__ void __launch_bounds__(Layout<DP, T>::NT, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ TMaps maps, const void* __restrict__ q,
                          const void* __restrict__ k, const void* __restrict__ v,
                          const void* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dmb, T* __restrict__ dk,
                          T* __restrict__ dv, int sq, int sk, int d, float scale, int causal,
                          int use_tma) {
  using L = Layout<DP, T>;
  using W = typename L::W;
  constexpr bool F32 = L::F32, H = L::H;
  constexpr int BQ = L::BQ, BKB = L::BKB, NS = L::NS, NC = L::NC;
  constexpr int TM = L::TERMS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars<NS> bars;  // once: the K and V tiles; the ring: Q/dO tiles
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = smem;                       // K's planes, then V's
  uint8_t* ring = smem + 2 * TM * L::KV_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKB;
  const int offset = sk - sq;
  // causal: query rows below k0 - offset see none of these keys
  const int qt0 = causal ? max(0, k0 - offset) / BQ : 0;
  const int nqt = (sq + BQ - 1) / BQ;
  const int ntiles = max(0, nqt - qt0);

  if (tid == 0) bars.init(use_tma, 4 * NC);
  __syncthreads();

  if (warp >= 4 * NC) {
    // ---- producer warpgroup --------------------------------------------
    // It hands its registers to the consumers; with TMA one lane works.
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    // maps: q's planes, k's, v's, dout's; a float32 plane is never staged by
    // plain loads (use_tma is set), so its pointer is not read
    Src kv[2 * TM], qdo[2 * TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      kv[j] = {&maps.m[TM + j], k, sk};
      kv[TM + j] = {&maps.m[2 * TM + j], v, sk};
      qdo[j] = {&maps.m[j], q, sq};
      qdo[TM + j] = {&maps.m[3 * TM + j], dout, sq};
    }
    produce<DP, NS, BKB, 2 * TM, BQ, 2 * TM>(bars, use_tma, tid - 128 * NC, bh, d, ks, kv, k0,
                                           ring, qdo, qt0, ntiles);
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------
  if constexpr (NC == 2) setmaxnreg_inc<232>();
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
  int ek[2] = {kEMin, kEMin};  // float16: the running exponents of keys key0, key0 + 8

  mbar_wait(&bars.once, 0);
  // plane j of this warpgroup's 64 keys of K and of V
  auto k_addr = [&](int j) { return smem_u32(ks) + j * L::KV_BYTES + wg * 64 * 128; };
  auto v_addr = [&](int j) { return smem_u32(ks) + (TM + j) * L::KV_BYTES + wg * 64 * 128; };

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
      // plane j of the stage's Q and dO tiles
      const uint32_t stage = smem_u32(ring + s * L::STAGE);
      auto q_addr = [&](int j) { return stage + j * L::Q_BYTES; };
      auto o_addr = [&](int j) { return stage + (TM + j) * L::Q_BYTES; };

      // S^T = K Q^T and dP^T = V dO^T: one pass (bf16, float16), or six of
      // the two float32 operands' planes
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int p = 6 - L::NP; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;  // k16 step inside a 64-column block
          Wgmma<BQ, W>::ss(st, kmajor_desc(k_addr(pass_a(p)) + (kk >> 2) * BKB * 128 + off),
                           kmajor_desc(q_addr(pass_b(p)) + (kk >> 2) * BQ * 128 + off),
                           p > 6 - L::NP || kk > 0);
        }
#pragma unroll
      for (int p = 6 - L::NP; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;
          Wgmma<BQ, W>::ss(dpt, kmajor_desc(v_addr(pass_a(p)) + (kk >> 2) * BKB * 128 + off),
                           kmajor_desc(o_addr(pass_b(p)) + (kk >> 2) * BQ * 128 + off),
                           p > 6 - L::NP || kk > 0);
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

      // dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
      // fragments: bf16, their three split3 terms against dO's (Q's) one
      // plane; float16, two float16 terms of 2^15 P^T and of dS^T scaled by
      // its row's running exponent; float32, the six passes of their terms
      // and dO's (Q's) planes
      if constexpr (H) {
        uint32_t a[2][BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split2h(st[8 * kk + 2 * j] * kPScale, st[8 * kk + 2 * j + 1] * kPScale, a[0][kk][j],
                    a[1][kk][j]);
        wgmma_fence();
#pragma unroll
        for (int j = 1; j >= 0; --j)
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<DP, W>::rs(acc_v, a[j][kk], sw128_desc(o_addr(0) + kk * 2048, BQ * 128));
        wgmma_commit();
        if constexpr (DP > 64) wgmma_wait<0>();  // frees the P^T terms' registers

        // the running exponent of each key row (register i holds row
        // (i / 2) % 2 of this thread's two): the row's largest |dS^T| over
        // the quad, NaN aside
        float mx[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fabsf(dpt[i]));
        float up[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const int e = max(ek[h], exponent_of(mx[h]));
          const float shrink = pow2(ek[h] - e);  // the accumulator to the new exponent
          ek[h] = e;
          up[h] = pow2(14 - e);                  // this tile's row below 2^15
#pragma unroll
          for (int i = 0; i < DP / 2; ++i)
            if (((i >> 1) & 1) == h) acc_k[i] *= shrink;
        }
        uint32_t b[2][BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)  // registers 8kk + 2j, + 1 lie on row j % 2
            split2h(dpt[8 * kk + 2 * j] * up[j & 1], dpt[8 * kk + 2 * j + 1] * up[j & 1],
                    b[0][kk][j], b[1][kk][j]);
        wgmma_fence();
#pragma unroll
        for (int j = 1; j >= 0; --j)
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<DP, W>::rs(acc_k, b[j][kk], sw128_desc(q_addr(0) + kk * 2048, BQ * 128));
        wgmma_commit();
        wgmma_wait<0>();
      } else if constexpr (F32) {
        uint32_t a[3][BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split3(st[8 * kk + 2 * j], st[8 * kk + 2 * j + 1], a[0][kk][j], a[1][kk][j],
                   a[2][kk][j]);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<DP, W>::rs(acc_v, a[pass_a(p)][kk],
                          sw128_desc(o_addr(pass_b(p)) + kk * 2048, BQ * 128));
        wgmma_commit();
        if constexpr (DP > 64) wgmma_wait<0>();  // frees the P^T terms' registers

        uint32_t b[3][BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split3(dpt[8 * kk + 2 * j], dpt[8 * kk + 2 * j + 1], b[0][kk][j], b[1][kk][j],
                   b[2][kk][j]);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<DP, W>::rs(acc_k, b[pass_a(p)][kk],
                          sw128_desc(q_addr(pass_b(p)) + kk * 2048, BQ * 128));
        wgmma_commit();
        wgmma_wait<0>();
      } else {
        uint32_t a1[BQ / 16][4], a2[BQ / 16][4], a3[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split3(st[8 * kk + 2 * j], st[8 * kk + 2 * j + 1], a1[kk][j], a2[kk][j], a3[kk][j]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<DP>::rs(acc_v, a3[kk], sw128_desc(o_addr(0) + kk * 2048, BQ * 128));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<DP>::rs(acc_v, a2[kk], sw128_desc(o_addr(0) + kk * 2048, BQ * 128));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<DP>::rs(acc_v, a1[kk], sw128_desc(o_addr(0) + kk * 2048, BQ * 128));
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
          Wgmma<DP>::rs(acc_k, b3[kk], sw128_desc(q_addr(0) + kk * 2048, BQ * 128));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<DP>::rs(acc_k, b2[kk], sw128_desc(q_addr(0) + kk * 2048, BQ * 128));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<DP>::rs(acc_k, b1[kk], sw128_desc(q_addr(0) + kk * 2048, BQ * 128));
        wgmma_commit();
        wgmma_wait<0>();
      }
    } else {
      mbar_wait(&bars.full[s], (t / NS) & 1);
    }
    if (lane == 0) mbar_arrive(&bars.empty[s]);
  }

  // ---- epilogue: dK (times scale, NaN where poisoned) and dV -------------
  // float16: dK times 2^(E - 14) of its row, dV times 2^-15 (both exact)
  const float nan = __int_as_float(0x7fc00000);
  float kmul[2] = {scale, scale};
  if constexpr (H) {
    kmul[0] = pow2(ek[0] - 14) * scale;
    kmul[1] = pow2(ek[1] - 14) * scale;
  }
  const float vmul = H ? 1.f / kPScale : 1.f;
  constexpr uintptr_t pair_align = 2 * sizeof(T) - 1;
  const bool pairs = (d & 1) == 0 && (reinterpret_cast<uintptr_t>(dk) & pair_align) == 0 &&
                     (reinterpret_cast<uintptr_t>(dv) & pair_align) == 0;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int key = key0 + 8 * h;
    const int col = acc_col(i, lane);
    if (key >= sk || col >= d) continue;
    const int64_t at = (static_cast<int64_t>(bh) * sk + key) * d + col;
    const float k0v = poison ? nan : acc_k[i] * kmul[h];
    const float k1v = poison ? nan : acc_k[i + 1] * kmul[h];
    const float v0v = acc_v[i] * vmul, v1v = acc_v[i + 1] * vmul;
    if (pairs) {
      if constexpr (F32) {
        *reinterpret_cast<float2*>(dk + at) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(dv + at) = make_float2(v0v, v1v);
      } else {
        *reinterpret_cast<uint32_t*>(dk + at) = pack2<T>(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dv + at) = pack2<T>(v0v, v1v);
      }
    } else {
      dk[at] = from_acc<T>(k0v);
      dv[at] = from_acc<T>(v0v);
      if (col + 1 < d) {
        dk[at + 1] = from_acc<T>(k1v);
        dv[at + 1] = from_acc<T>(v1v);
      }
    }
  }
}

// The bf16 and float16 kernels on q, k, v, dout as they are (TMA where it
// can address them, else plain loads), or the float32 kernel on their split
// planes.
template <int DP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dmb, void* dk, void* dv, void* ws, int split,
                   int64_t bh, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using L = Layout<DP, T>;
  constexpr int smem = L::SMEM, BKB = L::BKB;
  static std::atomic<uint32_t> smem_raised{0};
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(flash_bwd_dkv_sm90_kernel<DP, T>), smem, smem_raised);
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
                             planes.d8, i == 1 || i == 2 ? BKB : L::BQ)) != cudaSuccess)
          return err;
  } else {
    use_tma = tma_ok(q, d) && tma_ok(k, d) && tma_ok(v, d) && tma_ok(dout, d);
    if (use_tma)
      for (int i = 0; i < 4; ++i)
        if ((err = make_tmap<T>(&maps.m[i], src[i], bh, i == 1 || i == 2 ? sk : sq, d,
                                i == 1 || i == 2 ? BKB : L::BQ)) != cudaSuccess)
          return err;
  }
  dim3 grid(static_cast<unsigned>(bh), (sk + BKB - 1) / BKB);
  flash_bwd_dkv_sm90_kernel<DP, T><<<grid, L::NT, smem, stream>>>(
      maps, src[0], src[1], src[2], src[3], lse, dmb, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, d, scale, causal, use_tma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dmb, void* dk, void* dv, void* ws, int split,
                     int64_t bh, int sq, int sk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64)
    return launch<64, T>(q, k, v, dout, lse, dmb, dk, dv, ws, split, bh, sq, sk, d, scale,
                         causal, s);
  if (d <= 128)
    return launch<128, T>(q, k, v, dout, lse, dmb, dk, dv, ws, split, bh, sq, sk, d, scale,
                          causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout (bh, sq, d) and k, v (bh, sk, d), contiguous and of one dtype
// (f32, bf16 or f16) on card `device`; lse and dmb (bh, sq) float32. dk and
// dv (bh, sk, d) in that dtype. ws: for f32 the workspace of the split
// planes, 12 * bh * d8 * (sq + sk) bytes (d8: d rounded up to 8), 16-byte
// aligned, and whether to write them (split) or read them as the other
// kernel of the same backward wrote them; unused otherwise. The wrapper
// guarantees bh >= 1, 1 <= sq, 1 <= sk <= 65535 * 64 and 1 <= d <= 128.
// Returns the launch's cudaError_t.
extern "C" int heat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* dmb, void* dk, void* dv, void* ws,
                                  int split, int64_t bh, int sq, int sk, int d, int dtype,
                                  float scale, int causal, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const float* l = static_cast<const float*>(lse);
  const float* m = static_cast<const float*>(dmb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return launch_d<__nv_bfloat16>(q, k, v, dout, l, m, dk, dv, ws, split, bh, sq, sk, d,
                                     scale, causal, s);
    case kF16:
      return launch_d<__half>(q, k, v, dout, l, m, dk, dv, ws, split, bh, sq, sk, d, scale,
                              causal, s);
    case kF32:
      return launch_d<float>(q, k, v, dout, l, m, dk, dv, ws, split, bh, sq, sk, d, scale,
                             causal, s);
    default: return cudaErrorInvalidValue;
  }
}

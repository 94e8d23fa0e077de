// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// (flash_fwd_sm90.cu, flash_bwd_dkv_sm90.cu, flash_bwd_dq_sm90.cu):
// mbarriers, TMA tensor maps and loads, wgmma descriptors and instructions in
// raw PTX (bf16 x bf16 and float16 x float16, both into fp32), the 128-byte
// swizzled tile layout, the exact three-way bf16 split of a float32 operand,
// the two-way float16 split of a scaled one and the power-of-two helpers of
// its running exponent.
//
// Tile layout in shared memory: a (ROWS, DP) bf16 or float16 tile is DP / 64
// column blocks of ROWS rows x 128 bytes, each block 1024-byte aligned, with the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8) of its row: the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads through
// a 128B-swizzle descriptor. Columns past the head dim are zeros.
//
// Precision rule: a product of two bf16 operands takes one tensor-core pass
// (bf16 x bf16 is exact in fp32, summed in fp32); a product with a float32
// operand x splits it into x1 = bf16(x), x2 = bf16(x - x1),
// x3 = bf16(x - x1 - x2), 24 significant bits as float32 has, and takes
// three passes into one fp32 accumulator, smallest term first. A product
// of two float32 operands (every product of the float32 kernels) splits both
// the same way and takes the six passes a_i x b_j with i + j <= 2 (terms 0,
// 1, 2 from the largest), smallest first: the three it drops are below
// 2^-24 of |a||b|. float16: a product of two float16 operands takes one pass
// (11 x 11 significant bits, exact in fp32); a float32 operand x is first
// scaled by a power of two s into float16's range (|s x| < 2^15 < 65,504)
// and split into h1 = f16(s x), h2 = f16(s x - h1), 22 significant bits down
// to float16's subnormals, two passes; the product is divided by s in fp32
// (exact). Both counts are the fewest that hold the checks in
// tests/test_torch_sm90_precision.py, which emulates them.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; libcuda is not linked)

#include <type_traits>

#include "common.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA transfer to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma) of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ------------------------------------------------------------------

// A (64 columns, box rows, 1) box at (col, row, outer) of a 3-D tensor map
// into shared memory; its bytes count against the barrier's expected
// transaction (zero-filled parts past the tensor's ends included).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(outer)
      : "memory");
}

// ---- register hand-over between warpgroups --------------------------------

// A producer warpgroup gives registers up, the consumer warpgroups take them
// (all 128 threads of a warpgroup execute it; the roles must never merge).
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a 128B-swizzled operand at shared address `addr` (inside a
// 1024-byte aligned column block): 8-row groups 1024 bytes apart (SBO).
// K-major operands (K contiguous; a k16 step is +32 bytes of the address)
// ignore the leading offset; MN-major ones (MN contiguous; a k16 step is +16
// rows, 2048 bytes) take the stride between their 64-wide column blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return sw128_desc(addr, 16); }

// Accumulator fragments of m64nN (fp32): register i of a thread holds row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * (lane % 4) + i % 2
// of the warpgroup's 64 x N tile. The A fragment of k16 step kk (4 x b32,
// bf16 pairs) takes registers 8kk .. 8kk + 7 of that layout in order, so an
// accumulator becomes an A operand in registers without any exchange.
__device__ __forceinline__ int acc_col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }

// 2^x on the special-function unit, results below 2^-126 flushed to zero
// (far below one part in 2^24 of any softmax sum they join).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// float16 kernels: the floor of a running exponent (dS scaled by 2^(14 - E)
// stays finite for E down to it)
constexpr int kEMin = -110;

// 2^n as a float32 for an integer n <= 127, and zero below 2^-126: a rescale
// by it is exact, or drops less than 2^-126 of what it scales.
__device__ __forceinline__ float pow2(int n) {
  return n < -126 ? 0.f : __int_as_float((n + 127) << 23);
}
// The unbiased exponent of a float32 x >= 0 (-127 for zero and subnormals,
// 128 for inf).
__device__ __forceinline__ int exponent_of(float x) {
  return ((__float_as_int(x) >> 23) & 0xff) - 127;
}

// the element types of the tensor-core kernels' 16-bit operands
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t half2_bits(__half2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two float32 values rounded to a pair of T (bf16 or float16), low half the
// first: an A fragment register, or two outputs written at once.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  if constexpr (kIsHalf<T>)
    return half2_bits(__floats2half2_rn(x0, x1));
  else
    return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// The split of two float32 values of magnitude below 2^15 (already scaled)
// into two float16 pairs (low half the first value): x - h1 - h2 is within
// 2^-22 |x|, or within 2^-25 where h2 falls among float16's subnormals.
__device__ __forceinline__ void split2h(float x0, float x1, uint32_t& h1, uint32_t& h2) {
  const __half2 a = __floats2half2_rn(x0, x1);
  h1 = half2_bits(a);
  h2 = half2_bits(__floats2half2_rn(x0 - __low2float(a), x1 - __high2float(a)));
}

// The exact split of two float32 values into three bf16 pairs (low half
// the first value): x = t1 + t2 + t3 exactly for normal x down to ~2^-110.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& t1, uint32_t& t2,
                                       uint32_t& t3) {
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(b1), r1 = x1 - __high2float(b1);
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 b3 = __floats2bfloat162_rn(r0 - __low2float(b2), r1 - __high2float(b2));
  t1 = bf16x2_bits(b1);
  t2 = bf16x2_bits(b2);
  t3 = bf16x2_bits(b3);
}

// The passes of a product of two float32 operands, each split into its
// three split3 terms (0 the largest), smallest first: pass p (0..5)
// multiplies A's term pass_a(p) by B's term pass_b(p): 2x0, 0x2, 1x1, 1x0,
// 0x1, 0x0. A product of two bf16 operands takes the last pass alone.
__device__ __forceinline__ constexpr int pass_a(int p) {
  return p == 0 ? 2 : (p == 2 || p == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int pass_b(int p) {
  return p == 1 ? 2 : (p == 2 || p == 4) ? 1 : 0;
}

// Stage rows [0, rows) of a row-major (rows, d) source of 16-bit elements
// (bf16 or float16: their bits are moved as they are) into a swizzled
// (ROWS, DP) tile with plain loads, zeros elsewhere: the path for sources
// TMA cannot address (d * 2 bytes not a multiple of 16, or a base that is
// not 16-byte aligned). The NT threads numbered `t` share the work; each
// writes 16-byte chunks.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint16_t* __restrict__ src,
                                           int rows, int d, int t) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  for (int e = t; e < ROWS * CPR; e += NT) {
    const int r = e / CPR, ch = e % CPR;
    alignas(16) uint16_t buf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = ch * 8 + j;
      buf[j] = (r < rows && c < d) ? src[static_cast<int64_t>(r) * d + c] : uint16_t{0};
    }
    uint8_t* blk = dst + (ch / 8) * ROWS * 128;
    *reinterpret_cast<uint4*>(blk + r * 128 + (((ch & 7) ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(buf);
  }
}

// ---- the producer warpgroup's ring ----------------------------------------

// A tensor a producer stages: its TMA map, and for the plain-load path its
// base and rows per batch*head (a contiguous (BH, rows, d) bf16 or float16
// tensor).
struct Src {
  const CUtensorMap* map;
  const void* ptr;
  int rows;
};

// The barriers of a producer/consumer ring of NS stages: `once` for the
// tiles loaded once, full[s] for stage s loaded, empty[s] for stage s
// released by lane 0 of each consumer warp (8, or 4 where a kernel runs one
// consumer warpgroup). With TMA one lane
// loads (one arrival and the expected bytes), else all 128 producer
// threads arrive.
template <int NS>
struct RingBars {
  uint64_t once, full[NS], empty[NS];

  __device__ __forceinline__ void init(bool use_tma, int consumer_warps = 8) {
    const int loaders = use_tma ? 1 : 128;
    mbar_init(&once, loaders);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], loaders);
      mbar_init(&empty[s], consumer_warps);
    }
    fence_barrier_init();
  }
};

// ROWS rows from row0 of each of the N sources, one (ROWS, DP) tile after
// another, into dst, completing on bar: by TMA from the calling lane, or by
// plain loads shared by the producer threads numbered ptid (0..127), each
// of which then arrives.
template <int ROWS, int DP, int N>
__device__ __forceinline__ void load_tiles(uint8_t* dst, const Src (&src)[N], int row0, int bh,
                                           int d, uint64_t* bar, bool use_tma, int ptid) {
  constexpr int BYTES = ROWS * DP * 2;
  if (use_tma) {
    mbar_arrive_expect_tx(bar, N * BYTES);
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int cb = 0; cb < DP / 64; ++cb)
        tma_load_3d(dst + j * BYTES + cb * ROWS * 128, src[j].map, bar, cb * 64, row0, bh);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      stage_tile<ROWS, DP, 128>(dst + j * BYTES,
                                static_cast<const uint16_t*>(src[j].ptr) +
                                    (static_cast<int64_t>(bh) * src[j].rows + row0) * d,
                                min(ROWS, src[j].rows - row0), d, ptid);
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// The producer warpgroup's work (threads ptid 0..127; with TMA ptid 0
// alone): ONCE_ROWS rows of the `once` sources from row once_row into
// once_dst; then for t = 0 .. ntiles - 1, RING_ROWS rows of the `ring`
// sources from row (tile0 + t) * RING_ROWS into stage t % NS of the ring,
// as soon as the consumers have released that stage.
template <int DP, int NS, int ONCE_ROWS, int N1, int RING_ROWS, int N2>
__device__ __forceinline__ void produce(RingBars<NS>& bars, bool use_tma, int ptid, int bh, int d,
                                        uint8_t* once_dst, const Src (&once)[N1], int once_row,
                                        uint8_t* ring, const Src (&srcs)[N2], int tile0,
                                        int ntiles) {
  if (use_tma && ptid != 0) return;
  constexpr int STAGE = N2 * RING_ROWS * DP * 2;
  load_tiles<ONCE_ROWS, DP>(once_dst, once, once_row, bh, d, &bars.once, use_tma, ptid);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    mbar_wait(&bars.empty[s], ((t / NS) & 1) ^ 1);
    load_tiles<RING_ROWS, DP>(ring + s * STAGE, srcs, (tile0 + t) * RING_ROWS, bh, d,
                              &bars.full[s], use_tma, ptid);
  }
}

// ---- wgmma instructions (m64nNk16, bf16 x bf16 or f16 x f16 -> fp32) --------

// The accumulator operands of m64nNk16 (N / 2 fp32 registers a thread) and
// their register lists in the instruction text.
#define SM90_D8(d, i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D16(d) SM90_D8(d, 0), SM90_D8(d, 8)
#define SM90_D32(d) SM90_D16(d), SM90_D8(d, 16), SM90_D8(d, 24)
#define SM90_D64(d) SM90_D32(d), SM90_D8(d, 32), SM90_D8(d, 40), SM90_D8(d, 48), SM90_D8(d, 56)
#define SM90_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (64 x N, fp32) (+)= A (64 x 16, smem) * B (16 x N, smem), both K-major,
// D kept where acc != 0; TY the operands' type ("bf16" or "f16"), PRED and
// TAIL the operand numbers of acc and of the two descriptors.
#define SM90_SS_ASM(N, TY, REGS, PRED, TAIL, DEFS)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " REGS ", " \
               TAIL ", p, 1, 1, 0, 0;\n}\n"                                               \
               : DEFS(d)                                                                  \
               : "l"(da), "l"(db), "r"(acc))
// D (64 x N, fp32) += A (64 x 16, TY pairs in registers) * B (16 x N, smem,
// MN-major).
#define SM90_RS_ASM(N, TY, REGS, PRED, TAIL, DEFS)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " REGS ", " \
               TAIL ", p, 1, 1, 1;\n}\n"                                                  \
               : DEFS(d)                                                                  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define SM90_WGMMA(N, R, REGS, DEFS, SS_PRED, SS_TAIL, RS_PRED, RS_TAIL)                      \
  template <typename T>                                                                       \
  struct Wgmma<N, T> {                                                                        \
    static constexpr int kRegs = R;                                                           \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t da, uint64_t db,       \
                                              int acc) {                                      \
      if constexpr (kIsHalf<T>)                                                               \
        SM90_SS_ASM(N, "f16", REGS, SS_PRED, SS_TAIL, DEFS);                                  \
      else                                                                                    \
        SM90_SS_ASM(N, "bf16", REGS, SS_PRED, SS_TAIL, DEFS);                                 \
    }                                                                                         \
    static __device__ __forceinline__ void rs(float (&d)[R], const uint32_t (&a)[4],         \
                                              uint64_t db) {                                  \
      if constexpr (kIsHalf<T>)                                                               \
        SM90_RS_ASM(N, "f16", REGS, RS_PRED, RS_TAIL, DEFS);                                  \
      else                                                                                    \
        SM90_RS_ASM(N, "bf16", REGS, RS_PRED, RS_TAIL, DEFS);                                 \
    }                                                                                         \
  };

// m64nNk16 products of T (bf16 or float16) operands into fp32; the A
// fragment of k16 step kk (4 x b32, T pairs) takes accumulator registers
// 8kk .. 8kk + 7 in order (see acc_col).
template <int N, typename T = __nv_bfloat16>
struct Wgmma;
SM90_WGMMA(32, 16, SM90_R16, SM90_D16, "%18", "%16, %17", "%21", "{%16, %17, %18, %19}, %20")
SM90_WGMMA(64, 32, SM90_R32, SM90_D32, "%34", "%32, %33", "%37", "{%32, %33, %34, %35}, %36")
SM90_WGMMA(128, 64, SM90_R64, SM90_D64, "%66", "%64, %65", "%69", "{%64, %65, %66, %67}, %68")

// ---- the float32 kernels' split pass ---------------------------------------

// The split3 terms of a contiguous (rows, d) float32 tensor times `mul` into
// three (rows, d8) bf16 planes, the largest first, d8 = d rounded up to a
// multiple of 8 and the columns past d zero: rows TMA can address whatever
// d is. One thread per 8 columns of a row (16 bytes of each plane). Static:
// one copy per translation unit that launches it.
static __global__ void __launch_bounds__(256)
split_planes_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes,
                    int64_t rows, int d, int d8, int vec, float mul) {
  const int cpr = d8 / 8;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * cpr) return;
  const int64_t r = e / cpr;
  const int c0 = static_cast<int>(e - r * cpr) * 8;
  alignas(16) float v[8];
  const float* src = x + r * d + c0;
  if (vec) {  // d == d8 and a 16-byte aligned base
    *reinterpret_cast<float4*>(v) = reinterpret_cast<const float4*>(src)[0];
    *reinterpret_cast<float4*>(v + 4) = reinterpret_cast<const float4*>(src)[1];
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c0 + j < d ? src[j] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] *= mul;  // exact for mul = 1
  uint4 t1, t2, t3;
  split3(v[0], v[1], t1.x, t2.x, t3.x);
  split3(v[2], v[3], t1.y, t2.y, t3.y);
  split3(v[4], v[5], t1.z, t2.z, t3.z);
  split3(v[6], v[7], t1.w, t2.w, t3.w);
  const int64_t at = r * d8 + c0, plane = rows * d8;
  *reinterpret_cast<uint4*>(planes + at) = t1;
  *reinterpret_cast<uint4*>(planes + plane + at) = t2;
  *reinterpret_cast<uint4*>(planes + 2 * plane + at) = t3;
}

// The split planes of a float32 kernel's inputs in the caller's workspace ws
// (16-byte aligned): q, k, v and, for the backward kernels, dout, each its
// three planes in order, (bh, rows, d8) bf16 per plane: 6 * bh * d8 * (sq +
// 2 sk) bytes for the forward, 12 * bh * d8 * (sq + sk) for the backward.
// q is multiplied by q_mul first (the forward's scale; 1 in the backward).
// With split == 0 ws already holds them (the other backward kernel of the
// same call wrote them): only their addresses are set.
struct SplitInputs {
  const __nv_bfloat16* plane[4][3];  // [q, k, v, dout][term]
  int d8;
};

static cudaError_t split_inputs(const void* q, const void* k, const void* v, const void* dout,
                                float q_mul, void* ws, int split, int64_t bh, int sq, int sk,
                                int d, cudaStream_t stream, SplitInputs* out) {
  const int d8 = (d + 7) / 8 * 8;
  const void* src[4] = {q, k, v, dout};
  const int64_t rows[4] = {bh * sq, bh * sk, bh * sk, bh * sq};
  const int n = dout != nullptr ? 4 : 3;
  __nv_bfloat16* at = static_cast<__nv_bfloat16*>(ws);
  for (int i = 0; i < n; ++i) {
    const int64_t threads = rows[i] * (d8 / 8);
    const int vec = d == d8 && reinterpret_cast<uintptr_t>(src[i]) % 16 == 0;
    if (split)
      split_planes_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
          static_cast<const float*>(src[i]), at, rows[i], d, d8, vec, i == 0 ? q_mul : 1.f);
    for (int j = 0; j < 3; ++j) out->plane[i][j] = at + j * rows[i] * d8;
    at += 3 * rows[i] * d8;
  }
  out->d8 = d8;
  return cudaGetLastError();
}

// The tensor maps of a kernel's inputs, passed as one __grid_constant__
// parameter: per input (q, k, v[, dout]) its bf16 planes, one or three, in
// that order.
template <int N>
struct TMapsN {
  CUtensorMap m[N];
};
using TMaps = TMapsN<12>;  // the backward kernels' four inputs

// ---- host: tensor maps ----------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so that the library links no libcuda stub.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// Tensor map of a contiguous (outer, rows, d) tensor of T (bf16, the
// default, or float16) read in boxes of 64 columns x box_rows rows x 1,
// 128-byte swizzled, zeros past every end.
// TMA needs d % 8 == 0 (16-byte row strides) and a 16-byte aligned base;
// tma_ok says whether a tensor qualifies.
inline bool tma_ok(const void* base, int d) {
  return d % 8 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

template <typename T = __nv_bfloat16>
inline cudaError_t make_tmap(CUtensorMap* map, const void* base, int64_t outer, int rows, int d,
                             int box_rows) {
  EncodeTiledFn encode;
  cudaError_t err = encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult res = encode(map, type, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90

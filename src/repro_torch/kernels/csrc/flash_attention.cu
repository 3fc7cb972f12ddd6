// Blocked online-softmax attention (flash attention, forward) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention (flash_attention.py:76, pallas_call at :108)
//     -> hsgd_flash_attention
//
// q is (B, Sq, Hq, D), k and v are (B, Sk, Hk, D), o is (B, Sq, Hq, D), all
// contiguous, all float32 or all bfloat16; Hq % Hk == 0 and query head h
// reads key/value head h / (Hq / Hk) (jnp.repeat's order), with no repeat
// in memory.  For each (b, h) and query position i, over key positions j:
//   logit = (q_i . k_j) * f32(1/sqrt(D)), in float32;
//   visible iff j < Sk, j <= i when causal, i - j < window when windowed
//   (positions count from 0 on both sides); other logits are -1e30;
//   online softmax with a running max and sum in float32;
//   o_i = acc / max(l, 1e-30) (IEEE division), stored in q's type.
// This is what flash_attention.py:26-71 computes, including its -1e30
// arithmetic: a tile in which a row sees no key adds exp(0) = 1 terms that
// the next tile with a visible key scales away by exp(-1e30 - m) = 0.  The
// wrapper (kernels/attention.py) only passes shapes in which every query
// row sees at least one key, so no row keeps such terms.
//
// Bound: operations.  The work is 4*D floating-point operations per
// visible (query, key) pair against 2*D elements per row of q, k, v and o,
// so at a prefill's lengths the card's tensor cores (989 TFLOP/s bf16),
// not its memory, are the limit.  Both types run on the tensor cores,
// through one warp-specialised wgmma + TMA skeleton; bfloat16 is described
// first, float32 after it.
//
// bfloat16: warp-specialised tensor-core kernel (the FA3 shape without
// ping-pong or persistence).  What bounds it and what it does about it:
//   * Q.K^T on wgmma m64n64k16 (bf16 in, f32 accumulators).  A product of
//     two bf16 values is exact in float32, so this is the reference's f32
//     dot of the upcast inputs up to the order of the f32 sums; the scale
//     is applied after the dot, as the reference does.
//   * P.V on wgmma with P kept in float32, where the reference keeps it
//     (flash_attention.py:59-63): in registers each probability splits
//     into three bf16 terms by truncation, hi = p's top 8 significand
//     bits, mid the next 8 of p - hi, lo the rest (p - hi and p - hi - mid
//     are exact in f32, and the rest fits 8 bits), so hi + mid + lo == p
//     exactly; three register-A wgmmas, hi.V, mid.V and lo.V, add into one
//     f32 accumulator.  Why three terms: two rounded ones (hi = bf16(p),
//     lo = bf16(p - hi)) leave an error of 2^-18 p, above f32's 2^-24,
//     which rounds more bf16 outputs away from the plain version's; on
//     the card they moved recurrentgemma-2b's bf16 scores by 0.344 nats
//     against the 0.3 those are held to.  Why truncation: it is bit masks
//     and f32 subtractions, where three float-to-bf16 conversions took the
//     qwen2-0.5b prefill shape from 0.113 to 0.132 ms on the card.  It
//     costs 8*D tensor-core operations per visible pair instead of 4*D, a
//     bound twice the 4*D one.  The accumulator layout of S = Q.K^T is the
//     register-A layout of the next product, so P never leaves registers.
//     V is read in its natural [key][D] layout with the transposed-B form.
//   * TMA with an mbarrier ring feeds shared memory: one producer thread
//     loads the CTA's Q once and keeps a 2-stage ring of K/V tiles in
//     flight, while the consumer warpgroups compute.  The inputs stay in
//     (B, S, H, D): each is a 4-D tensor map (D, H, S, B), encoded on the
//     host for every call and passed as a __grid_constant__ CUtensorMap
//     (cuTensorMapEncodeTiled comes from
//     cudaGetDriverEntryPointByVersion, so the library needs no -lcuda).
//     Tiles are 64 (128-byte swizzle) or 32 (64-byte swizzle) columns
//     wide, the swizzle wgmma's descriptors read.
//     TMA zero-fills rows past S, which replaces the masked staging of
//     ragged tiles; keys at or past Sk are still masked to -1e30.
//   * One consumer warpgroup owns 64 query rows: two per CTA at D <= 128
//     (setmaxnreg moves registers from the producer warpgroup, 24, to the
//     consumers, 240), one at D = 192 and 256, where the 64 x D f32
//     accumulator alone takes D/2 registers a thread.  The running max and
//     sum stay in registers, a row's four threads reduce with shuffles;
//     only tiles on the causal diagonal, the window's edge or the ragged
//     end are masked, and tiles with no visible key are not loaded.
//   * Grid (q tiles, Hq, B); the CTA's linear index maps the longest
//     causal q tiles to the first CTAs, so the last wave is short.
//   * Exponentials: exp2f, with log2(e) folded into the scale (one f32
//     rounding of scale * log2(e)) and the running max kept in the log2
//     domain.  At the qwen2-0.5b prefill shape a call evaluates 58.8 M
//     exponentials, about 0.015 ms of the SFU, the order of the tensor-core
//     bound.  It changes each probability by a few f32 ulps, far inside
//     the 2e-2 the bf16 path is held to.
//
// float32: the same skeleton on exact bf16 splits, since the tensor
// cores give float32 products only as TF32, which the port keeps off.
//   * A split pre-pass (split_planes_kernel, one launch for q, k and v)
//     cuts every float32 x by truncation, as P is cut above: hi = x with
//     its low 16 bits cleared, mid = (x - hi) likewise, lo = x - hi - mid.
//     Each is a bf16 value and hi + mid + lo == x exactly while the terms
//     stay normal (|x| >= 2^-110 or so).  It writes (3, B, S, H, D) bf16
//     planes into scratch the wrapper allocates; viewed as (3B, S, H, D),
//     one tensor map per operand covers the three planes (plane p of batch
//     b at coordinate p*B + b).  It moves 10 bytes an element: read 4,
//     write 6.  K and V are read again by every q tile and by Hq/Hk heads,
//     so splitting them once here is cheaper than in every CTA.
//   * A product a.b keeps six plane pairs, hi.hi, hi.mid, mid.hi, hi.lo,
//     lo.hi and mid.mid, accumulated in float32, and drops mid.lo, lo.mid
//     and lo.lo: |mid| < 2^-7 |x| and |lo| < 2^-15 |x|, so what is dropped
//     is under 2^-21 |a||b| a term (about 2^-26 on average), the order of
//     float32's own rounding and far below TF32's 2^-11.  S = Q.K^T over
//     the Q and K planes, the softmax as in bf16 (exp2f, folded scale, f32
//     statistics), then P.V over P's three register terms and V's planes:
//     24*D tensor-core operations per visible pair, a bound of 24*D at 989
//     TFLOP/s (0.41 of the 4*D-at-67 TFLOP/s ceiling of CUDA-core FMAs)
//     plus the pre-pass's bytes.
//   * Q's three planes stay in shared memory; the ring carries one plane
//     tile (64 keys x D) a stage, in the order the products use them: K_lo
//     (with Q_hi), K_mid (Q_mid, Q_hi), K_hi (Q_lo, Q_mid, Q_hi), then V_lo
//     (P_hi), V_mid (P_mid, P_hi), V_hi (P_lo, P_mid, P_hi).  Each plane
//     tile is read by one commit group of products and its stage released
//     as soon as that group is done (wgmma.wait_group 2, 1, 0), so the
//     producer refills the ring while the rest of the products run.
//     Smallest terms first: the small pairs are summed while S is still
//     small, so that only the D/16 steps of hi.hi add at the scale of S,
//     in case the tensor cores' f32 sums are not rounded to nearest.
//   * Geometry per D (F32Tile): 64-key tiles (S and P stay 32 and 48
//     registers a thread, as bf16's D = 256), two consumer warpgroups up
//     to D = 128 and one above, and a ring of 3 to 8 stages, as shared
//     memory allows: at D = 256, 96 KB of Q planes and 3 x 32 KB of ring.
//     At D = 256 ptxas reports 255 registers and 104 bytes of spill
//     stores a thread (O alone is 128 registers); no other D spills.
//   * The pre-pass ran at 1.1 times its bytes bound on the card, 9-14% of
//     a call at the timing shapes, so Q is split there too rather than in
//     the kernel after its TMA load.
//   * The output is stored as float32, o = acc / max(l, 1e-30) by IEEE
//     division.
// Shared memory passes 48 KB, so it is dynamic and each instantiation
// raises its limit with cudaFuncSetAttribute; a launch the card refuses
// comes back as the cudaError the entry point returns.
//
// Exactness: f32 statistics and accumulators on both paths (exp2f, IEEE
// division, built without --use_fast_math); a product of two bf16 values,
// inputs or planes, is exact in float32, and float32 inputs lose only the
// three dropped plane pairs.  Both sum in another order than the plain
// version's products (kernels/ref.py::attention_ref), so they agree to a
// tolerance (2e-5 in float32, 2e-2 in bfloat16), not bitwise.  On an H100
// the float32 path lies 2.1 to 56 x 2^-24 of max |o| from the same
// attention in float64, where attention_ref lies 2.3 to 21 and the design
// without the lo planes 306 to 1007: about 4x the plain version's error,
// as sums that are not rounded to nearest would give.  chip_smoke.py holds
// it to 128 x 2^-24 of max |o| (ATTN_F32_ULPS) beside 2e-5.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;

// ---- bfloat16: wgmma + TMA ----------------------------------------------

// Tile geometry of one instantiation: D head dim, CW columns per TMA box
// (64: 128-byte swizzle, 32: 64-byte), NC consumer warpgroups of 64 query
// rows, BK keys per K/V tile.
template <int D, int CW, int NC, int BK>
struct Bf16Tile {
  static constexpr int kBlockQ = 64 * NC;
  static constexpr int kRowBytes = 2 * CW;
  static constexpr int kChunks = D / CW;       // boxes across D
  static constexpr int kQBytes = kChunks * kBlockQ * kRowBytes;
  static constexpr int kKVBytes = kChunks * BK * kRowBytes;   // K or V tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (NC + 1);   // + producer warpgroup
  static constexpr int kUsed = kQBytes + kStages * 2 * kKVBytes + 64;
  // 1 KB of slack to align the tiles to the swizzle's 1 KB period; with
  // two consumers, at least 116 KB so that no second CTA shares the SM
  // (setmaxnreg hands the consumers every register of the SM)
  static constexpr int kSmem =
      NC == 2 && kUsed + 1024 < 116 * 1024 ? 116 * 1024 : kUsed + 1024;
  static constexpr uint64_t kLayout = CW == 64 ? 1 : 2;   // wgmma swizzle
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8 rows
  static_assert(D % CW == 0 && (CW == 32 || CW == 64), "box width");
  static_assert(BK % 64 == 0 && BK <= 256, "key tile");
  static_assert(kUsed + 1024 <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory at dst; completion is counted on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Orders a register after the wgmma wait: the compiler may not move its
// reads (accumulators) or reuse it (register-A fragments) across this.
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// (t, x - t) with t = x truncated to bf16 (its top 8 significand bits):
// both exact in float32, and t exact in bf16
__device__ __forceinline__ float2 split_top(float x) {
  const float t = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
  return make_float2(t, x - t);
}

// bf16(a) in the low half, bf16(b) in the high half, by truncation (the
// top 16 bits of each); exact for values split_top leaves
__device__ __forceinline__ uint32_t bf16x2_pack(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// d (64 x 64 f32, accumulator layout) = A . B (+ d when accumulate):
// A and B both from shared memory, K-major (no transpose)
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A . B: A (64 x 16 bf16) from registers, B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 f32) += A . B: A (64 x 16 bf16) from registers, B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x CW f32) += A . B for one box-wide column chunk of V
template <int CW>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db) {
  if constexpr (CW == 64) {
    mma_rs_n64(d, a, db);
  } else {
    mma_rs_n32(d, a, db);
  }
}

template <int D, int CW, int NC, int BK>
__global__ void __launch_bounds__(Bf16Tile<D, CW, NC, BK>::kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                            int Hq, int Hk, int causal, int window,
                            float scale_log2) {
  using G = Bf16Tile<D, CW, NC, BK>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + G::kQBytes;   // stage s: K, then V
  const uint32_t bars = kv_s + G::kStages * 2 * G::kKVBytes;
  const uint32_t q_full = bars;             // then full[2], empty[2]
  const uint32_t full0 = bars + 8, empty0 = bars + 8 + 8 * G::kStages;

  // this CTA's (q tile, head, batch): longest causal q tiles first
  const int hb = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int qt = gridDim.x - 1 - lin / hb;
  const int rest = lin % hb;
  const int h = rest % Hq, b = rest / Hq;
  const int hk = h / (Hq / Hk);
  const int q_first = qt * G::kBlockQ;
  const int q_last = min(q_first + G::kBlockQ, Sq) - 1;

  // the K/V tiles that hold at least one visible key for some row here
  const int nk = (Sk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kt_begin =
      window > 0 && q_first - window + 1 > 0 ? (q_first - window + 1) / BK : 0;
  const int ntiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NC);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer warpgroup: one thread issues every load ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(q_full, G::kQBytes);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
        tma_load(q_s + c * G::kBlockQ * G::kRowBytes, &tq, q_full, c * CW, h,
                 q_first, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % G::kStages;
        mbar_wait(empty0 + 8 * s, ((i / G::kStages) & 1) ^ 1);
        const uint32_t kd = kv_s + s * 2 * G::kKVBytes;
        const uint32_t vd = kd + G::kKVBytes;
        const int k0 = (kt_begin + i) * BK;
        mbar_expect_tx(full0 + 8 * s, 2 * G::kKVBytes);
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load(kd + c * BK * G::kRowBytes, &tk, full0 + 8 * s, c * CW, hk,
                   k0, b);
          tma_load(vd + c * BK * G::kRowBytes, &tv, full0 + 8 * s, c * CW, hk,
                   k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q_first + 64 wg + [0, 64) ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int r_lo = q_first + 64 * wg;
    // accumulator layout: register 4j + e holds row (e < 2 ? row_a : row_b)
    // and column 8j + col + (e & 1)
    const int row_a = r_lo + 16 * warp + (lane >> 2), row_b = row_a + 8;
    const int col = 2 * (lane & 3);
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    const uint32_t q_wg = q_s + 64 * wg * G::kRowBytes;

    mbar_wait(q_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % G::kStages;
      const uint32_t kd = kv_s + s * 2 * G::kKVBytes;
      const uint32_t vd = kd + G::kKVBytes;
      const int k0 = (kt_begin + i) * BK;
      mbar_wait(full0 + 8 * s, (i / G::kStages) & 1);

      // S = Q . K^T over D in steps of 16, 64 keys an instruction
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks / (CW / 16), kk = ks % (CW / 16);
        const uint64_t da = wgmma_desc(
            q_wg + c * G::kBlockQ * G::kRowBytes + 32 * kk, 16,
            G::kGroupBytes, G::kLayout);
#pragma unroll
        for (int nb = 0; nb < BK / 64; ++nb) {
          const uint64_t db = wgmma_desc(
              kd + c * BK * G::kRowBytes + nb * 64 * G::kRowBytes + 32 * kk,
              16, G::kGroupBytes, G::kLayout);
          mma_ss_n64(sc + 32 * nb, da, db, ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) pin(sc[j]);

      // scale (log2 domain), mask where this tile needs it, row max
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > r_lo) ||
                          (window > 0 && r_lo + 63 - k0 >= window);
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            bool ok = key < Sk;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && row - key < window;
            x = ok ? x : kNegInf;
          }
          sc[4 * j + e] = x;
          if (e < 2) {
            mx_a = fmaxf(mx_a, x);
          } else {
            mx_b = fmaxf(mx_b, x);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;

      // probabilities, split exactly into bf16 hi + mid + lo register-A
      // fragments: the fragment of key slice u (keys 16u..16u+15) is S's
      // registers 8u..8u+7
      uint32_t p_hi[BK / 16][4], p_mid[BK / 16][4], p_lo[BK / 16][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float mr = (r & 1) ? m_b : m_a;
          const float p0 = exp2f(sc[8 * u + 2 * r] - mr);
          const float p1 = exp2f(sc[8 * u + 2 * r + 1] - mr);
          if (r & 1) {
            sum_b += p0 + p1;
          } else {
            sum_a += p0 + p1;
          }
          const float2 m0 = split_top(p0), m1 = split_top(p1);
          const float2 l0 = split_top(m0.y), l1 = split_top(m1.y);
          p_hi[u][r] = bf16x2_pack(p0, p1);
          p_mid[u][r] = bf16x2_pack(m0.y, m1.y);
          p_lo[u][r] = bf16x2_pack(l0.y, l1.y);
        }
      }
      l_a = alpha_a * l_a + sum_a;
      l_b = alpha_b * l_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }

      // O += (hi + mid + lo) . V, 16 keys an instruction triple, CW columns
      // each
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          const uint64_t db = wgmma_desc(
              vd + c * BK * G::kRowBytes + 16 * u * G::kRowBytes,
              BK * G::kRowBytes, G::kGroupBytes, G::kLayout);
          mma_rs<CW>(acc + c * (CW / 2), p_hi[u], db);
          mma_rs<CW>(acc + c * (CW / 2), p_mid[u], db);
          mma_rs<CW>(acc + c * (CW / 2), p_lo[u], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < D / 2; ++j) pin(acc[j]);
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pin(p_hi[u][r]);
          pin(p_mid[u][r]);
          pin(p_lo[u][r]);
        }
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this tile is free
    }

    // o = acc / l, the row's sum reduced over its four threads
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    const long long stride = static_cast<long long>(Hq) * D;
    __nv_bfloat16* oa =
        o + (static_cast<long long>(b) * Sq + row_a) * stride + h * D + col;
    __nv_bfloat16* ob = oa + 8 * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      // register 4j lies in column chunk j / (CW / 8), 8 (j % (CW / 8))
      // columns into it: column 8j of the row either way
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(oa + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
      if (row_b < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (D, H, S, B) of a contiguous (B, S, H, D) bf16 tensor, read
// in boxes of (cw, 1, rows, 1); rows past S read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int H,
                int D, int cw, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cw), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int CW, int NC, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int Hq, int Hk, int causal,
                        int window, cudaStream_t stream) {
  using G = Bf16Tile<D, CW, NC, BK>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Sq, Hq, D, CW, G::kBlockQ) ||
      !tensor_map(&tk, k, B, Sk, Hk, D, CW, BK) ||
      !tensor_map(&tv, v, B, Sk, Hk, D, CW, BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_bf16_kernel<D, CW, NC, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((Sq + G::kBlockQ - 1) / G::kBlockQ, Hq, B);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, Hq, Hk, causal,
      window, scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int Hq, int Hk,
                          int D, int causal, int window, cudaStream_t stream) {
  // <D, box width, consumer warpgroups, keys per tile>: 128-key tiles
  // while the S, P and O registers fit, two consumers up to D = 128
  switch (D) {
    case 32:
      return launch_bf16<32, 32, 2, 128>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 64:
      return launch_bf16<64, 64, 2, 128>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 96:
      return launch_bf16<96, 32, 2, 64>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 128:
      return launch_bf16<128, 64, 2, 64>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 192:
      return launch_bf16<192, 64, 1, 64>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 256:
      return launch_bf16<256, 64, 1, 64>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---- float32: exact bf16 splits on wgmma + TMA ----------------------------

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The planes of q, k and v: src[t] holds n4[t] float4s, dst[t] the planes
// hi, mid and lo one after another, n4[t] groups of 4 bf16 each.
struct SplitArgs {
  const float4* src[3];
  uint2* dst[3];
  long long n4[3];
};

constexpr int kSplitThreads = 256;

// One launch splits q, k and v (blockIdx.y); a thread takes a float4 at a
// time and writes 8 bytes to each plane.  The operand is chosen by
// selects, not by indexing: an indexed parameter array is copied to the
// stack by every thread, which took the kernel to 4.4 times its bound.
__global__ void __launch_bounds__(kSplitThreads)
split_planes_kernel(const SplitArgs args) {
  const int t = blockIdx.y;
  const float4* __restrict__ src =
      t == 0 ? args.src[0] : t == 1 ? args.src[1] : args.src[2];
  uint2* __restrict__ dst =
      t == 0 ? args.dst[0] : t == 1 ? args.dst[1] : args.dst[2];
  const long long n4 = t == 0 ? args.n4[0] : t == 1 ? args.n4[1] : args.n4[2];
  for (long long i = blockIdx.x * static_cast<long long>(kSplitThreads) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(kSplitThreads) * gridDim.x) {
    const float4 x = src[i];
    // (hi, x - hi), then (mid, lo) of x - hi
    const float2 a0 = split_top(x.x), a1 = split_top(x.y);
    const float2 a2 = split_top(x.z), a3 = split_top(x.w);
    const float2 b0 = split_top(a0.y), b1 = split_top(a1.y);
    const float2 b2 = split_top(a2.y), b3 = split_top(a3.y);
    dst[i] = make_uint2(bf16x2_pack(x.x, x.y), bf16x2_pack(x.z, x.w));
    dst[n4 + i] =
        make_uint2(bf16x2_pack(a0.y, a1.y), bf16x2_pack(a2.y, a3.y));
    dst[2 * n4 + i] =
        make_uint2(bf16x2_pack(b0.y, b1.y), bf16x2_pack(b2.y, b3.y));
  }
}

// Tile geometry of one float32 instantiation: D head dim, CW columns per
// TMA box, NC consumer warpgroups of 64 query rows, BK keys per tile,
// STAGES plane tiles in the ring.
template <int D, int CW, int NC, int BK, int STAGES>
struct F32Tile {
  static constexpr int kBlockQ = 64 * NC;
  static constexpr int kRowBytes = 2 * CW;
  static constexpr int kChunks = D / CW;
  static constexpr int kQPlane = kChunks * kBlockQ * kRowBytes;  // one of Q's
  static constexpr int kTile = kChunks * BK * kRowBytes;  // a K or V plane
  static constexpr int kStages = STAGES;
  static constexpr int kThreads = 128 * (NC + 1);   // + producer warpgroup
  static constexpr int kUsed =
      3 * kQPlane + kStages * kTile + 8 * (1 + 2 * kStages);
  // as Bf16Tile: 1 KB of slack for the swizzle's alignment, and with two
  // consumers at least 116 KB, so that no second CTA shares the SM
  static constexpr int kSmem =
      NC == 2 && kUsed + 1024 < 116 * 1024 ? 116 * 1024 : kUsed + 1024;
  static constexpr uint64_t kLayout = CW == 64 ? 1 : 2;   // wgmma swizzle
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8 rows
  static_assert(D % CW == 0 && (CW == 32 || CW == 64), "box width");
  static_assert(BK == 64, "key tile: S is one n64 product a k-step");
  // a consumer holds the three planes of a K or V tile at once
  static_assert(kStages >= 3, "ring stages");
  static_assert(kUsed + 1024 <= 227 * 1024, "shared memory");
};

// sc (64 query rows x 64 keys, accumulator layout) += Q plane . K plane^T
// over D: q is the warpgroup's rows of one Q plane, k one plane tile;
// `first` starts the sum from zero
template <typename G, int D, int CW, int BK>
__device__ __forceinline__ void qk_plane(float* sc, uint32_t q, uint32_t k,
                                         bool first) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / (CW / 16), kk = ks % (CW / 16);
    const uint64_t da =
        wgmma_desc(q + c * G::kBlockQ * G::kRowBytes + 32 * kk, 16,
                   G::kGroupBytes, G::kLayout);
    const uint64_t db = wgmma_desc(k + c * BK * G::kRowBytes + 32 * kk, 16,
                                   G::kGroupBytes, G::kLayout);
    mma_ss_n64(sc, da, db, !(first && ks == 0));
  }
}

// acc (64 x D) += P term . V plane tile, 16 keys an instruction, CW
// columns each
template <typename G, int D, int CW, int BK>
__device__ __forceinline__ void pv_plane(float* acc, const uint32_t (*p)[4],
                                         uint32_t v) {
#pragma unroll
  for (int u = 0; u < BK / 16; ++u) {
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c) {
      const uint64_t db =
          wgmma_desc(v + c * BK * G::kRowBytes + 16 * u * G::kRowBytes,
                     BK * G::kRowBytes, G::kGroupBytes, G::kLayout);
      mma_rs<CW>(acc + c * (CW / 2), p[u], db);
    }
  }
}

template <int D, int CW, int NC, int BK, int STAGES>
__global__ void __launch_bounds__(F32Tile<D, CW, NC, BK, STAGES>::kThreads, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ o, int B, int Sq, int Sk,
                           int Hq, int Hk, int causal, int window,
                           float scale_log2) {
  using G = F32Tile<D, CW, NC, BK, STAGES>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // Q's planes hi, mid, lo; the ring; then q_full, full[], empty[]
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + 3 * G::kQPlane;
  const uint32_t q_full = ring + G::kStages * G::kTile;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * G::kStages;

  // this CTA's (q tile, head, batch): longest causal q tiles first
  const int hb = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int qt = gridDim.x - 1 - lin / hb;
  const int rest = lin % hb;
  const int h = rest % Hq, b = rest / Hq;
  const int hk = h / (Hq / Hk);
  const int q_first = qt * G::kBlockQ;
  const int q_last = min(q_first + G::kBlockQ, Sq) - 1;

  // the K/V tiles that hold at least one visible key for some row here
  const int nk = (Sk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kt_begin =
      window > 0 && q_first - window + 1 > 0 ? (q_first - window + 1) / BK : 0;
  const int ntiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * NC);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer warpgroup: one thread issues every load ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(q_full, 3 * G::kQPlane);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c)
          tma_load(q_s + p * G::kQPlane + c * G::kBlockQ * G::kRowBytes, &tq,
                   q_full, c * CW, h, q_first, p * B + b);
      }
      // plane tile g: per key tile K lo, mid, hi, then V lo, mid, hi
      int g = 0;
      for (int i = 0; i < ntiles; ++i) {
        const int k0 = (kt_begin + i) * BK;
        for (int j = 0; j < 6; ++j, ++g) {
          const int s = g % G::kStages;
          const uint32_t full = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((g / G::kStages) & 1) ^ 1);
          mbar_expect_tx(full, G::kTile);
          const CUtensorMap* map = j < 3 ? &tk : &tv;
          const int plane = 2 - j % 3;
#pragma unroll
          for (int c = 0; c < G::kChunks; ++c)
            tma_load(ring + s * G::kTile + c * BK * G::kRowBytes, map, full,
                     c * CW, hk, k0, plane * B + b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q_first + 64 wg + [0, 64) ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int r_lo = q_first + 64 * wg;
    // accumulator layout: register 4j + e holds row (e < 2 ? row_a : row_b)
    // and column 8j + col + (e & 1)
    const int row_a = r_lo + 16 * warp + (lane >> 2), row_b = row_a + 8;
    const int col = 2 * (lane & 3);
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    // the warpgroup's rows of Q's planes
    const uint32_t q_hi = q_s + 64 * wg * G::kRowBytes;
    const uint32_t q_mid = q_hi + G::kQPlane, q_lo = q_hi + 2 * G::kQPlane;

    // plane tile g: wait until it has landed and return its address; and
    // hand its stage back to the producer (every thread arrives: a lane-0
    // branch here is no faster)
    auto arrive = [&](int g) {
      const int s = g % G::kStages;
      mbar_wait(full0 + 8 * s, (g / G::kStages) & 1);
      return ring + s * G::kTile;
    };
    auto release = [&](int g) { mbar_arrive(empty0 + 8 * (g % G::kStages)); };

    mbar_wait(q_full, 0);
    for (int i = 0, g = 0; i < ntiles; ++i, g += 6) {
      const int k0 = (kt_begin + i) * BK;

      // S = Q . K^T over the six kept plane pairs, smallest first, in one
      // commit group per K plane; each plane's stage is released as soon
      // as its group is done.  All three planes are waited for before the
      // first product: a wait between products put a divergent loop inside
      // the wgmma pipeline, which ptxas serialised (C7520) at D = 192 and
      // 256, and took (b) from 0.40 to 0.62 ms on the card.
      float sc[BK / 2];
      const uint32_t k_lo = arrive(g), k_mid = arrive(g + 1);
      const uint32_t k_hi = arrive(g + 2);
      wgmma_fence();
      qk_plane<G, D, CW, BK>(sc, q_hi, k_lo, true);
      wgmma_commit();
      qk_plane<G, D, CW, BK>(sc, q_mid, k_mid, false);
      qk_plane<G, D, CW, BK>(sc, q_hi, k_mid, false);
      wgmma_commit();
      qk_plane<G, D, CW, BK>(sc, q_lo, k_hi, false);
      qk_plane<G, D, CW, BK>(sc, q_mid, k_hi, false);
      qk_plane<G, D, CW, BK>(sc, q_hi, k_hi, false);
      wgmma_commit();
      wgmma_wait<2>();
      release(g);
      wgmma_wait<1>();
      release(g + 1);
      wgmma_wait<0>();
      release(g + 2);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) pin(sc[j]);

      // scale (log2 domain), mask where this tile needs it, row max
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > r_lo) ||
                          (window > 0 && r_lo + 63 - k0 >= window);
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            bool ok = key < Sk;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && row - key < window;
            x = ok ? x : kNegInf;
          }
          sc[4 * j + e] = x;
          if (e < 2) {
            mx_a = fmaxf(mx_a, x);
          } else {
            mx_b = fmaxf(mx_b, x);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;

      // probabilities, split exactly into bf16 hi + mid + lo register-A
      // fragments: the fragment of key slice u (keys 16u..16u+15) is S's
      // registers 8u..8u+7
      uint32_t p_hi[BK / 16][4], p_mid[BK / 16][4], p_lo[BK / 16][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float mr = (r & 1) ? m_b : m_a;
          const float p0 = exp2f(sc[8 * u + 2 * r] - mr);
          const float p1 = exp2f(sc[8 * u + 2 * r + 1] - mr);
          if (r & 1) {
            sum_b += p0 + p1;
          } else {
            sum_a += p0 + p1;
          }
          const float2 m0 = split_top(p0), m1 = split_top(p1);
          const float2 l0 = split_top(m0.y), l1 = split_top(m1.y);
          p_hi[u][r] = bf16x2_pack(p0, p1);
          p_mid[u][r] = bf16x2_pack(m0.y, m1.y);
          p_lo[u][r] = bf16x2_pack(l0.y, l1.y);
        }
      }
      l_a = alpha_a * l_a + sum_a;
      l_b = alpha_b * l_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }

      // O += P . V over the six kept pairs of P's terms and V's planes,
      // smallest first, in the same way
      const uint32_t v_lo = arrive(g + 3), v_mid = arrive(g + 4);
      const uint32_t v_hi = arrive(g + 5);
      wgmma_fence();
      pv_plane<G, D, CW, BK>(acc, p_hi, v_lo);
      wgmma_commit();
      pv_plane<G, D, CW, BK>(acc, p_mid, v_mid);
      pv_plane<G, D, CW, BK>(acc, p_hi, v_mid);
      wgmma_commit();
      pv_plane<G, D, CW, BK>(acc, p_lo, v_hi);
      pv_plane<G, D, CW, BK>(acc, p_mid, v_hi);
      pv_plane<G, D, CW, BK>(acc, p_hi, v_hi);
      wgmma_commit();
      wgmma_wait<2>();
      release(g + 3);
      wgmma_wait<1>();
      release(g + 4);
      wgmma_wait<0>();
      release(g + 5);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) pin(acc[j]);
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pin(p_hi[u][r]);
          pin(p_mid[u][r]);
          pin(p_lo[u][r]);
        }
      }
    }

    // o = acc / l, the row's sum reduced over its four threads
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    const long long stride = static_cast<long long>(Hq) * D;
    float* oa =
        o + (static_cast<long long>(b) * Sq + row_a) * stride + h * D + col;
    float* ob = oa + 8 * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      // register 4j holds column 8j + col of its row, as in bf16
      if (row_a < Sq)
        *reinterpret_cast<float2*>(oa + 8 * j) =
            make_float2(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
      if (row_b < Sq)
        *reinterpret_cast<float2*>(ob + 8 * j) =
            make_float2(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
  }
}

// The split pre-pass into `planes` (3 (B Sq Hq + 2 B Sk Hk) D bf16: q's
// planes, then k's, then v's), then the attention kernel on them.
template <int D, int CW, int NC, int BK, int STAGES>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* planes, int B, int Sq, int Sk, int Hq, int Hk,
                       int causal, int window, cudaStream_t stream) {
  using G = F32Tile<D, CW, NC, BK, STAGES>;
  const long long nq = static_cast<long long>(B) * Sq * Hq * D;
  const long long nk = static_cast<long long>(B) * Sk * Hk * D;
  __nv_bfloat16* pq = static_cast<__nv_bfloat16*>(planes);
  __nv_bfloat16* pk = pq + 3 * nq;
  __nv_bfloat16* pv = pk + 3 * nk;
  const SplitArgs args = {
      {static_cast<const float4*>(q), static_cast<const float4*>(k),
       static_cast<const float4*>(v)},
      {reinterpret_cast<uint2*>(pq), reinterpret_cast<uint2*>(pk),
       reinterpret_cast<uint2*>(pv)},
      {nq / 4, nk / 4, nk / 4}};
  // enough blocks to fill the card twice over; each thread then loops
  const long long blocks =
      ((nq > nk ? nq : nk) / 4 + kSplitThreads - 1) / kSplitThreads;
  split_planes_kernel<<<dim3(static_cast<unsigned>(blocks < 2048 ? blocks
                                                                 : 2048),
                             3),
                        kSplitThreads, 0, stream>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, pq, 3 * B, Sq, Hq, D, CW, G::kBlockQ) ||
      !tensor_map(&tk, pk, 3 * B, Sk, Hk, D, CW, BK) ||
      !tensor_map(&tv, pv, 3 * B, Sk, Hk, D, CW, BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_f32_kernel<D, CW, NC, BK, STAGES>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((Sq + G::kBlockQ - 1) / G::kBlockQ, Hq, B);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), B, Sq, Sk, Hq, Hk, causal, window,
      scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, void* planes, int B, int Sq, int Sk,
                         int Hq, int Hk, int D, int causal, int window,
                         cudaStream_t stream) {
  // <D, box width, consumer warpgroups, keys per tile, ring stages>: two
  // consumers up to D = 128, and the stages that fit beside Q's planes
  switch (D) {
    case 32:
      return launch_f32<32, 32, 2, 64, 8>(q, k, v, o, planes, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 64:
      return launch_f32<64, 64, 2, 64, 8>(q, k, v, o, planes, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 96:
      return launch_f32<96, 32, 2, 64, 6>(q, k, v, o, planes, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 128:
      return launch_f32<128, 64, 2, 64, 6>(q, k, v, o, planes, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 192:
      return launch_f32<192, 64, 1, 64, 6>(q, k, v, o, planes, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 256:
      return launch_f32<256, 64, 1, 64, 3>(q, k, v, o, planes, B, Sq, Sk, Hq, Hk, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.  planes is
// the float32 path's scratch, 3 (B Sq Hq + 2 B Sk Hk) D bf16 values on
// 16 bytes (unused in bfloat16).  Returns the cudaError of the launch (0 on
// success); the wrapper checks shapes, types, alignment and grid limits
// before it calls.
extern "C" int hsgd_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* planes,
                                    int dtype, int B, int Sq, int Sk, int Hq,
                                    int Hk, int D, int causal, int window,
                                    cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hk <= 0 || Hq % Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0 && planes != nullptr
          ? dispatch_f32(q, k, v, o, planes, B, Sq, Sk, Hq, Hk, D, causal,
                         window, stream)
      : dtype == 1 ? dispatch_bf16(q, k, v, o, B, Sq, Sk, Hq, Hk, D, causal,
                                   window, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

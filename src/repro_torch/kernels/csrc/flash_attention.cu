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
// not its memory, are the limit.  The two types take two paths.
//
// float32: a SIMT kernel on the CUDA cores (67 TFLOP/s, a ceiling about 15
// times the tensor-core bound).  The reference's kernel is float32
// throughout, and the f32 serving contract (greedy tokens equal to the
// plain route's) rests on float32 products, which the tensor cores only
// give as TF32.  Its design:
//   * one CTA of 8 warps per (q tile of 64 rows, query head, batch); a loop
//     inside the CTA walks the K/V tiles, in place of the TPU's sequential
//     fourth grid axis (flash_attention.py:102);
//   * tiles that the causal or window mask removes entirely are skipped,
//     not masked (the Pallas kernel visits all of them);
//   * q, k and v are staged once per tile in shared memory; a warp owns 8
//     query rows, a lane BK/32 keys for q.k and D/32 output columns for
//     p.v; the running max, the lane's part of the sum and the accumulator
//     stay in registers; ragged q and k tiles are masked, not padded.
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
//   * Grid (q tiles, Hq, B) as the f32 path's, but the CTA's linear index
//     maps the longest causal q tiles to the first CTAs, so the last wave
//     is short.
//   * Exponentials: exp2f, with log2(e) folded into the scale (one f32
//     rounding of scale * log2(e)) and the running max kept in the log2
//     domain.  At the qwen2-0.5b prefill shape a call evaluates 58.8 M
//     exponentials, about 0.015 ms of the SFU, the order of the tensor-core
//     bound.  It changes each probability by a few f32 ulps, far inside
//     the 2e-2 the bf16 path is held to.
// Shared memory passes 48 KB, so it is dynamic and each instantiation
// raises its limit with cudaFuncSetAttribute; a launch the card refuses
// comes back as the cudaError the entry point returns.
//
// Exactness: float32 throughout on the f32 path (expf, IEEE division,
// built without --use_fast_math); f32 statistics and accumulators on the
// bf16 path.  Both sum in another order than the plain version's products
// (kernels/ref.py::attention_ref), so they agree to a tolerance (2e-5 in
// float32, 2e-2 in bfloat16), not bitwise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

// ---- float32: SIMT ----------------------------------------------------
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 64;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr float kNegInf = -1e30f;
static_assert(kRowsPerWarp == 8, "a key's probabilities are two float4s");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }


__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage `rows` rows of one head (row r at src + r * row_stride, D values
// each) into dst as float32 rows of `ld` floats; rows at or past `valid`
// are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      long long row_stride, int rows,
                                      int valid, float* __restrict__ dst,
                                      int ld) {
  constexpr int kVecPerRow = D / 4;
  for (int e = threadIdx.x; e < rows * kVecPerRow; e += kThreads) {
    const int r = e / kVecPerRow;
    const int c = (e - r * kVecPerRow) * 4;
    const float4 out = r < valid ? load4(src + r * row_stride + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = out;
  }
}

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * (D + 4) +
                          static_cast<size_t>(BK) * (D + 4) +
                          static_cast<size_t>(BK) * D +
                          static_cast<size_t>(kWarps) * BK * kRowsPerWarp);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int Hq, int Hk, int causal, int window,
                       float scale) {
  constexpr int kLd = D + 4;          // padded row of the q and k tiles
  constexpr int kKeysPerLane = BK / 32;
  constexpr int kCols = D / 32;       // output columns a lane owns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBlockQ][kLd]
  float* ks = qs + kBlockQ * kLd;                // [BK][kLd]
  float* vs = ks + BK * kLd;                     // [BK][D]
  float* ps = vs + BK * D;                       // [kWarps][BK][8]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q_first = blockIdx.x * kBlockQ;
  const int q_rows = min(kBlockQ, Sq - q_first);
  const int q_last = q_first + q_rows - 1;

  // The K/V tiles that hold at least one visible key for some row here.
  const int nk = (Sk + BK - 1) / BK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q_first - window + 1 > 0)
    kt_begin = (q_first - window + 1) / BK;

  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_stride = static_cast<long long>(Hk) * D;
  const T* qg = q + ((static_cast<long long>(b) * Sq + q_first) * Hq + h) * D;
  stage<T, D>(qg, q_stride, kBlockQ, q_rows, qs, kLd);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const float* qw = qs + warp * kRowsPerWarp * kLd;
  float* pw = ps + warp * BK * kRowsPerWarp;
  const int row0 = q_first + warp * kRowsPerWarp;   // query position of r=0

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const long long kv_off =
        ((static_cast<long long>(b) * Sk + k0) * Hk + hk) * D;
    __syncthreads();   // the previous tile's k/v (and, first, nothing)
    stage<T, D>(k + kv_off, kv_stride, BK, Sk - k0, ks, kLd);
    stage<T, D>(v + kv_off, kv_stride, BK, Sk - k0, vs, D);
    __syncthreads();

    // s[r][t] = q_row(r) . k_key(lane + 32 t)
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) s[r][t] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[kKeysPerLane];
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t)
        kv[t] = *reinterpret_cast<const float4*>(ks + (lane + 32 * t) * kLd + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * kLd + d);
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          s[r][t] = fmaf(qv.x, kv[t].x, s[r][t]);
          s[r][t] = fmaf(qv.y, kv[t].y, s[r][t]);
          s[r][t] = fmaf(qv.z, kv[t].z, s[r][t]);
          s[r][t] = fmaf(qv.w, kv[t].w, s[r][t]);
        }
      }
    }

    // mask and online softmax; s becomes the probabilities
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = row0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        const int kpos = k0 + lane + 32 * t;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[r][t] = ok ? s[r][t] * scale : kNegInf;
        mx = fmaxf(mx, s[r][t]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        s[r][t] = expf(s[r][t] - m_new);
        part += s[r][t];
      }
      l[r] = alpha * l[r] + part;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    // the 8 rows' probabilities of a key as two 16-byte stores
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      float* dst = pw + (lane + 32 * t) * kRowsPerWarp;
      *reinterpret_cast<float4*>(dst) =
          make_float4(s[0][t], s[1][t], s[2][t], s[3][t]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(s[4][t], s[5][t], s[6][t], s[7][t]);
    }
    __syncwarp();

    // acc[r][c] += sum_j p[j][r] * v[j][lane + 32 c]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pw + j * kRowsPerWarp);
      const float4 pb =
          *reinterpret_cast<const float4*>(pw + j * kRowsPerWarp + 4);
      const float p[kRowsPerWarp] = {pa.x, pa.y, pa.z, pa.w,
                                     pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[j * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
    __syncwarp();   // pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = row0 + r;
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    if (qpos >= Sq) continue;
    T* og = o + ((static_cast<long long>(b) * Sq + qpos) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store1(og + lane + 32 * c, acc[r][c] / denom);
  }
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int Hq, int Hk, int causal,
                   int window, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D, BK>;
  constexpr size_t smem = smem_bytes<D, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int Hq, int Hk, int D,
                     int causal, int window, cudaStream_t stream) {
  // 64-key tiles up to D = 96; 32-key tiles above, so that shared memory
  // stays under 150 KB and a D = 128 CTA leaves room for two more per SM
  switch (D) {
    case 32:
      return launch<T, 32, 64>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 64:
      return launch<T, 64, 64>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 96:
      return launch<T, 96, 64>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 128:
      return launch<T, 128, 32>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 192:
      return launch<T, 192, 32>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    case 256:
      return launch<T, 256, 32>(q, k, v, o, B, Sq, Sk, Hq, Hk, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.  Returns the
// cudaError of the launch (0 on success); the wrapper checks shapes,
// types, alignment and grid limits before it calls.
extern "C" int hsgd_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int dtype, int B,
                                    int Sq, int Sk, int Hq, int Hk, int D,
                                    int causal, int window,
                                    cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hk <= 0 || Hq % Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, o, B, Sq, Sk, Hq, Hk, D, causal,
                                   window, stream)
      : dtype == 1 ? dispatch_bf16(q, k, v, o, B, Sq, Sk, Hq, Hk, D, causal,
                                   window, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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
// visible (query, key) pair against 2*D bytes per row of q, k, v and o, so
// at a prefill's lengths the card's tensor cores, not its memory, are the
// limit (989 TFLOP/s bf16).  This first design runs float32 FMAs on the
// CUDA cores (67 TFLOP/s), a ceiling about 15 times the tensor-core bound;
// wgmma, TMA and the warp-specialised FA3 shape are left to a later
// design.  What this one does about its ceiling:
//   * one CTA of 8 warps per (q tile of 64 rows, query head, batch); a loop
//     inside the CTA walks the K/V tiles, in place of the TPU's sequential
//     fourth grid axis (flash_attention.py:102);
//   * tiles that the causal or window mask removes entirely are skipped,
//     not masked (the Pallas kernel visits all of them), so a causal
//     prefill does about half the products and a windowed one
//     window/Sk of them;
//   * q, k and v are converted to float32 once, into shared memory, as
//     each tile is staged; every later read is from shared memory;
//   * a warp owns 8 query rows; each lane owns BK/32 keys of the tile for
//     q.k (16-byte loads; the k rows are padded by 4 floats so 8 lanes of a
//     quarter-warp hit distinct banks, the q reads are broadcasts) and
//     D/32 columns of the output for p.v (the probabilities go through a
//     per-warp buffer, read back as two 16-byte broadcasts per key);
//   * the running max, the lane's part of the sum and the accumulator stay
//     in registers across the whole loop; the sum is reduced across the
//     warp once, at the end;
//   * the ragged last q and k tiles are masked in the kernel, not padded by
//     a copy (flash_attention.py:88-94 pads).
// Shared memory passes 48 KB for D >= 64, so it is dynamic and each
// instantiation raises its limit with cudaFuncSetAttribute; a launch the
// card refuses comes back as the cudaError the entry point returns.
//
// Exactness: float32 throughout, expf (not __expf), IEEE division, built
// without --use_fast_math.  The sums run in another order than the plain
// version's products (kernels/ref.py::attention_ref), so the two agree to
// a tolerance, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 64;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr float kNegInf = -1e30f;
static_assert(kRowsPerWarp == 8, "a key's probabilities are two float4s");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
      : dtype == 1
          ? dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hk, D, causal,
                                    window, stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

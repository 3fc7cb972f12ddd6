// Per-block symmetric int8 wire codec for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/comms.py:
//   int8_quantize        (comms.py:68, pallas_call at :76)   -> hsgd_int8_quantize
//   int8_dequantize      (comms.py:94, pallas_call at :100)  -> hsgd_int8_dequantize
//   int8_scale_quantize  (comms.py:120, pallas_call at :131) -> hsgd_int8_scale_quantize
//
// A payload is R rows of C float32 values cut into blocks of `block`
// contiguous columns (nb = ceil(C / block) blocks per row; the last one may
// be ragged).  Per block: scale = max|x| * f32(1/127),
// q = clip(rint(x * (1/scale)), -127, 127), q = 0 where scale = 0;
// dequantize is q * scale.
//
// Bound: memory.  Each element is read once and written once at 5 bytes
// (4 in + 1 out for the quantizers, 1 in + 4 out for the dequantizer), plus
// 4 bytes per block for the scale, against a handful of operations per
// element, far below the card's operations-per-byte balance.  The design
// does three things about it:
//   * one warp owns one (row, block) task, so every load and store of a
//     warp is one contiguous, coalesced span;
//   * when the row length and block are multiples of 4 and the pointers
//     are aligned, each lane moves 16 bytes of floats (float4) and 4 bytes
//     of int8 (char4) per access; otherwise a scalar path with the same
//     coalescing runs (a ragged row length misaligns every row after the
//     first);
//   * the ragged last block is masked in the kernel (`len` below), not
//     copied into a zero-padded buffer as the TPU wrapper does.
// The quantizer reads its block twice (amax, then quantize); the second
// read is served by L1/L2, so device memory still sees x once.
//
// Exactness (each kernel must equal its plain PyTorch version bit for bit):
//   * Rounding rule: rintf rounds half to even, as jnp.round and
//     torch.round do.  Never roundf or +0.5.
//   * Division rule: 1.0f / s is an IEEE division and x * inv a single
//     rounding; the scale is amax * f32(1/127), which is what XLA makes of
//     the reference's `amax / 127` under jit.  Build without
//     --use_fast_math and never call __fdividef: either would change q.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr float kInv127 = 1.0f / 127.0f;  // folded at compile time, IEEE

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float inv_of(float s) {
  return s > 0.f ? 1.0f / s : 0.f;
}

__device__ __forceinline__ int8_t quant1(float x, float inv) {
  float v = rintf(x * inv);
  v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(v));
}

// The (row, block) task of this warp; false when the warp has none.  The
// test depends on the warp index only, so a warp exits as a whole and the
// shuffles below always run with all 32 lanes.
struct Task {
  long long id, offset;  // task index (= scale index), first element
  int len;               // real elements in this block (ragged tail masked)
};

__device__ __forceinline__ bool task_of(long long rows, long long cols,
                                        int block, long long nb, Task* t) {
  t->id = static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (t->id >= rows * nb) return false;
  const long long r = t->id / nb, b = t->id - r * nb;
  const long long c0 = b * block;
  t->offset = r * cols + c0;
  const long long rest = cols - c0;
  t->len = static_cast<int>(rest < block ? rest : block);
  return true;
}

template <int VEC>
__device__ __forceinline__ void quantize_span(const float* __restrict__ xs,
                                              int8_t* __restrict__ qs,
                                              int len, float inv, int lane) {
  if constexpr (VEC == 4) {
    for (int i = lane * 4; i < len; i += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xs + i));
      char4 o;
      o.x = quant1(v.x, inv);
      o.y = quant1(v.y, inv);
      o.z = quant1(v.z, inv);
      o.w = quant1(v.w, inv);
      *reinterpret_cast<char4*>(qs + i) = o;
    }
  } else {
    for (int i = lane; i < len; i += 32) qs[i] = quant1(__ldg(xs + i), inv);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
int8_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, long long rows,
                     long long cols, int block, long long nb) {
  Task t;
  if (!task_of(rows, cols, block, nb, &t)) return;
  const int lane = threadIdx.x & 31;
  const float* xs = x + t.offset;
  float amax = 0.f;
  if constexpr (VEC == 4) {
    for (int i = lane * 4; i < t.len; i += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xs + i));
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = lane; i < t.len; i += 32) amax = fmaxf(amax, fabsf(__ldg(xs + i)));
  }
  amax = warp_max(amax);
  const float s = amax * kInv127;
  quantize_span<VEC>(xs, q + t.offset, t.len, inv_of(s), lane);
  if (lane == 0) scale[t.id] = s;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
int8_scale_quantize_kernel(const float* __restrict__ x,
                           const float* __restrict__ scale,
                           int8_t* __restrict__ q, long long rows,
                           long long cols, int block, long long nb) {
  Task t;
  if (!task_of(rows, cols, block, nb, &t)) return;
  const int lane = threadIdx.x & 31;
  quantize_span<VEC>(x + t.offset, q + t.offset, t.len,
                     inv_of(__ldg(scale + t.id)), lane);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
int8_dequantize_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       float* __restrict__ y, long long rows, long long cols,
                       int block, long long nb) {
  Task t;
  if (!task_of(rows, cols, block, nb, &t)) return;
  const int lane = threadIdx.x & 31;
  const float s = __ldg(scale + t.id);
  const int8_t* qs = q + t.offset;
  float* ys = y + t.offset;
  if constexpr (VEC == 4) {
    for (int i = lane * 4; i < t.len; i += 128) {
      const char4 v = *reinterpret_cast<const char4*>(qs + i);
      *reinterpret_cast<float4*>(ys + i) =
          make_float4(static_cast<float>(v.x) * s, static_cast<float>(v.y) * s,
                      static_cast<float>(v.z) * s, static_cast<float>(v.w) * s);
    }
  } else {
    for (int i = lane; i < t.len; i += 32) ys[i] = static_cast<float>(qs[i]) * s;
  }
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// Grid for rows * nb warp tasks; 0 blocks when there is nothing to do.
bool grid_for(long long rows, long long cols, int block, long long* nb,
              unsigned* blocks) {
  if (rows < 0 || cols < 0 || block <= 0) return false;
  *nb = (cols + block - 1) / block;
  const long long ctas = (rows * *nb + kWarpsPerCta - 1) / kWarpsPerCta;
  if (ctas > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(ctas);
  return true;
}

}  // namespace

extern "C" {

// Each entry point returns 0 or the cudaError_t of the launch.
int hsgd_int8_quantize(const void* x, void* q, void* scale, long long rows,
                       long long cols, int block, void* stream) {
  long long nb;
  unsigned blocks;
  if (!grid_for(rows, cols, block, &nb, &blocks)) return cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  if (cols % 4 == 0 && block % 4 == 0 && aligned(x, 16) && aligned(q, 4))
    int8_quantize_kernel<4><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, cols, block, nb);
  else
    int8_quantize_kernel<1><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, cols, block, nb);
  return static_cast<int>(cudaGetLastError());
}

int hsgd_int8_scale_quantize(const void* x, const void* scale, void* q,
                             long long rows, long long cols, int block,
                             void* stream) {
  long long nb;
  unsigned blocks;
  if (!grid_for(rows, cols, block, &nb, &blocks)) return cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  int8_t* qp = static_cast<int8_t*>(q);
  if (cols % 4 == 0 && block % 4 == 0 && aligned(x, 16) && aligned(q, 4))
    int8_scale_quantize_kernel<4><<<blocks, kThreads, 0, s>>>(xp, sp, qp, rows, cols, block, nb);
  else
    int8_scale_quantize_kernel<1><<<blocks, kThreads, 0, s>>>(xp, sp, qp, rows, cols, block, nb);
  return static_cast<int>(cudaGetLastError());
}

int hsgd_int8_dequantize(const void* q, const void* scale, void* y,
                         long long rows, long long cols, int block,
                         void* stream) {
  long long nb;
  unsigned blocks;
  if (!grid_for(rows, cols, block, &nb, &blocks)) return cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* yp = static_cast<float*>(y);
  if (cols % 4 == 0 && block % 4 == 0 && aligned(q, 4) && aligned(y, 16))
    int8_dequantize_kernel<4><<<blocks, kThreads, 0, s>>>(qp, sp, yp, rows, cols, block, nb);
  else
    int8_dequantize_kernel<1><<<blocks, kThreads, 0, s>>>(qp, sp, yp, rows, cols, block, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

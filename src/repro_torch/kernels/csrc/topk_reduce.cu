// Top-k fused decode-reduce for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/comms.py:
//   topk_decode_reduce (comms.py:156, pallas_call at :169)
//     -> hsgd_topk_decode_reduce
//
// M gathered top-k payloads, values vals (M, K) f32 and indices idx (M, K)
// int32, are scatter-summed into one dense out (size,) f32:
//   out = 0;  for m in 0..M-1: for j in 0..K-1: out[idx[m, j]] += vals[m, j]
// Indices outside [0, size) are dropped, as the Pallas kernel (which never
// matches them to an output column) drops them.
//
// Bound: memory.  The work is M*K adds; the function reads 8 bytes per
// entry and writes 4 bytes per output element.  A scatter has no tile for
// wgmma or TMA to feed.  The Pallas design, where each of the ceil(size/256)
// grid steps scans all M*K entries for those that land in its block, costs
// O(size * M * K / 256) reads and is not carried over.  The design:
//   * the output is zeroed by cudaMemsetAsync;
//   * then one pass per member m, launched in member order on the caller's
//     stream, so pass m starts only after pass m-1 has finished: a
//     grid-stride loop, one thread per entry, adds vals[m, j] into
//     out[idx[m, j]].
//
// Exactness (the kernel must equal its plain PyTorch version bit for bit,
// src/repro_torch/kernels/ref.py::topk_reduce_ref):
//   * Order rule: per output element the adds are taken member after
//     member, starting from +0.0, as the plain version's one index_add_
//     per member takes them.  The passes give that order.
//   * Within a pass the top-k codec's indices are distinct, so each element
//     receives at most one add a pass, whatever the threads' order.  Indices
//     repeated within one member are legal input (the Pallas kernel sums
//     them): they are added atomically, in an order that changes from run
//     to run, so that case agrees with the plain version to float32
//     rounding (1e-6), not bit for bit.
//   * Add rule: the atomic add is a compare-and-swap loop around an IEEE
//     float add.  The hardware float atomicAdd (red.global.add.f32) flushes
//     subnormal inputs and results to zero, which the plain version on the
//     CPU does not.  Build without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCtas = 132 * 16;  // 16 CTAs on each of 132 SMs

// out[i] += v with an IEEE round-to-nearest add, atomically.  With no
// competing add the first compare-and-swap succeeds.
__device__ __forceinline__ void add_ieee(float* out, float v) {
  unsigned* word = reinterpret_cast<unsigned*>(out);
  unsigned seen = __float_as_uint(__ldcg(out));  // bypasses L1
  while (true) {
    const unsigned want = __float_as_uint(__uint_as_float(seen) + v);
    const unsigned had = atomicCAS(word, seen, want);
    if (had == seen) return;
    seen = had;
  }
}

// One member's pass: K entries, one thread each (grid-stride).
__global__ void __launch_bounds__(kThreads)
topk_scatter_pass(const float* __restrict__ vals, const int* __restrict__ idx,
                  float* __restrict__ out, long long k, long long size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < k; j += stride) {
    const int i = __ldg(idx + j);
    if (i >= 0 && i < size) add_ieee(out + i, __ldg(vals + j));
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the first call that failed.
// vals: (m, k) f32; idx: (m, k) int32; out: (size,) f32.
int hsgd_topk_decode_reduce(const void* vals, const void* idx, void* out,
                            long long m, long long k, long long size,
                            void* stream) {
  if (m < 0 || k < 0 || size < 0) return cudaErrorInvalidValue;
  if (size == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, size * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 0) return 0;
  long long ctas = (k + kThreads - 1) / kThreads;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  const float* vp = static_cast<const float*>(vals);
  const int* ip = static_cast<const int*>(idx);
  float* op = static_cast<float*>(out);
  for (long long r = 0; r < m; ++r) {
    topk_scatter_pass<<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
        vp + r * k, ip + r * k, op, k, size);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"

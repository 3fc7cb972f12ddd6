// RG-LRU linear recurrence (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rglru_scan.py:
//   rglru_scan (rglru_scan.py:47, pallas_call at :57) -> hsgd_rglru_scan
//
// a, b and h are (Bt, S, W) float32, contiguous.  For each (batch, channel)
// from h = 0:  h_t = a_t h_{t-1} + b_t,  stored for every t.
//
// This is the exact recurrence, the one the plain version
// (kernels/ref.py::rglru_ref) and the reference's oracle compute.  The
// Pallas kernel evaluates it in log-space prefix form inside blocks of 128
// steps, h_t = A_t (h_0 + sum_j b_j / A_j) with A_t the prefix product of
// a, and clamps the prefix at 1e-30 (rglru_scan.py:19, :38, :52).  This
// kernel does not reproduce that clamp: where a's prefix product over a
// block falls below 1e-30 the Pallas form departs from the recurrence, and
// this kernel does not.  That is a difference of the reference's kernel
// from its own oracle.  On the model's gates (a in (0.9, 1)) the prefix
// over 128 steps stays above 0.9^128 ~ 1.4e-6, far from the clamp, and the
// two agree within the reference's limit (atol 5e-5, rtol 1e-4).
//
// Bound: bytes.  Two float32 reads and one write per element, two
// operations; at recurrentgemma-2b's forward (8, 1024, 2560) that is 252 MB.
// This first design gives one thread to each (batch, channel) and walks S
// in order with h = fmaf(a, h, b): neighbouring threads own neighbouring
// channels, so every load and store is coalesced.  The walk is sequential,
// so the card holds only Bt W threads (20,480 at that shape, about 5 warps
// per SM), and memory latency, not bandwidth, sets the pace; each thread
// therefore issues the loads of kUnroll steps before it runs their chain,
// to keep that many loads in flight.  A split of S across CTAs with a
// second pass for the carries is left to a later design.
//
// Exactness: one fmaf per step, no fast math; the plain version rounds the
// product and the sum separately, so the two agree to a tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int W) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * W + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = static_cast<long long>(t + u) * W;
      av[u] = __ldg(ap + off);
      bv[u] = __ldg(bp + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = fmaf(av[u], hv, bv[u]);
      hp[static_cast<long long>(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const long long off = static_cast<long long>(t) * W;
    hv = fmaf(__ldg(ap + off), hv, __ldg(bp + off));
    hp[off] = hv;
  }
}

}  // namespace

// Returns the cudaError of the launch (0 on success); the wrapper checks
// shapes, types and grid limits before it calls.
extern "C" int hsgd_rglru_scan(const void* a, const void* b, void* h, int Bt,
                               int S, int W, cudaStream_t stream) {
  if (Bt <= 0 || S <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, Bt);
  rglru_scan_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

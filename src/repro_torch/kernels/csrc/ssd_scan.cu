// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan (ssd_scan.py:58, pallas_call at :74) -> hsgd_ssd_scan
//
// x is (Bt, S, H, P), B and C are (Bt, S, N), all float32 or all bfloat16;
// dt is (Bt, S, H) float32 (softplus'ed, >= 0) and A is (H,) float32
// (negative); y is (Bt, S, H, P) contiguous, in x's type.  x, B and C may
// be strided views: the kernel takes their batch and sequence strides (in
// elements) and needs only the inner dims packed ((H, P) of x, N of B and
// C), so the column slices of one projection are read in place.  In float32
// throughout, for each (batch b, head h) and each chunk of Q positions
// (ssd_scan.py:32-54, in its order):
//   cum_i   = sum_{k <= i} dt_k A           (the in-chunk cumulative sum)
//   G       = C B^T                          (Q x Q)
//   M_ij    = G_ij exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i     = sum_j M_ij x_j + exp(cum_i) C_i . state   (state entering)
//   state   = state exp(cum_{Q-1}) + sum_j dt_j exp(cum_{Q-1} - cum_j) B_j x_j^T
// from a zero state.  A ragged last chunk is masked in the kernel: rows
// past S read as zeros (dt = 0 leaves cum and the state as they are), which
// is the reference's zero padding (ssd_scan.py:65-70), and are not stored.
//
// Bound: at Mamba-2's shapes (Q = P = 64, N = 128) the work is about 2 Q N
// + 2 Q P + 4 P N operations per position and head against about 2 P bytes
// (bf16) of x and y, so in bf16 the memory is the limit (the tensor cores
// would take less time than the bytes); in float32, which has no tensor
// cores here, the operations are.  This first design runs float32 FMAs on
// the CUDA cores.  What it does about that:
//   * one CTA of 256 threads per (head, batch) walks the chunks in order;
//     the loop inside the CTA takes the place of the TPU's sequential chunk
//     grid axis, and the (P, N) state stays in shared memory throughout
//     (the TPU keeps it in VMEM scratch);
//   * each chunk's x, B, C and dt are converted to float32 once, into shared
//     memory; rows of B, C and the state are padded by one float so that
//     lanes reading a column hit distinct banks;
//   * each of the four products runs on register tiles: a thread owns 4 x 4
//     outputs of G and of y (rows and columns strided by 16) and 8 x NT of
//     the state update (strided by 8 and 32), so every shared-memory load
//     feeds 2 to 4 FMAs; the state update's accumulators stay in registers
//     until the old state has been read by y;
//   * the in-chunk cumulative sum is a warp scan with shuffles.
// G is recomputed per head (the TPU kernel does the same); sharing it
// across heads, and wgmma in bf16, are left to a later design.  Shared
// memory is 4 (P (N+1) + Q P + 2 Q (N+1) + Q (Q+1) + 3 Q) bytes, 132,864 at
// Mamba-2's shapes, so it is dynamic, and the launch raises the limit; a
// launch the card refuses comes back as the cudaError the entry point
// returns.  The wrapper (kernels/ssd_scan.py) keeps Q <= 64, P <= 64,
// N <= 256 and the bytes under the card's 232,448.
//
// Exactness: float32 throughout, expf (not __expf), built without
// --use_fast_math.  The chunked form sums in another order than the plain
// version's step-by-step recurrence (kernels/ref.py::ssd_ref), so the two
// agree to a tolerance, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 64;        // chunk: 16 rows x 4 per thread
constexpr int kMaxP = 64;        // head dim: 16 (y) and 8 x 8 (state) per thread
constexpr int kMaxN = 256;       // state: 32 x NT per thread, NT <= 8

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);     // round to nearest even, as torch's cast
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int S, int H,
                int P, int N, int Q, long long xsb, long long xss,
                long long bsb, long long bss, long long csb, long long css) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int NS = N + 1;
  const int QS = Q + 1;
  extern __shared__ float smem[];
  float* state = smem;              // P x NS
  float* xs = state + P * NS;       // Q x P
  float* bs = xs + Q * P;           // Q x NS
  float* cs = bs + Q * NS;          // Q x NS
  float* ms = cs + Q * NS;          // Q x QS: G, then M
  float* cum = ms + Q * QS;         // Q
  float* w = cum + Q;               // Q: dt_j exp(cum_last - cum_j)
  float* dts = w + Q;               // Q

  for (int i = tid; i < P * NS; i += kThreads) state[i] = 0.f;
  const float a = A[h];
  // (row, col) tiles of G and y: 16 x 16 threads, 4 x 4 outputs each
  const int ti = tid >> 4;
  const int tj = tid & 15;
  // (p, n) tiles of the state: 8 x 32 threads, 8 x NT outputs each
  const int sp = tid >> 5;
  const int sn = tid & 31;
  const long long xh = static_cast<long long>(h) * P;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int len = min(Q, S - s0);
    // stage the chunk in float32; rows past S are zeros
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int j = idx / P;
      const int p = idx - j * P;
      xs[idx] = j < len ? ld(x + b * xsb + (s0 + j) * xss + xh + p) : 0.f;
    }
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int j = idx / N;
      const int n = idx - j * N;
      const bool in = j < len;
      bs[j * NS + n] = in ? ld(Bm + b * bsb + (s0 + j) * bss + n) : 0.f;
      cs[j * NS + n] = in ? ld(Cm + b * csb + (s0 + j) * css + n) : 0.f;
    }
    if (tid < Q)
      dts[tid] = tid < len
                     ? dt[(static_cast<long long>(b) * S + s0 + tid) * H + h]
                     : 0.f;
    __syncthreads();

    // cum: inclusive scan of dt A over the chunk, two entries per lane
    if (tid < 32) {
      float v0 = tid < Q ? dts[tid] * a : 0.f;
      float v1 = tid + 32 < Q ? dts[tid + 32] * a : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float t1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (tid >= o) {
          v0 += t0;
          v1 += t1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      if (tid < Q) cum[tid] = v0;
      if (tid + 32 < Q) cum[tid + 32] = v1;
    }
    __syncthreads();
    const float clast = cum[Q - 1];
    if (tid < Q) w[tid] = dts[tid] * expf(clast - cum[tid]);

    // M = (C B^T) * exp(cum_i - cum_j) * dt_j on the causal triangle
    {
      float g[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ti + 16 * r;
          const int j = tj + 16 * r;
          cv[r] = i < Q ? cs[i * NS + n] : 0.f;
          bv[r] = j < Q ? bs[j * NS + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          if (i < Q && j < Q)
            ms[i * QS + j] =
                j <= i ? g[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(cum_i) (C state^T), with the state entering the chunk
    {
      float yi[4][4] = {};
      float ye[4][4] = {};
      for (int j = 0; j < Q; ++j) {
        float mv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ti + 16 * r;
          const int p = tj + 16 * r;
          mv[r] = i < Q ? ms[i * QS + j] : 0.f;
          xv[r] = p < P ? xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[r][c] = fmaf(mv[r], xv[c], yi[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ti + 16 * r;
          const int p = tj + 16 * r;
          cv[r] = i < Q ? cs[i * NS + n] : 0.f;
          sv[r] = p < P ? state[p * NS + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) ye[r][c] = fmaf(cv[r], sv[c], ye[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= len) continue;
        const float e = expf(cum[i]);
        T* yrow = y + ((static_cast<long long>(b) * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          if (p < P) st(yrow + p, yi[r][c] + e * ye[r][c]);
        }
      }
    }

    // state = state exp(cum_last) + sum_j w_j x_j B_j^T
    {
      float u[8][NT] = {};
      for (int j = 0; j < Q; ++j) {
        const float wj = w[j];
        float xv[8], bv[NT];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int p = sp + 8 * r;
          xv[r] = p < P ? wj * xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          const int n = sn + 32 * c;
          bv[c] = n < N ? bs[j * NS + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < NT; ++c) u[r][c] = fmaf(xv[r], bv[c], u[r][c]);
      }
      __syncthreads();   // y has read the old state
      const float dec = expf(clast);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int p = sp + 8 * r;
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          const int n = sn + 32 * c;
          if (p < P && n < N)
            state[p * NS + n] = state[p * NS + n] * dec + u[r][c];
        }
      }
    }
    __syncthreads();     // the state is written, the chunk buffers are free
  }
}

size_t smem_bytes(int P, int N, int Q) {
  return sizeof(float) *
         (static_cast<size_t>(P) * (N + 1) + static_cast<size_t>(Q) * P +
          2 * static_cast<size_t>(Q) * (N + 1) +
          static_cast<size_t>(Q) * (Q + 1) + 3 * static_cast<size_t>(Q));
}

template <typename T, int NT>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, int Bt, int S,
                   int H, int P, int N, int Q, long long xsb, long long xss,
                   long long bsb, long long bss, long long csb,
                   long long css, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, NT>;
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, Bt);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), S, H, P, N, Q, xsb, xss,
      bsb, bss, csb, css);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y, int Bt, int S,
                     int H, int P, int N, int Q, long long xsb, long long xss,
                     long long bsb, long long bss, long long csb,
                     long long css, cudaStream_t stream) {
  // the state update's columns per thread: N over 32 lanes, rounded up
  if (N <= 32)
    return launch<T, 1>(x, dt, A, B, C, y, Bt, S, H, P, N, Q, xsb, xss, bsb,
                        bss, csb, css, stream);
  if (N <= 64)
    return launch<T, 2>(x, dt, A, B, C, y, Bt, S, H, P, N, Q, xsb, xss, bsb,
                        bss, csb, css, stream);
  if (N <= 128)
    return launch<T, 4>(x, dt, A, B, C, y, Bt, S, H, P, N, Q, xsb, xss, bsb,
                        bss, csb, css, stream);
  return launch<T, 8>(x, dt, A, B, C, y, Bt, S, H, P, N, Q, xsb, xss, bsb,
                      bss, csb, css, stream);
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16.  Strides are in
// elements.  Returns the cudaError of the launch (0 on success); the
// wrapper checks shapes, types and limits before it calls.
extern "C" int hsgd_ssd_scan(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y, int dtype,
                             int Bt, int S, int H, int P, int N, int Q,
                             long long xsb, long long xss, long long bsb,
                             long long bss, long long csb, long long css,
                             cudaStream_t stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxQ || P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(x, dt, A, B, C, y, Bt, S, H, P, N, Q, xsb,
                                   xss, bsb, bss, csb, css, stream)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(x, dt, A, B, C, y, Bt, S, H, P, N, Q,
                                    xsb, xss, bsb, bss, csb, css, stream)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan (ssd_scan.py:58, pallas_call at :74) -> hsgd_ssd_scan
//
// x is (Bt, S, H, P), B and C are (Bt, S, N), all float32 or all bfloat16;
// dt is (Bt, S, H) float32 (softplus'ed, >= 0) and A is (H,) float32
// (negative); y is (Bt, S, H, P) contiguous, in x's type.  x, B and C may
// be strided views: the kernels take their batch and sequence strides (in
// elements) and need only the inner dims packed ((H, P) of x, N of B and
// C), so the column slices of one projection are read in place.  In float32
// throughout, for each (batch b, head h) and each chunk of Q positions
// (ssd_scan.py:32-54):
//   cum_i   = sum_{k <= i} dt_k A           (the in-chunk cumulative sum)
//   G       = C B^T                          (Q x Q)
//   M_ij    = G_ij exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i     = sum_j M_ij x_j + exp(cum_i) C_i . state   (state entering)
//   state   = state exp(cum_{Q-1}) + sum_j dt_j exp(cum_{Q-1} - cum_j) B_j x_j^T
// from a zero state.  A ragged last chunk is masked in the kernels: rows
// past S read as zeros (dt = 0 leaves cum and the state as they are), which
// is the reference's zero padding (ssd_scan.py:65-70), and are not stored.
//
// The chunk-parallel form.  The TPU walks the chunks in order with the
// state in VMEM.  Here only the state recurrence is sequential, and it is
// elementwise, so one call is four stream-ordered launches over nc =
// ceil(S / Q) chunks:
//   1. prep, grid (nc, Bt): G = C B^T once per (batch, chunk) for all heads
//      (B and C have no head axis), and cum for every head;
//   2. chunk_state, grid (H, nc, Bt): each chunk's own state
//      s_c = sum_j w_j x_j B_j^T, w_j = dt_j exp(cum_last - cum_j);
//   3. state_pass, grid (tiles of P N, H, Bt): entering_c = running;
//      running = running exp(cum_last_c) + s_c, written over s_c;
//   4. chunk_scan, grid (H, nc, Bt): y = M x + exp(cum_i) C . entering.
// The wrapper (kernels/ssd_scan.py::ssd_plan) allocates the scratch:
// states (Bt, nc, H, P, N), G (Bt, nc, Q, Q) and cum (Bt, nc, H, Q), all
// float32.  The kernels allocate nothing.
//
// Bound: at Mamba-2's shapes (Q = P = 64, N = 128) the function does about
// 2 Q N + 2 Q P + 4 P N operations per position and head against about
// 2 P bytes (bf16) of x and y, so in bf16 the memory is the limit and in
// float32, which has no tensor cores here, the operations are.  This
// design adds its own traffic, the states written, read and written, and
// read (about 403 MB at 8 x 1024 x 24 heads), which bounds it at about
// 0.14 ms.  What it does about that:
//   * 3,072 CTAs for the products at 8 x 1024 x 24 heads (the grid is H x
//     nc x Bt), each small enough that two or more share an SM;
//   * each CTA stages its operands with all of a thread's loads issued
//     before its first store to shared memory (gather(), scatter()), and
//     the bf16 passes issue a tile's loads before the products of the tile
//     before it;
//   * state_pass moves float4s and keeps 8 chunks' loads in flight per
//     thread;
//   * the in-chunk cumulative sum is a warp scan with shuffles.
// float32 inputs run the products as FMAs on the CUDA cores (the SIMT
// passes): x, B, C and M staged in float32 in shared memory, rows of B, C
// and the state padded by one float so that lanes reading a column hit
// distinct banks, C and the state staged 64 columns at a time, and register
// tiles so that every shared-memory load feeds 2 to 4 FMAs (a thread owns
// 4 x 4 outputs of G and y, rows and columns strided by 16, and 8 x NT of
// the chunk state, strided by 8 and 32).  bfloat16 inputs run G, the chunk
// state and both products of chunk_scan on the tensor cores with
// mma.sync.m16n8k16 (f32 accumulators, fragments from ldmatrix): C, B and
// x enter exactly; each float32 operand (w B, M and the entering state) is
// split by truncation into three bf16 terms, hi + mid + lo, which sum to
// it exactly for |v| >= 2^-110 (within 2^-133 below), so a product costs
// three mma.sync and keeps float32's operand.  Operands are padded with
// zeros to multiples of 16, rows of (width + 8) bf16 so that ldmatrix's
// eight rows fall on distinct banks.
//
// Exactness: float32 throughout, expf (not __expf), built without
// --use_fast_math.  The SIMT passes compute each element in the order of
// the earlier single-CTA kernel, one CTA per (head, batch) walking the
// chunks (the same sums over n and j, the same expressions, so the same
// contractions): their float32 output is that kernel's bit for bit.  The tensor cores sum in their own order.  The
// chunked form sums in another order than the plain version's step-by-step
// recurrence (kernels/ref.py::ssd_ref), so the two agree to a tolerance,
// not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 64;        // chunk: 16 rows x 4 per thread
constexpr int kMaxP = 64;        // head dim: 16 (y) and 8 x 8 (state) per thread
constexpr int kMaxN = 256;       // state: 32 x NT per thread, NT <= 8
constexpr int kNTile = 64;       // columns of N staged at a time
constexpr int kTS = kNTile + 1;  // their padded row
constexpr int kPassDepth = 8;    // chunks in flight per thread in state_pass

constexpr int kWarps = kThreads / 32;
constexpr int kTB = kNTile + 8;  // bf16 row of a staged 64-column tile: 144
                                 // bytes, so ldmatrix's 8 rows hit 8 banks

typedef __nv_bfloat16 bf16;

// cum of chunk c of batch b for every head: the inclusive scan of dt A over
// the chunk, one warp per head, two entries per lane; rows past S are dt = 0
__device__ __forceinline__ void chunk_cum(const float* __restrict__ dt,
                                          const float* __restrict__ A,
                                          float* __restrict__ cum, int b,
                                          int c, int nc, int S, int H,
                                          int Q) {
  const int s0 = c * Q;
  const int len = min(Q, S - s0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* cumc = cum + (static_cast<long long>(b) * nc + c) * H * Q;
  const float* dtc = dt + (static_cast<long long>(b) * S + s0) * H;
  for (int h = warp; h < H; h += kWarps) {
    const float a = A[h];
    const float d0 = lane < len ? dtc[static_cast<long long>(lane) * H + h]
                                : 0.f;
    const float d1 =
        lane + 32 < len ? dtc[static_cast<long long>(lane + 32) * H + h] : 0.f;
    float v0 = lane < Q ? d0 * a : 0.f;
    float v1 = lane + 32 < Q ? d1 * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t0 = __shfl_up_sync(0xffffffffu, v0, o);
      const float t1 = __shfl_up_sync(0xffffffffu, v1, o);
      if (lane >= o) {
        v0 += t0;
        v1 += t1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    if (lane < Q) cumc[h * Q + lane] = v0;
    if (lane + 32 < Q) cumc[h * Q + lane + 32] = v1;
  }
}

// Staging of a tile of up to 64 rows and 32 K columns: warp w takes rows
// w, w + 8, ..., lane l columns l, l + 32, ...  gather() issues every
// load(row, col) into registers and scatter() stores them, so a thread has
// its 8 K loads in flight at once (the staging is otherwise latency bound),
// and a caller can issue a later tile's loads before it computes on this
// one.  Rows and columns past the tile are the callers' to mask.
constexpr int kRows = kMaxQ / kWarps;

template <int K, typename V, typename Load>
__device__ __forceinline__ void gather(V (&v)[kRows][K], Load load) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k) v[r][k] = load(warp + kWarps * r, lane + 32 * k);
}

template <int K, typename V, typename Store>
__device__ __forceinline__ void scatter(const V (&v)[kRows][K], Store store) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k) store(warp + kWarps * r, lane + 32 * k, v[r][k]);
}

template <int K, typename V, typename Load, typename Store>
__device__ __forceinline__ void stage(Load load, Store store) {
  V v[kRows][K];
  gather(v, load);
  scatter(v, store);
}

// ---- bfloat16 helpers: mma.sync, ldmatrix, the exact three-term split ----

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
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

// a and b split into bf16 hi, mid and lo, each pair packed: hi + mid + lo
// is the value exactly where |value| >= 2^-110 (below, within 2^-133)
__device__ __forceinline__ void split3(float a, float b, uint32_t* hi,
                                       uint32_t* mid, uint32_t* lo) {
  const float2 ha = split_top(a);
  const float2 hb = split_top(b);
  const float2 ma = split_top(ha.y);
  const float2 mb = split_top(hb.y);
  *hi = bf16x2_pack(ha.x, hb.x);
  *mid = bf16x2_pack(ma.x, mb.x);
  *lo = bf16x2_pack(ma.y, mb.y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices, lane l giving the address of row l % 8 of
// matrix l / 8; .trans hands each lane its column pair instead of its row
// pair
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d (16 x 8 f32) += A (16 x 16 bf16, row) . B (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses for lane l, in a bf16 array of row stride ld.  An A
// fragment (16 x 16 at (m0, k0)) of a row-major S[m][k], or two B
// fragments (16 x 8 each, n0 and n0 + 8) of a K-major S[k][n] with .trans:
__device__ __forceinline__ const bf16* frag_rows(const bf16* S, int ld,
                                                 int r0, int c0, int l) {
  return S + (r0 + (l & 15)) * ld + c0 + ((l >> 4) << 3);
}
// An A fragment of S[k][m] = A^T with .trans (r0 = k0, c0 = m0), or two B
// fragments of an N-major S[n][k] (r0 = n0, c0 = k0):
__device__ __forceinline__ const bf16* frag_cols(const bf16* S, int ld,
                                                 int r0, int c0, int l) {
  return S + (r0 + ((l >> 4) << 3) + (l & 7)) * ld + c0 + (((l >> 3) & 1) << 3);
}
// ---- float32: SIMT passes -----------------------------------------------

// 1. prep: G = C B^T per (batch, chunk), cum per head
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ dt, const float* __restrict__ A,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            float* __restrict__ G, float* __restrict__ cum, int S, int H,
            int N, int Q, long long bsb, long long bss, long long csb,
            long long css) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int s0 = c * Q;
  const int len = min(Q, S - s0);
  __shared__ float bs[kMaxQ * kTS];
  __shared__ float cs[kMaxQ * kTS];

  chunk_cum(dt, A, cum, b, c, nc, S, H, Q);

  // G on register tiles: 16 x 16 threads, 4 x 4 outputs each, summed over
  // n in order, C and B staged 64 columns at a time
  const int ti = tid >> 4;
  const int tj = tid & 15;
  float g[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kNTile) {
    const int nt = min(kNTile, N - n0);
    stage<2, float2>(
        [&](int j, int n) {
          const bool in = j < len && n < nt;
          return make_float2(
              in ? Bm[b * bsb + (s0 + j) * bss + n0 + n] : 0.f,
              in ? Cm[b * csb + (s0 + j) * css + n0 + n] : 0.f);
        },
        [&](int j, int n, float2 v) {
          if (j < Q) {
            bs[j * kTS + n] = v.x;
            cs[j * kTS + n] = v.y;
          }
        });
    __syncthreads();
    for (int n = 0; n < nt; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        const int j = tj + 16 * r;
        cv[r] = i < Q ? cs[i * kTS + n] : 0.f;
        bv[r] = j < Q ? bs[j * kTS + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) g[r][cc] = fmaf(cv[r], bv[cc], g[r][cc]);
    }
    __syncthreads();
  }
  float* Gc = G + (static_cast<long long>(b) * nc + c) * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti + 16 * r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = tj + 16 * cc;
      if (i < Q && j < Q) Gc[i * Q + j] = j <= i ? g[r][cc] : 0.f;
    }
  }
}

// 2. chunk_state: s_c = sum_j w_j x_j B_j^T per (head, chunk, batch)
template <int NT>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ Bm,
                   const float* __restrict__ cum,
                   float* __restrict__ states, int S, int H, int P, int N,
                   int Q, long long xsb, long long xss, long long bsb,
                   long long bss) {
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int s0 = c * Q;
  const int len = min(Q, S - s0);
  extern __shared__ float smem[];
  float* xs = smem;              // Q x P
  float* bs = xs + Q * P;        // Q x N
  float* w = bs + Q * N;         // Q: dt_j exp(cum_last - cum_j)
  const long long xh = static_cast<long long>(h) * P;
  stage<2, float>(
      [&](int j, int p) {
        return j < len && p < P ? x[b * xsb + (s0 + j) * xss + xh + p] : 0.f;
      },
      [&](int j, int p, float v) {
        if (j < Q && p < P) xs[j * P + p] = v;
      });
  for (int n0 = 0; n0 < N; n0 += kNTile)
    stage<2, float>(
        [&](int j, int n) {
          return j < len && n0 + n < N ? Bm[b * bsb + (s0 + j) * bss + n0 + n]
                                       : 0.f;
        },
        [&](int j, int n, float v) {
          if (j < Q && n0 + n < N) bs[j * N + n0 + n] = v;
        });
  const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
  const float* cumc = cum + bch * Q;
  if (tid < Q) {
    const float d =
        tid < len ? dt[(static_cast<long long>(b) * S + s0 + tid) * H + h]
                  : 0.f;
    w[tid] = d * expf(cumc[Q - 1] - cumc[tid]);
  }
  __syncthreads();

  // (p, n) tiles: 8 x 32 threads, 8 x NT outputs each
  const int sp = tid >> 5;
  const int sn = tid & 31;
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
    for (int cc = 0; cc < NT; ++cc) {
      const int n = sn + 32 * cc;
      bv[cc] = n < N ? bs[j * N + n] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < NT; ++cc) u[r][cc] = fmaf(xv[r], bv[cc], u[r][cc]);
  }
  float* sc = states + bch * P * N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = sp + 8 * r;
#pragma unroll
    for (int cc = 0; cc < NT; ++cc) {
      const int n = sn + 32 * cc;
      if (p < P && n < N) sc[p * N + n] = u[r][cc];
    }
  }
}

// ---- both types: state_pass, the recurrence over chunks, elementwise ------
// states holds s_c on entry and the state entering chunk c on exit.  A
// thread walks one float, or four adjacent ones as a float4 where P N is a
// multiple of 4, through the chunks.

// returns run, then sets run = run * d + s (the same contraction per lane)
__device__ __forceinline__ float pass(float& run, float d, float s) {
  const float entering = run;
  run = run * d + s;
  return entering;
}

__device__ __forceinline__ float4 pass(float4& run, float d, float4 s) {
  return make_float4(pass(run.x, d, s.x), pass(run.y, d, s.y),
                     pass(run.z, d, s.z), pass(run.w, d, s.w));
}

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                  int H, int PN, int Q, int nc) {
  constexpr int V = sizeof(Vec) / sizeof(float);
  const int e = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= PN) return;
  const long long step = static_cast<long long>(H) * PN / V;
  Vec* s = reinterpret_cast<Vec*>(
      states + (static_cast<long long>(b) * nc * H + h) * PN + e);
  const float* last = cum + (static_cast<long long>(b) * nc * H + h) * Q + Q - 1;
  const long long cstep = static_cast<long long>(H) * Q;
  Vec running{};
  for (int c0 = 0; c0 < nc; c0 += kPassDepth) {
    Vec sc[kPassDepth];
    float dec[kPassDepth];
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      const bool in = c0 + k < nc;
      sc[k] = in ? s[(c0 + k) * step] : Vec{};
      dec[k] = in ? expf(last[(c0 + k) * cstep]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k)
      if (c0 + k < nc) s[(c0 + k) * step] = pass(running, dec[k], sc[k]);
  }
}

// 4. chunk_scan: y = M x + exp(cum_i) C . entering (three CTAs an SM)
__global__ void __launch_bounds__(kThreads, 3)
chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Cm, const float* __restrict__ G,
                  const float* __restrict__ cum,
                  const float* __restrict__ states, float* __restrict__ y,
                  int S,
                  int H, int P, int N, int Q, long long xsb, long long xss,
                  long long csb, long long css) {
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int s0 = c * Q;
  const int len = min(Q, S - s0);
  const int QS = Q + 1;
  extern __shared__ float smem[];
  float* xs = smem;                 // Q x P
  float* cs = xs + Q * P;           // Q x kTS: a tile of C
  float* ss = cs + Q * kTS;         // P x kTS: a tile of the entering state
  float* ms = ss + P * kTS;         // Q x QS: M
  float* cums = ms + Q * QS;        // Q
  float* dts = cums + Q;            // Q
  const long long xh = static_cast<long long>(h) * P;
  stage<2, float>(
      [&](int j, int p) {
        return j < len && p < P ? x[b * xsb + (s0 + j) * xss + xh + p] : 0.f;
      },
      [&](int j, int p, float v) {
        if (j < Q && p < P) xs[j * P + p] = v;
      });
  const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
  if (tid < Q) {
    cums[tid] = cum[bch * Q + tid];
    dts[tid] = tid < len
                   ? dt[(static_cast<long long>(b) * S + s0 + tid) * H + h]
                   : 0.f;
  }
  __syncthreads();
  // M = G * exp(cum_i - cum_j) * dt_j on the causal triangle
  const float* Gc = G + (static_cast<long long>(b) * nc + c) * Q * Q;
  stage<2, float>(
      [&](int i, int j) { return i < Q && j <= i ? Gc[i * Q + j] : 0.f; },
      [&](int i, int j, float g) {
        if (i < Q && j < Q)
          ms[i * QS + j] = j <= i ? g * expf(cums[i] - cums[j]) * dts[j] : 0.f;
      });
  __syncthreads();

  // (row, col) tiles of y: 16 x 16 threads, 4 x 4 outputs each
  const int ti = tid >> 4;
  const int tj = tid & 15;
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
      for (int cc = 0; cc < 4; ++cc) yi[r][cc] = fmaf(mv[r], xv[cc], yi[r][cc]);
  }
  const float* sc = states + bch * P * N;
  for (int n0 = 0; n0 < N; n0 += kNTile) {
    const int nt = min(kNTile, N - n0);
    // rows of C (i < Q) and of the entering state (p < P) together
    stage<2, float2>(
        [&](int r, int n) {
          return make_float2(
              r < len && n < nt ? Cm[b * csb + (s0 + r) * css + n0 + n] : 0.f,
              r < P && n < nt ? sc[r * N + n0 + n] : 0.f);
        },
        [&](int r, int n, float2 v) {
          if (r < Q) cs[r * kTS + n] = v.x;
          if (r < P) ss[r * kTS + n] = v.y;
        });
    __syncthreads();
    for (int n = 0; n < nt; ++n) {
      float cv[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        const int p = tj + 16 * r;
        cv[r] = i < Q ? cs[i * kTS + n] : 0.f;
        sv[r] = p < P ? ss[p * kTS + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) ye[r][cc] = fmaf(cv[r], sv[cc], ye[r][cc]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti + 16 * r;
    if (i >= len) continue;
    const float e = expf(cums[i]);
    float* yrow = y + ((static_cast<long long>(b) * S + s0 + i) * H + h) * P;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = tj + 16 * cc;
      if (p < P) yrow[p] = yi[r][cc] + e * ye[r][cc];
    }
  }
}


// ---- bfloat16: the products on mma.sync ----------------------------------
// Operands are staged in shared memory as bf16, padded with zeros to
// multiples of 16 (rows and columns) and with rows of (width + 8) elements.
// Each warp owns one 16 x 32 output tile (four m16n8 accumulators).  bf16
// inputs enter the products exactly; a float32 operand (w B, M, the
// entering state) is split into three bf16 terms, three products each.

// 1. prep: G = C B^T per (batch, chunk) on the causal triangle, cum per head
__global__ void __launch_bounds__(kThreads)
prep_mma_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                float* __restrict__ G, float* __restrict__ cum, int S, int H,
                int N, int Q, long long bsb, long long bss, long long csb,
                long long css) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int nc = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s0 = c * Q;
  const int len = min(Q, S - s0);
  const int QP = round16(Q);
  const int NP = round16(N);
  const int ld = NP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);   // QP x ld
  bf16* cs = bs + QP * ld;                          // QP x ld

  chunk_cum(dt, A, cum, b, c, nc, S, H, Q);

  const bf16 zero = __float2bfloat16(0.f);
  for (int n0 = 0; n0 < NP; n0 += kNTile)
    stage<2, __nv_bfloat162>(
        [&](int j, int n) {
          const bool in = j < len && n0 + n < N;
          return __nv_bfloat162(
              in ? Bm[b * bsb + (s0 + j) * bss + n0 + n] : zero,
              in ? Cm[b * csb + (s0 + j) * css + n0 + n] : zero);
        },
        [&](int j, int n, __nv_bfloat162 v) {
          if (j < QP && n0 + n < NP) {
            bs[j * ld + n0 + n] = v.x;
            cs[j * ld + n0 + n] = v.y;
          }
        });
  __syncthreads();

  const int i0 = 16 * (warp >> 1);
  const int j0 = 32 * (warp & 1);
  if (i0 >= QP || j0 >= QP) return;
  float acc[4][4] = {};
  // column blocks wholly above the diagonal stay zero
  const bool one = j0 <= i0 + 15;
  const bool two = j0 + 16 < QP && j0 + 16 <= i0 + 15;
  if (one) {
    for (int k0 = 0; k0 < NP; k0 += 16) {
      uint32_t a[4], bq[4];
      ldsm(a, frag_rows(cs, ld, i0, k0, lane));
      ldsm(bq, frag_cols(bs, ld, j0, k0, lane));
      mma(acc[0], a, bq[0], bq[1]);
      mma(acc[1], a, bq[2], bq[3]);
      if (two) {
        ldsm(bq, frag_cols(bs, ld, j0 + 16, k0, lane));
        mma(acc[2], a, bq[0], bq[1]);
        mma(acc[3], a, bq[2], bq[3]);
      }
    }
  }
  float* Gc = G + (static_cast<long long>(b) * nc + c) * Q * Q;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (lane >> 2) + 8 * (e >> 1);
      const int j = j0 + 8 * t + 2 * (lane & 3) + (e & 1);
      if (i < Q && j < Q) Gc[i * Q + j] = j <= i ? acc[t][e] : 0.f;
    }
}

// 2. chunk_state: s_c = X^T (w B) per (head, chunk, batch), w B split; the
// columns of N in tiles of 64 (four CTAs an SM)
__global__ void __launch_bounds__(kThreads, 4)
chunk_state_mma_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const bf16* __restrict__ Bm,
                       const float* __restrict__ cum,
                       float* __restrict__ states, int S, int H, int P, int N,
                       int Q, long long xsb, long long xss, long long bsb,
                       long long bss) {
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s0 = c * Q;
  const int len = min(Q, S - s0);
  const int QP = round16(Q);
  const int PP = round16(P);
  const int XS = PP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);          // QP x XS
  bf16* wb = xs + QP * XS;                               // 3 x QP x kTB
  float* w = reinterpret_cast<float*>(wb + 3 * QP * kTB);  // QP

  const bf16 zero = __float2bfloat16(0.f);
  const long long xh = static_cast<long long>(h) * P;
  // a tile of B, 64 columns from n0, one column pair per lane
  auto b_tile = [=](int n0) {
    return [=](int j, int l) {
      const int n = n0 + 2 * l;
      const bf16* brow = Bm + b * bsb + (s0 + j) * bss;
      return __nv_bfloat162(j < len && n < N ? brow[n] : zero,
                            j < len && n + 1 < N ? brow[n + 1] : zero);
    };
  };
  // the loads of x and of B's first tile together, with cum and dt
  bf16 xv[kRows][2];
  __nv_bfloat162 bv[kRows][1];
  gather(xv, [&](int j, int p) {
    return j < len && p < P ? x[b * xsb + (s0 + j) * xss + xh + p] : zero;
  });
  gather(bv, b_tile(0));
  const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
  const float* cumc = cum + bch * Q;
  if (tid < QP) {
    const float d =
        tid < len ? dt[(static_cast<long long>(b) * S + s0 + tid) * H + h]
                  : 0.f;
    w[tid] = tid < Q ? d * expf(cumc[Q - 1] - cumc[tid]) : 0.f;
  }
  scatter(xv, [&](int j, int p, bf16 v) {
    if (j < QP && p < PP) xs[j * XS + p] = v;
  });
  __syncthreads();

  const int p0 = 16 * (warp >> 1);
  const int c0 = 32 * (warp & 1);
  float* sc = states + bch * P * N;
  for (int n0 = 0; n0 < N; n0 += kNTile) {
    // w_j B_jn in float32, split
    scatter(bv, [&](int j, int l, __nv_bfloat162 v) {
      if (j >= QP) return;
      uint32_t t3[3];
      split3(w[j] * __bfloat162float(v.x), w[j] * __bfloat162float(v.y),
             &t3[0], &t3[1], &t3[2]);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint32_t*>(wb + (t * QP + j) * kTB + 2 * l) = t3[t];
    });
    __syncthreads();
    // the next tile's loads stay in flight through this tile's products
    if (n0 + kNTile < N) gather(bv, b_tile(n0 + kNTile));
    const int ntp = round16(min(kNTile, N - n0));
    if (p0 < PP && c0 < ntp) {
      const bool two = c0 + 16 < ntp;
      float acc[4][4] = {};
      for (int k0 = 0; k0 < QP; k0 += 16) {
        uint32_t a[4];
        ldsm_t(a, frag_cols(xs, XS, k0, p0, lane));
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const bf16* wt = wb + t * QP * kTB;
          uint32_t bq[4];
          ldsm_t(bq, frag_rows(wt, kTB, k0, c0, lane));
          mma(acc[0], a, bq[0], bq[1]);
          mma(acc[1], a, bq[2], bq[3]);
          if (two) {
            ldsm_t(bq, frag_rows(wt, kTB, k0, c0 + 16, lane));
            mma(acc[2], a, bq[0], bq[1]);
            mma(acc[3], a, bq[2], bq[3]);
          }
        }
      }
      // column pairs: whole 32-byte sectors where N is even
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + (lane >> 2) + 8 * r;
          const int n = n0 + c0 + 8 * t + 2 * (lane & 3);
          if (p >= P || n >= N) continue;
          float* out = sc + p * N + n;
          if (n + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(out) =
                make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
          } else {
            out[0] = acc[t][2 * r];
            if (n + 1 < N) out[1] = acc[t][2 * r + 1];
          }
        }
    }
    __syncthreads();
  }
}

// 4. chunk_scan: y = M x + exp(cum_i) C . entering, M and the entering
// state split; C and the state in tiles of 64 columns of N (two CTAs an SM
// at least: unbounded, the compiler takes 174 registers and one fits)
__global__ void __launch_bounds__(kThreads, 2)
chunk_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const bf16* __restrict__ Cm, const float* __restrict__ G,
                      const float* __restrict__ cum,
                      const float* __restrict__ states, bf16* __restrict__ y,
                      int S, int H, int P, int N, int Q, long long xsb,
                      long long xss, long long csb, long long css) {
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s0 = c * Q;
  const int len = min(Q, S - s0);
  const int QP = round16(Q);
  const int PP = round16(P);
  const int XS = PP + 8;
  const int MS = QP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // QP x XS
  bf16* ms = xs + QP * XS;                        // 3 x QP x MS: M split
  bf16* cs = ms + 3 * QP * MS;                    // QP x kTB: a tile of C
  bf16* es = cs + QP * kTB;                       // 3 x PP x kTB: entering
  float* cums = reinterpret_cast<float*>(es + 3 * PP * kTB);   // QP
  float* dts = cums + QP;                                      // QP

  const bf16 zero = __float2bfloat16(0.f);
  const long long xh = static_cast<long long>(h) * P;
  const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
  const float* Gc = G + (static_cast<long long>(b) * nc + c) * Q * Q;
  const float* sc = states + bch * P * N;
  // a tile of C (rows i < len) and of the entering state (rows p < P), 64
  // columns from n0, one column pair per lane
  struct Pair {
    __nv_bfloat162 c;
    float2 e;
  };
  auto tile = [=](int n0) {
    return [=](int r, int l) {
      const int n = n0 + 2 * l;
      const bf16* crow = Cm + b * csb + (s0 + r) * css;
      const float* erow = sc + r * N;
      return Pair{
          __nv_bfloat162(r < len && n < N ? crow[n] : zero,
                         r < len && n + 1 < N ? crow[n + 1] : zero),
          make_float2(r < P && n < N ? erow[n] : 0.f,
                      r < P && n + 1 < N ? erow[n + 1] : 0.f)};
    };
  };
  auto tile_store = [&](int r, int l, Pair v) {
    if (r < QP)
      *reinterpret_cast<__nv_bfloat162*>(cs + r * kTB + 2 * l) = v.c;
    if (r < PP) {
      uint32_t t3[3];
      split3(v.e.x, v.e.y, &t3[0], &t3[1], &t3[2]);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint32_t*>(es + (t * PP + r) * kTB + 2 * l) = t3[t];
    }
  };
  // the loads of x, of G's pairs (one column pair per lane) and of the first
  // tile together, with cum and dt
  bf16 xv[kRows][2];
  float2 gv[kRows][1];
  Pair tv[kRows][1];
  gather(xv, [&](int j, int p) {
    return j < len && p < P ? x[b * xsb + (s0 + j) * xss + xh + p] : zero;
  });
  gather(gv, [&](int i, int l) {
    const int j = 2 * l;
    return make_float2(i < Q && j <= i ? Gc[i * Q + j] : 0.f,
                       i < Q && j + 1 <= i ? Gc[i * Q + j + 1] : 0.f);
  });
  gather(tv, tile(0));
  if (tid < QP) {
    cums[tid] = tid < Q ? cum[bch * Q + tid] : 0.f;
    dts[tid] = tid < len
                   ? dt[(static_cast<long long>(b) * S + s0 + tid) * H + h]
                   : 0.f;
  }
  scatter(xv, [&](int j, int p, bf16 v) {
    if (j < QP && p < PP) xs[j * XS + p] = v;
  });
  scatter(tv, tile_store);
  __syncthreads();
  // M = G * exp(cum_i - cum_j) * dt_j on the causal triangle, split
  scatter(gv, [&](int i, int l, float2 g) {
    const int j = 2 * l;
    if (i >= QP || j >= QP) return;
    const float v0 =
        i < Q && j <= i ? g.x * expf(cums[i] - cums[j]) * dts[j] : 0.f;
    const float v1 = i < Q && j + 1 <= i
                         ? g.y * expf(cums[i] - cums[j + 1]) * dts[j + 1]
                         : 0.f;
    uint32_t t3[3];
    split3(v0, v1, &t3[0], &t3[1], &t3[2]);
#pragma unroll
    for (int t = 0; t < 3; ++t)
      *reinterpret_cast<uint32_t*>(ms + (t * QP + i) * MS + j) = t3[t];
  });
  __syncthreads();

  const int i0 = 16 * (warp >> 1);
  const int p0 = 32 * (warp & 1);
  const bool active = i0 < QP && p0 < PP;
  const bool two = p0 + 16 < PP;
  float yi[4][4] = {};
  float ye[4][4] = {};
  if (active) {
    // M is zero right of the diagonal block
    const int kend = min(QP, i0 + 16);
    for (int k0 = 0; k0 < kend; k0 += 16) {
      uint32_t bx[4], bx2[4];
      ldsm_t(bx, frag_rows(xs, XS, k0, p0, lane));
      if (two) ldsm_t(bx2, frag_rows(xs, XS, k0, p0 + 16, lane));
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        uint32_t a[4];
        ldsm(a, frag_rows(ms + t * QP * MS, MS, i0, k0, lane));
        mma(yi[0], a, bx[0], bx[1]);
        mma(yi[1], a, bx[2], bx[3]);
        if (two) {
          mma(yi[2], a, bx2[0], bx2[1]);
          mma(yi[3], a, bx2[2], bx2[3]);
        }
      }
    }
  }
  for (int n0 = 0; n0 < N; n0 += kNTile) {
    if (n0 > 0) {     // the first tile is staged above
      scatter(tv, tile_store);
      __syncthreads();
    }
    // the next tile's loads stay in flight through this tile's products
    if (n0 + kNTile < N) gather(tv, tile(n0 + kNTile));
    const int ntp = round16(min(kNTile, N - n0));
    if (active) {
      for (int k0 = 0; k0 < ntp; k0 += 16) {
        uint32_t a[4];
        ldsm(a, frag_rows(cs, kTB, i0, k0, lane));
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const bf16* et = es + t * PP * kTB;
          uint32_t bq[4];
          ldsm(bq, frag_cols(et, kTB, p0, k0, lane));
          mma(ye[0], a, bq[0], bq[1]);
          mma(ye[1], a, bq[2], bq[3]);
          if (two) {
            ldsm(bq, frag_cols(et, kTB, p0 + 16, k0, lane));
            mma(ye[2], a, bq[0], bq[1]);
            mma(ye[3], a, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + (lane >> 2) + 8 * r;
    if (i >= len) continue;
    const float e = expf(cums[i]);
    bf16* yrow = y + ((static_cast<long long>(b) * S + s0 + i) * H + h) * P;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int p = p0 + 8 * t + 2 * (lane & 3);
      if (p >= P) continue;
      // round to nearest even, as torch's cast
      const bf16 y0 = __float2bfloat16(yi[t][2 * r] + e * ye[t][2 * r]);
      const bf16 y1 =
          __float2bfloat16(yi[t][2 * r + 1] + e * ye[t][2 * r + 1]);
      if (p + 1 < P && (P & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __nv_bfloat162(y0, y1);
      } else {
        yrow[p] = y0;
        if (p + 1 < P) yrow[p + 1] = y1;
      }
    }
  }
}

// ---- launches ------------------------------------------------------------

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* states;
  float* G;
  float* cum;
  int Bt, S, H, P, N, Q, nc;
  long long xsb, xss, bsb, bss, csb, css;
};

// dynamic shared memory of the launches (mirrored by the wrapper's
// kernels/ssd_scan.py::smem_bytes)
size_t state_smem_f32(int P, int N, int Q) {
  return sizeof(float) * (static_cast<size_t>(Q) * P +
                          static_cast<size_t>(Q) * N + Q);
}

size_t scan_smem_f32(int P, int Q) {
  return sizeof(float) * (static_cast<size_t>(Q) * P +
                          static_cast<size_t>(Q + P) * kTS +
                          static_cast<size_t>(Q) * (Q + 1) + 2 * Q);
}

size_t prep_smem_bf16(int N, int Q) {
  return sizeof(bf16) * 2 * static_cast<size_t>(round16(Q)) *
         (round16(N) + 8);
}

size_t state_smem_bf16(int P, int Q) {
  const size_t QP = round16(Q), PP = round16(P);
  return sizeof(bf16) * (QP * (PP + 8) + 3 * QP * kTB) + sizeof(float) * QP;
}

size_t scan_smem_bf16(int P, int Q) {
  const size_t QP = round16(Q), PP = round16(P);
  return sizeof(bf16) * (QP * (PP + 8) + 3 * QP * (QP + 8) + QP * kTB +
                         3 * PP * kTB) +
         sizeof(float) * 2 * QP;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t state_pass(const Args& a, cudaStream_t stream) {
  const int PN = a.P * a.N;
  if (PN % 4 == 0) {
    const int threads = PN / 4;
    state_pass_kernel<float4>
        <<<dim3((threads + kThreads - 1) / kThreads, a.H, a.Bt), kThreads, 0,
            stream>>>(a.states, a.cum, a.H, PN, a.Q, a.nc);
  } else {
    state_pass_kernel<float>
        <<<dim3((PN + kThreads - 1) / kThreads, a.H, a.Bt), kThreads, 0,
            stream>>>(a.states, a.cum, a.H, PN, a.Q, a.nc);
  }
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const float* x = static_cast<const float*>(a.x);
  const float* Bm = static_cast<const float*>(a.B);
  const float* Cm = static_cast<const float*>(a.C);
  prep_kernel<<<dim3(a.nc, a.Bt), kThreads, 0, stream>>>(
      a.dt, a.A, Bm, Cm, a.G, a.cum, a.S, a.H, a.N, a.Q, a.bsb, a.bss, a.csb,
      a.css);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_s = state_smem_f32(a.P, a.N, a.Q);
  err = allow_smem(chunk_state_kernel<NT>, smem_s);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<NT><<<dim3(a.H, a.nc, a.Bt), kThreads, smem_s, stream>>>(
      x, a.dt, Bm, a.cum, a.states, a.S, a.H, a.P, a.N, a.Q, a.xsb, a.xss,
      a.bsb, a.bss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = state_pass(a, stream);
  if (err != cudaSuccess) return err;

  const size_t smem_c = scan_smem_f32(a.P, a.Q);
  err = allow_smem(chunk_scan_kernel, smem_c);
  if (err != cudaSuccess) return err;
  chunk_scan_kernel<<<dim3(a.H, a.nc, a.Bt), kThreads, smem_c, stream>>>(
      x, a.dt, Cm, a.G, a.cum, a.states, static_cast<float*>(a.y), a.S, a.H,
      a.P, a.N, a.Q, a.xsb, a.xss, a.csb, a.css);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Args& a, cudaStream_t stream) {
  // the chunk state's columns per thread: N over 32 lanes, rounded up
  if (a.N <= 32) return launch_f32<1>(a, stream);
  if (a.N <= 64) return launch_f32<2>(a, stream);
  if (a.N <= 128) return launch_f32<4>(a, stream);
  return launch_f32<8>(a, stream);
}

cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* Bm = static_cast<const bf16*>(a.B);
  const bf16* Cm = static_cast<const bf16*>(a.C);
  const size_t smem_p = prep_smem_bf16(a.N, a.Q);
  cudaError_t err = allow_smem(prep_mma_kernel, smem_p);
  if (err != cudaSuccess) return err;
  prep_mma_kernel<<<dim3(a.nc, a.Bt), kThreads, smem_p, stream>>>(
      a.dt, a.A, Bm, Cm, a.G, a.cum, a.S, a.H, a.N, a.Q, a.bsb, a.bss, a.csb,
      a.css);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_s = state_smem_bf16(a.P, a.Q);
  err = allow_smem(chunk_state_mma_kernel, smem_s);
  if (err != cudaSuccess) return err;
  chunk_state_mma_kernel<<<dim3(a.H, a.nc, a.Bt), kThreads, smem_s,
                           stream>>>(x, a.dt, Bm, a.cum, a.states, a.S, a.H,
                                     a.P, a.N, a.Q, a.xsb, a.xss, a.bsb,
                                     a.bss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = state_pass(a, stream);
  if (err != cudaSuccess) return err;

  const size_t smem_c = scan_smem_bf16(a.P, a.Q);
  err = allow_smem(chunk_scan_mma_kernel, smem_c);
  if (err != cudaSuccess) return err;
  chunk_scan_mma_kernel<<<dim3(a.H, a.nc, a.Bt), kThreads, smem_c, stream>>>(
      x, a.dt, Cm, a.G, a.cum, a.states, static_cast<bf16*>(a.y), a.S, a.H,
      a.P, a.N, a.Q, a.xsb, a.xss, a.csb, a.css);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16.  Strides are in
// elements.  states, G and cum are the wrapper's float32 scratch of
// (Bt, nc, H, P, N), (Bt, nc, Q, Q) and (Bt, nc, H, Q) elements, nc =
// ceil(S / Q).  Returns the cudaError of the first launch that fails (0 on
// success); the wrapper checks shapes, types and limits before it calls.
extern "C" int hsgd_ssd_scan(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y, void* states,
                             void* G, void* cum, int dtype, int Bt, int S,
                             int H, int P, int N, int Q, long long xsb,
                             long long xss, long long bsb, long long bss,
                             long long csb, long long css,
                             cudaStream_t stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxQ || P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               B, C, y, static_cast<float*>(states), static_cast<float*>(G),
               static_cast<float*>(cum), Bt, S, H, P, N, Q, (S + Q - 1) / Q,
               xsb, xss, bsb, bss, csb, css};
  const cudaError_t err = dtype == 0   ? dispatch_f32(a, stream)
                          : dtype == 1 ? launch_bf16(a, stream)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

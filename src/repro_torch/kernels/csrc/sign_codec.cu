// 1-bit sign wire codec for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/comms.py:
//   sign_pack    (comms.py:194, pallas_call at :206)  -> hsgd_sign_pack
//   sign_unpack  (comms.py:229, pallas_call at :238)  -> hsgd_sign_unpack
//
// A payload is R rows of C float32 values cut into blocks of `block`
// contiguous columns (block % 8 == 0; nb = ceil(C / block) blocks per row,
// the last one may be ragged).  Per block:
//   bits:  bit k of byte j is x[8j+k] >= 0, least significant bit first
//          (-0.0 counts as +, NaN as -); the zero padding of a ragged last
//          block counts as + and its bytes are written too, so a row of
//          bits is nb * block / 8 bytes, as in the reference;
//   scale: mean |x| over the block's real entries.
// sign_unpack writes (2*bit - 1) * scale for the first `size` columns.
//
// Bound: memory.  sign_pack reads 4 bytes per element and writes 1/8 byte
// plus 4 bytes per block; sign_unpack does the reverse.  The work per
// element is a compare and an add.  The design:
//   * sign_pack gives each (row, block) task to one warp, 8 warps to a CTA.
//     The warp reads its block with coalesced loads (float4 when the row
//     length and the pointer allow it, else scalar), 8 passes of loads
//     issued before any is used, turns the compares
//     into bytes with __ballot_sync (a warp's 32 bits are exactly 4 bytes
//     of the reference's layout) and sums |x| in its own slice of shared
//     memory.  Only __syncwarp orders the sum, so a warp never waits for
//     another and the other warps' loads stay in flight.  (A CTA per task,
//     tied by __syncthreads, ran at 0.52 ms with 256 threads and 1.21 ms
//     with 1024 where the bound is 0.165 ms: PERF.md.)
//   * sign_unpack gives 256 consecutive columns of a row to one warp: one
//     coalesced 32-byte load of their bits, bytes passed between lanes by
//     __shfl_sync, then 8 stores of 32 consecutive floats, each one
//     128-byte span; the block of each column is advanced by compares,
//     with one integer division a chunk.  (One thread per byte writing 8
//     floats spread each
//     warp store over 32 sectors: 1.20 ms; one thread per element, too
//     little work a thread: 0.58 ms.)
//
// Exactness (each kernel must equal its plain PyTorch version bit for bit,
// src/repro_torch/kernels/ref.py):
//   * Summation rule: the block is zero-padded to P, the next power of two,
//     and summed by the halving tree  w = P; while (w > 1) { w /= 2;
//     s[i] = s[i] + s[i + w] for i < w; }  -- the same pairs as the plain
//     version, in shared memory down to 32 partial sums and by warp
//     shuffles below that.  Float adds are commutative, so only the pairs
//     matter.
//   * Division rule: the scale is sum / count, an IEEE division by the
//     block's real count.  Build without --use_fast_math and never call
//     __fdividef.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a sign_pack CTA may take; larger blocks get fewer warps
constexpr int kPackSmemBytes = 64 * 1024;

// Store the packed bits of one warp's 32 elements starting at column c0 of
// the block: `bytes` of them (1..4) at `dst`; one 32-bit store when all 4
// are in the block and the address is aligned.  Called by the whole warp.
__device__ __forceinline__ void store_bits(uint8_t* dst, unsigned ballot,
                                           int bytes, int lane) {
  if (bytes == 4 && (reinterpret_cast<uintptr_t>(dst) & 3u) == 0) {
    if (lane == 0) *reinterpret_cast<uint32_t*>(dst) = ballot;
  } else if (lane < bytes) {
    dst[lane] = static_cast<uint8_t>(ballot >> (8 * lane));
  }
}

// One warp loads its block into `sa` as |x| (zeros past the real entries,
// up to span = max(P, 32) floats) and writes the block's packed bits.
template <int VEC>
__device__ __forceinline__ void load_and_pack(const float* __restrict__ xs,
                                              uint8_t* __restrict__ bs,
                                              float* __restrict__ sa, int len,
                                              int block, int span, int lane) {
  // kBatch passes of loads are issued before any of them is used, so each
  // lane has kBatch loads in flight
  constexpr int kBatch = 8;
  if constexpr (VEC == 4) {
    // 128 consecutive columns a pass, 4 per lane
    for (int c0 = 0; c0 < span; c0 += 128 * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = c0 + 128 * u + lane * 4;
        v[u] = i < len ? __ldg(reinterpret_cast<const float4*>(xs + i))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + 128 * u >= span) break;  // the same for the whole warp
        const int i = c0 + 128 * u + lane * 4;
        if (i < span)
          *reinterpret_cast<float4*>(sa + i) = make_float4(
              fabsf(v[u].x), fabsf(v[u].y), fabsf(v[u].z), fabsf(v[u].w));
        // 4 bits per lane; an even lane joins its odd neighbour's into one
        // byte (columns i .. i+7, i a multiple of 8)
        const unsigned nib =
            (v[u].x >= 0.f ? 1u : 0u) | (v[u].y >= 0.f ? 2u : 0u) |
            (v[u].z >= 0.f ? 4u : 0u) | (v[u].w >= 0.f ? 8u : 0u);
        const unsigned hi = __shfl_down_sync(kFull, nib, 1);
        if ((lane & 1) == 0 && i < block)
          bs[i >> 3] = static_cast<uint8_t>(nib | (hi << 4));
      }
    }
  } else {
    // 32 consecutive columns a pass, 1 per lane
    for (int c0 = 0; c0 < span; c0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = c0 + 32 * u + lane;
        v[u] = i < len ? __ldg(xs + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p0 = c0 + 32 * u;
        if (p0 >= span) break;  // the same for the whole warp
        sa[p0 + lane] = fabsf(v[u]);
        const unsigned ballot = __ballot_sync(kFull, v[u] >= 0.f);
        if (p0 < block) {
          const int rest = block - p0;
          store_bits(bs + (p0 >> 3), ballot, (rest < 32 ? rest : 32) >> 3,
                     lane);
        }
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const float* __restrict__ x, uint8_t* __restrict__ bits,
                 float* __restrict__ scale, long long tasks, long long cols,
                 int block, long long nb, int p) {
  extern __shared__ float smem[];  // blockDim.x / 32 slices of span floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long task =  // = r * nb + b, also the scale index
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (task >= tasks) return;  // the whole warp leaves together
  const int span = p < 32 ? 32 : p;
  float* sa = smem + warp * span;
  const long long r = task / nb, b = task - r * nb;
  const long long c0 = b * block;
  const long long rest = cols - c0;
  const int len = static_cast<int>(rest < block ? rest : block);
  load_and_pack<VEC>(x + r * cols + c0,
                     bits + task * static_cast<long long>(block >> 3), sa,
                     len, block, span, lane);
  __syncwarp();
  // halving tree: levels w >= 32 in shared memory
  int w = p;
  while (w > 32) {
    w >>= 1;
    for (int i = lane; i < w; i += 32) sa[i] = sa[i] + sa[i + w];
    __syncwarp();
  }
  // the last levels (w = 16 .. 1) by shuffles: lane i adds lane i + w
  float v = lane < w ? sa[lane] : 0.f;
  for (int o = w >> 1; o > 0; o >>= 1) v = v + __shfl_down_sync(kFull, v, o);
  if (lane == 0) scale[task] = v / static_cast<float>(len);
}

// One warp per 256 consecutive columns of one row (grid: x over the
// column chunks, 8 per CTA; y over the rows).
__global__ void __launch_bounds__(kThreads)
sign_unpack_kernel(const uint8_t* __restrict__ bits,
                   const float* __restrict__ scale, float* __restrict__ y,
                   long long rows, int size, int block, long long nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row_bytes = nb * (block >> 3);
  const int chunks = (size + 255) >> 8;
  const int last_byte = (size - 1) >> 3;  // bytes past it are padding
  for (int chunk = blockIdx.x * kWarpsPerCta + warp; chunk < chunks;
       chunk += gridDim.x * kWarpsPerCta) {
    const int c0 = chunk << 8;
    const int j = (c0 >> 3) + lane;
    for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
      const unsigned byte = j <= last_byte
          ? __ldg(bits + r * row_bytes + j) : 0u;
      const float* sr = scale + r * nb;
      float* yr = y + r * size;
      // the block of column c, advanced as c grows: one division a chunk
      int c = c0 + lane;
      int blk = c / block, end = (blk + 1) * block;
#pragma unroll
      for (int k = 0; k < 8; ++k, c += 32) {
        while (c >= end) {
          ++blk;
          end += block;
        }
        const unsigned b = __shfl_sync(kFull, byte, 4 * k + (lane >> 3));
        if (c < size)
          yr[c] = (2.f * static_cast<float>((b >> (lane & 7)) & 1u) - 1.f) *
                  __ldg(sr + blk);
      }
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <int VEC>
cudaError_t launch_pack(const float* x, uint8_t* bits, float* scale,
                        long long tasks, long long cols, int block,
                        long long nb, cudaStream_t stream) {
  const int p = pow2_at_least(block);
  const int slice = (p < 32 ? 32 : p) * static_cast<int>(sizeof(float));
  int warps = kPackSmemBytes / slice;
  warps = warps < 1 ? 1 : (warps > kWarpsPerCta ? kWarpsPerCta : warps);
  const int smem = warps * slice;
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        sign_pack_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const long long ctas = (tasks + warps - 1) / warps;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  sign_pack_kernel<VEC><<<static_cast<unsigned>(ctas), 32 * warps, smem,
                          stream>>>(x, bits, scale, tasks, cols, block, nb, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point returns 0 or the cudaError_t of the launch.
// bits: (rows, nb * block / 8) uint8; scale: (rows, nb) f32.
int hsgd_sign_pack(const void* x, void* bits, void* scale, long long rows,
                   long long cols, int block, void* stream) {
  if (rows < 0 || cols < 0 || block <= 0 || block % 8 != 0 ||
      block > (1 << 15))
    return cudaErrorInvalidValue;
  const long long nb = (cols + block - 1) / block;
  const long long tasks = rows * nb;
  if (tasks == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  uint8_t* bp = static_cast<uint8_t*>(bits);
  float* sp = static_cast<float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cols % 4 == 0 && aligned(x, 16)
          ? launch_pack<4>(xp, bp, sp, tasks, cols, block, nb, s)
          : launch_pack<1>(xp, bp, sp, tasks, cols, block, nb, s);
  return static_cast<int>(err);
}

// y: (rows, size) f32 from bits (rows, nb * block / 8) and scale (rows, nb),
// nb = ceil(size / block).
int hsgd_sign_unpack(const void* bits, const void* scale, void* y,
                     long long rows, long long size, int block,
                     void* stream) {
  // the column and block-end counters are ints: keep them from overflowing
  if (rows < 0 || size < 0 || size > INT_MAX - (1 << 16) || block <= 0 ||
      block % 8 != 0 || block > (1 << 15))
    return cudaErrorInvalidValue;
  if (rows == 0 || size == 0) return 0;
  const long long nb = (size + block - 1) / block;
  const long long ctas = ((size + 255) / 256 + kWarpsPerCta - 1) / kWarpsPerCta;
  const dim3 grid(static_cast<unsigned>(ctas < 65535 ? ctas : 65535),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  sign_unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const float*>(scale),
      static_cast<float*>(y), rows, static_cast<int>(size), block, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// O(size * M * K / 256) reads and is not carried over.  Nor is a float
// atomic per entry at a random address of an output that L2 does not hold.
// The design is a counting sort of the entries by output tile, then one CTA
// per tile that sums the tile in shared memory and writes it once:
//   * tiles of kTile output floats (64 KB of shared memory); chunks of
//     kChunk entries, none straddling two members, numbered in member order;
//   * count: per chunk, a shared-memory histogram of tile ids (integer
//     atomics, which are exact); out-of-range indices, negative ones
//     included, are dropped here;
//   * scan: an exclusive scan over (tile, chunk) in tile-major order gives
//     each chunk's offset in each tile's bucket.  Because chunks are in
//     member order, a tile's bucket holds member 0's entries, then member
//     1's, and so on; the member boundaries inside a bucket are the scan's
//     values at the members' first chunks;
//   * scatter: each chunk is sorted by tile in shared memory first, so that
//     its run of entries for one tile (about kChunk / tiles of them) goes
//     to the tile's bucket as neighbouring (tile-local index, value)
//     records written by neighbouring threads; scattered 8-byte writes
//     would leave partial sectors in a 67 MB buffer that L2 cannot hold;
//   * reduce: one CTA per tile zeroes the tile in shared memory, stages its
//     records in shared memory (kWindow at a time, all loads in flight at
//     once), adds member m's for m = 0..M-1 in order, with a barrier
//     between members that waits on no load, and writes the tile to out,
//     coalesced, once.  No memset of out.
//   * the chunk kernels issue kUnroll loads a thread before they use any:
//     with one load in flight a thread, reading idx alone took 38 us at
//     the timing shape (under 1 TB/s).
// The bytes: idx once for the count, the entries read and their records
// written once for the scatter and read once for the reduce, out written
// once (about 300 MB at (8, 1,048,581, 2^24 + 77), against the 101 MB the
// function must move).  At most kSmallEntries entries into at most one
// tile (the quickstart's syncs, (8, 530, 2120)) take a single CTA and one
// launch, which does the same member-ordered sum without bucketing.  Past
// kSmemBins tiles the histogram and the cursors live in global memory
// (integer atomics there too) and the scatter writes unsorted.
//
// Exactness (the kernel must equal its plain PyTorch version bit for bit,
// src/repro_torch/kernels/ref.py::topk_reduce_ref):
//   * Order rule: per output element the adds are taken member after
//     member, starting from +0.0, as the plain version's one index_add_
//     per member takes them.  The barriers between members give that order.
//   * Within a member the top-k codec's indices are distinct, so each
//     element receives at most one add per member, whatever the threads'
//     order.  Indices repeated within one member are legal input (the
//     Pallas kernel sums them): their adds land in an order that changes
//     from run to run, so that case agrees with the plain version to
//     float32 rounding (1e-6), not bit for bit.
//   * Add rule: every add is an IEEE round-to-nearest float add, taken in
//     shared memory by compare-and-swap, which succeeds on its first try
//     when uncontended.  The hardware float atomicAdd flushes subnormal
//     inputs and results to zero, which the plain version on the CPU does
//     not.  Build without --use_fast_math.
//
// Scratch: the wrapper (kernels/comms.py::topk_plan, which mirrors the
// constants and the layout below) allocates one byte buffer and passes its
// size; an entry point given too little returns cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileLog2 = 14;
constexpr int kTile = 1 << kTileLog2;       // output floats per tile
constexpr long long kChunk = 1 << 13;       // entries per chunk
constexpr long long kSmallEntries = 1 << 18;
constexpr long long kSmemBins = 1 << 14;    // tiles a histogram holds
constexpr int kScanThreads = 1024;
constexpr int kScanBlock = 4 * kScanThreads;
constexpr int kThreads = 1024;              // single and reduce CTAs
constexpr int kChunkThreads = 512;          // count and scatter CTAs
constexpr int kMembersPerPass = 1024;       // member bounds in shared memory
constexpr int kWindow = 4 * kThreads;       // records a reduce CTA stages
constexpr int kUnroll = 4;                  // loads a chunk thread issues

// *p += v with an IEEE round-to-nearest add, atomically, in shared memory.
__device__ __forceinline__ void add_ieee(float* p, float v) {
  unsigned* word = reinterpret_cast<unsigned*>(p);
  unsigned seen = *reinterpret_cast<volatile unsigned*>(word);
  while (true) {
    const unsigned want = __float_as_uint(__fadd_rn(__uint_as_float(seen), v));
    const unsigned had = atomicCAS(word, seen, want);
    if (had == seen) return;
    seen = had;
  }
}

__device__ __forceinline__ bool in_range(int i, long long size) {
  return i >= 0 && i < size;
}

// Every entry into one tile of size <= kTile floats, one CTA.
__global__ void __launch_bounds__(kThreads)
topk_single(const float* __restrict__ vals, const int* __restrict__ idx,
            float* __restrict__ out, long long m, long long k, int size) {
  extern __shared__ float tile[];
  for (int i = threadIdx.x; i < size; i += blockDim.x) tile[i] = 0.f;
  __syncthreads();
  for (long long r = 0; r < m; ++r) {
    for (long long j = threadIdx.x; j < k; j += blockDim.x) {
      const int i = __ldg(idx + r * k + j);
      if (in_range(i, size)) add_ieee(tile + i, __ldg(vals + r * k + j));
    }
    __syncthreads();   // member r is in before member r + 1
  }
  for (int i = threadIdx.x; i < size; i += blockDim.x) out[i] = tile[i];
}

// Chunk c's count of entries per tile, into counts[t * chunks + c].  With
// kShared the histogram is in shared memory and every bin is written;
// otherwise counts starts zeroed and takes global integer atomics.
template <bool kShared>
__global__ void __launch_bounds__(kChunkThreads)
topk_count(const int* __restrict__ idx, int* __restrict__ counts, long long k,
           long long size, long long cpm, long long chunks, long long tiles) {
  extern __shared__ int hist[];
  const long long c = blockIdx.x;
  const long long r = c / cpm;
  const long long j0 = (c - r * cpm) * kChunk;
  const long long j1 = min(k, j0 + kChunk);
  if (kShared) {
    for (long long t = threadIdx.x; t < tiles; t += blockDim.x) hist[t] = 0;
    __syncthreads();
  }
  for (long long j = j0 + threadIdx.x; j < j1; j += kUnroll * blockDim.x) {
    int i[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // the loads first, all in flight
      const long long ju = j + u * blockDim.x;
      i[u] = ju < j1 ? __ldg(idx + r * k + ju) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!in_range(i[u], size)) continue;
      const long long t = i[u] >> kTileLog2;
      if (kShared) {
        atomicAdd(hist + t, 1);
      } else {
        atomicAdd(counts + t * chunks + c, 1);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (long long t = threadIdx.x; t < tiles; t += blockDim.x)
      counts[t * chunks + c] = hist[t];
    if (c == 0 && threadIdx.x == 0) counts[tiles * chunks] = 0;
  }
}

// Exclusive scan of one int per thread over the CTA (a multiple of 32
// threads, at most 1024); returns the CTA's total through *total.
__device__ __forceinline__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + inc - x;
  *total = warp_sums[warps - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return before;
}

// Sum of each kScanBlock-long block of a[0, n) into sums[block].
__global__ void __launch_bounds__(kScanThreads)
scan_sums(const int* __restrict__ a, int* __restrict__ sums, long long n) {
  const long long base = static_cast<long long>(blockIdx.x) * kScanBlock +
                         4 * threadIdx.x;
  int x = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (base + e < n) x += a[base + e];
  int total;
  block_exclusive_scan(x, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Exclusive scan of sums[0, nb) in place, one CTA.
__global__ void __launch_bounds__(kScanThreads)
scan_block_sums(int* __restrict__ sums, long long nb) {
  int carry = 0;
  for (long long base = 0; base < nb; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const int x = i < nb ? sums[i] : 0;
    int total;
    const int before = block_exclusive_scan(x, &total);
    if (i < nb) sums[i] = carry + before;
    carry += total;
  }
}

// a[0, n) becomes its exclusive scan (block offsets from sums); with a
// cursor array, a copy of the first n - 1 values goes there too.
__global__ void __launch_bounds__(kScanThreads)
scan_apply(int* __restrict__ a, const int* __restrict__ sums, long long n,
           int* __restrict__ cursor) {
  const long long base = static_cast<long long>(blockIdx.x) * kScanBlock +
                         4 * threadIdx.x;
  int v[4], x = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = base + e < n ? a[base + e] : 0;
    x += v[e];
  }
  int total;
  int run = sums[blockIdx.x] + block_exclusive_scan(x, &total);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (base + e < n) {
      a[base + e] = run;
      if (cursor != nullptr && base + e < n - 1) cursor[base + e] = run;
    }
    run += v[e];
  }
}

// Chunk c's entries into their tiles' buckets as records (tile-local
// index, value bits).  With kShared the chunk is first sorted by tile in
// shared memory (its count per tile is the difference of two neighbouring
// scan values), so that each (chunk, tile) run is written to its bucket
// by neighbouring threads, coalesced; otherwise each entry takes its slot
// from a global cursor.
template <bool kShared>
__global__ void __launch_bounds__(kChunkThreads)
topk_scatter(const float* __restrict__ vals, const int* __restrict__ idx,
             const int* __restrict__ offs, int* __restrict__ cursor,
             uint2* __restrict__ recs, long long k, long long size,
             long long cpm, long long chunks, long long tiles) {
  extern __shared__ uint2 stage[];   // kChunk records, then cur, base
  int* cur = reinterpret_cast<int*>(stage + kChunk);
  int* base = cur + tiles;
  const long long c = blockIdx.x;
  const long long r = c / cpm;
  const long long j0 = (c - r * cpm) * kChunk;
  const long long j1 = min(k, j0 + kChunk);
  if (!kShared) {
    for (long long j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
      const int i = __ldg(idx + r * k + j);
      if (!in_range(i, size)) continue;
      const int slot = atomicAdd(cursor + (i >> kTileLog2) * chunks + c, 1);
      recs[slot] = make_uint2(static_cast<unsigned>(i & (kTile - 1)),
                              __float_as_uint(__ldg(vals + r * k + j)));
    }
    return;
  }
  // each thread scans a run of tiles: local starts of the sorted chunk
  const int per = static_cast<int>((tiles + blockDim.x - 1) / blockDim.x);
  const long long t0 = static_cast<long long>(threadIdx.x) * per;
  const long long t1 = min(tiles, t0 + per);
  int run = 0;
  for (long long t = t0; t < t1; ++t) {
    const int o = offs[t * chunks + c];
    cur[t] = offs[t * chunks + c + 1] - o;
    base[t] = o;
    run += cur[t];
  }
  int n;
  int start = block_exclusive_scan(run, &n);
  for (long long t = t0; t < t1; ++t) {
    const int cnt = cur[t];
    cur[t] = start;
    base[t] -= start;   // bucket slot = base[t] + position in the chunk
    start += cnt;
  }
  __syncthreads();
  for (long long j = j0 + threadIdx.x; j < j1; j += kUnroll * blockDim.x) {
    int i[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // the loads first, all in flight
      const long long ju = j + u * blockDim.x;
      i[u] = ju < j1 ? __ldg(idx + r * k + ju) : -1;
      v[u] = ju < j1 ? __ldg(vals + r * k + ju) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!in_range(i[u], size)) continue;
      stage[atomicAdd(cur + (i[u] >> kTileLog2), 1)] =
          make_uint2(static_cast<unsigned>(i[u]), __float_as_uint(v[u]));
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const uint2 e = stage[p];
    recs[base[e.x >> kTileLog2] + p] = make_uint2(e.x & (kTile - 1), e.y);
  }
}

// Tile t of out: member r's records are offs[t*chunks + r*cpm] up to
// offs[t*chunks + (r+1)*cpm]; m = 0 writes zeros.  Members go in passes of
// kMembersPerPass (their bounds in shared memory); a pass's records are
// staged into shared memory in windows of kWindow, each thread's loads
// unrolled so that they are all in flight at once, and the barriers
// between members then wait on no load.  Two CTAs share an SM.
__global__ void __launch_bounds__(kThreads, 2)
topk_reduce_tiles(const uint2* __restrict__ recs, const int* __restrict__ offs,
                  float* __restrict__ out, long long m, long long size,
                  long long cpm, long long chunks) {
  extern __shared__ float tile[];   // kTile floats, window, member bounds
  uint2* window = reinterpret_cast<uint2*>(tile + kTile);
  int* bound = reinterpret_cast<int*>(window + kWindow);
  const long long t = blockIdx.x;
  const long long first = t * kTile;
  const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                     size - first));
  for (int i = threadIdx.x; i < kTile / 4; i += blockDim.x)
    reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long g = 0; g < m; g += kMembersPerPass) {
    const int gm = static_cast<int>(min(static_cast<long long>(kMembersPerPass),
                                        m - g));
    for (int q = threadIdx.x; q <= gm; q += blockDim.x)
      bound[q] = offs[t * chunks + (g + q) * cpm];
    __syncthreads();
    int r = 0;   // the first member with records at or past w0
    for (int w0 = bound[0]; w0 < bound[gm]; w0 += kWindow) {
      const int w1 = min(bound[gm], w0 + kWindow);
#pragma unroll
      for (int u = 0; u < kWindow / kThreads; ++u) {
        const int p = w0 + threadIdx.x + u * kThreads;
        if (p < w1) window[p - w0] = recs[p];
      }
      __syncthreads();
      for (; r < gm && bound[r] < w1; ++r) {
        const int e = min(bound[r + 1], w1);
        for (int p = max(bound[r], w0) + threadIdx.x; p < e; p += blockDim.x) {
          const uint2 rec = window[p - w0];
          add_ieee(tile + rec.x, __uint_as_float(rec.y));
        }
        __syncthreads();   // member g + r is in before member g + r + 1
        if (bound[r + 1] > w1) break;   // member r goes on in the next window
      }
    }
    __syncthreads();   // bound is rewritten by the next pass
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[first + i] = tile[i];
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the first call that failed.
// vals: (m, k) f32; idx: (m, k) int32; out: (size,) f32; scratch: a
// device buffer of scratch_bytes (kernels/comms.py::topk_plan).
int hsgd_topk_decode_reduce(const void* vals, const void* idx, void* out,
                            long long m, long long k, long long size,
                            void* scratch, long long scratch_bytes,
                            void* stream) {
  if (m < 0 || k < 0 || size < 0 || m * k > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (size == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vp = static_cast<const float*>(vals);
  const int* ip = static_cast<const int*>(idx);
  float* op = static_cast<float*>(out);
  const long long entries = m * k;
  cudaError_t err;

  if (size <= kTile && entries <= kSmallEntries) {
    const int smem = static_cast<int>(size * sizeof(float));
    err = cudaFuncSetAttribute(topk_single,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    topk_single<<<1, kThreads, smem, s>>>(vp, ip, op, m, k,
                                          static_cast<int>(size));
    return cudaGetLastError();
  }

  const long long tiles = cdiv(size, kTile);
  const int tile_smem = static_cast<int>(
      (kTile + kMembersPerPass + 1) * sizeof(int) + kWindow * sizeof(uint2));
  err = cudaFuncSetAttribute(topk_reduce_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_smem);
  if (err != cudaSuccess) return err;
  if (entries == 0) {   // zeros, through the reduce with no member
    topk_reduce_tiles<<<static_cast<unsigned>(tiles), kThreads, tile_smem,
                        s>>>(nullptr, nullptr, op, 0, size, 0, 0);
    return cudaGetLastError();
  }

  // scratch layout: offs (scan_len ints), block sums, cursors (global
  // bins only), records (entries x 8 bytes), each 16-byte aligned
  const long long cpm = cdiv(k, kChunk);
  const long long chunks = m * cpm;
  const long long scan_len = tiles * chunks + 1;
  const long long scan_blocks = cdiv(scan_len, kScanBlock);
  const bool shared_bins = tiles <= kSmemBins;
  const long long off_sums = align16(4 * scan_len);
  const long long off_cursor = off_sums + align16(4 * scan_blocks);
  const long long off_recs =
      off_cursor + (shared_bins ? 0 : align16(4 * (scan_len - 1)));
  if (scratch == nullptr || scratch_bytes < off_recs + 8 * entries)
    return cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(scratch);
  int* offs = reinterpret_cast<int*>(base);
  int* sums = reinterpret_cast<int*>(base + off_sums);
  int* cursor = shared_bins ? nullptr : reinterpret_cast<int*>(base + off_cursor);
  uint2* recs = reinterpret_cast<uint2*>(base + off_recs);
  // shared memory: the count's histogram; the scatter's staged chunk and
  // its cursors and bucket bases
  const int bins_smem = shared_bins ? static_cast<int>(4 * tiles) : 0;
  const int stage_smem =
      shared_bins ? static_cast<int>(8 * kChunk + 8 * tiles) : 0;
  if (shared_bins) {
    err = cudaFuncSetAttribute(topk_count<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bins_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(topk_scatter<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 stage_smem);
    if (err != cudaSuccess) return err;
  }

  if (shared_bins) {
    topk_count<true><<<static_cast<unsigned>(chunks), kChunkThreads,
                       bins_smem, s>>>(ip, offs, k, size, cpm, chunks, tiles);
  } else {
    err = cudaMemsetAsync(offs, 0, 4 * scan_len, s);   // scratch, not out
    if (err != cudaSuccess) return err;
    topk_count<false><<<static_cast<unsigned>(chunks), kChunkThreads, 0, s>>>(
        ip, offs, k, size, cpm, chunks, tiles);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_sums<<<static_cast<unsigned>(scan_blocks), kScanThreads, 0, s>>>(
      offs, sums, scan_len);
  scan_block_sums<<<1, kScanThreads, 0, s>>>(sums, scan_blocks);
  scan_apply<<<static_cast<unsigned>(scan_blocks), kScanThreads, 0, s>>>(
      offs, sums, scan_len, cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (shared_bins) {
    topk_scatter<true><<<static_cast<unsigned>(chunks), kChunkThreads,
                         stage_smem, s>>>(vp, ip, offs, nullptr, recs, k, size,
                                         cpm, chunks, tiles);
  } else {
    topk_scatter<false><<<static_cast<unsigned>(chunks), kChunkThreads, 0,
                          s>>>(vp, ip, offs, cursor, recs, k, size, cpm,
                               chunks, tiles);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_reduce_tiles<<<static_cast<unsigned>(tiles), kThreads, tile_smem, s>>>(
      recs, offs, op, m, size, cpm, chunks);
  return cudaGetLastError();
}

}  // extern "C"

// Stable B-way partition for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel genome_tpu/kernels/partition.py::
// partition_by_bucket (_move_kernel). Element i with 0 <= bid[i] < B goes
// to out[bid[i] * cap + rank], rank = its position among the elements of
// its bucket in stream order; elements with any other bid are dropped.
// Only ranks below cap are written, so an overflowing bucket never writes
// outside its region. totals[b] is each bucket's exact element count.
//
// The TPU design (row sort by bucket in XLA, then chunk-aligned DMA
// appends through per-bucket VMEM carry buffers over a sequential grid)
// exists because the TPU has no vector scatter. Hopper scatters, so this
// is one stable counting pass in three launches on the caller's stream:
//   1. count_tiles:  each block counts its TILE elements per bucket into
//                    counts[b * T + t] (a shared histogram, warp-
//                    aggregated adds);
//   2. scan_buckets: one block per bucket scans its T tile counts into
//                    exclusive int64 offsets[b * T + t] and totals[b];
//   3. scatter_tiles: each block re-reads its tile. Warp w owns the
//                    contiguous sub-range w of the tile; pass 1 counts
//                    each warp's elements per bucket in shared memory,
//                    a scan over the warps turns the counts into in-tile
//                    starts, and pass 2 walks the sub-range again 32
//                    elements at a time: __match_any_sync on the bucket
//                    gives each element's peers, its rank is
//                    popc(peers & lanes below) plus the warp's running
//                    start, and rem is written to its slot.
// Deterministic: stream order holds within every bucket by construction.
//
// What bounds it on this card: memory bandwidth. The least traffic is bid
// read once, rem read once and written once; this design reads bid three
// times (count, pass 1, pass 2), and the [B, T] counts and offsets add
// 12 B per bucket per tile. TILE is large (32768) to keep that matrix
// small: 11 MB of counts at B = 1025 and 88.5 M elements. The writes go to
// B regions at once, each warp's 32 stores to up to 32 of them; within a
// tile a bucket's slots are consecutive, so L2 merges the partial sectors.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define TILE 32768
#define PER_WARP (TILE / WARPS)
#define UNROLL 4
#define MAX_BUCKETS 4096
#define FULL_MASK 0xffffffffu

template <typename BT>
__device__ __forceinline__ int bucket_of(BT v, int B) {
  return (v >= 0 && v < (BT)B) ? (int)v : -1;
}

// Every lane of the warp calls this; lanes with b < 0 add nothing.
__device__ __forceinline__ void add_bucket(int* bins, int b) {
  const unsigned active = __ballot_sync(FULL_MASK, b >= 0);
  if (b < 0) return;
  const unsigned peers = __match_any_sync(active, b);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&bins[b], __popc(peers));
}

template <typename BT>
__global__ void __launch_bounds__(THREADS)
    count_tiles(const BT* __restrict__ bid, long long n, int B, long long T,
                int* __restrict__ counts) {
  extern __shared__ int cnt[];
  for (int b = threadIdx.x; b < B; b += THREADS) cnt[b] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < TILE / THREADS; r += UNROLL) {
    int bk[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)(r + u) * THREADS + threadIdx.x;
      bk[u] = i < n ? bucket_of(bid[i], B) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_bucket(cnt, bk[u]);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += THREADS)
    counts[(long long)b * T + blockIdx.x] = cnt[b];
}

// One block per bucket; thread t owns a contiguous run of tiles.
__global__ void __launch_bounds__(THREADS)
    scan_buckets(const int* __restrict__ counts, long long T,
                 long long* __restrict__ offsets,
                 long long* __restrict__ totals) {
  __shared__ long long warp_incl[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* row = counts + (long long)blockIdx.x * T;
  long long* orow = offsets + (long long)blockIdx.x * T;
  const long long per = (T + THREADS - 1) / THREADS;
  const long long start = (long long)threadIdx.x * per;
  const long long end = start + per < T ? start + per : T;
  long long s = 0;
  for (long long t = start; t < end; ++t) s += row[t];

  long long incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long v = lane < WARPS ? warp_incl[lane] : 0;
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const long long y = __shfl_up_sync(FULL_MASK, v, d);
      if (lane >= d) v += y;
    }
    if (lane < WARPS) warp_incl[lane] = v;
  }
  __syncthreads();
  long long excl = incl - s + (warp > 0 ? warp_incl[warp - 1] : 0);
  for (long long t = start; t < end; ++t) {
    orow[t] = excl;
    excl += row[t];
  }
  if (threadIdx.x == THREADS - 1) totals[blockIdx.x] = excl;
}

// Dynamic shared memory: base[B] int64 (the tile's offset per bucket),
// then pos[WARPS][B] int32 (warp-private counts, then running starts).
template <typename BT, typename RT>
__global__ void __launch_bounds__(THREADS)
    scatter_tiles(const BT* __restrict__ bid, const RT* __restrict__ rem,
                  long long n, int B, long long T,
                  const long long* __restrict__ offsets, RT* __restrict__ out,
                  long long cap) {
  extern __shared__ long long smem[];
  long long* base = smem;
  int* pos = reinterpret_cast<int*>(smem + B);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  int* mine = pos + warp * B;
  for (int j = threadIdx.x; j < WARPS * B; j += THREADS) pos[j] = 0;
  for (int b = threadIdx.x; b < B; b += THREADS)
    base[b] = offsets[(long long)b * T + blockIdx.x];
  __syncthreads();
  const long long sub = (long long)blockIdx.x * TILE + warp * PER_WARP;

  // pass 1: this warp's count per bucket
  for (int r = 0; r < PER_WARP; r += 32 * UNROLL) {
    int bk[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = sub + r + u * 32 + lane;
      bk[u] = i < n ? bucket_of(bid[i], B) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_bucket(mine, bk[u]);
  }
  __syncthreads();
  // scan over the warps: counts -> in-tile starts
  for (int b = threadIdx.x; b < B; b += THREADS) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = pos[w * B + b];
      pos[w * B + b] = run;
      run += c;
    }
  }
  __syncthreads();

  // pass 2: rank in stream order and write
  for (int r = 0; r < PER_WARP; r += 32 * UNROLL) {
    int bk[UNROLL];
    RT v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = sub + r + u * 32 + lane;
      bk[u] = i < n ? bucket_of(bid[i], B) : -1;
      v[u] = bk[u] >= 0 ? rem[i] : (RT)0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int b = bk[u];
      const unsigned active = __ballot_sync(FULL_MASK, b >= 0);
      unsigned peers = 0;
      int start = 0;
      if (b >= 0) {
        peers = __match_any_sync(active, b);
        start = mine[b];
      }
      __syncwarp();  // every peer has read mine[b] before it moves on
      if (b >= 0) {
        const int rank = __popc(peers & lt_mask);
        if (rank == 0) mine[b] = start + __popc(peers);
        const long long slot = base[b] + start + rank;
        if (slot < cap) out[(long long)b * cap + slot] = v[u];
      }
      __syncwarp();  // the update is visible to the next step's reads
    }
  }
}

template <typename BT, typename RT>
static int launch(const void* bid, const void* rem, long long n, int B,
                  long long cap, long long T, int* counts, long long* offsets,
                  long long* totals, void* out, cudaStream_t s) {
  const size_t cnt_smem = sizeof(int) * B;
  const size_t sc_smem = sizeof(long long) * B + sizeof(int) * WARPS * B;
  cudaFuncSetAttribute(count_tiles<BT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)cnt_smem);
  cudaFuncSetAttribute(scatter_tiles<BT, RT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sc_smem);
  const auto* b = static_cast<const BT*>(bid);
  count_tiles<BT><<<(unsigned)T, THREADS, cnt_smem, s>>>(b, n, B, T, counts);
  scan_buckets<<<(unsigned)B, THREADS, 0, s>>>(counts, T, offsets, totals);
  scatter_tiles<BT, RT><<<(unsigned)T, THREADS, sc_smem, s>>>(
      b, static_cast<const RT*>(rem), n, B, T, offsets,
      static_cast<RT*>(out), cap);
  return (int)cudaGetLastError();
}

extern "C" {

long long partition_tile_size(void) { return TILE; }

// Returns a cudaError_t (0 = launched). bid: int32 or int64 (bid_size 4
// or 8), rem and out: int32 or int64 (rem_size). Scratch: counts
// int32[B * T], offsets int64[B * T], T = ceil(n / TILE); totals
// int64[B]; out [B, cap].
int partition_cuda(const void* bid, int bid_size, const void* rem,
                   int rem_size, long long n, int B, long long cap,
                   void* counts, void* offsets, void* totals, void* out,
                   void* stream) {
  if (n <= 0 || B < 1 || B > MAX_BUCKETS || cap < 0
      || (bid_size != 4 && bid_size != 8) || (rem_size != 4 && rem_size != 8))
    return (int)cudaErrorInvalidValue;
  const long long T = (n + TILE - 1) / TILE;
  auto* c = static_cast<int*>(counts);
  auto* o = static_cast<long long*>(offsets);
  auto* t = static_cast<long long*>(totals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bid_size == 4)
    return rem_size == 4
               ? launch<int, int>(bid, rem, n, B, cap, T, c, o, t, out, s)
               : launch<int, long long>(bid, rem, n, B, cap, T, c, o, t, out, s);
  return rem_size == 4
             ? launch<long long, int>(bid, rem, n, B, cap, T, c, o, t, out, s)
             : launch<long long, long long>(bid, rem, n, B, cap, T, c, o, t,
                                            out, s);
}

}  // extern "C"

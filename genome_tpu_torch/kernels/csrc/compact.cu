// Ordered stream compaction for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel genome_tpu/kernels/compact.py::
// compact_flagged (_compact_kernel). Flagged elements of up to MAX_ARR
// payload arrays (4- or 8-byte elements) go densely and in order to the
// front of their outputs, with their int64 source positions (pos) and
// the exact flagged total. Slots >= capacity are dropped; the
// total stays exact above capacity, so the caller's overflow test is
// exactly total > capacity (the TPU's one-chunk conservative margin was a
// DMA-alignment artifact). Output slots >= total are left unwritten.
//
// The TPU design (in-VMEM binary-shift compaction, rolls, a carry buffer
// riding a sequential grid) has no meaning on a card whose blocks run in
// any order. Here it is three launches, all on the caller's stream:
//   1. count_tiles:   each block counts the flags of its TILE elements;
//   2. scan_tiles:    one block turns the per-tile counts into exclusive
//                     int64 output offsets and writes the total;
//   3. scatter_tiles: each block recomputes in-tile ranks (warp ballot +
//                     popc, warp counts scanned through shared memory)
//                     and writes every payload and pos at offset + rank.
// Deterministic and order-preserving. The work is memory-bound: the
// flags and the flagged payload elements are read, each output element
// is written once; pass 1 reads the flags a second time. A single-pass
// decoupled look-back would drop that re-read.
//
// Indexing is 64-bit throughout (the count-site stream is ~9e7 elements
// and a later slice doubles it); the ragged last tile is masked by i < n.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define ROUNDS 16
#define TILE (THREADS * ROUNDS)
#define MAX_ARR 6
#define SCAN_THREADS 1024
#define FULL_MASK 0xffffffffu

struct Payloads {
  const void* src[MAX_ARR];
  void* dst[MAX_ARR];
  int esize[MAX_ARR];
  int n_arr;
};

__global__ void count_tiles(const uint8_t* __restrict__ flags, long long n,
                            int* __restrict__ tile_counts) {
  __shared__ int warp_sum[WARPS];
  const long long base = (long long)blockIdx.x * TILE;
  int local = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + (long long)r * THREADS + threadIdx.x;
    local += (i < n && flags[i] != 0) ? 1 : 0;
  }
  local = __reduce_add_sync(FULL_MASK, local);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) s += warp_sum[w];
    tile_counts[blockIdx.x] = s;
  }
}

// One block of SCAN_THREADS; thread t owns a contiguous run of tiles.
__global__ void scan_tiles(const int* __restrict__ tile_counts, long long nt,
                           long long* __restrict__ offsets,
                           long long* __restrict__ total) {
  __shared__ long long warp_incl[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long per = (nt + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long start = (long long)threadIdx.x * per;
  const long long end = start + per < nt ? start + per : nt;
  long long s = 0;
  for (long long t = start; t < end; ++t) s += tile_counts[t];

  long long incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long v = warp_incl[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(FULL_MASK, v, d);
      if (lane >= d) v += y;
    }
    warp_incl[lane] = v;
  }
  __syncthreads();
  long long excl = incl - s + (warp > 0 ? warp_incl[warp - 1] : 0);
  for (long long t = start; t < end; ++t) {
    offsets[t] = excl;
    excl += tile_counts[t];
  }
  // the last thread's running prefix ends at the grand total
  if (threadIdx.x == SCAN_THREADS - 1) *total = excl;
}

__global__ void scatter_tiles(const uint8_t* __restrict__ flags, long long n,
                              const int* __restrict__ tile_counts,
                              const long long* __restrict__ offsets,
                              Payloads p, long long* __restrict__ pos,
                              long long capacity) {
  __shared__ int warp_cnt[WARPS];
  long long out = offsets[blockIdx.x];
  // uniform per block: nothing flagged here, or everything lands past
  // capacity
  if (tile_counts[blockIdx.x] == 0 || out >= capacity) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + (long long)r * THREADS + threadIdx.x;
    const bool f = i < n && flags[i] != 0;
    const unsigned m = __ballot_sync(FULL_MASK, f);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      round_total += c;
    }
    if (f) {
      const long long dst = out + before + __popc(m & lt_mask);
      if (dst < capacity) {
        for (int a = 0; a < p.n_arr; ++a) {
          if (p.esize[a] == 8)
            static_cast<long long*>(p.dst[a])[dst] =
                static_cast<const long long*>(p.src[a])[i];
          else
            static_cast<int*>(p.dst[a])[dst] =
                static_cast<const int*>(p.src[a])[i];
        }
        pos[dst] = i;
      }
    }
    out += round_total;
    __syncthreads();  // warp_cnt is rewritten next round
  }
}

extern "C" {

long long compact_tile_size(void) { return TILE; }

// Returns a cudaError_t (0 = launched). Scratch: tile_counts int32[nt],
// offsets int64[nt], with nt = ceil(n / TILE); total is int64[1].
int compact_flagged_cuda(const void* flags, long long n, int n_arr,
                         const void* const* srcs, void* const* dsts,
                         const int* esizes, long long* pos,
                         long long capacity, int* tile_counts,
                         long long* offsets, long long* total, void* stream) {
  if (n < 0 || capacity < 0 || n_arr < 0 || n_arr > MAX_ARR)
    return (int)cudaErrorInvalidValue;
  Payloads p;
  p.n_arr = n_arr;
  for (int a = 0; a < MAX_ARR; ++a) {
    p.src[a] = a < n_arr ? srcs[a] : nullptr;
    p.dst[a] = a < n_arr ? dsts[a] : nullptr;
    p.esize[a] = a < n_arr ? esizes[a] : 0;
    if (a < n_arr && p.esize[a] != 4 && p.esize[a] != 8)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nt = (n + TILE - 1) / TILE;
  const auto* fl = static_cast<const uint8_t*>(flags);
  if (nt > 0) count_tiles<<<(unsigned)nt, THREADS, 0, s>>>(fl, n, tile_counts);
  scan_tiles<<<1, SCAN_THREADS, 0, s>>>(tile_counts, nt, offsets, total);
  if (nt > 0)
    scatter_tiles<<<(unsigned)nt, THREADS, 0, s>>>(
        fl, n, tile_counts, offsets, p, pos, capacity);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Streaming digit histogram for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel genome_tpu/kernels/pallas_hist.py::
// digit_histogram (_hist_kernel). Counts digit = (u >> shift) & (2^nbits
// - 1) over n int64 keys, where u is the key's 64-bit JAX (hi, lo) value:
// the key itself, with bit 63 set for keys above INT64_MAX - 2^32 (the
// port's form of the JAX sentinel pairs, hi = 0xFFFFFFFF; keys.py). The
// output holds 2^nbits uint64 counts; the entry point zeroes it.
//
// What bounds it on this card: memory bandwidth, the keys read once (8 B
// a key; 0.2113 ms for the 88.5 M-key count stream at 3.35 TB/s). The TPU
// kernel compares each tile with every bin, because the TPU has no vector
// scatter. Here a call is one memset of the output and one launch: a
// persistent grid of one wave walks the stream with 16-byte loads (UNROLL
// in flight a thread), and each block counts into 32-bit counters in
// shared memory, one plain atomic add a key.
//
// No __match_any_sync: the match costs in proportion to the distinct
// digits of a warp step, about 31 on random keys, and held the earlier
// form of this kernel at 3.6x its bound. This card's shared atomics take
// a warp of 32 distinct bins, or of one bin, at about the same cost, so
// plain adds run at the memory bound whatever the data (sorted, hot or
// random); warp aggregation by a shuffle and ballot measured no better.
//
// Regimes, by nbits:
// - up to 15 (128 KB of counters): the block's own shared memory holds
//   every bin; at the end each block adds its nonzero bins into the
//   output with one global atomic each.
// - 16 (256 KB, more than a block may hold): a thread block cluster of
//   two, block r holding bins r * 2^15 ... Each block reads its half of a
//   pair step once and stages the keys' 16-bit digits in its shared
//   memory (two stages). It arrives at the cluster barrier, counts the
//   digits of its half among its own keys, waits, and counts those among
//   its partner's staged digits, read through distributed shared memory.
//   (Adding into the partner's counters with remote atomics, or each
//   block reading all of the pair's keys itself, measured slower.)
// Integer atomics are exact in any order, so the result is exact. The
// counters are 32-bit: the grid has at least n / 2^31 blocks (pairs), so
// that none counts 2^32 keys.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int THREADS = 1024;
constexpr int UNROLL = 4;                   // 16-byte loads a thread a step
constexpr int SPAN = 2 * THREADS * UNROLL;  // keys a block step
constexpr int BLOCK_MAX_BITS = 15;
constexpr int MAX_BITS = 16;
constexpr int MAX_DEVICES = 64;
// INT64_MAX - 2^32: keys above it are sentinel pairs (hi = 0xFFFFFFFF)
constexpr long long NEAR_SENTINEL = 0x7FFFFFFEFFFFFFFFLL;
// a pair block stages a thread's 2 * UNROLL digits as UNROLL / 4 uint4s
constexpr int VECS = UNROLL / 4;
static_assert(UNROLL % 4 == 0, "a thread stages whole uint4s of digits");
// dynamic shared memory: a block's counters; a pair block's half of the
// counters and two stages of its digits
constexpr size_t BLOCK_SMEM = sizeof(unsigned) << BLOCK_MAX_BITS;
constexpr size_t PAIR_SMEM = (sizeof(unsigned) << (MAX_BITS - 1)) +
                             2 * VECS * THREADS * sizeof(uint4);

__device__ __forceinline__ unsigned digit_of(long long key, int shift,
                                             unsigned mask) {
  unsigned long long u = (unsigned long long)key;
  if (key > NEAR_SENTINEL) u |= 1ull << 63;
  return (unsigned)(u >> shift) & mask;
}

__device__ __forceinline__ void load_step(longlong2 (&v)[UNROLL],
                                          const long long* step) {
  const longlong2* p = reinterpret_cast<const longlong2*>(step) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) v[u] = p[u * THREADS];
}

// keys: 16-byte aligned, n of them; head: one more key before them (the
// unaligned first key of a view), or null.
__global__ void __launch_bounds__(THREADS)
    hist_block(const long long* __restrict__ keys, long long n,
               const long long* __restrict__ head, int shift, int nbits,
               unsigned long long* __restrict__ out) {
  extern __shared__ unsigned bins[];
  const int nbins = 1 << nbits;
  const unsigned mask = (unsigned)nbins - 1u;
  for (int b = threadIdx.x; b < nbins; b += THREADS) bins[b] = 0;
  __syncthreads();

  const long long steps = n / SPAN;  // whole block steps
  for (long long s = blockIdx.x; s < steps; s += gridDim.x) {
    longlong2 v[UNROLL];
    load_step(v, keys + s * SPAN);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      atomicAdd(&bins[digit_of(v[u].x, shift, mask)], 1u);
      atomicAdd(&bins[digit_of(v[u].y, shift, mask)], 1u);
    }
  }
  // the partial step, then the head key: one block each
  if (blockIdx.x == steps % gridDim.x)
    for (long long i = steps * SPAN + threadIdx.x; i < n; i += THREADS)
      atomicAdd(&bins[digit_of(keys[i], shift, mask)], 1u);
  if (head != nullptr && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    atomicAdd(&bins[digit_of(*head, shift, mask)], 1u);

  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += THREADS)
    if (const unsigned c = bins[b]) atomicAdd(&out[b], (unsigned long long)c);
}

// A pair block adds a 16-bit digit if it falls in its half of the bins.
__device__ __forceinline__ void add_own(unsigned* bins, unsigned d,
                                        unsigned rank) {
  if ((d >> (MAX_BITS - 1)) == rank)
    atomicAdd(&bins[d & ((1u << (MAX_BITS - 1)) - 1u)], 1u);
}

__device__ __forceinline__ void add_own2(unsigned* bins, unsigned w,
                                         unsigned rank) {
  add_own(bins, w & 0xFFFFu, rank);
  add_own(bins, w >> 16, rank);
}

// nbits = 16, launched in clusters of two. Pair step s covers 2 * SPAN
// keys; block r of the pair reads the r-th SPAN of them.
__global__ void __launch_bounds__(THREADS)
    hist_pair(const long long* __restrict__ keys, long long n,
              const long long* __restrict__ head, int shift,
              unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  constexpr int HALF = 1 << (MAX_BITS - 1);
  constexpr unsigned MASK = (1u << MAX_BITS) - 1u;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  unsigned* bins = smem;  // bins rank * HALF ... of the output
  // [2][VECS][THREADS]
  uint4* stage = reinterpret_cast<uint4*>(smem + HALF);
  const uint4* other = cluster.map_shared_rank(stage, (int)(rank ^ 1u));
  for (int b = threadIdx.x; b < HALF; b += THREADS) bins[b] = 0;
  __syncthreads();

  // both blocks of a pair run the same steps, so every cluster barrier
  // below is reached by both
  const long long unit = blockIdx.x >> 1, units = gridDim.x >> 1;
  const long long steps = n / (2 * SPAN);
  longlong2 v[UNROLL];
  if (unit < steps) load_step(v, keys + (2 * unit + rank) * SPAN);
  for (long long s = unit, k = 0; s < steps; s += units, k ^= 1) {
    unsigned w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      w[u] = digit_of(v[u].x, shift, MASK) |
             digit_of(v[u].y, shift, MASK) << 16;
    // stage k was last read by the partner two steps ago, before it
    // arrived at the previous step's barrier
    uint4* mine = stage + k * VECS * THREADS + threadIdx.x;
#pragma unroll
    for (int j = 0; j < VECS; ++j)
      mine[j * THREADS] =
          make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
    if (s + units < steps)
      load_step(v, keys + (2 * (s + units) + rank) * SPAN);
    // arrive, count this block's own digits, then wait for the partner's
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_own2(bins, w[u], rank);
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    const uint4* theirs = other + k * VECS * THREADS + threadIdx.x;
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      const uint4 p = theirs[j * THREADS];
      add_own2(bins, p.x, rank);
      add_own2(bins, p.y, rank);
      add_own2(bins, p.z, rank);
      add_own2(bins, p.w, rank);
    }
  }
  // the partial pair step, then the head key: both blocks of one pair
  // read them and count their own halves
  if (unit == steps % units)
    for (long long i = steps * 2 * SPAN + threadIdx.x; i < n; i += THREADS)
      add_own(bins, digit_of(keys[i], shift, MASK), rank);
  if (head != nullptr && unit == units - 1 && threadIdx.x == 0)
    add_own(bins, digit_of(*head, shift, MASK), rank);

  // the partner has read this block's stage for the last time
  cluster.sync();
  unsigned long long* half_out = out + (size_t)rank * HALF;
  for (int b = threadIdx.x; b < HALF; b += THREADS)
    if (const unsigned c = bins[b])
      atomicAdd(&half_out[b], (unsigned long long)c);
}

// Blocks (hist_block) or pairs (hist_pair) resident in one wave, per
// device and nbits; 0 until the first call asks.
static int g_resident[MAX_DEVICES][MAX_BITS + 1];

static cudaError_t launch(const long long* keys, long long n,
                          const long long* head, int shift, int nbits,
                          unsigned long long* out, cudaStream_t s) {
  const bool pair = nbits > BLOCK_MAX_BITS;
  const void* fn = pair ? (const void*)hist_pair : (const void*)hist_block;
  const size_t smem = pair ? PAIR_SMEM : sizeof(unsigned) << nbits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = pair ? 1 : 0;
  int& resident = g_resident[dev][nbits];
  if (resident == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(pair ? PAIR_SMEM : BLOCK_SMEM));
    if (err != cudaSuccess) return err;
    int units = 0;
    if (pair) {
      cfg.gridDim = dim3(2);
      err = cudaOccupancyMaxActiveClusters(&units, fn, &cfg);
    } else {
      int sms = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&units, fn,
                                                            THREADS, smem);
      units *= sms;
    }
    if (err != cudaSuccess) return err;
    if (units <= 0) return cudaErrorInvalidConfiguration;
    resident = units;
  }
  // one unit (block or pair) a step at most, one wave at most, and enough
  // that no unit counts 2^32 keys
  const long long span = pair ? 2 * SPAN : SPAN;
  long long units = (n + span - 1) / span;
  if (units > resident) units = resident;
  if (units < (n >> 31) + 1) units = (n >> 31) + 1;
  cfg.gridDim = dim3((unsigned)(pair ? 2 * units : units));
  err = pair ? cudaLaunchKernelEx(&cfg, hist_pair, keys, n, head, shift, out)
             : cudaLaunchKernelEx(&cfg, hist_block, keys, n, head, shift,
                                  nbits, out);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

extern "C" {

// Zeroes out (uint64[2^nbits]) on the stream, then launches the histogram
// there. Returns a cudaError_t (0 = launched).
int digit_histogram_cuda(const void* keys, long long n, int nbits, int shift,
                         void* out, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(keys);
  if (n <= 0 || nbits < 1 || nbits > MAX_BITS || shift < 0 ||
      shift + nbits > 64 || (addr & 7) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(unsigned long long) << nbits, s);
  if (err != cudaSuccess) return (int)err;
  const auto* k = static_cast<const long long*>(keys);
  const long long* head = nullptr;
  if (addr & 15) {  // the body starts on the next 16-byte line
    head = k++;
    --n;
  }
  return (int)launch(k, n, head, shift, nbits,
                     static_cast<unsigned long long*>(out), s);
}

}  // extern "C"

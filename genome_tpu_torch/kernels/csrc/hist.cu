// Streaming digit histogram for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel genome_tpu/kernels/pallas_hist.py::
// digit_histogram (_hist_kernel). Counts digit = (u >> shift) & (2^nbits
// - 1) over n int64 keys, where u is the key's 64-bit JAX (hi, lo) value:
// the key itself, with bit 63 set for keys above INT64_MAX - 2^32 (the
// port's form of the JAX sentinel pairs, hi = 0xFFFFFFFF; keys.py). The
// output holds 2^nbits uint64 counts, zeroed by the caller.
//
// The TPU kernel loops over every bin and compares the whole tile with it
// (2^nbits vector passes per tile, one output row per tile, summed by
// XLA), because the TPU has no vector scatter. Hopper has shared-memory
// atomics, so here one launch does it all: each block of a grid sized to
// fill the card walks the stream with 16-byte loads (two keys a thread,
// UNROLL loads in flight), keeps a private histogram in shared memory and
// adds it into the output with one global atomic per nonzero bin at the
// end. Above 2^SHARED_MAX_BITS bins (32 KB of counters) the bins stay in
// device memory and every add is a global atomic. Integer atomics are
// exact in any order, so the result is exact.
//
// What bounds it on this card: memory bandwidth, the keys read once (8 B
// a key). A sorted or all-equal stream sends a whole warp to one bin,
// where plain atomics would serialise 32 deep; each add is therefore
// warp-aggregated (__match_any_sync, one add of popc(peers) by the lowest
// lane of each group).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define UNROLL 4
#define SHARED_MAX_BITS 13
#define FULL_MASK 0xffffffffu
// INT64_MAX - 2^32: keys above it are sentinel pairs (hi = 0xFFFFFFFF)
#define NEAR_SENTINEL 0x7FFFFFFEFFFFFFFFLL

__device__ __forceinline__ unsigned digit_of(long long key, int shift,
                                             unsigned mask) {
  unsigned long long u = (unsigned long long)key;
  if (key > NEAR_SENTINEL) u |= 1ull << 63;
  return (unsigned)(u >> shift) & mask;
}

// Every lane of the warp calls this; lanes with valid = false add nothing.
template <typename Counter>
__device__ __forceinline__ void add_digit(Counter* bins, unsigned d,
                                          bool valid) {
  const unsigned active = __ballot_sync(FULL_MASK, valid);
  if (!valid) return;
  const unsigned peers = __match_any_sync(active, d);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&bins[d], (Counter)__popc(peers));
}

// SHARED: bins in shared memory (dynamic, 4 B each), else straight into
// `out`. VEC: keys 16-byte aligned, loaded as longlong2.
template <bool SHARED, bool VEC>
__global__ void __launch_bounds__(THREADS)
    hist_kernel(const long long* __restrict__ keys, long long n, int shift,
                int nbits, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned sh_bins[];
  const int nbins = 1 << nbits;
  const unsigned mask = (unsigned)nbins - 1u;
  if (SHARED) {
    for (int b = threadIdx.x; b < nbins; b += THREADS) sh_bins[b] = 0;
    __syncthreads();
  }
  // one block step covers UNROLL x THREADS pairs of keys; the loop bound
  // is uniform over the block, so every warp stays converged
  const long long span = 2LL * THREADS * UNROLL;
  const long long stride = span * gridDim.x;
  for (long long base = span * blockIdx.x; base < n; base += stride) {
    long long k[2 * UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + 2LL * (u * THREADS + threadIdx.x);
      k[2 * u] = k[2 * u + 1] = 0;
      if (VEC && i + 1 < n) {
        const longlong2 p = *reinterpret_cast<const longlong2*>(keys + i);
        k[2 * u] = p.x;
        k[2 * u + 1] = p.y;
      } else {
        if (i < n) k[2 * u] = keys[i];
        if (i + 1 < n) k[2 * u + 1] = keys[i + 1];
      }
    }
#pragma unroll
    for (int e = 0; e < 2 * UNROLL; ++e) {
      const long long i = base + 2LL * ((e / 2) * THREADS + threadIdx.x)
                          + (e & 1);
      const unsigned d = digit_of(k[e], shift, mask);
      if (SHARED)
        add_digit<unsigned>(sh_bins, d, i < n);
      else
        add_digit<unsigned long long>(out, d, i < n);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += THREADS)
      if (sh_bins[b]) atomicAdd(&out[b], (unsigned long long)sh_bins[b]);
  }
}

template <bool SHARED, bool VEC>
static int launch(const long long* keys, long long n, int shift, int nbits,
                  unsigned long long* out, cudaStream_t s) {
  const size_t smem = SHARED ? sizeof(unsigned) << nbits : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hist_kernel<SHARED, VEC>, THREADS, smem);
  const long long span = 2LL * THREADS * UNROLL;
  long long blocks = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > (n + span - 1) / span) blocks = (n + span - 1) / span;
  // shared counters are 32-bit: no block may see 2^32 keys
  if (blocks < (n >> 31) + 1) blocks = (n >> 31) + 1;
  hist_kernel<SHARED, VEC><<<(unsigned)blocks, THREADS, smem, s>>>(
      keys, n, shift, nbits, out);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns a cudaError_t (0 = launched). out: uint64[2^nbits], zeroed.
int digit_histogram_cuda(const void* keys, long long n, int nbits, int shift,
                         void* out, void* stream) {
  if (n <= 0 || nbits < 1 || nbits > 16 || shift < 0 || shift + nbits > 64)
    return (int)cudaErrorInvalidValue;
  const auto* k = static_cast<const long long*>(keys);
  auto* o = static_cast<unsigned long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const bool shared = nbits <= SHARED_MAX_BITS;
  if (shared)
    return vec ? launch<true, true>(k, n, shift, nbits, o, s)
               : launch<true, false>(k, n, shift, nbits, o, s);
  return vec ? launch<false, true>(k, n, shift, nbits, o, s)
             : launch<false, false>(k, n, shift, nbits, o, s);
}

}  // extern "C"

// Ordered stream compaction for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel genome_tpu/kernels/compact.py::
// compact_flagged (_compact_kernel). Flagged elements of up to MAX_ARR
// payload arrays (4- or 8-byte elements) go densely and in order to the
// front of their outputs, with their int64 source positions (pos) and
// the exact flagged total. Slots >= capacity are dropped; the total stays
// exact above capacity and the kernel writes overflow = total > capacity
// itself (the TPU's one-chunk conservative margin was a DMA-alignment
// artifact). Output slots >= total are left unwritten.
//
// What bounds it on an H100: bytes. The flags are read once, each kept
// payload element is read once and each output element is written once,
// over 3.35 TB/s; there is no arithmetic to speak of. The TPU design
// (in-VMEM binary-shift compaction riding a sequential grid) has no
// meaning on a card whose blocks run in any order, so this is one pass
// with decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back"): one memset of the look-back
// words and one launch a call, both on the caller's stream.
//   - A block takes its tile id from a global counter, so a tile waits
//     only on tiles already started and the look-back always progresses.
//   - Each thread loads its 32 flags as two 16-byte vectors, once, and
//     counts them bytewise (__vcmpne4, __popc). Tiles are aligned to 16
//     bytes of the flags' address, so any view works: only the stream's
//     first and last partial vectors fall back to scalar loads.
//   - A block-wide scan of the counts gives each flag its in-tile rank;
//     the tile publishes its aggregate in one 64-bit status word (state
//     in the top bits, count below; release store, acquire load), then
//     warp 0 sums its predecessors 32 at a time back to the nearest
//     inclusive prefix and publishes its own.
//   - The flagged in-tile indices are staged in shared memory in stream
//     order, so pos and every payload are written by the whole block as
//     contiguous runs (coalesced stores; gathers of increasing sources).
//     The payload element size is dispatched once per array and tile,
//     never per element. A tile at or past capacity still publishes its
//     count, so the total stays exact, and writes nothing.
//   - The last tile writes the total and the overflow flag.
// A block is 256 threads, 28 registers each and 16,432 bytes of shared
// memory (ptxas, CUDA 12.8), so 8 blocks (64 warps) fit on an SM and
// 1,056 tiles are in flight on the card's 132 SMs. Deterministic and
// order-preserving. Indexing is 64-bit throughout.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define PER_THREAD 32                   // flags a thread (mask bits)
#define TILE (THREADS * PER_THREAD)     // 8192 flags a block
#define VEC 16
#define MAX_ARR 6
#define FULL_MASK 0xffffffffu

// a tile's status word: state in the top two bits, its count below
#define ST_AGGREGATE (1ull << 62)  // the tile's own count
#define ST_PREFIX (2ull << 62)     // the count of this and every earlier tile
#define ST_COUNT (ST_AGGREGATE - 1)

// scratch words (int64): the call's outputs, then what the memset clears
#define W_TOTAL 0
#define W_OVERFLOW 1
#define W_NEXT 2    // the next tile id to hand out
#define W_STATUS 3  // one status word per tile from here

struct Payloads {
  const void* src[MAX_ARR];
  void* dst[MAX_ARR];
  int n_arr;
  int wide;  // bit a set: array a has 8-byte elements
};

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// 4 flag bytes -> 4 bits, byte b to bit b
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The 16 flags at aligned position v of the stream shifted right by
// `shift` (stream index v + b - shift), as bits; none outside [0, n).
__device__ __forceinline__ unsigned flag_bits16(const uint8_t* flags,
                                                long long v, long long shift,
                                                long long n) {
  if (v >= shift && v + VEC <= shift + n) {
    const uint4 q =
        __ldcs(reinterpret_cast<const uint4*>(flags + (v - shift)));
    return nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8
        | nibble(q.w) << 12;
  }
  unsigned m = 0;  // the stream's first or last partial vector
  for (int b = 0; b < VEC; ++b) {
    const long long i = v + b - shift;
    if (i >= 0 && i < n && flags[i]) m |= 1u << b;
  }
  return m;
}

// d[j] = src[ibase + idx[j]] for j < lim, the block's threads striding j
template <typename T>
__device__ __forceinline__ void gather(const void* src, void* dst,
                                       const uint16_t* idx, int lim,
                                       long long ibase) {
  const T* __restrict__ s = static_cast<const T*>(src);
  T* __restrict__ d = static_cast<T*>(dst);
#pragma unroll 4
  for (int j = threadIdx.x; j < lim; j += THREADS) d[j] = s[ibase + idx[j]];
}

__global__ void __launch_bounds__(THREADS)
compact_tiles(const uint8_t* __restrict__ flags, long long n, long long shift,
              long long nt, Payloads p, long long* __restrict__ pos,
              long long capacity, unsigned long long* __restrict__ scratch) {
  __shared__ uint16_t s_idx[TILE];  // flagged in-tile indices, by rank
  __shared__ int s_warp[WARPS];
  __shared__ long long s_tile, s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* status = scratch + W_STATUS;

  if (tid == 0)
    s_tile = (long long)atomicAdd(scratch + W_NEXT, 1ull);
  __syncthreads();
  const long long tile = s_tile;

  // this thread's PER_THREAD flags, read once
  const long long v = tile * TILE + tid * PER_THREAD;
  unsigned mask = 0;  // bit b: flag v + b
#pragma unroll
  for (int c = 0; c < PER_THREAD / VEC; ++c)
    mask |= flag_bits16(flags, v + c * VEC, shift, n) << (c * VEC);

  // block-wide exclusive scan of the counts
  const int cnt = __popc(mask);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int rank = incl - cnt, agg = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_warp[w];
    rank += w < warp ? c : 0;
    agg += c;
  }

  // publish at once, so no successor waits on this tile's look-back
  if (tid == 0)
    store_release(status + tile, (tile == 0 ? ST_PREFIX : ST_AGGREGATE)
                                     | (unsigned long long)agg);

  for (unsigned m = mask; m; m &= m - 1)
    s_idx[rank++] = (uint16_t)(tid * PER_THREAD + __ffs(m) - 1);

  // decoupled look-back: warp 0, lane l reads tile - 1 - l of a window
  if (warp == 0) {
    unsigned long long excl = 0;
    for (long long last = tile - 1; last >= 0; last -= 32) {
      const long long j = last - lane;
      unsigned long long s;
      do {  // before tile 0: an empty prefix
        s = j >= 0 ? load_acquire(status + j) : ST_PREFIX;
      } while (__any_sync(FULL_MASK, s < ST_AGGREGATE));
      const unsigned pref = __ballot_sync(FULL_MASK, s >= ST_PREFIX);
      const int first = pref ? __ffs(pref) - 1 : 32;  // nearest prefix
      // aggregates of the nearer tiles, each below 2^14
      excl += __reduce_add_sync(
          FULL_MASK, lane < first ? (unsigned)(s & ST_COUNT) : 0u);
      if (pref) {
        excl += __shfl_sync(FULL_MASK, s, first) & ST_COUNT;
        break;
      }
    }
    if (lane == 0) {
      const unsigned long long incl_tile = excl + agg;
      if (tile > 0) store_release(status + tile, ST_PREFIX | incl_tile);
      s_excl = (long long)excl;
      if (tile == nt - 1) {
        scratch[W_TOTAL] = incl_tile;
        scratch[W_OVERFLOW] = (long long)incl_tile > capacity;
      }
    }
  }
  __syncthreads();

  const long long off = s_excl;
  if (off >= capacity) return;
  const int lim = (int)(agg < capacity - off ? agg : capacity - off);
  const long long ibase = tile * TILE - shift;  // stream index of slot 0
  long long* __restrict__ pout = pos + off;
#pragma unroll 4
  for (int j = tid; j < lim; j += THREADS) pout[j] = ibase + s_idx[j];
#pragma unroll
  for (int a = 0; a < MAX_ARR; ++a) {
    if (a >= p.n_arr) break;
    if (p.wide >> a & 1)
      gather<long long>(p.src[a], static_cast<long long*>(p.dst[a]) + off,
                        s_idx, lim, ibase);
    else
      gather<int>(p.src[a], static_cast<int*>(p.dst[a]) + off, s_idx, lim,
                  ibase);
  }
}

extern "C" {

long long compact_tile_size(void) { return TILE; }

// Returns a cudaError_t (0 = launched). srcs/dsts: n_arr payload arrays
// (the rest ignored), bit a of `wide` set where array a has 8-byte
// elements. scratch: int64[scratch_words], at least 3 + n / TILE + 2
// words; on return word 0 holds the total and word 1 the overflow flag.
int compact_flagged_cuda(const void* flags, long long n, long long capacity,
                         int n_arr, int wide, const void* src0,
                         const void* src1, const void* src2, const void* src3,
                         const void* src4, const void* src5, void* dst0,
                         void* dst1, void* dst2, void* dst3, void* dst4,
                         void* dst5, long long* pos, long long* scratch,
                         long long scratch_words, void* stream) {
  if (n < 0 || capacity < 0 || n_arr < 0 || n_arr > MAX_ARR
      || (wide >> n_arr) != 0)
    return (int)cudaErrorInvalidValue;
  const Payloads p = {{src0, src1, src2, src3, src4, src5},
                      {dst0, dst1, dst2, dst3, dst4, dst5}, n_arr, wide};
  const long long shift = (long long)((uintptr_t)flags & (VEC - 1));
  long long nt = (n + shift + TILE - 1) / TILE;
  if (nt == 0) nt = 1;  // one tile writes the zero total
  if (scratch_words < W_STATUS + nt || nt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch + W_NEXT, 0,
                                    (size_t)(1 + nt) * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  compact_tiles<<<(unsigned)nt, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(flags), n, shift, nt, p, pos, capacity,
      reinterpret_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}

}  // extern "C"

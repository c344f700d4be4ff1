// Bitonic block sort and bitonic block merge for Hopper (sm_90a), bound
// with ctypes.
//
// Replaces the Pallas TPU kernels genome_tpu/kernels/bitonic.py::
// sort_blocks (_sort_kernel) and merge_blocks (_merge_kernel). Each
// independent `block`-element run of up to MAX_ARR arrays (4- or 8-byte
// elements, mixed) is sorted ascending, lexicographically on the first
// num_keys arrays (signed compare), the rest carried. The network is the
// TPU kernel's, stage for stage: phases kk = 2, 4, ..., block (merge: only
// kk = block), distances j = kk/2 ... 1, partner i ^ j, the phase
// direction bit (i & kk) of the in-block index, and the same tie rule (a
// pair swaps only when strictly out of order). So the output equals the
// plain version (kernels/bitonic.py) bit for bit, payloads among equal
// keys included.
//
// A block of 65536 int64 keys is 512 KiB, more than the 227 KiB of shared
// memory one CTA can opt into, and blocks have no VMEM-sized home. So the
// design splits the network by distance:
//   - stages_tile: one CTA per TILE-element tile holds every array's tile
//     in dynamic shared memory and runs all stages of one phase with
//     j < TILE (or, first, the whole network up to kk = TILE), with a
//     __syncthreads() between stages;
//   - stage_global: a stage with j >= TILE is one grid-wide
//     compare-exchange launch over device memory.
// TILE is the largest power of two <= block whose tile of every array fits
// in the opt-in shared memory. The first launch reads the inputs and
// writes the outputs; every later launch works in place on the outputs.
//
// What bounds it: the network moves each element log2(block) * (log2(block)
// + 1) / 2 times through shared memory and once per global stage through
// device memory, so it runs far above the one-read, one-write bandwidth
// bound that chip_smoke.py reports beside it. Indexing is 64-bit: the
// count-site call pads to 2^27 elements.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_ARR 4
#define TILE_THREADS 1024
#define GLOBAL_THREADS 256

struct Arrays {
  const void* src[MAX_ARR];
  void* dst[MAX_ARR];
  int esize[MAX_ARR];
  int n_arr;
  int num_keys;
};

__device__ __forceinline__ long long load(const void* p, int es, long long i) {
  return es == 8 ? static_cast<const long long*>(p)[i]
                 : (long long)static_cast<const int*>(p)[i];
}

__device__ __forceinline__ void store(void* p, int es, long long i,
                                      long long v) {
  if (es == 8)
    static_cast<long long*>(p)[i] = v;
  else
    static_cast<int*>(p)[i] = (int)v;
}

// The TPU kernel's rule: the lower element takes its partner when
// (ascending and a > b) or (descending and a < b); ties never swap.
__device__ __forceinline__ bool swaps(long long a0, long long b0,
                                      long long a1, long long b1,
                                      int num_keys, bool desc) {
  bool gt = a0 > b0, eq = a0 == b0;
  if (num_keys == 2) {
    gt = gt || (eq && a1 > b1);
    eq = eq && a1 == b1;
  }
  return desc ? (!gt && !eq) : gt;
}

// One stage at distance j >= TILE over the whole stream (grid-stride).
__global__ void stage_global(Arrays A, long long n, long long j, long long kk,
                             long long block) {
  const long long pairs = n >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool inplace = A.src[0] == A.dst[0];
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pairs; p += stride) {
    const long long i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const long long q = i + j;
    // bit kk of i is bit kk of its in-block index (kk < block, powers of 2)
    const bool desc = kk < block && (i & kk) != 0;
    const long long a0 = load(A.src[0], A.esize[0], i);
    const long long b0 = load(A.src[0], A.esize[0], q);
    long long a1 = 0, b1 = 0;
    if (A.num_keys == 2) {
      a1 = load(A.src[1], A.esize[1], i);
      b1 = load(A.src[1], A.esize[1], q);
    }
    const bool s = swaps(a0, b0, a1, b1, A.num_keys, desc);
    if (!s && inplace) continue;
    for (int a = 0; a < A.n_arr; ++a) {
      const long long va = load(A.src[a], A.esize[a], i);
      const long long vb = load(A.src[a], A.esize[a], q);
      store(A.dst[a], A.esize[a], i, s ? vb : va);
      store(A.dst[a], A.esize[a], q, s ? va : vb);
    }
  }
}

extern __shared__ __align__(16) unsigned char smem[];

__device__ __forceinline__ long long sload(const unsigned char* p, int es,
                                           int i) {
  return es == 8 ? reinterpret_cast<const long long*>(p)[i]
                 : (long long)reinterpret_cast<const int*>(p)[i];
}

__device__ __forceinline__ void sstore(unsigned char* p, int es, int i,
                                       long long v) {
  if (es == 8)
    reinterpret_cast<long long*>(p)[i] = v;
  else
    reinterpret_cast<int*>(p)[i] = (int)v;
}

// One stage at distance j < tile inside the shared-memory tile.
__device__ __forceinline__ void tile_stage(unsigned char* const* sm,
                                           const Arrays& A, int tile,
                                           long long base, int j,
                                           long long kk, long long block) {
  for (int p = threadIdx.x; p < (tile >> 1); p += blockDim.x) {
    const int l = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int r = l + j;
    const bool desc = kk < block && ((base + l) & kk) != 0;
    const long long a0 = sload(sm[0], A.esize[0], l);
    const long long b0 = sload(sm[0], A.esize[0], r);
    long long a1 = 0, b1 = 0;
    if (A.num_keys == 2) {
      a1 = sload(sm[1], A.esize[1], l);
      b1 = sload(sm[1], A.esize[1], r);
    }
    if (swaps(a0, b0, a1, b1, A.num_keys, desc)) {
      for (int a = 0; a < A.n_arr; ++a) {
        const long long va = sload(sm[a], A.esize[a], l);
        const long long vb = sload(sm[a], A.esize[a], r);
        sstore(sm[a], A.esize[a], l, vb);
        sstore(sm[a], A.esize[a], r, va);
      }
    }
  }
  __syncthreads();
}

// One CTA per tile. full_sort: phases kk = 2 .. tile, every stage;
// otherwise the stages j = tile/2 .. 1 of the one phase kk.
__global__ void stages_tile(Arrays A, int tile, long long block,
                            int full_sort, long long kk) {
  unsigned char* sm[MAX_ARR];
  size_t off = 0;
  for (int a = 0; a < A.n_arr; ++a) {
    sm[a] = smem + off;
    off += (size_t)tile * A.esize[a];
  }
  const long long base = (long long)blockIdx.x * tile;
  for (int a = 0; a < A.n_arr; ++a)
    for (int l = threadIdx.x; l < tile; l += blockDim.x)
      sstore(sm[a], A.esize[a], l, load(A.src[a], A.esize[a], base + l));
  __syncthreads();
  if (full_sort) {
    for (int k2 = 2; k2 <= tile; k2 <<= 1)
      for (int j = k2 >> 1; j >= 1; j >>= 1)
        tile_stage(sm, A, tile, base, j, k2, block);
  } else {
    for (int j = tile >> 1; j >= 1; j >>= 1)
      tile_stage(sm, A, tile, base, j, kk, block);
  }
  for (int a = 0; a < A.n_arr; ++a)
    for (int l = threadIdx.x; l < tile; l += blockDim.x)
      store(A.dst[a], A.esize[a], base + l, sload(sm[a], A.esize[a], l));
}

static long long smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

extern "C" {

// The tile the kernels use for `block` and this many bytes per element
// (summed over the arrays): the largest power of two <= block that fits.
long long bitonic_tile(int bytes_per_elem, long long block) {
  const long long cap = smem_optin();
  long long t = block;
  while (t > 2 && t * bytes_per_elem > cap) t >>= 1;
  return t;
}

// Returns a cudaError_t (0 = launched). merge_only: run the kk = block
// phase only (merge_blocks); else the whole network (sort_blocks).
int bitonic_cuda(long long n, int n_arr, const void* const* srcs,
                 void* const* dsts, const int* esizes, int num_keys,
                 long long block, int merge_only, void* stream) {
  if (n_arr < 1 || n_arr > MAX_ARR || num_keys < 1 || num_keys > 2 ||
      num_keys > n_arr || block < 2 || (block & (block - 1)) != 0 || n < 0 ||
      n % block != 0)
    return (int)cudaErrorInvalidValue;
  Arrays A;
  A.n_arr = n_arr;
  A.num_keys = num_keys;
  int bytes = 0;
  for (int a = 0; a < MAX_ARR; ++a) {
    A.src[a] = a < n_arr ? srcs[a] : nullptr;
    A.dst[a] = a < n_arr ? dsts[a] : nullptr;
    A.esize[a] = a < n_arr ? esizes[a] : 0;
    if (a < n_arr && A.esize[a] != 4 && A.esize[a] != 8)
      return (int)cudaErrorInvalidValue;
    bytes += A.esize[a];
  }
  if (n == 0) return (int)cudaSuccess;
  const long long tile = bitonic_tile(bytes, block);
  const size_t shmem = (size_t)tile * bytes;
  if (tile < 2 || (long long)shmem > smem_optin())
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stages_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tthreads = tile / 2 < TILE_THREADS ? (int)(tile / 2) : TILE_THREADS;
  const unsigned n_tiles = (unsigned)(n / tile);
  long long gblocks = (n / 2 + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  if (gblocks > 132 * 32) gblocks = 132 * 32;
  Arrays cur = A;  // after the first launch: in place on the outputs
  Arrays inplace = A;
  for (int a = 0; a < n_arr; ++a) inplace.src[a] = A.dst[a];

  auto global = [&](long long j, long long kk) -> cudaError_t {
    stage_global<<<(unsigned)gblocks, GLOBAL_THREADS, 0, s>>>(cur, n, j, kk,
                                                              block);
    cur = inplace;
    return cudaGetLastError();
  };
  auto tiled = [&](int full, long long kk) -> cudaError_t {
    stages_tile<<<n_tiles, tthreads, shmem, s>>>(cur, (int)tile, block, full,
                                                 kk);
    cur = inplace;
    return cudaGetLastError();
  };

  if (!merge_only) {
    if ((err = tiled(1, 0)) != cudaSuccess) return (int)err;
    for (long long kk = 2 * tile; kk <= block; kk <<= 1) {
      for (long long j = kk >> 1; j >= tile; j >>= 1)
        if ((err = global(j, kk)) != cudaSuccess) return (int)err;
      if ((err = tiled(0, kk)) != cudaSuccess) return (int)err;
    }
  } else {
    for (long long j = block >> 1; j >= tile; j >>= 1)
      if ((err = global(j, block)) != cudaSuccess) return (int)err;
    if ((err = tiled(0, block)) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"

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
// pair swaps only when strictly out of order). Within a stage the pairs
// are independent, so the output equals the plain version
// (kernels/bitonic.py) bit for bit, payloads among equal keys included.
//
// What bounds it: a block of 65536 int64 keys takes 136 stages of 32768
// compare-exchanges each and does not fit one SM's shared memory. A
// network whose working set lives in shared memory pays a load, a store
// and a barrier per stage. So the tile kernel keeps it in registers, and
// its stages are bound by the instructions that issue them (a 64-bit
// compare and selects per compare-exchange, two shuffles per element on a
// lane bit); the stages at or above the tile are bound by device memory.
//   - stages_tile<NARR, NK>: one CTA of THREADS threads sorts a TILE =
//     THREADS * E element tile; every array is widened to int64 in
//     registers at load (int32 sign-extended, so signed order holds) and
//     narrowed at store, so no element size reaches the network. Under the
//     working layout A (thread t holds tile indices t*E ... t*E + E-1) the
//     index bits fall in three groups: the low log2(E) are register bits
//     (compare-exchanges between a thread's own registers), the next 5
//     lane bits (__shfl_xor_sync), the top ones warp bits. Stages on warp
//     bits run under layout C (thread t holds r*THREADS + t), where they
//     are register bits: a phase that reaches them re-lays the tile out
//     through shared memory once to C and once back, so shared memory is
//     touched twice per such phase instead of once per stage, with a
//     barrier only around the re-layouts (10 re-layouts for a 16384-key
//     network of 105 stages). Each element's direction bit is taken from
//     its tile index under the current layout. Device memory is read and
//     written under C, coalesced. Phases stop at kk = block, so one tile
//     may hold several blocks (block >= 256).
//   - stage_global<NARR, NK>: a stage with j >= TILE is one grid-wide
//     compare-exchange launch over device memory; the first launch reads
//     the inputs and writes the outputs, every later one works in place.
// TILE (the C function bitonic_tile) is 16384 for one array, 8192 for two,
// 4096 for three or four: 512 threads of 32 registers for one array, 256
// threads of 32 (two arrays) or 16 (three or four) otherwise, so the tile
// takes 64 to 128 of a thread's registers for data and the re-layout
// buffer at most 136 KiB of shared memory: one CTA on each SM. Indexing is
// 64-bit: the count-site call pads to 2^27.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_ARR 4
#define GLOBAL_THREADS 256

struct Arrays {
  const void* src[MAX_ARR];
  void* dst[MAX_ARR];
  int esize[MAX_ARR];
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

// A compile-time loop: f(Int<I>{}) for I = B .. N-1.
template <int V>
struct Int {
  static constexpr int value = V;
};

template <int B, int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (B < N) {
    f(Int<B>{});
    unroll<B + 1, N>(f);
  }
}

// Lexicographic a > b on NK keys (a1, b1 unused for one key).
template <int NK>
__device__ __forceinline__ bool key_gt(long long a0, long long a1,
                                       long long b0, long long b1) {
  if constexpr (NK == 1)
    return a0 > b0;
  else
    return a0 > b0 || (a0 == b0 && a1 > b1);
}

// The TPU kernel's rule for the pair (lower x, upper y): swap when
// (ascending and x > y) or (descending and x < y); ties never swap. When
// every array is a key, a swap of equal elements changes nothing, so one
// compare serves both directions.
template <int NARR, int NK>
__device__ __forceinline__ bool swaps(long long x0, long long x1,
                                      long long y0, long long y1, bool desc) {
  if constexpr (NARR == NK)
    return key_gt<NK>(x0, x1, y0, y1) != desc;
  else
    return desc ? key_gt<NK>(y0, y1, x0, x1) : key_gt<NK>(x0, x1, y0, y1);
}

// Compare-exchange of a thread's registers R (lower) and S (upper).
template <int R, int S, int NARR, int NK, int E>
__device__ __forceinline__ void cx(long long (&v)[NARR][E], bool desc) {
  const bool s = swaps<NARR, NK>(v[0][R], NK == 2 ? v[NK - 1][R] : 0,
                                 v[0][S], NK == 2 ? v[NK - 1][S] : 0, desc);
#pragma unroll
  for (int a = 0; a < NARR; ++a) {
    const long long x = v[a][R], y = v[a][S];
    v[a][R] = s ? y : x;
    v[a][S] = s ? x : y;
  }
}

// Every pair of registers at distance J, one direction.
template <int J, int NARR, int NK, int E>
__device__ __forceinline__ void reg_stage(long long (&v)[NARR][E], bool desc) {
  unroll<0, E>([&](auto r) {
    constexpr int R = decltype(r)::value;
    if constexpr (!(R & J)) cx<R, R | J, NARR, NK, E>(v, desc);
  });
}

template <int X>
constexpr int log2i() {
  return X <= 1 ? 0 : 1 + log2i<X / 2>();
}

// The tile geometry of each array count: THREADS threads of E registers.
template <int NARR>
struct Tile {
  static constexpr int SIZE = NARR == 1 ? 16384 : NARR == 2 ? 8192 : 4096;
  static constexpr int THREADS = NARR == 1 ? 512 : 256;
  static constexpr int E = SIZE / THREADS;
  static constexpr int LE = log2i<E>();
  static_assert(THREADS / 32 <= E, "layout C must hold the warp bits");
};

// Rows of the tile under layout C from device memory (W: the stored
// element type), widened; the tail past n reads as 0.
template <class W, int E, int THREADS>
__device__ __forceinline__ void load_row(long long (&row)[E], const void* p,
                                         long long base, long long n) {
  const W* q = static_cast<const W*>(p) + base + threadIdx.x;
  if (base + (long long)E * THREADS <= n) {
#pragma unroll
    for (int r = 0; r < E; ++r) row[r] = q[r * THREADS];
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r)
      row[r] = base + r * THREADS + threadIdx.x < n ? q[r * THREADS] : 0;
  }
}

template <class W, int E, int THREADS>
__device__ __forceinline__ void store_row(const long long (&row)[E], void* p,
                                          long long base, long long n) {
  W* q = static_cast<W*>(p) + base + threadIdx.x;
  const bool whole = base + (long long)E * THREADS <= n;
#pragma unroll
  for (int r = 0; r < E; ++r)
    if (whole || base + r * THREADS + threadIdx.x < n)
      q[r * THREADS] = (W)row[r];
}

// Re-layout through shared memory: A -> C (TO_C) or C -> A. Layout A: the
// thread's register r is tile index t*E + r; layout C: r*THREADS + t. The
// shared tile stores index l at l + l/E (rows of E padded by one element):
// a warp's 8-byte accesses under either layout then hit 16 distinct bank
// pairs in each half-warp (E is a multiple of 16), and every address is a
// per-thread base plus a compile-time offset, so no address stays live in
// a register between re-layouts.
template <bool TO_C, int NARR, int E, int LE, int THREADS>
__device__ __forceinline__ void relayout(long long (&v)[NARR][E],
                                         long long* sm) {
  constexpr int ROWS = THREADS * (E + 1);  // one array's padded tile
  constexpr int CSTEP = THREADS + THREADS / E;
  static_assert(E % 16 == 0, "bank pairs");
  const int t = threadIdx.x;
  long long* const a_at = sm + t * (E + 1);     // + r: layout A
  long long* const c_at = sm + t + (t >> LE);   // + r * CSTEP: layout C
  __syncthreads();  // the previous re-layout's reads are done
#pragma unroll
  for (int a = 0; a < NARR; ++a)
#pragma unroll
    for (int r = 0; r < E; ++r)
      (TO_C ? a_at[a * ROWS + r] : c_at[a * ROWS + r * CSTEP]) = v[a][r];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NARR; ++a)
#pragma unroll
    for (int r = 0; r < E; ++r)
      v[a][r] = TO_C ? c_at[a * ROWS + r * CSTEP] : a_at[a * ROWS + r];
}

// A stage on a lane bit under layout A: lanes `m` apart exchange every
// register. Both lanes of a pair see the same two elements and so take the
// same decision; the lower lane keeps the minimum unless descending.
template <int NARR, int NK, int E>
__device__ __forceinline__ void shfl_stage(long long (&v)[NARR][E], int m,
                                           bool desc, int lane) {
  const bool lower = (lane & m) == 0;
  const bool want_min = lower != desc;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    long long o[NARR];
#pragma unroll
    for (int a = 0; a < NARR; ++a)
      o[a] = __shfl_xor_sync(0xffffffffu, v[a][r], m);
    const long long m1 = NK == 2 ? v[NK - 1][r] : 0;
    const long long o1 = NK == 2 ? o[NK - 1] : 0;
    bool take;
    if constexpr (NARR == NK)  // equal elements: taking either is the same
      take = key_gt<NK>(v[0][r], m1, o[0], o1) == want_min;
    else
      take = want_min ? key_gt<NK>(v[0][r], m1, o[0], o1)
                      : key_gt<NK>(o[0], o1, v[0][r], m1);
#pragma unroll
    for (int a = 0; a < NARR; ++a) v[a][r] = take ? o[a] : v[a][r];
  }
}

// One CTA per TILE elements of the stream (several blocks when block <
// TILE; the tail past n is padding that no real pair reaches). full: the
// phases kk = 2 .. min(block, TILE), every stage; otherwise the stages
// j = min(kk1, TILE)/2 .. 1 of the one phase kk1.
template <int NARR, int NK>
__global__ void __launch_bounds__(Tile<NARR>::THREADS, 1)
    stages_tile(Arrays A, long long n, long long block, int full,
                long long kk1) {
  using T = Tile<NARR>;
  constexpr int THREADS = T::THREADS, E = T::E, LE = T::LE, TILE = T::SIZE;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sm = reinterpret_cast<long long*>(smem);
  const int t = threadIdx.x, lane = t & 31;
  const long long base = (long long)blockIdx.x * TILE;
  long long v[NARR][E];

#pragma unroll
  for (int a = 0; a < NARR; ++a) {
    if (A.esize[a] == 8)
      load_row<long long, E, THREADS>(v[a], A.src[a], base, n);
    else
      load_row<int, E, THREADS>(v[a], A.src[a], base, n);
  }
  relayout<false, NARR, E, LE, THREADS>(v, sm);

  long long kk = kk1, kend = kk1;
  if (full) {
    // phases kk = 2 .. E/2 lie inside each thread's registers: the
    // direction bit kk is a register bit, known at compile time
    unroll<1, LE>([&](auto kb) {
      constexpr int KB = decltype(kb)::value;
      unroll<0, KB>([&](auto jb) {
        constexpr int J = 1 << (KB - 1 - decltype(jb)::value);
        unroll<0, E>([&](auto r) {
          constexpr int R = decltype(r)::value;
          if constexpr (!(R & J))
            cx<R, R | J, NARR, NK, E>(v, (R >> KB) & 1);
        });
      });
    });
    kk = E;
    kend = block < TILE ? block : TILE;
  }
  for (; kk <= kend; kk <<= 1) {
    const long long dmask = kk < block ? kk : 0;  // kk == block: ascending
    long long j = (kk < TILE ? kk : TILE) >> 1;
    if (j >= 32 * E) {  // stages on warp bits: under layout C
      relayout<true, NARR, E, LE, THREADS>(v, sm);
      unroll<0, LE>([&](auto i) {
        constexpr int RD = E >> (1 + decltype(i)::value);
        if ((long long)RD * THREADS <= j) {
          unroll<0, E>([&](auto r) {
            constexpr int R = decltype(r)::value;
            if constexpr (!(R & RD))
              cx<R, R | RD, NARR, NK, E>(
                  v, ((base + (long long)R * THREADS) & dmask) != 0);
          });
        }
      });
      relayout<false, NARR, E, LE, THREADS>(v, sm);
      j = THREADS / 2;
    }
    // under layout A bit kk >= E is a thread bit: one direction a thread
    const bool desc = ((base + (long long)t * E) & dmask) != 0;
    for (; j >= E; j >>= 1)
      shfl_stage<NARR, NK, E>(v, (int)(j >> LE), desc, lane);
    unroll<0, LE>([&](auto i) {
      reg_stage<(E >> (1 + decltype(i)::value)), NARR, NK, E>(v, desc);
    });
  }

  relayout<true, NARR, E, LE, THREADS>(v, sm);
#pragma unroll
  for (int a = 0; a < NARR; ++a) {
    if (A.esize[a] == 8)
      store_row<long long, E, THREADS>(v[a], A.dst[a], base, n);
    else
      store_row<int, E, THREADS>(v[a], A.dst[a], base, n);
  }
}

// One stage at distance j >= TILE over the whole stream (grid-stride).
template <int NARR, int NK>
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
    long long x[NARR], y[NARR];
#pragma unroll
    for (int a = 0; a < NK; ++a) {
      x[a] = load(A.src[a], A.esize[a], i);
      y[a] = load(A.src[a], A.esize[a], q);
    }
    // The strict rule, not swaps(): a tied pair is then never written back
    // in place, which saves device-memory traffic here.
    const bool s = desc ? key_gt<NK>(y[0], y[NK - 1], x[0], x[NK - 1])
                        : key_gt<NK>(x[0], x[NK - 1], y[0], y[NK - 1]);
    if (!s && inplace) continue;
#pragma unroll
    for (int a = NK; a < NARR; ++a) {
      x[a] = load(A.src[a], A.esize[a], i);
      y[a] = load(A.src[a], A.esize[a], q);
    }
#pragma unroll
    for (int a = 0; a < NARR; ++a) {
      store(A.dst[a], A.esize[a], i, s ? y[a] : x[a]);
      store(A.dst[a], A.esize[a], q, s ? x[a] : y[a]);
    }
  }
}

static long long smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

static long long tile_of(int n_arr) {
  switch (n_arr) {
    case 1: return Tile<1>::SIZE;
    case 2: return Tile<2>::SIZE;
    case 3: return Tile<3>::SIZE;
    case 4: return Tile<4>::SIZE;
  }
  return 0;
}

// The launch sequence: the tile kernel first (sort: the whole network up
// to kk = TILE; merge: after the global stages of kk = block), then per
// phase kk > TILE its stages j >= TILE as grid-wide launches and its
// stages j < TILE as one tile launch.
template <int NARR, int NK>
static cudaError_t run(const Arrays& A, long long n, long long block,
                       int merge_only, cudaStream_t s) {
  constexpr long long tile = Tile<NARR>::SIZE;
  constexpr int threads = Tile<NARR>::THREADS;
  const size_t shmem = (size_t)NARR * (tile + tile / Tile<NARR>::E) *
                       sizeof(long long);
  if ((long long)shmem > smem_optin()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stages_tile<NARR, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return err;
  const unsigned n_tiles = (unsigned)((n + tile - 1) / tile);
  long long gblocks = (n / 2 + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  if (gblocks > 132 * 32) gblocks = 132 * 32;
  Arrays cur = A;  // after the first launch: in place on the outputs
  Arrays inplace = A;
  for (int a = 0; a < NARR; ++a) inplace.src[a] = A.dst[a];

  auto global = [&](long long j, long long kk) -> cudaError_t {
    stage_global<NARR, NK><<<(unsigned)gblocks, GLOBAL_THREADS, 0, s>>>(
        cur, n, j, kk, block);
    cur = inplace;
    return cudaGetLastError();
  };
  auto tiled = [&](int full, long long kk) -> cudaError_t {
    stages_tile<NARR, NK><<<n_tiles, threads, shmem, s>>>(cur, n, block, full,
                                                         kk);
    cur = inplace;
    return cudaGetLastError();
  };

  if (!merge_only) {
    if ((err = tiled(1, 0)) != cudaSuccess) return err;
    for (long long kk = 2 * tile; kk <= block; kk <<= 1) {
      for (long long j = kk >> 1; j >= tile; j >>= 1)
        if ((err = global(j, kk)) != cudaSuccess) return err;
      if ((err = tiled(0, kk)) != cudaSuccess) return err;
    }
  } else {
    for (long long j = block >> 1; j >= tile; j >>= 1)
      if ((err = global(j, block)) != cudaSuccess) return err;
    if ((err = tiled(0, block)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" {

// The tile the kernels use for `block` and n_arr arrays: min(block, TILE).
long long bitonic_tile(int n_arr, long long block) {
  const long long t = tile_of(n_arr);
  return block < t ? block : t;
}

// Returns a cudaError_t (0 = launched). merge_only: run the kk = block
// phase only (merge_blocks); else the whole network (sort_blocks).
int bitonic_cuda(long long n, int n_arr, const void* const* srcs,
                 void* const* dsts, const int* esizes, int num_keys,
                 long long block, int merge_only, void* stream) {
  if (n_arr < 1 || n_arr > MAX_ARR || num_keys < 1 || num_keys > 2 ||
      num_keys > n_arr || block < 256 || (block & (block - 1)) != 0 ||
      n < 0 || n % block != 0)
    return (int)cudaErrorInvalidValue;
  Arrays A;
  for (int a = 0; a < MAX_ARR; ++a) {
    A.src[a] = a < n_arr ? srcs[a] : nullptr;
    A.dst[a] = a < n_arr ? dsts[a] : nullptr;
    A.esize[a] = a < n_arr ? esizes[a] : 0;
    if (a < n_arr && A.esize[a] != 4 && A.esize[a] != 8)
      return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_arr * 2 + num_keys - 1) {
    case 2: return (int)run<1, 1>(A, n, block, merge_only, s);
    case 4: return (int)run<2, 1>(A, n, block, merge_only, s);
    case 5: return (int)run<2, 2>(A, n, block, merge_only, s);
    case 6: return (int)run<3, 1>(A, n, block, merge_only, s);
    case 7: return (int)run<3, 2>(A, n, block, merge_only, s);
    case 8: return (int)run<4, 1>(A, n, block, merge_only, s);
    case 9: return (int)run<4, 2>(A, n, block, merge_only, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Stable B-way partition for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel genome_tpu/kernels/partition.py::
// partition_by_bucket (_move_kernel). Element i with 0 <= bid[i] < B goes
// to out[bid[i] * cap + rank], rank = its position among the elements of
// its bucket in stream order; elements with any other bid are dropped.
// Only ranks below cap are written, so an overflowing bucket never writes
// outside its region. totals[b] is each bucket's exact element count, and
// the kernel writes overflow = any(totals > ovf_limit) itself.
//
// What bounds it on an H100: bytes. bid is read once, rem is read once and
// written once (12 bytes an element for int32 ids and payloads: 0.3169 ms
// at the count stream's 88,473,600 elements over 3.35 TB/s); there is no
// arithmetic to speak of. The TPU design (a row sort by bucket in XLA,
// then chunk-aligned DMA appends through per-bucket VMEM carry buffers
// over a sequential grid) has no meaning on a card whose blocks run in any
// order. Each bucket has its own fixed region, so a tile needs only, for
// each bucket, how many of its elements came earlier in the stream: one
// pass with decoupled look-back (Merrill & Garland) over B-wide rows of
// counts. One memset of the tile states and one launch a call, both on
// the caller's stream:
//   - A block takes its tile id from a global counter, so a tile waits
//     only on tiles already started and the look-back always progresses.
//   - Each thread issues all its loads at once: the tile's bids, read
//     once as 16-byte vectors into shared memory as bucket ids, then its
//     payloads, read once into registers, where they wait out the
//     ranking. Tiles are cut on the 16-byte lines of bid's address, so any
//     view works: only the stream's first and last partial groups, and a
//     payload view on other lines, are read as scalars.
//   - Stable rank in shared memory: warp w owns a contiguous sub-range of
//     the tile, 32 elements a step in stream order. One ballot per bit of
//     the bucket id gives each element its peers in the step
//     (__match_any_sync measured no faster here), so its rank is
//     popc(peers & lanes below) plus the warp's running count of the
//     bucket, a uint16 counter [bucket][warp] that only the step's
//     leader reads and writes.
//     The steps' peers are found first, all independent; only the leaders'
//     counter updates form a chain. A scan of the counters in bucket-major
//     order turns them into each (bucket, warp)'s start in the tile's
//     bucket-grouped order: each bucket's in-tile count and run start.
//   - The tile publishes its row of B counts (uint16) and then its state
//     word, so no successor waits on this tile's own look-back; then the
//     payloads are staged in shared memory in bucket-grouped, stream-stable
//     order.
//   - Look-back: warp 0 reads 32 predecessors' states a trip back to the
//     nearest one whose inclusive prefix row (int64) is published, waiting
//     only on nearer tiles whose counts are not out yet. Thread c sums
//     buckets 8c ... 8c + 7 over that row and the count rows after it in
//     registers, 16 rows of 16-byte loads in flight (from L2: a row is read
//     only after its state, never through L1), then writes the tile's own
//     prefix row, and thread 0 its state. A tile past every cap still
//     publishes, so the totals stay exact.
//   - Thread i writes staged element i to out[b * cap + prefix[b] + i -
//     run_start[b]] when that slot is below cap: neighbouring threads
//     write neighbouring slots of one bucket.
//   - The last tile writes the totals and the overflow flag.
// Per-bucket status words (a 64-bit word a bucket, walked back bucket by
// bucket) were measured first and lost: a predecessor's row of them is
// 8 KB at B = 1025, an SM reads it from L2 slower than tiles start, so the
// walks grew until the look-back took 40 % of a block's time. So did
// summing the rows with shared atomics, and fewer rows in flight: the
// distance back to a published prefix grows whenever a row costs a tile
// more than the interval between tile starts (PERF.md).
// The overhead above the bound: the rows, written once (2 + 8 bytes a
// bucket a tile: 111 MB at the count shape, T = 10,800 tiles of 8192,
// B = 1025) and read back by the next tiles, mostly from L2; and the
// partial 32-byte sectors at each run's ends (about 8 elements a bucket a
// tile at B = 1025). Deterministic and order-preserving; 64-bit indexing.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 8192
#define THREADS 256
#define WARPS (THREADS / 32)
#define PER_WARP (TILE / WARPS)
#define STEPS (PER_WARP / 32)            // a warp's ranking steps
#define GROUP 4                          // elements a thread loads at once
#define GROUPS (TILE / (THREADS * GROUP))
#define ROWS 16  // count rows a look-back trip reads
// scratch words: the next tile id, nt 32-bit tile states, then (16-byte
// aligned) nt count rows of BP uint16, then nt prefix rows of BP int64
#define AGG_WORD(nt) ((2 + ((nt) + 1) / 2) & ~1LL)
#define MAX_BUCKETS 4096
#define BUCKET_BITS 12   // bits of a bucket id below MAX_BUCKETS
#define MAX_SMEM 232448  // what a block may use on the H100
#define DROP 0xffffu     // the bucket id of a dropped element
#define FULL_MASK 0xffffffffu

static_assert(WARPS % 8 == 0, "a bucket's warp counters are whole uint4s");
static_assert(TILE % (THREADS * GROUP) == 0 && TILE <= 32768,
              "uint16 in-tile positions");
static_assert(STEPS <= 32, "a warp's steps are held in registers");

// a tile's state word
#define T_AGGREGATE 1u  // its count row is published
#define T_PREFIX 2u     // its inclusive prefix row is published too

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// After a block barrier, so that the whole block's writes are ordered
// before a state word that thread 0 then stores.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// GROUP elements of p from stream index i0: 16-byte vectors when the group
// lies inside [0, n) and `vec` (its address is 16-byte aligned), else
// scalars, with `fill` outside [0, n).
__device__ __forceinline__ void load_group(const int* p, long long i0,
                                           long long n, bool vec, int fill,
                                           int v[GROUP]) {
  if (vec && i0 >= 0 && i0 + GROUP <= n) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p + i0));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < GROUP; ++k)
    v[k] = i0 + k >= 0 && i0 + k < n ? p[i0 + k] : fill;
}

__device__ __forceinline__ void load_group(const long long* p, long long i0,
                                           long long n, bool vec,
                                           long long fill,
                                           long long v[GROUP]) {
  if (vec && i0 >= 0 && i0 + GROUP <= n) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p + i0));
    const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p + i0 + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    return;
  }
#pragma unroll
  for (int k = 0; k < GROUP; ++k)
    v[k] = i0 + k >= 0 && i0 + k < n ? p[i0 + k] : fill;
}

// The lanes of `active` whose bucket equals this lane's b (b < 2^12):
// one ballot per bit of the bucket id. Every lane of the warp calls it.
__device__ __forceinline__ unsigned peers_of(unsigned active, unsigned b) {
  unsigned peers = active;
#pragma unroll
  for (int k = 0; k < BUCKET_BITS; ++k) {
    const bool bit = b >> k & 1u;
    const unsigned m = __ballot_sync(FULL_MASK, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// Dynamic shared memory, in this order (every part 16-byte aligned but
// the last two): staged payloads RT[TILE] in bucket-grouped order; per
// tile element its bucket (low 16 bits) and rank among its warp's
// elements of that bucket (high 16 bits), uint32[TILE]; counters
// uint16[B][WARPS] plus the tile's kept total; base int64[B] = the
// bucket's global prefix minus its in-tile run start; staged bucket ids
// uint16[TILE].
template <typename RT>
__host__ __device__ constexpr size_t smem_bytes(int B) {
  return (size_t)TILE * sizeof(RT) + (size_t)TILE * 4
      + (size_t)B * WARPS * 2 + 16 + (size_t)B * 8 + (size_t)TILE * 2;
}

// Two blocks an SM for 4-byte payloads; with 8-byte payloads a block's
// shared memory passes half the SM's at B = 1025, so one, and the
// compiler may use every register it needs.
template <typename BT, typename RT>
__global__ void __launch_bounds__(THREADS, sizeof(RT) == 4 ? 2 : 1)
partition_tiles(const BT* __restrict__ bid, const RT* __restrict__ rem,
                long long n, long long shift, int B, long long nt,
                long long cap, long long ovf_limit, RT* __restrict__ out,
                long long* __restrict__ result,
                unsigned long long* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  RT* s_v = reinterpret_cast<RT*>(smem);
  uint32_t* s_b = reinterpret_cast<uint32_t*>(s_v + TILE);
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(s_b + TILE);
  long long* s_base = reinterpret_cast<long long*>(s_cnt + B * WARPS + 8);
  uint16_t* s_sb = reinterpret_cast<uint16_t*>(s_base + B);
  uint4* cnt4 = reinterpret_cast<uint4*>(s_cnt);
  __shared__ long long s_tile;
  __shared__ unsigned s_warp[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // scratch: the next tile id, the tile states, count rows, prefix rows
  unsigned* tstate = reinterpret_cast<unsigned*>(scratch + 1);
  const int BP = (B + 7) & ~7;  // a row's width: whole 16-byte count chunks
  uint16_t* agg = reinterpret_cast<uint16_t*>(scratch + AGG_WORD(nt));
  long long* pref =  // 16-byte aligned too: BP is a multiple of 8
      reinterpret_cast<long long*>(scratch + AGG_WORD(nt) + nt * BP / 4);
  __shared__ long long s_jstar;

  if (tid == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
  for (int j = tid; j < B * (WARPS / 8); j += THREADS)
    cnt4[j] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const long long tile = s_tile;
  const long long ibase = tile * TILE - shift;  // stream index of slot 0

  // 1. the tile's bids and payloads, each read once, every load of the
  // thread in flight at once; the payloads stay in registers until step 5,
  // so their loads overlap the ranking
  {
    BT bv[GROUPS][GROUP];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      load_group(bid, ibase + (tid + g * THREADS) * GROUP, n, true, (BT)-1,
                 bv[g]);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      unsigned o[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k)
        o[k] = bv[g][k] >= 0 && bv[g][k] < (BT)B ? (unsigned)bv[g][k] : DROP;
      *reinterpret_cast<uint4*>(s_b + (tid + g * THREADS) * GROUP) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  RT rv[GROUPS][GROUP];
  const uintptr_t ra = reinterpret_cast<uintptr_t>(rem);
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const long long i0 = ibase + (tid + g * THREADS) * GROUP;
    load_group(rem, i0, n, ((ra + i0 * (long long)sizeof(RT)) & 15) == 0,
               (RT)0, rv[g]);
  }
  __syncthreads();

  // 2. stable rank within each warp's sub-range, in stream order: first
  // every step's peers (independent steps), then the warp's running count
  // per bucket, which only the steps' leaders touch
  {
    const unsigned lt = (1u << lane) - 1u;
    uint32_t* sub = s_b + warp * PER_WARP + lane;
    unsigned info[STEPS];  // bucket | rank in step << 16 | leader << 21
                           // | the step's count of the bucket << 26
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const unsigned b = sub[t * 32];
      const unsigned active = __ballot_sync(FULL_MASK, b != DROP);
      const unsigned peers = peers_of(active, b);
      info[t] = b | __popc(peers & lt) << 16
          | ((unsigned)(__ffs(peers) - 1) & 31u) << 21
          | __popc(peers) << 26;
    }
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const unsigned b = info[t] & 0xffffu;
      const int leader = b == DROP ? lane : (int)(info[t] >> 21 & 31u);
      unsigned cur = 0;
      if (leader == lane && b != DROP) {
        uint16_t* c = s_cnt + b * WARPS + warp;
        cur = *c;
        *c = (uint16_t)(cur + (info[t] >> 26));
      }
      cur = __shfl_sync(FULL_MASK, cur, leader);
      sub[t * 32] = b | (cur + (info[t] >> 16 & 31u)) << 16;
      __syncwarp();  // the leader's update is seen by the next step
    }
  }
  __syncthreads();

  // 3. scan the counters bucket-major: (bucket, warp) -> in-tile start
  {
    const int per = (B + THREADS - 1) / THREADS;
    const int b0 = min(tid * per, B), b1 = min(b0 + per, B);
    unsigned sum = 0;
    for (int j = b0 * (WARPS / 8); j < b1 * (WARPS / 8); ++j) {
      const uint4 x = cnt4[j];
      sum += (x.x & 0xffffu) + (x.x >> 16) + (x.y & 0xffffu) + (x.y >> 16)
          + (x.z & 0xffffu) + (x.z >> 16) + (x.w & 0xffffu) + (x.w >> 16);
    }
    unsigned incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    unsigned run = incl - sum, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = s_warp[w];
      run += w < warp ? c : 0u;
      total += c;
    }
    for (int j = b0 * (WARPS / 8); j < b1 * (WARPS / 8); ++j) {
      uint4 x = cnt4[j];
      unsigned* h = reinterpret_cast<unsigned*>(&x);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned lo = h[k] & 0xffffu, hi = h[k] >> 16;
        h[k] = run | (run + lo) << 16;
        run += lo + hi;
      }
      cnt4[j] = x;
    }
    if (tid == 0) s_cnt[B * WARPS] = (uint16_t)total;
  }
  __syncthreads();

  // 4. publish the tile's count of every bucket at once (tile 0: its
  // inclusive prefixes too), so no successor waits on this tile's own
  // look-back; the padding of a row past B holds zeros
  for (int b = tid; b < BP; b += THREADS) {
    const unsigned c = b < B ? s_cnt[(b + 1) * WARPS] - s_cnt[b * WARPS] : 0;
    agg[tile * BP + b] = (uint16_t)c;
    if (tile == 0) pref[b] = c;  // row 0: the inclusive prefixes
  }
  __syncthreads();
  if (tid == 0) {  // the block's rows before the state (cumulative fence)
    fence_acq_rel();
    store_release(tstate + tile, tile == 0 ? T_PREFIX : T_AGGREGATE);
  }

  // 5. stage the payloads, and the bucket ids, in bucket-grouped order
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int q = (tid + g * THREADS) * GROUP;
    const uint4 r4 = *reinterpret_cast<const uint4*>(s_b + q);
    const unsigned r[GROUP] = {r4.x, r4.y, r4.z, r4.w};
    const int w = q / PER_WARP;  // a group lies in one warp's sub-range
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const unsigned b = r[k] & 0xffffu;
      if (b == DROP) continue;
      const unsigned p = s_cnt[b * WARPS + w] + (r[k] >> 16);
      s_v[p] = rv[g][k];
      s_sb[p] = (uint16_t)b;
    }
  }

  // 6. decoupled look-back over the tile states: warp 0 finds the nearest
  // predecessor whose prefix row is published, 32 tiles a trip, waiting
  // only on tiles that have started but not yet published their counts.
  // Then thread c takes the buckets 8c ... 8c + 7: their prefix-row values
  // plus the count rows after it (contiguous; ROWS rows of 16-byte loads
  // in flight), summed in registers. Rows are read from L2 (__ldcg): a row
  // is read only after its state, and L1 may hold an older copy of a line.
  if (warp == 0) {
    long long jstar = -1;  // tile 0 has no predecessor
    for (long long last = tile - 1; last >= 0; last -= 32) {
      const long long j = last - lane;  // lane l: l + 1 tiles back
      unsigned pm, zm;
      do {  // before tile 0: read as a published prefix, never reached
        const unsigned st = j >= 0 ? load_acquire(tstate + j) : T_PREFIX;
        pm = __ballot_sync(FULL_MASK, st == T_PREFIX);
        zm = __ballot_sync(FULL_MASK, st == 0);
        // wait only on unpublished tiles nearer than the nearest prefix
      } while (zm & (pm ? (pm & -pm) - 1 : FULL_MASK));
      if (pm) {
        jstar = last - (__ffs(pm) - 1);
        break;
      }
    }
    if (lane == 0) s_jstar = jstar;
  }
  __syncthreads();
  const long long jstar = s_jstar;
  bool over = false;
  for (int c = tid; c < BP / 8; c += THREADS) {
    long long e[8];  // the exclusive prefixes of buckets 8c ... 8c + 7
    if (jstar >= 0) {
      const longlong2* pr =
          reinterpret_cast<const longlong2*>(pref + jstar * BP + c * 8);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const longlong2 q = __ldcg(pr + k);
        e[2 * k] = q.x;
        e[2 * k + 1] = q.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = 0;
    }
    const uint4* col = reinterpret_cast<const uint4*>(agg) + c;
    unsigned acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (long long j = jstar + 1; j < tile; j += ROWS) {
      uint4 v[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        v[k] = j + k < tile ? __ldcg(col + (j + k) * (BP / 8))
                            : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const unsigned h[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          acc[2 * x] += h[x] & 0xffffu;
          acc[2 * x + 1] += h[x] >> 16;
        }
      }
    }
    long long incl[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b = c * 8 + k;
      e[k] += acc[k];
      incl[k] = e[k];
      if (b < B) {
        const unsigned start = s_cnt[b * WARPS];
        incl[k] += s_cnt[(b + 1) * WARPS] - start;
        s_base[b] = e[k] - (long long)start;
        if (tile == nt - 1) {
          result[b] = incl[k];
          over |= incl[k] > ovf_limit;
        }
      }
    }
    if (tile > 0) {
      longlong2* pw = reinterpret_cast<longlong2*>(pref + tile * BP + c * 8);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pw[k] = make_longlong2(incl[2 * k], incl[2 * k + 1]);
    }
  }
  const int any_over = __syncthreads_or(over);
  if (tid == 0) {
    if (tile > 0) {  // the block's prefix row before its state
      fence_acq_rel();
      store_release(tstate + tile, T_PREFIX);
    }
    if (tile == nt - 1) result[B] = any_over ? 1 : 0;
  }

  // 7. staged element i to its bucket's region, below cap
  const int kept = s_cnt[B * WARPS];
  for (int i = tid; i < kept; i += THREADS) {
    const int b = s_sb[i];
    const long long slot = s_base[b] + i;
    if (slot < cap) out[(long long)b * cap + slot] = s_v[i];
  }
}

template <typename BT, typename RT>
static int launch(const void* bid, const void* rem, long long n, int B,
                  long long cap, long long ovf_limit, void* out,
                  long long* result, long long* scratch,
                  long long scratch_words, cudaStream_t s) {
  const long long shift =
      (long long)((uintptr_t)bid & 15) / (long long)sizeof(BT);
  const long long nt = (n + shift + TILE - 1) / TILE;
  const size_t smem = smem_bytes<RT>(B);
  const long long cleared = 1 + (nt + 1) / 2;  // the tile id, the states
  if (scratch_words < AGG_WORD(nt) + nt * ((B + 7) & ~7) / 4 * 5
      || nt > 0x7fffffffLL || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      partition_tiles<BT, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, (size_t)cleared * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  partition_tiles<BT, RT><<<(unsigned)nt, THREADS, smem, s>>>(
      static_cast<const BT*>(bid), static_cast<const RT*>(rem), n, shift, B,
      nt, cap, ovf_limit, static_cast<RT*>(out), result,
      reinterpret_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}

extern "C" {

long long partition_tile_size(void) { return TILE; }

// Returns a cudaError_t (0 = launched). bid: int32 or int64 (bid_size 4
// or 8), n >= 1 of them; rem and out: int32 or int64 (rem_size); out
// [B, cap]. result: int64[B + 1], the totals, then the overflow flag
// (any total > ovf_limit). scratch: int64[scratch_words], at least
// AGG_WORD(T) + T * BP * 5 / 4 words, T = ceil((n + shift) / TILE) tiles,
// shift = the elements from bid's 16-byte line to bid, BP = B rounded up
// to 8; its tile id and states are cleared here on the stream before the
// launch.
int partition_cuda(const void* bid, int bid_size, const void* rem,
                   int rem_size, long long n, int B, long long cap,
                   long long ovf_limit, void* out, long long* result,
                   long long* scratch, long long scratch_words,
                   void* stream) {
  if (n <= 0 || B < 1 || B > MAX_BUCKETS || cap < 0
      || (bid_size != 4 && bid_size != 8) || (rem_size != 4 && rem_size != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bid_size == 4)
    return rem_size == 4
        ? launch<int, int>(bid, rem, n, B, cap, ovf_limit, out, result,
                           scratch, scratch_words, s)
        : launch<int, long long>(bid, rem, n, B, cap, ovf_limit, out, result,
                                 scratch, scratch_words, s);
  return rem_size == 4
      ? launch<long long, int>(bid, rem, n, B, cap, ovf_limit, out, result,
                               scratch, scratch_words, s)
      : launch<long long, long long>(bid, rem, n, B, cap, ovf_limit, out,
                                     result, scratch, scratch_words, s);
}

}  // extern "C"

// Canonical k-mer window extraction for Hopper (sm_90a), bound with ctypes.
//
// Replaces no Pallas kernel: the JAX package extracts with plain jnp
// (genome_tpu/kernels/extract.py::extract_canonical_kmers_packed and
// extract_canonical_kmers), which XLA fuses on the TPU. The port's torch
// form of it makes about five full-grid int64 passes for each of the k
// rounds and about 25 more for the canonical form: some 800 bytes of
// device traffic a window. This kernel makes each key in registers.
//
// In: packed [B, ceil(L/4)] uint8, 4 codes a byte, the first code in the
// low bits (kernels/extract.py::pack_codes_host), and optionally invalid
// [B, ceil(L/8)] uint8, 1 bit a base, the first base in the low bit (a
// null pointer: no mask). Out: int64 [B * (L - k + 1)], row-major (read,
// then window): min(forward, reverse complement) of each window, with the
// first base at the most significant end, or INT64_MAX (the sentinel)
// for a window that covers a set mask bit. 1 <= k <= 31.
//
// What bounds it on an H100: the 8-byte store of each window (0.075 ms
// for a chunk of 2^18 reads of 150 bases at k = 31, at 3.35 TB/s); a
// row's input is L/4 (+ L/8) bytes against 8 (L - k + 1) bytes out. The
// design keeps everything but that store off device memory:
//   - A block owns one contiguous run of the output: R whole rows (R x
//     nwin ~ TILE windows) or, for a row of more than TILE windows, a
//     TILE-window segment of one row. Its input is then one contiguous
//     byte range of packed (and one of the mask), read once as 16-byte
//     vectors (bytes only at the range's two ragged ends, so any view
//     works) and staged in shared memory with each row starting on a
//     word, so that a window's bits sit at a fixed offset from its row.
//   - A thread makes a window's key from three staged words. Two funnel
//     shifts give the 64 bits from the window's first base; with the
//     first base in the low bits, their low 2k bits v are the reverse
//     complement's complement (rc = ~v), and the forward word is v with
//     its 2-bit groups reversed (__brevll and a swap of bit pairs),
//     shifted down. The mask's k bits come the same way from two words.
//   - Thread j of a block stores the block's window j, so each warp's
//     stores are 256 contiguous bytes. Nothing else touches device memory.
// One kernel serves every k, L and mask (runtime arguments; the mask is a
// template flag, so the unmasked path reads no mask words). Deterministic;
// output indexing is 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int TILE = 4096;  // windows a block, at most; a multiple of 128
static_assert(TILE % 128 == 0, "a segment starts on a word of both inputs");
// dynamic shared memory a block may use for its staged rows
constexpr int SMEM_BUDGET = 24 * 1024;
constexpr long long SENTINEL = 0x7FFFFFFFFFFFFFFFLL;

struct Geometry {
  long long B, nwin;  // rows, windows a row
  long long P, Q;     // packed and mask bytes a row
  int k;
  int R;     // rows a block (1 when rows are cut into segments)
  int W;     // windows of a row a block (nwin, or TILE)
  int ns;    // segments a row
  int wpr;   // staged packed words a row
  int mwpr;  // staged mask words a row (0 without a mask)
};

// Copies src[0, n) into shared memory, byte `off` of the range going to
// row off / P, column off % P of dst (rows `stride` bytes apart): the
// range is R whole rows of P bytes, or one segment of one row (n <= P).
__device__ __forceinline__ void stage(const uint8_t* __restrict__ src,
                                      int n, long long P,
                                      uint8_t* __restrict__ dst,
                                      int stride) {
  const int head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15));
  const int nvec = (n - head) >> 4;
  const int tail = head + (nvec << 4);
  for (int i = threadIdx.x; i < head + n - tail; i += THREADS) {
    const int off = i < head ? i : tail + (i - head);
    const int row = (int)(off / P);
    dst[row * stride + (off - row * P)] = src[off];
  }
  const uint4* v = reinterpret_cast<const uint4*>(src + head);
  for (int j = threadIdx.x; j < nvec; j += THREADS) {
    const uint4 q = __ldg(v + j);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    const int off = head + (j << 4);
    int row = (int)(off / P);
    long long col = off - row * P;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      dst[row * stride + col] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
      if (++col == P) {
        col = 0;
        ++row;
      }
    }
  }
}

template <bool MASK>
__global__ void __launch_bounds__(THREADS)
    extract_tiles(const uint8_t* __restrict__ packed,
                  const uint8_t* __restrict__ invalid,
                  long long* __restrict__ out, const Geometry g) {
  extern __shared__ uint32_t smem[];
  uint32_t* sp = smem;                 // R rows of wpr words
  uint32_t* sq = smem + g.R * g.wpr;   // R rows of mwpr words
  const long long group = blockIdx.x / g.ns;
  const int seg = (int)(blockIdx.x - group * g.ns);
  const long long r0 = group * g.R;
  const int rows = (int)min((long long)g.R, g.B - r0);
  const long long t0 = (long long)seg * g.W;  // the segment's first window
  const int w = (int)min((long long)g.W, g.nwin - t0);
  const int k = g.k;

  // bases [t0, t0 + w + k - 1) of each row: t0 is a multiple of 128, so
  // the segment starts on a byte of packed and of the mask
  const long long c1 = (t0 + w + k - 1 + 3) >> 2;
  stage(packed + r0 * g.P + (t0 >> 2),
        (int)((rows - 1) * g.P + c1 - (t0 >> 2)), g.P,
        reinterpret_cast<uint8_t*>(sp), 4 * g.wpr);
  if (MASK) {
    const long long m1 = (t0 + w + k - 1 + 7) >> 3;
    stage(invalid + r0 * g.Q + (t0 >> 3),
          (int)((rows - 1) * g.Q + m1 - (t0 >> 3)), g.Q,
          reinterpret_cast<uint8_t*>(sq), 4 * g.mwpr);
  }
  __syncthreads();

  const uint64_t kmask = (1ull << (2 * k)) - 1;
  const uint32_t kbits = (1u << k) - 1;
  const int down = 64 - 2 * k;
  long long* o = out + r0 * g.nwin + t0;  // R > 1 only with t0 = 0
  const int n = rows * w;
  // window j of the block: row r, window t of the segment; j steps by
  // THREADS = dr rows and dt windows
  const int dr = THREADS / w, dt = THREADS - dr * w;
  int r = threadIdx.x / w, t = threadIdx.x - r * w;
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const uint32_t* s = sp + r * g.wpr + (t >> 4);
    const int sh = (2 * t) & 31;
    const uint32_t lo = __funnelshift_r(s[0], s[1], sh);
    const uint32_t hi = __funnelshift_r(s[1], s[2], sh);
    const uint64_t v = (((uint64_t)hi << 32) | lo) & kmask;
    uint64_t f = __brevll(v);
    f = ((f >> 1) & 0x5555555555555555ull) |
        ((f & 0x5555555555555555ull) << 1);
    f >>= down;
    long long key = (long long)min(f, ~v & kmask);
    if (MASK) {
      const uint32_t* m = sq + r * g.mwpr + (t >> 5);
      if (__funnelshift_r(m[0], m[1], t & 31) & kbits) key = SENTINEL;
    }
    o[j] = key;
    t += dt;
    r += dr;
    if (t >= w) {
      t -= w;
      ++r;
    }
  }
}

extern "C" {

// Launches the extraction of packed [B, ceil(L/4)] (with the mask invalid
// [B, ceil(L/8)], or none for a null pointer) into out[B * (L - k + 1)]
// on the stream. Returns a cudaError_t (0 = launched, or nothing to do).
int extract_kmers_cuda(const void* packed, const void* invalid, long long B,
                       long long L, int k, void* out, void* stream) {
  if (B < 0 || L < 0 || k < 1 || k > 31) return (int)cudaErrorInvalidValue;
  Geometry g;
  g.B = B;
  g.nwin = L - k + 1;
  if (B == 0 || g.nwin <= 0) return (int)cudaSuccess;
  g.P = (L + 3) / 4;
  g.Q = (L + 7) / 8;
  g.k = k;
  const bool mask = invalid != nullptr;
  g.W = (int)(g.nwin > TILE ? TILE : g.nwin);
  g.R = g.nwin > TILE ? 1 : TILE / (int)g.nwin;
  g.ns = (int)((g.nwin + g.W - 1) / g.W);
  const int bases = g.W + k - 1;  // staged a row
  // two words past a row's bytes: a window's third word may lie there
  g.wpr = (bases + 15) / 16 + 2;
  g.mwpr = mask ? (bases + 31) / 32 + 2 : 0;
  const int row_bytes = 4 * (g.wpr + g.mwpr);
  if (g.R > SMEM_BUDGET / row_bytes) g.R = SMEM_BUDGET / row_bytes;
  const long long groups = (B + g.R - 1) / g.R;
  const long long blocks = groups * g.ns;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)g.R * row_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* m = static_cast<const uint8_t*>(invalid);
  auto* o = static_cast<long long*>(out);
  if (mask)
    extract_tiles<true><<<(unsigned)blocks, THREADS, smem, s>>>(p, m, o, g);
  else
    extract_tiles<false><<<(unsigned)blocks, THREADS, smem, s>>>(p, m, o, g);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Native FASTA/FASTQ parser -> 2-bit-coded read matrix (T0 fast path).
//
// Reference analog: read ingestion on the JVM (SURVEY.md §2.1 R1). Host
// parsing is the one genuinely CPU-bound stage of the TPU pipeline, so it
// gets the native treatment: a single pass over the mmap'd/read file
// buffer, branch-light, writing base codes (A=0 C=1 G=2 T=3, other=4)
// directly into the caller-allocated [rows, L] matrix that feeds
// genome_tpu.kernels.extract (padding value 4 == invalid, SEMANTICS §1).
//
// C ABI (ctypes-friendly), no exceptions across the boundary:
//   gt_scan(buf, n, *nrecords, *maxlen) -> 0 ok, negative = error code
//   gt_parse(buf, n, out, rows, L)      -> records written, negative = error
//   gt_index(buf, n, offsets, cap)      -> record start offsets (for MT)
//   gt_parse_mt(buf, n, offsets, rows, out, L, nthreads)
//       -> rows decoded in parallel over [rows] ranges, negative = error
//
// Build: g++ -O3 -pthread -shared -fPIC (see cio.py).

#include <cstdint>
#include <cstring>

#include <thread>
#include <vector>

namespace {

constexpr int8_t kInvalid = 4;

// 256-entry base->code LUT; everything not ACGT/acgt is 4.
struct Lut {
    int8_t t[256];
    constexpr Lut() : t{} {
        for (int i = 0; i < 256; ++i) t[i] = kInvalid;
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
    }
};
constexpr Lut kLut;

enum : int64_t {
    ERR_EMPTY = -1,
    ERR_FORMAT = -2,
    ERR_TRUNCATED = -3,
    ERR_OVERFLOW = -4,
};

inline const char* next_line(const char* p, const char* end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    return nl ? nl + 1 : end;
}

// Walk one FASTA record starting at '>'；returns pointer past the record,
// sequence length via *len (newlines/CR skipped).
const char* fasta_record(const char* p, const char* end, int64_t* len) {
    p = next_line(p, end);  // skip header
    int64_t n = 0;
    while (p < end && *p != '>') {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* stop = nl ? nl : end;
        n += stop - p;
        if (stop > p && stop[-1] == '\r') --n;
        p = nl ? nl + 1 : end;
    }
    *len = n;
    return p;
}

// Walk one FASTQ record starting at '@'; seq is a single line.
const char* fastq_record(const char* p, const char* end, int64_t* len,
                         bool* ok) {
    p = next_line(p, end);  // header
    const char* seq = p;
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!nl) { *ok = false; return end; }
    int64_t n = nl - seq;
    if (n > 0 && nl[-1] == '\r') --n;
    p = nl + 1;
    if (p >= end || *p != '+') { *ok = false; return end; }
    p = next_line(p, end);           // '+' line
    if (p >= end) { *ok = false; return end; }
    p = next_line(p, end);           // quality line (must exist)
    *len = n;
    *ok = true;
    return p;
}

}  // namespace

extern "C" {

// First pass: count records and the maximum sequence length.
int64_t gt_scan(const char* buf, int64_t n, int64_t* nrecords,
                int64_t* maxlen) {
    if (n <= 0) { *nrecords = 0; *maxlen = 0; return 0; }
    const char* p = buf;
    const char* end = buf + n;
    const bool fastq = (*p == '@');
    if (!fastq && *p != '>') return ERR_FORMAT;
    int64_t count = 0, mx = 0;
    while (p < end) {
        if (*p == '\n' || *p == '\r') { ++p; continue; }
        int64_t len = 0;
        if (fastq) {
            if (*p != '@') return ERR_FORMAT;
            bool ok = true;
            p = fastq_record(p, end, &len, &ok);
            if (!ok) return ERR_TRUNCATED;
        } else {
            if (*p != '>') return ERR_FORMAT;
            p = fasta_record(p, end, &len);
        }
        ++count;
        if (len > mx) mx = len;
    }
    *nrecords = count;
    *maxlen = mx;
    return 0;
}

// Second pass: decode sequences into out[rows, L], padded with 4.
// Sequences longer than L are truncated. Returns records written.
int64_t gt_parse(const char* buf, int64_t n, int8_t* out, int64_t rows,
                 int64_t L) {
    if (n <= 0) return 0;
    const char* p = buf;
    const char* end = buf + n;
    const bool fastq = (*p == '@');
    if (!fastq && *p != '>') return ERR_FORMAT;
    memset(out, kInvalid, static_cast<size_t>(rows * L));
    int64_t row = 0;
    while (p < end) {
        if (*p == '\n' || *p == '\r') { ++p; continue; }
        if (row >= rows) return ERR_OVERFLOW;
        int8_t* dst = out + row * L;
        int64_t written = 0;
        if (fastq) {
            if (*p != '@') return ERR_FORMAT;
            p = next_line(p, end);  // header
            const char* nl = static_cast<const char*>(
                memchr(p, '\n', static_cast<size_t>(end - p)));
            if (!nl) return ERR_TRUNCATED;
            const char* stop = (nl[-1] == '\r') ? nl - 1 : nl;
            for (const char* q = p; q < stop && written < L; ++q)
                dst[written++] = kLut.t[static_cast<uint8_t>(*q)];
            p = nl + 1;
            if (p >= end || *p != '+') return ERR_TRUNCATED;
            p = next_line(p, end);
            if (p >= end) return ERR_TRUNCATED;
            p = next_line(p, end);  // qualities
        } else {
            if (*p != '>') return ERR_FORMAT;
            p = next_line(p, end);  // header
            while (p < end && *p != '>') {
                const char* nl = static_cast<const char*>(
                    memchr(p, '\n', static_cast<size_t>(end - p)));
                const char* stop = nl ? nl : end;
                if (stop > p && stop[-1] == '\r') --stop;
                for (const char* q = p; q < stop && written < L; ++q)
                    dst[written++] = kLut.t[static_cast<uint8_t>(*q)];
                p = nl ? nl + 1 : end;
            }
        }
        ++row;
    }
    return row;
}

// Record-boundary index: offsets[i] = byte offset of record i's header.
// Single cheap pass; enables embarrassingly parallel decode. Returns the
// record count (<= cap) or a negative error.
int64_t gt_index(const char* buf, int64_t n, int64_t* offsets, int64_t cap) {
    if (n <= 0) return 0;
    const char* p = buf;
    const char* end = buf + n;
    const bool fastq = (*p == '@');
    if (!fastq && *p != '>') return ERR_FORMAT;
    int64_t count = 0;
    while (p < end) {
        if (*p == '\n' || *p == '\r') { ++p; continue; }
        if (count >= cap) return ERR_OVERFLOW;
        offsets[count++] = p - buf;
        int64_t len = 0;
        if (fastq) {
            if (*p != '@') return ERR_FORMAT;
            bool ok = true;
            p = fastq_record(p, end, &len, &ok);
            if (!ok) return ERR_TRUNCATED;
        } else {
            if (*p != '>') return ERR_FORMAT;
            p = fasta_record(p, end, &len);
        }
    }
    return count;
}

namespace {

// Decode rows [r0, r1) using the record index; each row is fully owned by
// one caller, so ranges decode concurrently without synchronization.
void parse_rows(const char* buf, int64_t n, const int64_t* offsets,
                int64_t r0, int64_t r1, int8_t* out, int64_t L,
                bool fastq) {
    const char* end = buf + n;
    for (int64_t row = r0; row < r1; ++row) {
        const char* p = buf + offsets[row];
        int8_t* dst = out + row * L;
        memset(dst, kInvalid, static_cast<size_t>(L));
        int64_t written = 0;
        if (fastq) {
            p = next_line(p, end);  // header
            const char* nl = static_cast<const char*>(
                memchr(p, '\n', static_cast<size_t>(end - p)));
            const char* stop = nl ? ((nl[-1] == '\r') ? nl - 1 : nl) : end;
            for (const char* q = p; q < stop && written < L; ++q)
                dst[written++] = kLut.t[static_cast<uint8_t>(*q)];
        } else {
            p = next_line(p, end);  // header
            while (p < end && *p != '>') {
                const char* nl = static_cast<const char*>(
                    memchr(p, '\n', static_cast<size_t>(end - p)));
                const char* stop = nl ? nl : end;
                if (stop > p && stop[-1] == '\r') --stop;
                for (const char* q = p; q < stop && written < L; ++q)
                    dst[written++] = kLut.t[static_cast<uint8_t>(*q)];
                p = nl ? nl + 1 : end;
            }
        }
    }
}

}  // namespace

namespace {

// Pack rows [r0, r1) of a [rows, L] code matrix into the device wire
// format (kernels/extract.py pack_codes_host): 4 codes/byte little-end
// first, plus a 1-bit-per-base invalid mask (code >= 4). Columns beyond
// L read as invalid/pad (code 4), matching the numpy reference.
// *any_invalid is set to 1 if any REAL (in-bounds) code is >= 4 — when it
// stays 0 the caller can skip transferring the mask entirely and rebuild
// validity from the row/column bounds on device. Each worker gets its own
// any_invalid slot (OR-reduced after join) so the write is race-free.
void pack_rows(const int8_t* codes, int64_t r0, int64_t r1, int64_t L,
               int64_t w4, int64_t w8, uint8_t* packed, uint8_t* invalid,
               int64_t* any_invalid) {
    int64_t seen = 0;
    for (int64_t row = r0; row < r1; ++row) {
        const int8_t* src = codes + row * L;
        uint8_t* pd = packed + row * w4;
        uint8_t* iv = invalid + row * w8;
        for (int64_t j = 0; j < w4; ++j) {
            uint8_t b = 0;
            const int64_t c0 = 4 * j;
            for (int64_t t = 0; t < 4; ++t) {
                const int64_t c = c0 + t;
                const uint8_t v = (c < L) ? static_cast<uint8_t>(src[c]) : 4;
                b |= static_cast<uint8_t>((v & 3) << (2 * t));
            }
            pd[j] = b;
        }
        for (int64_t j = 0; j < w8; ++j) {
            uint8_t b = 0;
            const int64_t c0 = 8 * j;
            for (int64_t t = 0; t < 8; ++t) {
                const int64_t c = c0 + t;
                const uint8_t v = (c < L) ? static_cast<uint8_t>(src[c]) : 4;
                const uint8_t bad = (v >= 4) ? 1 : 0;
                seen |= (c < L) ? bad : 0;
                b |= static_cast<uint8_t>(bad << t);
            }
            iv[j] = b;
        }
    }
    if (seen) *any_invalid = 1;
}

}  // namespace

// Multi-threaded host packing: codes [rows, L] int8 -> packed [rows, w4]
// + invalid bitmask [rows, w8] (w4 = ceil(L4/4) with L4 = 4-aligned L,
// w8 likewise over 8). Caller allocates outputs. Returns rows.
int64_t gt_pack_codes(const int8_t* codes, int64_t rows, int64_t L,
                      int64_t w4, int64_t w8, uint8_t* packed,
                      uint8_t* invalid, int64_t* any_invalid,
                      int64_t nthreads) {
    *any_invalid = 0;
    if (rows <= 0) return 0;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > rows) nthreads = rows;
    if (nthreads == 1) {
        pack_rows(codes, 0, rows, L, w4, w8, packed, invalid, any_invalid);
        return rows;
    }
    std::vector<std::thread> workers;
    workers.reserve(static_cast<size_t>(nthreads));
    std::vector<int64_t> seen(static_cast<size_t>(nthreads), 0);
    const int64_t per = (rows + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
        const int64_t r0 = t * per;
        const int64_t r1 = (r0 + per < rows) ? r0 + per : rows;
        if (r0 >= r1) break;
        workers.emplace_back(pack_rows, codes, r0, r1, L, w4, w8, packed,
                             invalid, &seen[static_cast<size_t>(t)]);
    }
    for (auto& w : workers) w.join();
    for (int64_t v : seen) *any_invalid |= (v != 0) ? 1 : 0;
    return rows;
}

// Multi-threaded decode over a prebuilt record index.
int64_t gt_parse_mt(const char* buf, int64_t n, const int64_t* offsets,
                    int64_t rows, int8_t* out, int64_t L,
                    int64_t nthreads) {
    if (n <= 0 || rows <= 0) return 0;
    const bool fastq = (buf[offsets[0]] == '@');
    if (!fastq && buf[offsets[0]] != '>') return ERR_FORMAT;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > rows) nthreads = rows;
    if (nthreads == 1) {
        parse_rows(buf, n, offsets, 0, rows, out, L, fastq);
        return rows;
    }
    std::vector<std::thread> workers;
    workers.reserve(static_cast<size_t>(nthreads));
    const int64_t per = (rows + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
        const int64_t r0 = t * per;
        const int64_t r1 = (r0 + per < rows) ? r0 + per : rows;
        if (r0 >= r1) break;
        workers.emplace_back(parse_rows, buf, n, offsets, r0, r1, out, L,
                             fastq);
    }
    for (auto& w : workers) w.join();
    return rows;
}

}  // extern "C"

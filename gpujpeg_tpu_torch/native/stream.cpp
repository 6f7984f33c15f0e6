// Native host-side codestream routines (the TPU build's counterpart of the
// reference's C host layer: stream assembly gpujpeg_encoder.c:566-624 and
// the memchr scan splitter gpujpeg_reader.c:1038-1155).
//
// Exposed with a plain C ABI for ctypes; no Python headers needed.
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC stream.cpp -o libgpujpeg_tpu_native.so

#include <cstdint>
#include <cstring>
#include <cstddef>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Compact per-segment rows into one contiguous stream.
//   rows:      nseg x row_stride bytes (big-endian word layout already
//              byte-ordered by the caller)
//   row_bytes: per-row valid byte counts
//   offsets:   per-row output offsets (exclusive prefix sum, caller-built)
//   out:       destination buffer (size >= offsets[nseg-1] + row_bytes[nseg-1])
void gj_assemble_rows(const uint8_t* rows, int64_t nseg, int64_t row_stride,
                      const int32_t* row_bytes, const int64_t* offsets,
                      uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < nseg; ++s) {
        std::memcpy(out + offsets[s], rows + s * row_stride,
                    (size_t)row_bytes[s]);
    }
}

// Scan-split one entropy-coded scan: find RST markers, record segment byte
// ranges (marker bytes excluded).  Returns the number of segments found and
// sets *end_pos to the offset of the terminating non-RST marker (or n).
//   data/n:    scan bytes starting at entropy data
//   starts/ends: caller-allocated arrays of capacity max_segments
//   expected_rst: if >= 0, verify the RST0-7 modulo sequence from this
//              index; out_bad_markers counts mismatches (reference logs
//              "[Recovery]", gpujpeg_reader.c:1071-1104)
int64_t gj_scan_split(const uint8_t* data, int64_t n,
                      int64_t* starts, int64_t* ends, int64_t max_segments,
                      int64_t* end_pos, int64_t* out_bad_markers) {
    int64_t nseg = 0;
    int64_t seg_start = 0;
    int64_t bad = 0;
    int64_t i = 0;
    int rst_idx = 0;
    while (i + 1 < n) {
        const uint8_t* p =
            (const uint8_t*)std::memchr(data + i, 0xFF, (size_t)(n - 1 - i));
        if (!p) { i = n; break; }
        i = p - data;
        uint8_t nxt = data[i + 1];
        if (nxt == 0x00) { i += 2; continue; }        // stuffed
        if (nxt == 0xFF) { i += 1; continue; }        // fill byte
        if (nxt >= 0xD0 && nxt <= 0xD7) {             // RSTn
            if (nseg < max_segments && i > seg_start) {
                starts[nseg] = seg_start;
                ends[nseg] = i;
                ++nseg;
            }
            if (nxt != 0xD0 + (rst_idx & 7)) ++bad;
            ++rst_idx;
            i += 2;
            seg_start = i;
            continue;
        }
        break;                                        // real marker: end
    }
    if (i + 1 >= n) i = n;
    if (nseg < max_segments && i > seg_start) {
        starts[nseg] = seg_start;
        ends[nseg] = i;
        ++nseg;
    }
    *end_pos = i;
    *out_bad_markers = bad;
    return nseg;
}

// Unstuff (0xFF 0x00 -> 0xFF) all segments into a padded row matrix of
// big-endian 32-bit words, zero-filled.  Returns nothing; writes per-row
// unstuffed byte counts.
//   data:      full codestream
//   starts/ends: segment byte ranges (stuffed)
//   mat:       nseg x (row_words*4) bytes, zeroed by callee
//   zero_tail: when 0, bytes past each row's payload are left as-is
//              (garbage): the decoder gates every bit-commit by the
//              per-segment bit count, so the tail is never decoded —
//              skipping the memset cuts ~40% of matrix writes at
//              restart_interval 1 (1.55 M ~41-B payloads in 68-B rows)
void gj_unstuff_rows(const uint8_t* data, int64_t nseg,
                     const int64_t* starts, const int64_t* ends,
                     uint8_t* mat, int64_t row_words,
                     int32_t* out_bytes, int64_t zero_tail) {
    const int64_t stride = row_words * 4;
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t s = 0; s < nseg; ++s) {
        uint8_t* dst = mat + s * stride;
        int64_t w = 0;
        const int64_t lim = stride;
        int64_t i = starts[s];
        const int64_t end = ends[s];
        // memchr/memcpy spans: 0xFF bytes are ~0.4% of typical entropy
        // data, so the stream copies at memcpy speed instead of a
        // byte-at-a-time branchy loop (~5x on the 8K host-prep path).
        // An inline 8-byte SWAR variant was A/B-measured SLOWER (14.8
        // vs 9.7 ms warm on 1.55 M 41-B rows): glibc's AVX2 memchr/
        // memcpy beat the u64 loop even including call overhead.
        while (i < end && w < lim) {
            const uint8_t* p = (const uint8_t*)std::memchr(
                data + i, 0xFF, (size_t)(end - i));
            int64_t span = p ? (p - (data + i)) + 1 : (end - i);
            if (span > lim - w) span = lim - w;
            std::memcpy(dst + w, data + i, (size_t)span);
            w += span;
            i += span;
            if (p && i < end && data[i] == 0x00) ++i;  // stuffed zero
        }
        // zero only the tail AFTER the payload: rows are typically
        // ~half full, so this halves the matrix writes vs a full
        // memset (matters at restart_interval 1, where nseg is the
        // block count and the matrix is ~100 MB at 8K Q100)
        if (zero_tail) std::memset(dst + w, 0, (size_t)(stride - w));
        out_bytes[s] = (int32_t)w;
    }
}

// Sequential Huffman bit-packer for the restart_interval == 0 path (the
// reference uses its CPU encoder there too, gpujpeg_encoder.c:512-534;
// bit emitter gpujpeg_huffman_cpu_encoder.c:72-107).  Tokens come from
// the device tokenizer as (right-aligned codeword bits, bit length)
// pairs; zero-length slots are padding and are skipped.  Emits 0xFF ->
// 0xFF 0x00 stuffing and F.1.2.3 1-bit padding to the byte boundary.
// Returns bytes written, or -1 if out_cap would overflow.
int64_t gj_pack_tokens(const uint32_t* bits, const int32_t* lens,
                       int64_t n, uint8_t* out, int64_t out_cap) {
    uint64_t acc = 0;
    int nb = 0;
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        int l = lens[i];
        if (l <= 0) continue;
        uint32_t mask = (l >= 32) ? 0xFFFFFFFFu : ((1u << l) - 1u);
        acc = (acc << l) | (uint64_t)(bits[i] & mask);
        nb += l;
        while (nb >= 8) {
            uint8_t b = (uint8_t)(acc >> (nb - 8));
            if (w + 2 > out_cap) return -1;
            out[w++] = b;
            if (b == 0xFF) out[w++] = 0x00;
            nb -= 8;
        }
    }
    if (nb > 0) {
        uint8_t b = (uint8_t)(((acc << (8 - nb)) | ((1u << (8 - nb)) - 1u))
                              & 0xFFu);
        if (w + 2 > out_cap) return -1;
        out[w++] = b;
        if (b == 0xFF) out[w++] = 0x00;
    }
    return w;
}

// Decode APP13 segment-info chunks: big-endian u32 scan offsets ->
// absolute int64 stream positions (+= base), with an inline
// monotonicity check (replaces a numpy concat + byteswapping astype +
// compare chain that cost ~5-9 ms per 8K Q100 frame at 1.55 M
// segments).  chunk_offs/chunk_lens: positions/byte lengths of the
// chunk payloads inside `data`; lens must be 4-multiples (checked).
// Returns entries written, or -1 on a malformed chunk length.
int64_t gj_parse_offsets(const uint8_t* data, int64_t n_chunks,
                         const int64_t* chunk_offs,
                         const int64_t* chunk_lens, int64_t base,
                         int64_t* out, int64_t* bad) {
    int64_t total = 0;
    for (int64_t c = 0; c < n_chunks; ++c) {
        if (chunk_lens[c] % 4) return -1;
        total += chunk_lens[c] / 4;
    }
    // per-chunk output bases (exclusive prefix sum)
    int64_t nbad = 0;
#pragma omp parallel for schedule(static) reduction(+:nbad)
    for (int64_t c = 0; c < n_chunks; ++c) {
        int64_t o = 0;
        for (int64_t k = 0; k < c; ++k) o += chunk_lens[k] / 4;
        const uint8_t* p = data + chunk_offs[c];
        int64_t n = chunk_lens[c] / 4;
        int64_t prev = (o > 0) ? -1 : 0;  // cross-chunk check done below
        for (int64_t i = 0; i < n; ++i) {
            uint32_t v = ((uint32_t)p[4 * i] << 24)
                       | ((uint32_t)p[4 * i + 1] << 16)
                       | ((uint32_t)p[4 * i + 2] << 8)
                       | (uint32_t)p[4 * i + 3];
            int64_t a = (int64_t)v + base;
            out[o + i] = a;
            if (prev >= 0 && a < prev) ++nbad;
            prev = a;
        }
    }
    // cross-chunk monotonicity seams
    int64_t o = 0;
    for (int64_t c = 1; c < n_chunks; ++c) {
        o += chunk_lens[c - 1] / 4;
        if (o > 0 && out[o] < out[o - 1]) ++nbad;
    }
    *bad = nbad;
    return total;
}

// Deterministic LCG test-pattern fill (image_delegate.c:560-582).
void gj_lcg_fill(uint8_t* out, int64_t n, uint32_t seed) {
    const uint64_t A = 1664525u, C = 1013904223u, M = 2147483647u;
    uint64_t state = seed % M;
    for (int64_t i = 0; i < n; ++i) {
        state = (A * state + C) % M;
        out[i] = (uint8_t)(state % 256u);
    }
}

int gj_native_version(void) { return 4; }

}  // extern "C"

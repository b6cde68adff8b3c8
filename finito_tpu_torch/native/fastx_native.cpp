// Native FASTA/FASTQ parser + 2-bit encoder for finito_tpu.
//
// The framework's data loader, in C++ like the reference's native IO
// stacks (SBWT SeqIO::Reader and jseqio; see SURVEY.md sections 2.3/2.4).
// Single pass over a decompressed in-memory buffer: splits records,
// concatenates sequence payloads encoded as A=0 C=1 G=2 T=3 (255 for
// non-ACGT, case-insensitive), and records header/sequence boundaries.
// Exposed through a minimal extern "C" surface consumed via ctypes
// (no pybind11 in this environment).
//
// Grammar matches the Python reference implementation in
// finito_tpu/io/fastx.py (which mirrors jseqio reader.rs:100-188):
//   * FASTA: '>' header line; sequence may span multiple lines.
//   * FASTQ: '@' header, one sequence line, '+' line, one quality line
//     (multi-line FASTQ unsupported, like the reference).
//   * \r\n and \n line endings.
//
// Build: g++ -O3 -march=native -shared -fPIC (see build.py).

#include <cstdint>
#include <cstring>

namespace {

// byte -> 2-bit code table (A/C/G/T upper+lower; 255 otherwise)
struct Lut {
    uint8_t t[256];
    Lut() {
        memset(t, 255, sizeof(t));
        const char* b = "ACGT";
        for (int i = 0; i < 4; i++) {
            t[(uint8_t)b[i]] = (uint8_t)i;
            t[(uint8_t)(b[i] | 32)] = (uint8_t)i;
        }
    }
};
const Lut LUT;

inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
    const void* q = memchr(p, '\n', (size_t)(end - p));
    return q ? (const uint8_t*)q : end;
}

inline size_t line_len_no_cr(const uint8_t* p, const uint8_t* nl) {
    size_t n = (size_t)(nl - p);
    if (n > 0 && p[n - 1] == '\r') n--;
    return n;
}

}  // namespace

extern "C" {

// Parse + encode. Inputs: raw (decompressed) file bytes.
// Outputs (caller-allocated, sized by ftx_count):
//   codes       : uint8[total_seq_len]  2-bit codes (255 for non-ACGT)
//   seq_ends    : int64[n_records]     exclusive ends into codes
//   hdr_bytes   : uint8[total_hdr_len] concatenated header bytes
//   hdr_ends    : int64[n_records]    exclusive ends into hdr_bytes
// Returns 0 on success, negative error code on malformed input:
//   -1 unknown leading byte, -2 malformed FASTQ '+', -3 FASTQ qual length,
//   -4 FASTA record before first header.
int ftx_parse(const uint8_t* data, int64_t n, uint8_t* codes, int64_t* seq_ends,
              uint8_t* hdr_bytes, int64_t* hdr_ends, int64_t* out_counts) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    int64_t n_rec = 0, n_code = 0, n_hdr = 0;
    if (n == 0) {
        out_counts[0] = 0; out_counts[1] = 0; out_counts[2] = 0;
        return 0;
    }
    const bool fasta = (data[0] == '>');
    if (!fasta && data[0] != '@') return -1;

    if (fasta) {
        bool have_rec = false;
        while (p < end) {
            const uint8_t* nl = find_nl(p, end);
            size_t len = line_len_no_cr(p, nl);
            if (len > 0 && p[0] == '>') {
                if (have_rec) {
                    seq_ends[n_rec] = n_code;
                    hdr_ends[n_rec] = n_hdr;
                    n_rec++;
                }
                memcpy(hdr_bytes + n_hdr, p + 1, len - 1);
                n_hdr += (int64_t)(len - 1);
                have_rec = true;
            } else if (len > 0) {
                if (!have_rec) return -4;
                for (size_t i = 0; i < len; i++) codes[n_code + (int64_t)i] = LUT.t[p[i]];
                n_code += (int64_t)len;
            }
            p = nl < end ? nl + 1 : end;
        }
        if (have_rec) {
            seq_ends[n_rec] = n_code;
            hdr_ends[n_rec] = n_hdr;
            n_rec++;
        }
    } else {
        while (p < end) {
            const uint8_t* nl = find_nl(p, end);
            size_t hlen = line_len_no_cr(p, nl);
            if (hlen == 0 && nl >= end) break;  // trailing blank
            if (hlen == 0 || p[0] != '@') return -1;
            memcpy(hdr_bytes + n_hdr, p + 1, hlen - 1);
            n_hdr += (int64_t)(hlen - 1);
            p = nl < end ? nl + 1 : end;

            nl = find_nl(p, end);
            size_t slen = line_len_no_cr(p, nl);
            for (size_t i = 0; i < slen; i++) codes[n_code + (int64_t)i] = LUT.t[p[i]];
            n_code += (int64_t)slen;
            p = nl < end ? nl + 1 : end;

            nl = find_nl(p, end);
            if (p >= end || p[0] != '+') return -2;
            p = nl < end ? nl + 1 : end;

            nl = find_nl(p, end);
            size_t qlen = line_len_no_cr(p, nl);
            if (qlen != slen) return -3;
            p = nl < end ? nl + 1 : end;

            seq_ends[n_rec] = n_code;
            hdr_ends[n_rec] = n_hdr;
            n_rec++;
        }
    }
    out_counts[0] = n_rec;
    out_counts[1] = n_code;
    out_counts[2] = n_hdr;
    return 0;
}

// Upper bounds for output sizing: records <= lines/2 + 1; codes/headers
// bounded by the input size. Cheap single memchr pass.
void ftx_bounds(const uint8_t* data, int64_t n, int64_t* out) {
    int64_t lines = 1;
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    while (p < end) {
        const void* q = memchr(p, '\n', (size_t)(end - p));
        if (!q) break;
        lines++;
        p = (const uint8_t*)q + 1;
    }
    out[0] = lines + 1;  // max records
    out[1] = n;          // max total sequence bytes
    out[2] = n;          // max total header bytes
}

// Batched 2-bit encode of raw bytes (for query pipelines that bypass the
// record parser).
void ftx_encode(const uint8_t* data, int64_t n, uint8_t* codes) {
    for (int64_t i = 0; i < n; i++) codes[i] = LUT.t[data[i]];
}

// Reverse complement of a code buffer (255 passes through).
void ftx_revcomp_codes(const uint8_t* codes, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = codes[n - 1 - i];
        out[i] = c <= 3 ? (uint8_t)(3 - c) : c;
    }
}

}  // extern "C"

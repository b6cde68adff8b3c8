// Single-pass bit pack/unpack kernels for the sdsl int_vector codec.
//
// The Python fallback (utils/bits.py) expands every element into `width`
// separate bit lanes (~width x 8 bytes of temporaries per element); on
// the microVM hosts this code runs on, first-touch page faults make that
// expansion the dominant cost of loading a genome-scale index (measured:
// 21.7 s of a 35.6 s FinimizerIndex.load at 16 Mbp). These kernels touch
// only the input and output bytes once.
//
// Layout contract (must match utils/bits.py and sdsl-lite's int_vector
// data words, ref SURVEY.md section 2.2): element i occupies bits
// [i*width, (i+1)*width) of the little-endian 64-bit word stream,
// LSB-first, contiguous across word boundaries.

#include <cstdint>
#include <cstring>

// words -> out[n] unsigned elements; inverse of fin_pack_values. Narrow
// outputs let the caller touch width-matched bytes instead of 8
// bytes/element (first-touch page faults on the microVM hosts cost ~2
// orders of magnitude more than the decode itself). Caller guarantees
// width <= 8*sizeof(T). (Template: must live outside the extern "C"
// block -- templates cannot have C linkage.)
template <typename T>
static void unpack_to(const uint64_t* words, int64_t n, int64_t width, T* out) {
    const uint64_t mask = (width == 64) ? ~0ULL : ((1ULL << width) - 1);
    int64_t bit = 0;
    for (int64_t i = 0; i < n; ++i, bit += width) {
        const int64_t w = bit >> 6;
        const int off = (int)(bit & 63);
        uint64_t v = words[w] >> off;
        if (off + width > 64) v |= words[w + 1] << (64 - off);
        out[i] = (T)(v & mask);
    }
}

extern "C" {

// values[n] (each < 2^width) -> out_words[ceil(n*width/64)] (pre-zeroed
// by the caller is NOT required; we zero the tail).
void fin_pack_values(const uint64_t* values, int64_t n, int64_t width,
                     uint64_t* out_words) {
    const int64_t n_words = (n * width + 63) / 64;
    if (n_words == 0) return;
    std::memset(out_words, 0, (size_t)n_words * 8);
    if (width == 64) {
        std::memcpy(out_words, values, (size_t)n * 8);
        return;
    }
    const uint64_t mask = (width == 64) ? ~0ULL : ((1ULL << width) - 1);
    int64_t bit = 0;
    for (int64_t i = 0; i < n; ++i, bit += width) {
        const uint64_t v = values[i] & mask;
        const int64_t w = bit >> 6;
        const int off = (int)(bit & 63);
        out_words[w] |= v << off;
        if (off + width > 64) out_words[w + 1] |= v >> (64 - off);
    }
}

// out_bytes selects the output element type (1/2/4/8).
void fin_unpack_values(const uint64_t* words, int64_t n, int64_t width,
                       int64_t out_bytes, void* out_values) {
    if (width == 64 && out_bytes == 8) {
        std::memcpy(out_values, words, (size_t)n * 8);
        return;
    }
    switch (out_bytes) {
        case 1: unpack_to(words, n, width, (uint8_t*)out_values); break;
        case 2: unpack_to(words, n, width, (uint16_t*)out_values); break;
        case 4: unpack_to(words, n, width, (uint32_t*)out_values); break;
        default: unpack_to(words, n, width, (uint64_t*)out_values); break;
    }
}

// Slot-descriptor expansion for the minimizer engine: packed scalar
// descriptors (start << len_bits | len) -> (n, 2) int32 rows
// [start, exact_len] where exact_len = next start - start (the stored
// 6-bit length saturates; successive starts are a cumsum so the
// difference is exact). One pass, writes only the 8 bytes/slot output.
// desc may be uint32 or uint64 (desc_bytes selects).
void fin_desc_to_rows(const void* desc, int64_t n, int64_t desc_bytes,
                      int64_t len_bits, int32_t* out_rows) {
    if (n <= 0) return;
    if (desc_bytes == 4) {
        const uint32_t* d = (const uint32_t*)desc;
        uint32_t prev = d[0] >> len_bits;
        for (int64_t i = 0; i + 1 < n; ++i) {
            const uint32_t next = d[i + 1] >> len_bits;
            out_rows[2 * i] = (int32_t)prev;
            out_rows[2 * i + 1] = (int32_t)(next - prev);
            prev = next;
        }
        out_rows[2 * (n - 1)] = (int32_t)prev;
        out_rows[2 * (n - 1) + 1] = 0;
    } else {
        const uint64_t* d = (const uint64_t*)desc;
        uint64_t prev = d[0] >> len_bits;
        for (int64_t i = 0; i + 1 < n; ++i) {
            const uint64_t next = d[i + 1] >> len_bits;
            out_rows[2 * i] = (int32_t)prev;
            out_rows[2 * i + 1] = (int32_t)(next - prev);
            prev = next;
        }
        out_rows[2 * (n - 1)] = (int32_t)prev;
        out_rows[2 * (n - 1) + 1] = 0;
    }
}

}  // extern "C"

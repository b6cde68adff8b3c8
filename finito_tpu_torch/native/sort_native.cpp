// Native host-side build kernels: radix argsort over multiword keys,
// sorted merge-join, rolling window packing, and the builder's
// validity-constrained sliding window minimum.
//
// Rationale: the host build pipeline (SBWT construction + finimizer
// selection, see finito_tpu/sbwt/construct.py and index/builder.py) is
// sort-bound, and this box has ONE core -- numpy's argsort/lexsort are
// comparison sorts with indirection (~40s per 50M argsort) while an LSD
// radix over 16-bit digits streams memory at copy speed. These kernels
// make genome-scale (>= 100 Mbp) index builds practical on the host; the
// accelerator path stays JAX (finito_tpu/ops). Python fallbacks in
// finito_tpu/sbwt/keys.py implement identical semantics (differentially
// tested).
//
// Key layout: a set of n W-word keys is word-major (words[w*n + i] =
// word w of key i), least-significant word first -- matching the list-
// of-arrays layout of finito_tpu/sbwt/keys.py.

#include <cstdint>
#include <cstring>
#include <atomic>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

inline int key_compare(const uint64_t* A, int64_t nA, int64_t i,
                       const uint64_t* B, int64_t nB, int64_t j, int64_t W) {
    for (int64_t w = W - 1; w >= 0; w--) {
        uint64_t a = A[w * nA + i], b = B[w * nB + j];
        if (a < b) return -1;
        if (a > b) return 1;
    }
    return 0;
}

}  // namespace

extern "C" {

namespace {

// Stable LSD radix over 16-bit digits of [lo, hi) records in `a`,
// scratch in `b` (both R-word records, key words LSW-first then the
// original index). Sorts digits [0, n_digits). Result left in `a`
// (copied back if it lands in scratch).
void lsd_radix_records(uint64_t* a, uint64_t* b, int64_t n, int64_t R,
                       int n_digits) {
    if (n <= 1) return;
    std::vector<int64_t> hist((size_t)n_digits * 65536, 0);
    for (int64_t i = 0; i < n; i++)
        for (int d = 0; d < n_digits; d++) {
            const int w = d >> 2, sh = (d & 3) << 4;
            hist[(size_t)d * 65536 + ((a[i * R + w] >> sh) & 0xFFFF)]++;
        }
    uint64_t* src = a;
    uint64_t* dst = b;
    for (int d = 0; d < n_digits; d++) {
        int64_t* h = hist.data() + (size_t)d * 65536;
        const int w = d >> 2, sh = (d & 3) << 4;
        const uint64_t first_dig = (src[0 * R + w] >> sh) & 0xFFFF;
        if (h[first_dig] == n) continue;  // constant digit: skip pass
        int64_t sum = 0;
        for (int j = 0; j < 65536; j++) {
            int64_t c = h[j];
            h[j] = sum;
            sum += c;
        }
        for (int64_t i = 0; i < n; i++) {
            const uint64_t dig = (src[i * R + w] >> sh) & 0xFFFF;
            uint64_t* out = dst + h[dig]++ * R;
            const uint64_t* in = src + i * R;
            for (int64_t t = 0; t < R; t++) out[t] = in[t];
        }
        uint64_t* tmp = src;
        src = dst;
        dst = tmp;
    }
    if (src != a) std::memcpy(a, src, (size_t)n * R * sizeof(uint64_t));
}

}  // namespace

// Stable radix argsort of n W-word keys: one MSD pass over the top 8
// used bits partitions records into 256 buckets (built straight from
// the word-major input into a SINGLE record buffer), then each bucket
// is LSD-sorted over the remaining digits with a scratch sized to the
// largest bucket. Peak memory = n*(W+1) words + max_bucket*(W+1) words
// (~half of a classic two-buffer LSD at genome scale -- this host
// provisions fresh memory at ~10-60 MB/s, so peak bytes are build
// time). used_bits caps the digit count (pass 3*k for 3-bit-packed
// length-k rows). idx_out: int64[n]. keys_out (optional, may be null):
// the sorted keys, word-major.
void fin_radix_argsort(const uint64_t* words, int64_t n, int64_t W,
                       int64_t used_bits, int64_t* idx_out,
                       uint64_t* keys_out) {
    if (n <= 0) return;
    const int64_t R = W + 1;
    if (used_bits > 64 * W) used_bits = 64 * W;
    if (used_bits < 1) used_bits = 1;

    // top-8-used-bits bucket of a key (from the word-major input)
    const int64_t top_lo = used_bits > 8 ? used_bits - 8 : 0;
    const int64_t tw = top_lo >> 6, tr = top_lo & 63;
    auto bucket_of = [&](int64_t i) -> int {
        uint64_t v = words[tw * n + i] >> tr;
        if (tr && tw + 1 < W) v |= words[(tw + 1) * n + i] << (64 - tr);
        return (int)(v & 0xFF);
    };

    int64_t counts[256] = {0};
    for (int64_t i = 0; i < n; i++) counts[bucket_of(i)]++;
    int64_t starts[257];
    starts[0] = 0;
    int64_t max_bucket = 0;
    for (int j = 0; j < 256; j++) {
        starts[j + 1] = starts[j] + counts[j];
        if (counts[j] > max_bucket) max_bucket = counts[j];
    }

    std::vector<uint64_t> buf((size_t)n * R);
    uint64_t* a = buf.data();
    {
        int64_t cur[256];
        for (int j = 0; j < 256; j++) cur[j] = starts[j];
        for (int64_t i = 0; i < n; i++) {  // stable: ascending i per bucket
            uint64_t* out = a + cur[bucket_of(i)]++ * R;
            for (int64_t w = 0; w < W; w++) out[w] = words[w * n + i];
            out[W] = (uint64_t)i;
        }
    }

    // Within-bucket LSD over every digit below top_lo. The digit range
    // rounds UP to 16-bit boundaries, so it can include bits of the
    // bucket byte itself -- harmless: those bits are constant inside a
    // bucket, and bits above used_bits are unused by contract.
    const int n_digits = (int)((top_lo + 15) / 16);
    int n_threads = 1;
    if (const char* t = std::getenv("FINITO_THREADS")) {
        n_threads = std::atoi(t);
        if (n_threads < 1) n_threads = 1;
        if (n_threads > 64) n_threads = 64;
    }
    if (n_threads <= 1 || n <= (1 << 16)) {
        std::vector<uint64_t> scratch((size_t)max_bucket * R);
        for (int j = 0; j < 256; j++)
            lsd_radix_records(a + starts[j] * R, scratch.data(), counts[j], R,
                              n_digits);
    } else {
        // buckets are independent; workers pull the next bucket off an
        // atomic counter, each with its own scratch. Output layout is
        // fixed by `starts`, so the result is thread-count-invariant.
        std::atomic<int> next{0};
        auto worker = [&]() {
            std::vector<uint64_t> scratch((size_t)max_bucket * R);
            for (;;) {
                const int j = next.fetch_add(1);
                if (j >= 256) break;
                lsd_radix_records(a + starts[j] * R, scratch.data(),
                                  counts[j], R, n_digits);
            }
        };
        std::vector<std::thread> pool;
        for (int t2 = 1; t2 < n_threads; t2++) pool.emplace_back(worker);
        worker();
        for (auto& th : pool) th.join();
    }

    for (int64_t i = 0; i < n; i++) idx_out[i] = (int64_t)a[i * R + W];
    if (keys_out) {
        for (int64_t i = 0; i < n; i++)
            for (int64_t w = 0; w < W; w++) keys_out[w * n + i] = a[i * R + w];
    }
}

// For each key of sorted A (duplicates allowed), the index of an equal
// key in sorted unique B, or -1. Linear two-pointer merge.
void fin_merge_join(const uint64_t* A, int64_t nA, const uint64_t* B,
                    int64_t nB, int64_t W, int64_t* out) {
    int64_t j = 0;
    for (int64_t i = 0; i < nA; i++) {
        while (j < nB && key_compare(B, nB, j, A, nA, i, W) < 0) j++;
        out[i] = (j < nB && key_compare(B, nB, j, A, nA, i, W) == 0) ? j : -1;
    }
}

// For each key of sorted A, the number of keys of sorted B strictly
// below it (lower bound). Linear two-pointer merge.
void fin_lower_bound(const uint64_t* A, int64_t nA, const uint64_t* B,
                     int64_t nB, int64_t W, int64_t* out) {
    int64_t j = 0;
    for (int64_t i = 0; i < nA; i++) {
        while (j < nB && key_compare(B, nB, j, A, nA, i, W) < 0) j++;
        out[i] = j;
    }
}

// best[idx[i]] = max(best[idx[i]], key[i]) -- numpy's ufunc.at runs at
// ~1us/element; this is a plain random-write loop.
void fin_scatter_max(int64_t* best, const int64_t* idx, const int64_t* key,
                     int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        const int64_t t = idx[i];
        if (key[i] > best[t]) best[t] = key[i];
    }
}

// All length-k windows of a 2-bit code sequence as W-word 3-bit-packed
// keys (char+1 at bits [3p, 3p+3) for window position p), word-major
// output out[w*nw + i]. Rolling update: one shift-right-3 per window.
void fin_pack_windows(const uint8_t* codes, int64_t n, int64_t k,
                      uint64_t* out) {
    const int64_t nw = n - k + 1;
    if (nw <= 0) return;
    const int64_t W = (3 * k + 63) / 64;
    // key words of the current window, LSW first.
    // W = ceil(3k/64) <= 12 for k <= 255 (the builder's hard k cap);
    // the Python wrapper refuses larger W before calling in.
    uint64_t cur[12] = {0};
    if (W > 12) return;
    for (int64_t p = 0; p < k; p++) {
        const uint64_t c = (uint64_t)(codes[p] + 1);
        const int64_t bit = 3 * p, q = bit >> 6, r = bit & 63;
        cur[q] |= c << r;
        if (r > 61 && q + 1 < W) cur[q + 1] |= c >> (64 - r);
    }
    const int64_t top_bit = 3 * (k - 1), tq = top_bit >> 6, tr = top_bit & 63;
    for (int64_t i = 0;; i++) {
        for (int64_t w = 0; w < W; w++) out[w * nw + i] = cur[w];
        if (i + 1 >= nw) break;
        // drop first char, append next at position k-1
        for (int64_t w = 0; w < W; w++) {
            cur[w] >>= 3;
            if (w + 1 < W) cur[w] |= cur[w + 1] << 61;
        }
        const uint64_t c = (uint64_t)(codes[i + k] + 1);
        cur[tq] |= c << tr;
        if (tr > 61 && tq + 1 < W) cur[tq + 1] |= c >> (64 - tr);
    }
}

// The builder's per-window candidate minimum (finito_tpu/index/builder.py
// _build_fast): cand_key[p] = (len << 48) | (colex << 8) at candidate
// end positions (>= BIGKEY when no candidate); for every window
// ws in [s, e-k] of each unitig [s, e) emit
//   min over p in [ws, ws+k-1] with len(p) <= p-ws+1
//       of (cand_key[p] | (p - ws)),
// or BIGKEY if no candidate qualifies. Monotone-deque O(n) total; the
// deque holds (key, p) with keys strictly increasing front to back (the
// low 8 r-bits never tie: distinct candidates have distinct colex).
void fin_window_min(const int64_t* cand_key, const int64_t* ends,
                    int64_t n_u, int64_t k, int64_t bigkey,
                    int64_t* out) {
    // up to k+1 entries can be live between insertion and front expiry
    std::vector<int64_t> dq_key((size_t)k + 2), dq_pos((size_t)k + 2);
    int64_t widx = 0;
    int64_t s = 0;
    for (int64_t u = 0; u < n_u; u++) {
        const int64_t e = ends[u];
        if (e - s >= k) {
            int64_t head = 0, tail = 0;  // [head, tail)
            for (int64_t p = s; p < e; p++) {
                const int64_t key = cand_key[p];
                if ((key >> 48) <= k) {
                    while (tail > head && dq_key[tail - 1] > key) tail--;
                    if (tail == (int64_t)dq_key.size()) {
                        // compact (ring not needed: <= k live entries)
                        const int64_t m = tail - head;
                        for (int64_t t = 0; t < m; t++) {
                            dq_key[t] = dq_key[head + t];
                            dq_pos[t] = dq_pos[head + t];
                        }
                        head = 0;
                        tail = m;
                    }
                    dq_key[tail] = key;
                    dq_pos[tail] = p;
                    tail++;
                }
                const int64_t ws = p - k + 1;
                if (ws >= s) {
                    while (tail > head &&
                           dq_pos[head] - (dq_key[head] >> 48) + 1 < ws)
                        head++;
                    out[widx++] = (tail > head)
                                      ? (dq_key[head] | (dq_pos[head] - ws))
                                      : bigkey;
                }
            }
        }
        s = e;
    }
}

// Leftmost-lowest minimizer positions (finito_tpu/index/minimizer.py
// build loop): for each unitig [s, e) with e-s >= k, for each window
// ws in [s, e-k], the position of the leftmost minimum of hv[ws..ws+R-1]
// (R = k-m+1). Deduplicated ascending positions are appended to out;
// returns the count. Monotone deque, O(n) total.
int64_t fin_minimizer_positions(const uint32_t* hv, const int64_t* ends,
                                int64_t n_u, int64_t k, int64_t m,
                                int64_t* out) {
    const int64_t R = k - m + 1;
    std::vector<int64_t> dq_pos((size_t)R + 2);
    int64_t count = 0;
    int64_t s = 0;
    for (int64_t u = 0; u < n_u; u++) {
        const int64_t e = ends[u];
        if (e - s >= k) {
            int64_t head = 0, tail = 0;
            int64_t last_emit = -1;
            // window of m-mer positions [ws, ws+R-1], ws in [s, e-k]
            for (int64_t p = s; p <= e - m; p++) {
                const uint32_t v = hv[p];
                // strict >: keeps the LEFTMOST minimum at the front
                while (tail > head && hv[dq_pos[tail - 1]] > v) tail--;
                if (tail == (int64_t)dq_pos.size()) {
                    const int64_t mm = tail - head;
                    for (int64_t t = 0; t < mm; t++) dq_pos[t] = dq_pos[head + t];
                    head = 0;
                    tail = mm;
                }
                dq_pos[tail++] = p;
                const int64_t ws = p - R + 1;
                if (ws >= s) {
                    while (tail > head && dq_pos[head] < ws) head++;
                    const int64_t best = dq_pos[head];
                    if (best != last_emit) {
                        out[count++] = best;
                        last_emit = best;
                    }
                }
            }
        }
        s = e;
    }
    return count;
}

// Render search-fmin output lines: for each line i with line_lens[i]
// pairs, writes "(u,p) (u,p) ...\n" (empty line for 0 pairs) from the
// flat u/p streams. Returns bytes written (caller sizes out as
// 27*n_pairs + n_lines, the worst case for two int32s per pair).
int64_t fin_format_pairs(const int32_t* u, const int32_t* p,
                         const int64_t* line_lens, int64_t n_lines,
                         uint8_t* out) {
    uint8_t* w = out;
    auto put_int = [&w](int64_t v) {
        if (v < 0) {
            *w++ = '-';
            v = -v;
        }
        uint8_t tmp[12];
        int t = 0;
        do {
            tmp[t++] = (uint8_t)('0' + v % 10);
            v /= 10;
        } while (v);
        while (t) *w++ = tmp[--t];
    };
    int64_t idx = 0;
    for (int64_t i = 0; i < n_lines; i++) {
        const int64_t n = line_lens[i];
        for (int64_t j = 0; j < n; j++, idx++) {
            if (j) *w++ = ' ';
            *w++ = '(';
            put_int(u[idx]);
            *w++ = ',';
            put_int(p[idx]);
            *w++ = ')';
        }
        *w++ = '\n';
    }
    return (int64_t)(w - out);
}

namespace {

// ---- simplitigs helpers: single packed keys as local word buffers ----
constexpr int64_t SIMP_W_MAX = 12;  // k <= 250 -> ceil(3k/64) <= 12

inline void skey_load(const uint64_t* keys, int64_t n, int64_t i, int64_t W,
                      uint64_t* out) {
    for (int64_t w = 0; w < W; w++) out[w] = keys[w * n + i];
}

inline int64_t skey_bsearch(const uint64_t* keys, int64_t n, int64_t W,
                            const uint64_t* q) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        int c = 0;
        for (int64_t w = W - 1; w >= 0; w--) {
            uint64_t a = keys[w * n + mid];
            if (a < q[w]) { c = -1; break; }
            if (a > q[w]) { c = 1; break; }
        }
        if (c < 0) lo = mid + 1; else hi = mid;
    }
    if (lo >= n) return -1;
    for (int64_t w = 0; w < W; w++)
        if (keys[w * n + lo] != q[w]) return -1;
    return lo;
}

inline uint64_t skey_char(const uint64_t* a, int64_t W, int64_t p) {
    int64_t bit = 3 * p, q = bit >> 6, r = bit & 63;
    uint64_t v = a[q] >> r;
    if (r > 61 && q + 1 < W) v |= a[q + 1] << (64 - r);
    return v & 7ULL;
}

inline void skey_set_char(uint64_t* a, int64_t W, int64_t p, uint64_t c) {
    int64_t bit = 3 * p, q = bit >> 6, r = bit & 63;
    a[q] |= c << r;
    if (r > 61 && q + 1 < W) a[q + 1] |= c >> (64 - r);
}

inline void skey_rc(const uint64_t* a, int64_t W, int64_t k, uint64_t* out) {
    for (int64_t w = 0; w < W; w++) out[w] = 0;
    for (int64_t p = 0; p < k; p++)
        skey_set_char(out, W, k - 1 - p, 5ULL - skey_char(a, W, p));
}

inline int skey_cmp(const uint64_t* a, const uint64_t* b, int64_t W) {
    for (int64_t w = W - 1; w >= 0; w--) {
        if (a[w] < b[w]) return -1;
        if (a[w] > b[w]) return 1;
    }
    return 0;
}

// greedy right-extension of (cur, cur_rc); consumed chars (1..4) go to
// `chars` when non-null; returns the number of extensions.
inline int64_t simp_extend(const uint64_t* keys, int64_t n, int64_t W, int64_t k,
                           uint8_t* used, uint64_t* cur, uint64_t* cur_rc,
                           uint8_t* chars, int64_t* n_chars) {
    uint64_t base[SIMP_W_MAX], base_rc[SIMP_W_MAX];
    uint64_t y[SIMP_W_MAX], yr[SIMP_W_MAX];
    int64_t cnt = 0;
    for (;;) {
        // base = cur >> 3 (drop first char)
        for (int64_t w = 0; w < W; w++) {
            base[w] = cur[w] >> 3;
            if (w + 1 < W) base[w] |= cur[w + 1] << 61;
        }
        // base_rc = (cur_rc keep low k-1 chars) << 3
        {
            int64_t bit = 3 * (k - 1);
            uint64_t masked[SIMP_W_MAX];
            for (int64_t w = 0; w < W; w++) {
                int64_t lo = 64 * w, hi = lo + 64;
                if (bit >= hi) masked[w] = cur_rc[w];
                else if (bit <= lo) masked[w] = 0;
                else masked[w] = cur_rc[w] & ((1ULL << (bit - lo)) - 1);
            }
            for (int64_t w = W - 1; w >= 0; w--) {
                base_rc[w] = masked[w] << 3;
                if (w > 0) base_rc[w] |= masked[w - 1] >> 61;
            }
        }
        bool found = false;
        for (uint64_t c = 1; c <= 4 && !found; c++) {
            for (int64_t w = 0; w < W; w++) { y[w] = base[w]; yr[w] = base_rc[w]; }
            skey_set_char(y, W, k - 1, c);
            yr[0] |= (5ULL - c);
            const uint64_t* q = skey_cmp(y, yr, W) <= 0 ? y : yr;
            int64_t j = skey_bsearch(keys, n, W, q);
            if (j >= 0 && !used[j]) {
                used[j] = 1;
                if (chars) chars[(*n_chars)++] = (uint8_t)c;
                cnt++;
                for (int64_t w = 0; w < W; w++) { cur[w] = y[w]; cur_rc[w] = yr[w]; }
                found = true;
            }
        }
        if (!found) break;
    }
    return cnt;
}

}  // namespace

// Greedy maximal walks (simplitigs) over a sorted canonical k-mer set
// (word-major keys, LSW first). Two modes sharing one deterministic
// traversal: write == 0 counts (out_total/out_walks), write == 1 fills
// out_chars (0..3 codes, walks back to back) + out_ends (exclusive).
// `scratch` must hold >= 2n + 2k uint8 (left/right char stacks).
void fin_simplitigs(const uint64_t* keys, int64_t n, int64_t W, int64_t k,
                    uint8_t* used, uint8_t* scratch, int write,
                    uint8_t* out_chars, int64_t* out_ends,
                    int64_t* out_total, int64_t* out_walks) {
    uint64_t cur[SIMP_W_MAX], cur_rc[SIMP_W_MAX];
    uint8_t* right = scratch;
    uint8_t* left = scratch + n + k;
    int64_t total = 0, walks = 0, wpos = 0;
    for (int64_t i = 0; i < n; i++) used[i] = 0;
    for (int64_t seed = 0; seed < n; seed++) {
        if (used[seed]) continue;
        used[seed] = 1;
        int64_t nr = 0, nl = 0;
        skey_load(keys, n, seed, W, cur);
        skey_rc(cur, W, k, cur_rc);
        simp_extend(keys, n, W, k, used, cur, cur_rc, right, &nr);
        // left: walk successors of the seed's RC orientation; char c
        // there is predecessor char comp(c) prepended in the output
        skey_load(keys, n, seed, W, cur_rc);
        skey_rc(cur_rc, W, k, cur);  // cur = rc(seed), cur_rc = seed
        simp_extend(keys, n, W, k, used, cur, cur_rc, left, &nl);
        int64_t len = k + nr + nl;
        total += len;
        walks++;
        if (write) {
            for (int64_t i = nl - 1; i >= 0; i--)
                out_chars[wpos++] = (uint8_t)(5 - left[i]) - 1;
            skey_load(keys, n, seed, W, cur);
            for (int64_t p = 0; p < k; p++)
                out_chars[wpos++] = (uint8_t)skey_char(cur, W, p) - 1;
            for (int64_t i = 0; i < nr; i++)
                out_chars[wpos++] = right[i] - 1;
            out_ends[walks - 1] = wpos;
        }
    }
    *out_total = total;
    *out_walks = walks;
}

}  // extern "C"

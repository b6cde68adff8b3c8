"""Multiword packed k-mer keys: the construction-time representation.

A length-k row over the 5-letter alphabet {$=0, A=1, C=2, G=3, T=4}
packs into ceil(3k/64) uint64 words, char at position p occupying bits
[3p, 3p+3) (little-endian in positions). Then:

  * colexicographic compare  == numeric compare (last char is most
    significant);
  * drop the FIRST char      == shift right by 3;
  * drop the LAST char       == mask off the top 3 bits;
  * the $-padded dummy $^(k-j) x[0:j] == (x & low(3j)) << 3(k-j).

Everything the SBWT constructor needs (sort, dedup, set membership,
exact match) becomes vectorized word arithmetic -- no byte-matrix
string views, whose numpy set operations dominate construction time at
genome scale.

Keys are stored as a list of W uint64 arrays, least-significant word
first.
"""

from __future__ import annotations

from typing import List

import numpy as np

U64 = np.uint64


def n_words(k: int) -> int:
    return (3 * k + 63) // 64


def pack_rows(mat: np.ndarray) -> List[np.ndarray]:
    """(n, k) uint8 rows (values 0..4) -> W-word keys."""
    n, k = mat.shape
    W = n_words(k)
    words = [np.zeros(n, dtype=U64) for _ in range(W)]
    for p in range(k):
        c = mat[:, p].astype(U64)
        bit = 3 * p
        q, r = bit >> 6, bit & 63
        words[q] |= c << U64(r)
        if r > 61 and q + 1 < W:
            words[q + 1] |= c >> U64(64 - r)
    return words


def pack_windows(codes: np.ndarray, k: int) -> List[np.ndarray]:
    """All k-windows of one code sequence (values 0..3 -> stored +1),
    as W-word keys; (len-k+1) windows."""
    from finito_tpu_torch import native

    if codes.size >= k:
        out = native.pack_windows(codes, k)
        if out is not None:
            return out
    nw = codes.size - k + 1
    W = n_words(k)
    words = [np.zeros(nw, dtype=U64) for _ in range(W)]
    for p in range(k):
        c = codes[p : p + nw].astype(U64) + U64(1)
        bit = 3 * p
        q, r = bit >> 6, bit & 63
        words[q] |= c << U64(r)
        if r > 61 and q + 1 < W:
            words[q + 1] |= c >> U64(64 - r)
    return words


def concat(keys_list: List[List[np.ndarray]]) -> List[np.ndarray]:
    W = len(keys_list[0])
    return [np.concatenate([ks[w] for ks in keys_list]) for w in range(W)]


def empty(W: int) -> List[np.ndarray]:
    return [np.zeros(0, dtype=U64) for _ in range(W)]


def take(keys: List[np.ndarray], idx) -> List[np.ndarray]:
    return [w[idx] for w in keys]


def used_bits(keys: List[np.ndarray]) -> int:
    """Bits actually used by the keys: full low words + the occupied bits
    of the most significant nonzero word (one max pass, guides the native
    radix's digit count)."""
    for w in range(len(keys) - 1, -1, -1):
        hi = int(keys[w].max()) if keys[w].size else 0
        if hi:
            return 64 * w + hi.bit_length()
    return 1


def sort_order(keys: List[np.ndarray]) -> np.ndarray:
    """Indices sorting keys ascending (colex of the rows)."""
    from finito_tpu_torch import native

    idx = native.radix_argsort(keys, used_bits(keys))
    if idx is not None:
        return idx
    if len(keys) == 1:
        return np.argsort(keys[0], kind="stable")
    # np.lexsort: LAST key is primary = the most significant word
    return np.lexsort(tuple(keys))


def sort_keys(keys: List[np.ndarray]) -> List[np.ndarray]:
    """The keys themselves in ascending order (native path skips the
    separate fancy-index gather)."""
    from finito_tpu_torch import native

    res = native.radix_argsort(keys, used_bits(keys), want_keys=True)
    if res is not None:
        return res[1]
    return take(keys, sort_order(keys))


def is_sorted_unique(keys: List[np.ndarray]) -> bool:
    """True iff the keys are strictly increasing."""
    n = keys[0].size
    if n <= 1:
        return True
    cmp = np.zeros(n - 1, dtype=np.int8)
    for w in keys:  # LSW -> MSW; a more significant difference overrides
        c = (w[1:] > w[:-1]).astype(np.int8) - (w[1:] < w[:-1]).astype(np.int8)
        np.copyto(cmp, c, where=c != 0)
    return bool(np.all(cmp > 0))


def eq_adjacent(keys: List[np.ndarray]) -> np.ndarray:
    """mask[i] = keys[i] == keys[i-1] (sorted input); mask[0] = False."""
    n = keys[0].size
    out = np.ones(n, dtype=bool)
    if n:
        out[0] = False
    for w in keys:
        out[1:] &= w[1:] == w[:-1]
    return out


def dedup_sorted(keys: List[np.ndarray]) -> List[np.ndarray]:
    keep = ~eq_adjacent(keys)
    return [w[keep] for w in keys]


def shift_right3(keys: List[np.ndarray]) -> List[np.ndarray]:
    """Drop the first char: value >> 3 across words."""
    W = len(keys)
    out = []
    for i in range(W):
        w = keys[i] >> U64(3)
        if i + 1 < W:
            w = w | (keys[i + 1] << U64(61))
        out.append(w)
    return out


def mask_low(keys: List[np.ndarray], chars: int) -> List[np.ndarray]:
    """Keep only the low `chars` characters (3*chars bits)."""
    bit = 3 * chars
    out = []
    for i, w in enumerate(keys):
        lo, hi = 64 * i, 64 * i + 64
        if bit >= hi:
            out.append(w.copy())
        elif bit <= lo:
            out.append(np.zeros_like(w))
        else:
            out.append(w & U64((1 << (bit - lo)) - 1))
    return out


def shift_left(keys: List[np.ndarray], chars: int) -> List[np.ndarray]:
    """value << 3*chars (words beyond W are dropped; caller guarantees
    the result fits, as for dummy construction)."""
    bit = 3 * chars
    q, r = bit >> 6, bit & 63
    W = len(keys)
    out = [np.zeros_like(keys[0]) for _ in range(W)]
    for i in range(W):
        j = i + q
        if j < W:
            out[j] |= keys[i] << U64(r)
        if r and j + 1 < W:
            out[j + 1] |= keys[i] >> U64(64 - r)
    return out


def top_char(keys: List[np.ndarray], k: int) -> np.ndarray:
    """The last (most significant) char of each key: bits [3(k-1), 3k)."""
    bit = 3 * (k - 1)
    q, r = bit >> 6, bit & 63
    v = keys[q] >> U64(r)
    if r > 61 and q + 1 < len(keys):
        v = v | (keys[q + 1] << U64(64 - r))
    return (v & U64(7)).astype(np.int64)


def match_into(A: List[np.ndarray], B: List[np.ndarray]) -> np.ndarray:
    """For each A key, the index of an equal key in B, or -1.

    One combined lexsort + equal-run propagation; B keys need not be
    unique (the first B index in the run wins) but callers here use
    unique B. O((|A|+|B|) log) with pure word ops.
    """
    from finito_tpu_torch import native

    nA, nB = A[0].size, B[0].size
    if nA == 0:
        return np.zeros(0, dtype=np.int64)
    if nB == 0:
        return np.full(nA, -1, dtype=np.int64)
    if native.get_lib() is not None and is_sorted_unique(B):
        # every construction-path B is sorted unique: radix-sort A and
        # linear-merge against B instead of one combined lexsort
        res = native.radix_argsort(A, used_bits(A), want_keys=True)
        if res is not None:
            idxA, A_sorted = res
            pos = native.merge_join(A_sorted, B)
            out = np.empty(nA, dtype=np.int64)
            out[idxA] = pos
            return out
    comb = [np.concatenate([a, b]) for a, b in zip(A, B)]
    order = sort_order(comb)
    sorted_keys = take(comb, order)
    new_run = ~eq_adjacent(sorted_keys)
    run_id = np.cumsum(new_run) - 1
    n_runs = int(run_id[-1]) + 1
    rep = np.full(n_runs, -1, dtype=np.int64)
    is_b = order >= nA
    # reversed so the FIRST B element of each run wins
    rep[run_id[is_b][::-1]] = (order[is_b][::-1] - nA)
    out = np.full(nA, -1, dtype=np.int64)
    is_a = ~is_b
    out[order[is_a]] = rep[run_id[is_a]]
    return out


def member(A: List[np.ndarray], B: List[np.ndarray]) -> np.ndarray:
    return match_into(A, B) >= 0


def merge_sorted_unique(A: List[np.ndarray], B: List[np.ndarray]) -> List[np.ndarray]:
    """Sorted-unique union of two sorted-unique key lists in O(|A|+|B|)
    (native two-pointer lower_bound + two scatters), without re-sorting
    the accumulated side -- the building block for incremental k-mer
    set collection at pangenome scale (peak memory ~ distinct + batch
    instead of all windows at once)."""
    from finito_tpu_torch import native

    if A[0].size == 0:
        return [w.copy() for w in B]
    if B[0].size == 0:
        return [w.copy() for w in A]
    dup = match_into(B, A) >= 0
    if dup.all():
        return A
    Bn = [w[~dup] for w in B]
    lb = native.lower_bound(Bn, A)
    if lb is None:  # no native library: one combined sort
        return dedup_sorted(sort_keys(concat([A, Bn])))
    nA, nB = A[0].size, Bn[0].size
    pos_B = lb + np.arange(nB, dtype=np.int64)
    # A[i] shifts right by the number of new keys below it:
    # Bn[j] < A[i]  <=>  lb[j] <= i  (Bn[j] is not in A)
    pos_A = np.arange(nA, dtype=np.int64) + np.searchsorted(
        lb, np.arange(nA, dtype=np.int64), side="right"
    )
    out = [np.empty(nA + nB, dtype=U64) for _ in A]
    for w, aw, bw in zip(out, A, Bn):
        w[pos_A] = aw
        w[pos_B] = bw
    return out


def cmp_keys(A: List[np.ndarray], B: List[np.ndarray]) -> np.ndarray:
    """Elementwise colex compare of equal-length key lists: int8 sign."""
    cmp = np.zeros(A[0].shape, dtype=np.int8)
    for a, b in zip(A, B):  # LSW -> MSW: later (more significant) wins
        c = (a > b).astype(np.int8) - (a < b).astype(np.int8)
        np.copyto(cmp, c, where=c != 0)
    return cmp


def select_keys(flag: np.ndarray, A: List[np.ndarray], B: List[np.ndarray]):
    """Elementwise flag ? A : B over key lists."""
    return [np.where(flag, a, b) for a, b in zip(A, B)]


def rc_keys(keys: List[np.ndarray], k: int) -> List[np.ndarray]:
    """Reverse complement of packed keys: char c at position p (values
    1..4) becomes 5-c at position k-1-p. k passes of word arithmetic."""
    n = keys[0].size
    W = len(keys)
    out = [np.zeros(n, dtype=U64) for _ in range(W)]
    five = U64(5)
    for p in range(k):
        bit = 3 * p
        q, r = bit >> 6, bit & 63
        c = keys[q] >> U64(r)
        if r > 61 and q + 1 < W:
            c = c | (keys[q + 1] << U64(64 - r))
        c = c & U64(7)
        comp = five - c
        tb = 3 * (k - 1 - p)
        tq, tr = tb >> 6, tb & 63
        out[tq] |= comp << U64(tr)
        if tr > 61 and tq + 1 < W:
            out[tq + 1] |= comp >> U64(64 - tr)
    return out


def set_top_char(keys: List[np.ndarray], k: int, c: int) -> List[np.ndarray]:
    """keys | (c << 3(k-1)) -- caller guarantees the slot is zero."""
    bit = 3 * (k - 1)
    q, r = bit >> 6, bit & 63
    out = [w.copy() for w in keys]
    cv = U64(c)
    out[q] = out[q] | (cv << U64(r))
    if r > 61 and q + 1 < len(keys):
        out[q + 1] = out[q + 1] | (cv >> U64(64 - r))
    return out


def unpack_char(keys: List[np.ndarray], p: int) -> np.ndarray:
    """Char value (1..4) at position p of each key."""
    bit = 3 * p
    q, r = bit >> 6, bit & 63
    v = keys[q] >> U64(r)
    if r > 61 and q + 1 < len(keys):
        v = v | (keys[q + 1] << U64(64 - r))
    return (v & U64(7)).astype(np.int64)

"""In-memory plain-matrix SBWT construction from a string set.

Host replacement for the reference's (absent) SBWT submodule
``NodeBOSSInMemoryConstructor<plain_matrix_sbwt_t>::build``
(call site: src/tests.cpp:44-46). Semantics reconstructed
from the node tables annotated in the reference's tests
(src/tests.cpp:110-123, 198-211) and pinned by the literal
LCS/Ustart/fmin fixtures there:

  * node set = all k-mers of the input strings, plus for every *source*
    k-mer x (one whose (k-1)-prefix is not the (k-1)-suffix of any k-mer)
    the $-padded dummy prefixes $^(k-j) x[0:j] for j = 1..k-1, plus the
    root $^k, deduplicated;
  * nodes sorted colexicographically with $ < A < C < G < T;
  * out-edge bit c set on node v iff v is the first node of its
    (k-1)-suffix group and (suffix + c) is a node ("subset matrix" with
    edge pruning so each node has exactly one in-edge);
  * C[c] = colex rank of the first node whose label ends with c
    = 1 + number of edges labeled < c.

Everything here is vectorized NumPy over small code matrices -- the
construction is host-side (index build is one-time); the resulting arrays
are uploaded to the device by the query engines.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from finito_tpu_torch.io.seqdb import encode_seq
from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT


def _row_bytes_view(mat: np.ndarray) -> np.ndarray:
    """View (n, w) uint8 rows as one fixed-width bytes scalar per row.

    Only used for equality / membership (byte order != colex order).
    Safe despite NUL-padding semantics because all rows have equal width.
    """
    mat = np.ascontiguousarray(mat)
    if mat.shape[1] == 0:
        return np.zeros(mat.shape[0], dtype="S1")
    return mat.view(np.dtype(f"S{mat.shape[1]}")).reshape(mat.shape[0])


def _colex_key_words(mat: np.ndarray) -> list:
    """Pack each row into ceil(3k/21)-ish uint64 key words such that
    lexicographic compare of the word tuple == colexicographic compare of
    the rows (alphabet 0..4, 3 bits/char, last char most significant).
    Returns the key words most-significant first (np.lexsort order is
    least-significant first, so callers reverse)."""
    n, k = mat.shape
    chars_per_word = 21  # 21 * 3 = 63 bits
    words = []
    # colex = lex on reversed rows; walk original columns right-to-left,
    # column by column (a whole-matrix reversed astype is a slow strided
    # copy in numpy -- per-column casts are ~20x faster)
    cols = list(range(k - 1, -1, -1))
    for w in range(0, k, chars_per_word):
        key = np.zeros(n, dtype=np.uint64)
        for col in cols[w : w + chars_per_word]:
            key = (key << np.uint64(3)) | mat[:, col].astype(np.uint64)
        words.append(key)
    return words  # most significant word first


def _colex_sort_rows(mat: np.ndarray) -> np.ndarray:
    """Indices sorting rows colexicographically (compare last column first).

    Packs rows into a few uint64 key words instead of lexsorting k uint8
    columns -- ~10x faster for k ~ 31 on large node sets."""
    if mat.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    words = _colex_key_words(mat)
    if len(words) == 1:
        return np.argsort(words[0], kind="stable")
    # np.lexsort: the LAST key is primary; words[0] is most significant.
    return np.lexsort(tuple(words[::-1]))


def _dedupe_sorted_rows(mat: np.ndarray) -> np.ndarray:
    if mat.shape[0] <= 1:
        return mat
    keep = np.ones(mat.shape[0], dtype=bool)
    keep[1:] = np.any(mat[1:] != mat[:-1], axis=1)
    return mat[keep]


def enumerate_kmers(seqs: Sequence[bytes], k: int) -> np.ndarray:
    """All distinct k-mers as colex-sorted (n, k) code rows (A=1..T=4)."""
    mats: List[np.ndarray] = []
    for s in seqs:
        codes = encode_seq(s if isinstance(s, bytes) else s.encode())
        if np.any(codes == 255):
            raise ValueError("Invalid character in input sequence (only ACGT allowed)")
        if codes.size >= k:
            mats.append(np.lib.stride_tricks.sliding_window_view(codes + 1, k))
    if not mats:
        return np.zeros((0, k), dtype=np.uint8)
    kmers = np.vstack(mats)
    kmers = kmers[_colex_sort_rows(kmers)]
    return _dedupe_sorted_rows(kmers)


def build_plain_matrix_sbwt(
    seqs: Sequence[bytes], k: int, return_keys: bool = False
):
    """Packed-key construction (the default): all set/sort/match steps run
    on ceil(3k/64)-word keys (see finito_tpu_torch/sbwt/keys.py) -- the
    byte-matrix pipeline below (_build_rowmatrix) is kept as the
    cross-tested reference implementation; at genome scale its numpy
    string-view set operations dominate (e.g. 205s -> ~20s at 4Mbp).

    With return_keys=True also returns the sorted node key words, letting
    the index builder resolve window colex ranks by key match instead of
    per-window SBWT search."""
    from finito_tpu_torch.sbwt import keys as kw

    if k < 2:
        raise ValueError("k must be >= 2")
    W = kw.n_words(k)

    per_seq = []
    for s in seqs:
        if isinstance(s, np.ndarray):
            codes = s  # pre-encoded 2-bit codes (e.g. SeqDB slices)
        else:
            codes = encode_seq(s if isinstance(s, bytes) else s.encode())
        if np.any(codes == 255):
            raise ValueError("Invalid character in input sequence (only ACGT allowed)")
        if codes.size >= k:
            per_seq.append(kw.pack_windows(codes, k))
    kmers = kw.concat(per_seq) if per_seq else kw.empty(W)
    kmers = kw.dedup_sorted(kw.sort_keys(kmers))
    n_kmers = kmers[0].size

    # Sources: k-mers whose (k-1)-prefix matches no (k-1)-suffix.
    prefixes = kw.mask_low(kmers, k - 1)
    suffixes = kw.shift_right3(kmers)  # sorted (monotone under >>3)
    is_source = ~kw.member(prefixes, kw.dedup_sorted(suffixes))

    # Dummies: root $^k plus $-padded prefixes of the source k-mers:
    # $^(k-j) x[0:j] == (x & low(3j)) << 3(k-j).
    src = kw.take(kmers, is_source)
    dummy_parts = [kw.empty(W)]  # root = all-zero key
    for j in range(1, k):
        dummy_parts.append(kw.shift_left(kw.mask_low(src, j), k - j))
    dummy_parts[0] = [np.zeros(1, dtype=np.uint64) for _ in range(W)]
    dummies = kw.concat(dummy_parts)
    dummies = kw.dedup_sorted(kw.sort_keys(dummies))

    nodes = kw.concat([kmers, dummies])
    nodes = kw.sort_keys(nodes)
    n_nodes = nodes[0].size

    # Suffix groups: nodes sharing label[1:] are colex-consecutive.
    node_suffix = kw.shift_right3(nodes)  # sorted
    first_of_group = ~kw.eq_adjacent(node_suffix)
    group_idx = np.flatnonzero(first_of_group)
    group_suffix = kw.take(node_suffix, group_idx)

    # In-edge of each non-root node y: bit c = y's last char at the first
    # node of the group whose shared (k-1)-suffix equals y[:-1].
    y_char_all = kw.top_char(nodes, k)
    non_root = y_char_all != 0
    y_prefix = kw.take(kw.mask_low(nodes, k - 1), non_root)
    pos = kw.match_into(y_prefix, group_suffix)
    if np.any(pos < 0):
        raise AssertionError("SBWT construction: missing predecessor group")
    target_first = group_idx[pos]

    bit_rows = np.zeros((4, n_nodes), dtype=np.uint8)
    bit_rows[y_char_all[non_root] - 1, target_first] = 1

    sbwt = PlainMatrixSBWT.from_bit_rows(bit_rows, k=k, n_kmers=n_kmers)
    if return_keys:
        return sbwt, nodes
    return sbwt


def _build_rowmatrix(seqs: Sequence[bytes], k: int) -> PlainMatrixSBWT:
    if k < 2:
        raise ValueError("k must be >= 2")
    kmers = enumerate_kmers(seqs, k)
    n_kmers = kmers.shape[0]

    # Sources: k-mers whose (k-1)-prefix has no matching (k-1)-suffix.
    suffix_bytes = np.unique(_row_bytes_view(kmers[:, 1:]))
    prefix_bytes = _row_bytes_view(kmers[:, :-1])
    is_source = ~np.isin(prefix_bytes, suffix_bytes)

    # Dummy nodes: root + $-padded prefixes of all source k-mers.
    src = kmers[is_source]
    dummy_parts = [np.zeros((1, k), dtype=np.uint8)]  # root $^k
    for j in range(1, k):
        rows = np.zeros((src.shape[0], k), dtype=np.uint8)
        rows[:, k - j :] = src[:, :j]
        dummy_parts.append(rows)
    dummies = np.vstack(dummy_parts)
    dummies = dummies[_colex_sort_rows(dummies)]
    dummies = _dedupe_sorted_rows(dummies)

    nodes = np.vstack([kmers, dummies])
    nodes = nodes[_colex_sort_rows(nodes)]
    n_nodes = nodes.shape[0]

    # Suffix-group firsts (nodes sharing label[1:] are colex-consecutive).
    first_of_group = np.ones(n_nodes, dtype=bool)
    if n_nodes > 1:
        first_of_group[1:] = np.any(nodes[1:, 1:] != nodes[:-1, 1:], axis=1)

    # In-edge of every non-root node y: bit c=y[-1] at the first node of
    # the group whose shared (k-1)-suffix equals y[:-1].
    group_idx = np.flatnonzero(first_of_group)
    group_suffix_bytes = _row_bytes_view(nodes[group_idx][:, 1:])
    order = np.argsort(group_suffix_bytes)  # byte order: consistent both sides
    sorted_group_bytes = group_suffix_bytes[order]

    non_root = nodes[:, -1] != 0  # only the root $^k ends with $
    y_prefix_bytes = _row_bytes_view(nodes[:, :-1])[non_root]
    y_char = nodes[non_root, -1].astype(np.int64) - 1  # 0..3
    pos = np.searchsorted(sorted_group_bytes, y_prefix_bytes)
    if np.any(pos >= sorted_group_bytes.size) or np.any(
        sorted_group_bytes[np.minimum(pos, sorted_group_bytes.size - 1)] != y_prefix_bytes
    ):
        raise AssertionError("SBWT construction: missing predecessor group")
    target_first = group_idx[order[pos]]

    bit_rows = np.zeros((4, n_nodes), dtype=np.uint8)
    bit_rows[y_char, target_first] = 1

    return PlainMatrixSBWT.from_bit_rows(bit_rows, k=k, n_kmers=n_kmers)

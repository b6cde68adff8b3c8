"""Host (numpy) builders of the minimizer engine's device tables.

The port's copy of the builders in finito_tpu/query/minimizer_engine.py
(that module imports jax, which the port never does). The tests hold
every function here equal to its original, table by table.
"""

from __future__ import annotations

import numpy as np

from finito_tpu_torch.index.minimizer import MinimizerIndex

_DESC_LEN_BITS = 6  # must match index.minimizer._LEN_BITS
_SLOT_ROWS_MAX_DESC_BYTES = 64 << 20  # fused slot rows only below this descriptor size


def initial_capacities(BW: int, use_v2: bool, slow_divisor: int | None = None):
    """Starting (K_slow, K_heads) for a (B*W)-window dispatch. v2's K
    bounds slow RUNS (~windows / run-length fewer than slow windows), so
    its divisor is larger. Callers needing more slow headroom pass a
    smaller slow_divisor."""
    if slow_divisor is None:
        slow_divisor = 256 if use_v2 else 32
    return max(256, BW // slow_divisor), max(1024, BW // 6)


def grow_capacities(K: int, KH: int, n_slow: int, n_heads: int, BW: int):
    """Resize policy after a dispatch: None if (K, KH) was sufficient,
    else the next (K, KH) to retry with (K x4, KH doubled or jumped
    straight to the observed head count). Raises when a counter exceeds
    a capacity already at the B*W ceiling -- overflow there means the
    counters are wrong, not the sizing (the JAX rule waits for both
    capacities at the ceiling, and grows nothing while v1's K_heads,
    which no counter fills, stays under it)."""
    if n_slow <= K and n_heads <= KH:
        return None
    if (n_slow > K and K >= BW) or (n_heads > KH and KH >= BW):
        raise AssertionError("slow-path overflow at K == B*W")
    if n_slow > K:
        K = min(BW, K * 4)
    if n_heads > KH:
        KH = min(BW, max(KH * 2, n_heads))
    return K, KH


def build_occ_rows(mindex: MinimizerIndex) -> np.ndarray:
    """(n_occ, 4) int32 candidate payload rows (gstart, uid, off, uend):
    one row gather per candidate check."""
    n_occ = int(mindex.occ_key.size)
    if not n_occ:
        return np.zeros((0, 4), np.int32)
    ends32 = np.asarray(mindex.ends, dtype=np.int32)
    uend = ends32[np.asarray(mindex.occ_uid)]
    return np.stack(
        [
            np.asarray(mindex.occ_gstart, np.int32),
            np.asarray(mindex.occ_uid, np.int32),
            np.asarray(mindex.occ_off, np.int32),
            uend,
        ],
        axis=1,
    )


def build_text_rows(words: np.ndarray) -> np.ndarray:
    """Overlapped stride-2 rows of 4 words over the packed text (k <= 32):
    any <= 3-word window is one row gather (2x text memory)."""
    n2 = (words.size - 2) // 2
    rows = np.lib.stride_tricks.sliding_window_view(words, 4)[: 2 * n2 : 2]
    return np.ascontiguousarray(rows)


def build_text_rows8(words: np.ndarray) -> np.ndarray:
    """Overlapped stride-4 rows of 8 words (32 < k <= 64): any <= 5-word
    window is one row gather (2x text memory)."""
    n4 = (words.size - 4) // 4
    rows = np.lib.stride_tricks.sliding_window_view(words, 8)[: 4 * n4 : 4]
    return np.ascontiguousarray(rows)


def pack_text_words(concat: np.ndarray, pad_words: int = 2) -> np.ndarray:
    """2-bit pack host codes into uint32 words, base j at bits [2j, 2j+2)
    of the word stream (sdsl/PackedStrings bit order); pad_words extra
    zero words so rolling window loads at the last base stay in bounds."""
    n = concat.size
    n_words = (2 * n + 31) // 32 + pad_words
    bits = np.zeros(n_words * 16, dtype=np.uint32)  # 16 bases per word
    bits[:n] = concat
    by = bits.reshape(n_words, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (by << shifts).sum(axis=1, dtype=np.uint32)


def build_slot_rows(mindex: MinimizerIndex) -> np.ndarray:
    """(2^h + 1, 4) int32 FUSED slot rows: descriptor and single-
    occurrence payload in one row, so the v1 fast path costs one
    big-table gather instead of two dependent ones (desc -> payload).

    Row encoding, discriminated by column 1:
      * single-occurrence slot (col1 = uid >= 0): the payload row
        [gstart, uid, off, uend] embedded directly;
      * empty slot: col1 = -1;
      * multi-occurrence slot (col1 = -len <= -2): col0 = start index
        into occ_rows; the compacted slow path scans [start, start+len).
    """
    starts = (np.asarray(mindex.desc) >> np.uint64(_DESC_LEN_BITS)).astype(np.int64)
    lens = np.diff(starts)  # exact per-slot occupancy (2^h,)
    rows = np.zeros((lens.size + 1, 4), np.int32)
    rows[:, 1] = -1  # empty
    single = np.nonzero(lens == 1)[0]
    idx = starts[single]
    uid = np.asarray(mindex.occ_uid, np.int32)[idx]
    rows[single, 0] = np.asarray(mindex.occ_gstart, np.int32)[idx]
    rows[single, 1] = uid
    rows[single, 2] = np.asarray(mindex.occ_off, np.int32)[idx]
    rows[single, 3] = np.asarray(mindex.ends, np.int32)[uid]
    multi = np.nonzero(lens >= 2)[0]
    rows[multi, 0] = starts[multi]
    rows[multi, 1] = -lens[multi]
    return rows


def desc_to_rows(desc: np.ndarray) -> np.ndarray:
    """Host packed slot descriptors -> (2^h + 1, 2) int32 rows
    [start, exact_len]. The host desc widens to uint64 past 2^26
    occurrences; explicit 32-bit planes are always exact (starts <
    n_occ < 2^31), and the exact length column (successive-start
    difference, not the 6-bit saturated stored length) bounds the slow
    path without a next-slot gather."""
    from finito_tpu_torch import native

    rows = native.desc_to_rows_native(np.asarray(desc), _DESC_LEN_BITS)
    if rows is not None:
        return rows
    starts = (np.asarray(desc) >> np.uint64(_DESC_LEN_BITS)).astype(np.int64)
    rows = np.empty((starts.size, 2), dtype=np.int32)
    rows[:, 0] = starts
    rows[:-1, 1] = np.diff(starts)
    rows[-1, 1] = 0
    return rows

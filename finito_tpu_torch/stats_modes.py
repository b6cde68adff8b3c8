"""Stats-only build modes: --type shortest and --type verify.

Equivalents of the reference's non-index build paths
(ref: include/build_fmin.hh:95-238): both only print
finimizer statistics (count, sum_freq, avg_freq, avg_len, n_kmers) for a
general frequency bound t; neither produces a queryable index (only
t=1 --type rarest does, README.md:73).
"""

from __future__ import annotations

from collections import deque
from typing import List, Set, Tuple

import numpy as np

from finito_tpu_torch.index.builder import drop_first_char


def verify_shortest_streaming_search(sbwt, codes: np.ndarray, t: int) -> Set[Tuple[int, int, int]]:
    """Brute-force O(k^2)-per-window reference search
    (ref: build_fmin.hh:95-132). Tuples ordered (len, freq, colex, end)."""
    n_nodes = sbwt.number_of_subsets()
    k = sbwt.get_k()
    str_len = int(codes.size)
    out: Set[Tuple[int, int, int]] = set()
    for i in range(str_len - k + 1):
        w_fmin = (k + 1, n_nodes, n_nodes, str_len)
        for start in range(i, k + i):
            I = (0, n_nodes - 1)
            for end in range(start, k + i):
                I = sbwt.update_interval(int(codes[end]), I)
                freq = I[1] - I[0] + 1
                if freq <= t:
                    new_fmin = (end - start + 1, freq, I[0], end)
                    if new_fmin < w_fmin:
                        w_fmin = new_fmin
        out.add((w_fmin[0], w_fmin[1], w_fmin[2]))
    return out


def build_shortest_streaming_search(
    sbwt, LCS: np.ndarray, codes: np.ndarray, t: int, fmin_found: np.ndarray
) -> Set[Tuple[int, int, int]]:
    """Streaming shortest finimizer stats for general t
    (ref: build_fmin.hh:134-200). Note the tuple order here is
    (len, freq, colex, end) -- different from the rarest builder's
    (freq, len, colex, end); for t=1 they coincide (SURVEY.md App. A 6)."""
    n_nodes = sbwt.number_of_subsets()
    k = sbwt.get_k()
    str_len = int(codes.size)
    all_fmin = deque()
    w_fmin = (k + 2, n_nodes, n_nodes, str_len)
    out: Set[Tuple[int, int, int]] = set()
    kmer = 0
    start = 0
    I = (0, n_nodes - 1)
    for end in range(str_len):
        I = sbwt.update_interval(int(codes[end]), I)
        freq = I[1] - I[0] + 1
        I_start = I[0]
        if freq <= t:
            while freq <= t:
                curr_substr = (end - start + 1, freq, I_start, end)
                start += 1
                I = drop_first_char(end - start + 1, I, LCS, n_nodes)
                freq = I[1] - I[0] + 1
                I_start = I[0]
            if w_fmin > curr_substr:
                all_fmin.clear()
                w_fmin = curr_substr
            else:
                while all_fmin and all_fmin[-1] > curr_substr:
                    all_fmin.pop()
            all_fmin.append(curr_substr)
        if end >= k - 1:
            if not fmin_found[w_fmin[2]]:
                out.add((w_fmin[0], w_fmin[1], w_fmin[2]))
                if w_fmin[3] >= k - 1:
                    fmin_found[w_fmin[2]] = 1
            kmer += 1
            while w_fmin[3] - w_fmin[0] + 1 < kmer:
                all_fmin.popleft()
                w_fmin = all_fmin[0] if all_fmin else (k + 1, n_nodes, n_nodes, kmer + k)
    return out


def remove_ns(seq: bytes, k: int) -> List[bytes]:
    """Split at non-ACGT characters, keeping pieces of length >= k.

    Deliberate fix vs the reference: build_fmin.hh:216-238 takes
    substr(start, i-start+1), which *includes* the invalid character in
    the emitted piece and then feeds it to interval updates (UB-ish
    downstream). We exclude it (SURVEY.md Appendix A item 8).
    """
    from finito_tpu_torch.io.seqdb import ENCODE_LUT

    out: List[bytes] = []
    str_len = len(seq)
    start = 0
    for i in range(str_len):
        if ENCODE_LUT[seq[i]] == 255:
            if i - start >= k:
                out.append(seq[start:i])
            start = i + 1
    if str_len - start >= k:
        out.append(seq[start:str_len])
    return out


def shortest_finimizer_stats_string(sbwt, LCS, reader, t: int) -> Set[Tuple[int, int, int]]:
    """--type shortest entry point (ref: build_fmin.hh:203-214)."""
    from finito_tpu_torch.io.seqdb import encode_seq

    n_nodes = sbwt.number_of_subsets()
    fmin_found = np.zeros(n_nodes, dtype=np.uint8)
    all_stats: Set[Tuple[int, int, int]] = set()
    for _h, seq in reader:
        codes = encode_seq(bytes(seq).upper())
        all_stats |= build_shortest_streaming_search(sbwt, LCS, codes, t, fmin_found)
    return all_stats

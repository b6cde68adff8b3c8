"""Streaming rarest-finimizer search: the exact (host-side) oracle.

Semantic replication of ``rarest_fmin_streaming_search``
(ref: include/common.hh:78-186): a single left-to-right
scan tracking two SBWT intervals -- the finimizer-candidate interval I
(with greedy start) and the k-mer interval I_kmer (with kmer_start) --
with LCS-guided left-contraction on failures, a monotone deque of
shortest-unique candidates ordered (freq, len, colex, end), and
rightmost-Ustart-singleton tracking.

Returns, per query position `end`, for each found k-mer ending there:
  * its colex rank,
  * the window finimizer as (finimizer_end, finimizer_colex),
  * the rightmost Ustart singleton (pos, colex) at/after the finimizer end.

The batched device engine (finito_tpu_torch.query.engine) is tested against this
oracle; where the reference has undefined behavior (non-ACGT queries,
common.hh:108-111 returning an empty tuple that the caller then indexes)
we return None and the caller produces an empty QueryResult.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from finito_tpu_torch.index.builder import drop_first_char


def rarest_fmin_streaming_search(
    sbwt,
    LCS: np.ndarray,
    codes: np.ndarray,
    Ustart: np.ndarray,
) -> Optional[
    Tuple[
        List[Optional[int]],
        List[Optional[Tuple[int, int]]],
        List[Optional[Tuple[int, int]]],
    ]
]:
    n_nodes = sbwt.number_of_subsets()
    k = sbwt.get_k()
    str_len = int(codes.size)

    from finito_tpu_torch.utils.bounded_deque import BoundedDeque

    all_fmin: BoundedDeque = BoundedDeque(str_len + 1)
    sentinel = (n_nodes, k + 1, n_nodes, str_len + 1)
    w_fmin = sentinel
    colex_ranks: List[Optional[int]] = [None] * str_len
    finimizers: List[Optional[Tuple[int, int]]] = [None] * str_len
    best: List[Optional[Tuple[int, int]]] = [None] * str_len

    start = 0
    kmer_start = 0
    I = (0, n_nodes - 1)
    I_kmer = (0, n_nodes - 1)
    best_Ustart = (-1, -1)

    for end in range(str_len):
        c = int(codes[end])
        if c > 3:
            sys.stderr.write("Error: unknown character in query (DNA alphabet {A,C,G,T} required)\n")
            return None

        # (1) extend the finimizer interval; on failure advance start and
        # left-contract until the extension succeeds (or the window empties).
        I_new = sbwt.update_interval(c, I)
        while I_new[0] == -1:
            start += 1
            kmer_start = start
            if start > end:
                I_new = (0, n_nodes - 1)
                I_kmer = I_new
                break
            I = drop_first_char(end - start, I, LCS, n_nodes)
            I_new = sbwt.update_interval(c, I)
            I_kmer = I_new
        I = I_new
        freq = I[1] - I[0] + 1

        # (2) the k-mer interval tracks its own start when it has diverged.
        if start != kmer_start:
            I_kmer_new = sbwt.update_interval(c, I_kmer)
            while I_kmer_new[0] == -1:
                kmer_start += 1
                I_kmer = drop_first_char(end - kmer_start, I_kmer, LCS, n_nodes)
                I_kmer_new = sbwt.update_interval(c, I_kmer)
            I_kmer = I_kmer_new
        else:
            I_kmer = I

        # (2b) shortest-unique candidate ending here; maintain window min.
        if freq == 1:
            curr_substr = None
            while freq == 1:
                curr_substr = (freq, end - start + 1, I[0], end)
                start += 1
                I = drop_first_char(end - start + 1, I, LCS, n_nodes)
                freq = I[1] - I[0] + 1
            if w_fmin > curr_substr:
                all_fmin.clear()
                w_fmin = curr_substr
            else:
                while len(all_fmin) and all_fmin.back() > curr_substr:
                    all_fmin.pop_back()
            all_fmin.push_back(curr_substr)

        # Rightmost Ustart singleton seen so far.
        if I_kmer[0] == I_kmer[1] and Ustart[I_kmer[0]] == 1:
            best_Ustart = (end, I_kmer[0])

        # Window closes: record this k-mer's colex + finimizer.
        if end - kmer_start + 1 == k:
            while w_fmin[3] - w_fmin[1] + 1 < kmer_start:
                all_fmin.pop_front()
                w_fmin = all_fmin.front() if len(all_fmin) else sentinel
            colex_ranks[kmer_start + k - 1] = I_kmer[0]
            finimizers[kmer_start + k - 1] = (w_fmin[3], w_fmin[2])
            if best_Ustart[0] >= w_fmin[3]:
                best[kmer_start + k - 1] = best_Ustart
            kmer_start += 1
            I_kmer = drop_first_char(end - kmer_start + 1, I_kmer, LCS, n_nodes)

    return colex_ranks, finimizers, best

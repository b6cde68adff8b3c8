"""Finimizer index construction (t=1 "rarest" shortest-unique finimizers).

Semantic equivalent of the reference's FinimizerIndexBuilder
(ref: include/FinimizerIndex.hh:262-395). This module is
the exact *oracle*: a per-unitig streaming scan replicating the
reference's candidate ordering, monotone-deque window minimum, and the
cross-unitig "last larger local end wins" canonical-occurrence rule
(FinimizerIndex.hh:370-378), so that the construction fixtures in
src/tests.cpp:62-84 are reproduced bit-exactly.

The production path is `_build_fast`: a fully vectorized pipeline
(closed-form candidates + O(n) native window minimum + one scatter-max)
whose output is tested against this oracle; its sort/merge/deque hot
loops run in native C++ (finito_tpu_torch/native/sort_native.cpp) with NumPy
fallbacks.
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np

from finito_tpu_torch import native

from finito_tpu_torch.index.packed_strings import PackedStrings, permute_unitigs
from finito_tpu_torch.io.seqdb import SeqDB
from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT
from finito_tpu_torch.utils.bits import bit_width_for_max


def prefix_candidates(sbwt, su, starts, ends, concat):
    """Shortest-unique candidates at local offsets < k-1: a batched
    per-unitig prefix scan (O(n_unitigs * k) interval updates -- the
    small control-plane part of construction, next to the O(text)
    window candidates). Returns (global end positions, lens, colex
    ranks). Shared by the host fast path and the mesh build."""
    k = sbwt.get_k()
    n_nodes = sbwt.number_of_subsets()
    n_u = ends.size
    lo = np.zeros(n_u, dtype=np.int64)
    hi = np.full(n_u, n_nodes - 1, dtype=np.int64)
    lens = ends - starts
    out_p, out_l, out_c = [], [], []
    for j in range(min(k - 1, int(lens.max()) if n_u else 0)):
        active = lens > j
        c = np.where(active, concat[np.minimum(starts + j, concat.size - 1)], 255)
        lo, hi = sbwt.update_interval_batch(c, lo, hi)
        if np.any(active & (lo < 0)):
            raise AssertionError("build: prefix extension failed (input not indexed?)")
        single = active & (lo == hi)
        s_ok = single & (su[np.where(single, lo, 0)] <= j + 1)
        out_p.append(starts[s_ok] + j)
        out_l.append(su[lo[s_ok]])
        out_c.append(lo[s_ok])
    if not out_p:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    return (
        np.concatenate(out_p),
        np.concatenate(out_l),
        np.concatenate(out_c),
    )


def drop_first_char(new_len: int, I: Tuple[int, int], LCS: np.ndarray, n_nodes: int) -> Tuple[int, int]:
    """Left-contraction: widen interval to all nodes sharing a suffix of
    length new_len, guided by the LCS array
    (ref: include/common.hh:38-48)."""
    if I[0] == -1:
        return I
    if new_len <= 0:
        return (0, n_nodes - 1)
    lo, hi = I
    while lo > 0 and LCS[lo] >= new_len:
        lo -= 1
    while hi < n_nodes - 1 and LCS[hi + 1] >= new_len:
        hi += 1
    return (lo, hi)


class FinimizerIndexBuilder:
    """Builds all finimizer-index components from an SBWT + LCS + unitigs.

    Two construction paths producing identical output (cross-tested):
      * the vectorized fast path (default) -- candidates in closed form
        over window colex ranks, sliding window minimum, and one
        scatter-max pass replacing the reference's sequential
        cross-unitig overwrite rule;
      * oracle=True -- the per-base streaming scan replicating the
        reference's add_sequence step by step (the arbiter in tests).
    """

    def __init__(
        self,
        sbwt: PlainMatrixSBWT,
        LCS: np.ndarray,
        unitigs: SeqDB,
        oracle: bool = False,
        node_keys=None,
        device="cuda",
    ):
        """node_keys: the SBWT's sorted node keys (sbwt.construct
        return_keys=True); they give every window's colex rank by one
        key merge on the host. Without them the fast path ranks the
        windows by SBWT search on `device` ("cuda", "cuda:1", "cpu"),
        which raises when a CUDA device is asked for and none is visible;
        the device is touched only then."""
        from finito_tpu_torch.index.index import FinimizerIndex

        self.sbwt = sbwt
        self.device = device
        self.LCS = np.asarray(LCS, dtype=np.int64)

        n_nodes = sbwt.number_of_subsets()
        fmin_bv = np.zeros(n_nodes, dtype=np.uint8)
        # Local end offset of the last recorded occurrence per node, used by
        # the larger-end-wins rule; reference keeps it in an int_vector
        # initialized to 0 (FinimizerIndex.hh:281).
        fmin_found = np.zeros(n_nodes, dtype=np.int64)
        global_offsets = np.zeros(n_nodes, dtype=np.uint64)

        packed, ustart, _perm = permute_unitigs(sbwt, unitigs)

        finimizers: Set[Tuple[int, int, int]] = set()
        if oracle:
            total_len = 0
            for i in range(packed.number_of_strings()):
                codes = packed.get(i)
                finimizers |= self.add_sequence(
                    codes, fmin_bv, fmin_found, global_offsets, total_len
                )
                total_len += codes.size
        else:
            finimizers = self._build_fast(packed, fmin_bv, global_offsets, node_keys)

        max_off = int(global_offsets.max()) if n_nodes else 0
        width = bit_width_for_max(max_off)
        packed_global_offsets = global_offsets[fmin_bv == 1].astype(np.uint64)

        self.finimizer_stats = finimizers
        index = FinimizerIndex()
        index.sbwt = sbwt
        index.LCS = self.LCS
        index.lcs_width = bit_width_for_max(sbwt.get_k() - 1)
        index.unitigs = packed
        index.fmin = fmin_bv
        index.global_offsets = packed_global_offsets
        index.offsets_width = width
        index.Ustart = ustart
        index.rebuild_rank_supports()
        self._index = index

    def _build_fast(
        self,
        packed: PackedStrings,
        fmin_bv: np.ndarray,
        global_offsets: np.ndarray,
        node_keys=None,
    ):
        """Vectorized equivalent of looping add_sequence over all unitigs.

        Rests on three exact reductions of the reference's streaming scan
        (FinimizerIndex.hh:321-389), shared with the replica query engine:

        1. During construction the scanned text IS the indexed text, so
           interval extension never fails and every window position
           j >= k-1 has a singleton interval = that window's colex rank.
        2. Shortest-unique candidates are closed-form: a singleton {x}
           yields (len = SU[x] = max(LCS[x], LCS[x+1]) + 1, colex = x).
           Candidates the reference's greedy interval would skip are
           strictly dominated inside every window, so the per-window
           (freq, len, colex, end) minimum is unchanged.
        3. The sequential cross-unitig overwrite rule ("mark; keep the
           occurrence with the larger local end; on equal never replace;
           local end 0 never locks", FinimizerIndex.hh:370-378) is
           order-independent once encoded as a max over the key
             l > 0:  (l << 33) | (2^33-1 - order)
             l == 0:  order
           so one scatter-max reproduces the exact sequential outcome.
        """
        sbwt = self.sbwt
        k = sbwt.get_k()
        n_nodes = sbwt.number_of_subsets()
        concat = packed.concat
        ends = np.asarray(packed.ends, dtype=np.int64)
        starts = np.concatenate([[0], ends[:-1]])

        su = np.maximum(self.LCS, np.concatenate([self.LCS[1:], [0]])) + 1

        # --- per-position candidates over the whole concatenation
        BIG = 1 << 30
        cand_len = np.full(concat.size, BIG, dtype=np.int64)
        cand_colex = np.zeros(concat.size, dtype=np.int64)

        n_pos = concat.size - k + 1 if concat.size >= k else 0
        if n_pos > 0:
            pos = np.arange(n_pos, dtype=np.int64)
            uid = np.searchsorted(ends, pos, side="right")
            valid = pos + k <= ends[uid]
            vpos = pos[valid]
            if node_keys is not None:
                # colex rank == position of the window's packed key among
                # the sorted node keys: one key match, no SBWT search and
                # no device round-trip (the big win at genome scale).
                from finito_tpu_torch.sbwt import keys as kw

                # pack every concat window in one rolling pass, then keep
                # the in-unitig ones (vpos)
                wk = kw.take(kw.pack_windows(concat, k), vpos)
                ranks = kw.match_into(wk, node_keys)
                del wk
            else:
                # fallback: batched SBWT search on the builder's device, in
                # chunks of 2^20 windows (the JAX builder's accelerator
                # search); torch is touched only here
                import torch

                from finito_tpu_torch.ops.bitvec import DeviceSBWT, search_batch_device

                dev = torch.device(self.device)
                if dev.type == "cuda" and not torch.cuda.is_available():
                    raise RuntimeError(f"device {self.device!r} requested for the builder's "
                                       "SBWT search but CUDA is not available")
                dsbwt = DeviceSBWT.from_host(sbwt, dev)
                windows = np.lib.stride_tricks.sliding_window_view(concat, k)[vpos]
                ranks = np.empty(vpos.size, dtype=np.int64)
                CH = 1 << 20
                for s in range(0, vpos.size, CH):
                    w = torch.from_numpy(np.ascontiguousarray(windows[s : s + CH])).to(dev)
                    ranks[s : s + CH] = search_batch_device(dsbwt, w).cpu().numpy()
            if np.any(ranks < 0):
                raise AssertionError("build: indexed window not found in SBWT")
            j_end = vpos + k - 1
            cand_len[j_end] = su[ranks]
            cand_colex[j_end] = ranks

        # positions with local offset < k-1: batched per-unitig prefix scan
        pc_pos, pc_len, pc_colex = prefix_candidates(sbwt, su, starts, ends, concat)
        cand_len[pc_pos] = pc_len
        cand_colex[pc_pos] = pc_colex

        # --- per-window (len, colex, end)-minimum over valid candidates;
        # the tuple packs into one int64 (len | colex | r) so the k-step
        # sliding minimum is a single minimum chain
        if np.any(cand_colex >= (1 << 40)):
            raise ValueError("build: colex range exceeds the packed-key encoding")
        if k > 255:
            raise ValueError("build: k > 255 exceeds the packed window-min encoding "
                             "(the reference caps at MAX_KMER_LENGTH=250)")
        BIGKEY = np.int64((k + 3) << 48)
        safe_len = np.where(cand_len >= BIG, k + 2, cand_len)
        cand_key = np.where(
            cand_len >= BIG, BIGKEY, (safe_len << 48) | (cand_colex << 8)
        )
        if n_pos > 0:
            pos = np.arange(n_pos, dtype=np.int64)
            uid = np.searchsorted(ends, pos, side="right")
            wvalid = pos + k <= ends[uid]
            ws = pos[wvalid]  # global window starts
            fin_key = native.window_min(cand_key, ends, k, int(BIGKEY))
            if fin_key is None:
                # Python fallback: k passes of the packed-tuple minimum
                # (the native path is the O(n) monotone deque)
                fin_key = np.full(ws.size, BIGKEY, dtype=np.int64)
                for r in range(k):
                    ck = cand_key[ws + r] | r
                    ck = np.where((ck >> 48) <= r + 1, ck, BIGKEY)
                    np.minimum(fin_key, ck, out=fin_key)
            assert fin_key.size == ws.size
            fin_len = fin_key >> 48
            fin_colex = (fin_key >> 8) & ((1 << 40) - 1)
            fin_r = fin_key & 0xFF
            none = fin_key >= BIGKEY
            fin_len[none] = BIG
            fin_colex[none] = 0
            fin_r[none] = 0
        else:
            ws = np.zeros(0, dtype=np.int64)
            fin_len = fin_colex = fin_r = np.zeros(0, dtype=np.int64)

        # windows with no candidate: the reference falls back to the empty-
        # deque sentinel (n_nodes, k+1, kmer+1, kmer+k) -- cannot happen for
        # a valid t=1 DSPSS (the full k-mer is always a unique candidate)
        none_mask = fin_len >= BIG
        w_uid = np.searchsorted(ends, ws, side="right")
        win_idx = ws - starts[w_uid]  # per-unitig window counter ("kmer")
        fin_len = np.where(none_mask, k + 1, fin_len)
        fin_colex = np.where(none_mask, win_idx + 1, fin_colex)
        local_end = np.where(none_mask, win_idx + k, ws - starts[w_uid] + fin_r)
        g_end = np.where(none_mask, starts[w_uid] + local_end, ws + fin_r)

        # --- scatter-max replacement of the sequential overwrite rule
        order = np.arange(ws.size, dtype=np.int64)  # global scan order
        M33 = (1 << 33) - 1
        if np.any(local_end >= (1 << 30)) or ws.size >= M33:
            raise ValueError("build: input too large for the scatter-max key encoding")
        key = np.where(local_end > 0, (local_end << 33) | (M33 - order), order)
        best = np.full(n_nodes, -1, dtype=np.int64)
        if not native.scatter_max(best, fin_colex, key):
            np.maximum.at(best, fin_colex, key)
        fmin_bv[fin_colex] = 1
        winner = key == best[fin_colex]
        # several windows can share (colex, local_end, order)? order is
        # unique, so at most one winner per colex.
        global_offsets[fin_colex[winner]] = g_end[winner].astype(np.uint64)

        # stats set via one int64 unique (freq is 1 except the sentinel);
        # kept packed -- a Python set of tuples costs ~100 bytes/entry,
        # untenable at genome scale (up to n_nodes entries)
        packed = (fin_len << 41) | (fin_colex << 1) | none_mask.astype(np.int64)
        uniq = native.unique_sorted_i64(packed)
        if uniq is None:
            uniq = np.unique(packed)
        return FinimizerStatsSet(uniq, n_nodes)

    def add_sequence(
        self,
        codes: np.ndarray,
        fmin_bv: np.ndarray,
        fmin_found: np.ndarray,
        global_offsets: np.ndarray,
        unitig_start: int,
    ) -> Set[Tuple[int, int, int]]:
        """Streaming shortest-unique-finimizer selection over one unitig.

        Exact replication of FinimizerIndexBuilder::add_sequence
        (ref: FinimizerIndex.hh:321-389): candidate tuples ordered
        (freq, len, colex, end); per-window minimum via monotone deque;
        stats set gathers (len, freq, colex) per window.
        """
        sbwt = self.sbwt
        LCS = self.LCS
        n_nodes = sbwt.number_of_subsets()
        k = sbwt.get_k()
        str_len = int(codes.size)

        from finito_tpu_torch.utils.bounded_deque import BoundedDeque

        all_fmin: BoundedDeque = BoundedDeque(str_len + 1)
        w_fmin = (n_nodes, k + 1, n_nodes, str_len)
        count_all_w_fmin: Set[Tuple[int, int, int]] = set()

        kmer = 0
        start = 0
        I = (0, n_nodes - 1)
        for end in range(str_len):
            c = int(codes[end])
            I = sbwt.update_interval(c, I)
            freq = I[1] - I[0] + 1
            I_start = I[0]
            if freq == 1:
                while freq == 1:
                    curr_substr = (freq, end - start + 1, I_start, end)
                    start += 1
                    I = drop_first_char(end - start + 1, I, LCS, n_nodes)
                    freq = I[1] - I[0] + 1
                    I_start = I[0]
                if w_fmin > curr_substr:
                    all_fmin.clear()
                    w_fmin = curr_substr
                else:
                    while len(all_fmin) and all_fmin.back() > curr_substr:
                        all_fmin.pop_back()
                all_fmin.push_back(curr_substr)
            if end >= k - 1:
                count_all_w_fmin.add((w_fmin[1], w_fmin[0], w_fmin[2]))
                colex = w_fmin[2]
                if fmin_found[colex] == 0 or fmin_found[colex] < w_fmin[3]:
                    fmin_bv[colex] = 1
                    fmin_found[colex] = w_fmin[3]
                    global_offsets[colex] = unitig_start + w_fmin[3]
                kmer += 1
                while w_fmin[3] - w_fmin[1] + 1 < kmer:
                    all_fmin.pop_front()
                    w_fmin = all_fmin.front() if len(all_fmin) else (n_nodes, k + 1, kmer + 1, kmer + k)
        return count_all_w_fmin

    def get_index(self):
        return self._index


class FinimizerStatsSet:
    """Array-backed set of (len, freq, colex) finimizer stats tuples.

    `_build_fast` yields up to n_nodes distinct tuples; a Python set of
    tuples costs ~100 bytes/entry (tens of GB at genome scale), so the
    packed int64 form ((len << 41) | (colex << 1) | sentinel) is kept and
    set semantics -- len, iteration, equality against real sets (used by
    the oracle cross-tests) -- are provided on top. freq is 1 for every
    real finimizer; the sentinel (no-candidate window, impossible for a
    valid t=1 DSPSS) carries freq = n_nodes like the reference's empty-
    deque fallback (FinimizerIndex.hh:352)."""

    __slots__ = ("packed", "n_nodes")

    def __init__(self, packed: np.ndarray, n_nodes: int):
        self.packed = np.asarray(packed, dtype=np.int64)
        self.n_nodes = int(n_nodes)

    def _tuple(self, v: int):
        return (
            int(v >> 41),
            self.n_nodes if (v & 1) else 1,
            int((v >> 1) & ((1 << 40) - 1)),
        )

    def __len__(self) -> int:
        return int(self.packed.size)

    def __iter__(self):
        return (self._tuple(v) for v in self.packed.tolist())

    def __contains__(self, t) -> bool:
        ln, freq, colex = t
        sent = 1 if freq != 1 else 0
        v = (int(ln) << 41) | (int(colex) << 1) | sent
        i = int(np.searchsorted(self.packed, v))
        return i < self.packed.size and int(self.packed[i]) == v and (
            freq == 1 or freq == self.n_nodes
        )

    def __eq__(self, other) -> bool:
        if isinstance(other, FinimizerStatsSet):
            return self.n_nodes == other.n_nodes and np.array_equal(
                self.packed, other.packed
            )
        if isinstance(other, (set, frozenset)):
            return len(self) == len(other) and all(t in other for t in self)
        return NotImplemented

    __hash__ = None  # mutable ndarray inside

    def stats_sums(self):
        """(count, sum_freq, sum_len) without materializing tuples."""
        n = int(self.packed.size)
        n_sent = int((self.packed & 1).sum())
        sum_freq = (n - n_sent) + n_sent * self.n_nodes
        sum_len = int((self.packed >> 41).sum())
        return n, sum_freq, sum_len


def finimizer_stats_string(finimizers, n_kmers: int) -> str:
    """CSV stats line: count,sum_freq,avg_freq,avg_len,n_kmers
    (ref: include/common.hh:188-206; tuples are
    (len, freq, colex))."""
    if hasattr(finimizers, "stats_sums"):
        n, sum_freq, sum_len = finimizers.stats_sums()
    else:
        n = len(finimizers)
        sum_freq = sum(x[1] for x in finimizers)
        sum_len = sum(x[0] for x in finimizers)
    avg_freq = np.float32(sum_freq) / np.float32(n) if n else float("nan")
    avg_len = np.float32(sum_len) / np.float32(n) if n else float("nan")
    return f"{n},{sum_freq},{avg_freq:.6f},{avg_len:.6f},{n_kmers}"

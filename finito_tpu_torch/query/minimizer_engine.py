"""Device query path of the minimizer seed-and-verify index, in PyTorch:
counterpart of finito_tpu/query/minimizer_engine.py (its v1 and v2
locates and their occurrence-counting forms).

Per (B, W) window batch, make_minimizer_locate runs
  1. the front end (ops.minimizer_front: the CUDA kernel on the card)
     -- minimizer value and offset, window validity, packed windows;
  2. one fused slot-row gather (or, without slot rows, a descriptor
     gather then a payload gather);
  3. the packed-text compare of the single-occurrence candidate;
  4. compaction of the multi-occurrence windows (ops.streaming) and an
     exact candidate scan over their slots.
make_minimizer_locate_v2 runs the same steps once per minimizer run.
Output equals FinimizerIndex.search and the JAX engine: (uid, off) or
(-1, -1) per window.

Words follow ops.bits: tables hold int32 bit patterns, and every shift
or compare runs on int64 words in [0, 2^32). Every index a masked-off
lane can produce is clamped into its table: torch raises on an
out-of-range index on the CPU and kills the CUDA context on the card,
where jnp.take filled silently.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from finito_tpu_torch.index.minimizer import MinimizerIndex
from finito_tpu_torch.ops.bits import U32, popcount32, put_i32, slot32, u32
from finito_tpu_torch.ops.minimizer_front import minimizer_windows, n_words
from finito_tpu_torch.ops.streaming import compact_mask
from finito_tpu_torch.query.minimizer_tables import (
    _SLOT_ROWS_MAX_DESC_BYTES,
    build_occ_rows,
    build_slot_rows,
    build_text_rows,
    build_text_rows8,
    desc_to_rows,
    pack_text_words,
)
from finito_tpu_torch.utils import trace

# v2 from this descriptor size up: the JAX engine's threshold
# (finito_tpu/query/engine.py), which is also its slot-row cap
V2_MIN_DESC_BYTES = 64 << 20

# the leaves of the JAX DeviceMinimizerIndex, in its tree_flatten order
LEAVES = ("desc", "occ_rows", "ends", "text", "text_rows", "slot_rows")


class DeviceMinimizerIndex:
    """The tables of a MinimizerIndex on one device, with the fields of
    the JAX DeviceMinimizerIndex: desc (2^h + 1, 2) [start, exact_len];
    slot_rows (2^h + 1, 4) fused rows, or None when the descriptor is
    64 MB or more; occ_rows (n_occ, 4) [gstart, uid, off, uend]; ends;
    text, the packed unitig text with k-dependent pad words; text_rows,
    its overlapped 4-word (k <= 32) or 8-word (k <= 64) rows, else None.
    Word tables are int32 bit patterns of the JAX uint32 tables."""

    def __init__(self, mindex: MinimizerIndex, device="cuda"):
        if int(mindex.concat.size) >= (1 << 31):
            raise ValueError(
                "unitig text exceeds int32 single-device addressing (2^31 bases)"
            )
        desc = desc_to_rows(mindex.desc)
        words = pack_text_words(mindex.concat, n_words(mindex.k) + 5)
        if mindex.k <= 32:
            text_rows = build_text_rows(words)
        elif mindex.k <= 64:
            text_rows = build_text_rows8(words)
        else:
            text_rows = None
        arrays = {
            "desc": desc,
            "occ_rows": build_occ_rows(mindex),
            "ends": np.asarray(mindex.ends, dtype=np.int32),
            "text": words,
            "text_rows": text_rows,
            "slot_rows": (
                build_slot_rows(mindex)
                if desc.nbytes < _SLOT_ROWS_MAX_DESC_BYTES
                else None
            ),
        }
        self._set(arrays, mindex.k, mindex.m, int(mindex.occ_key.size), mindex.h, device)

    @classmethod
    def from_numpy(cls, arrays: dict, k: int, m: int, n_occ: int, h: int, device="cuda"):
        """The port's index from the JAX index's tables: arrays maps each
        name of LEAVES to np.asarray(leaf) (None for an absent leaf)."""
        obj = cls.__new__(cls)
        obj._set(arrays, k, m, n_occ, h, device)
        return obj

    def _set(self, arrays, k, m, n_occ, h, device):
        self.k, self.m, self.n_occ, self.h = int(k), int(m), int(n_occ), int(h)
        self.device = torch.device(device)
        for name in LEAVES:
            setattr(self, name, put_i32(arrays[name], self.device))
        # an index with no occurrence still gets one payload row, never
        # matched (uend 0), so masked-off lanes have a row to read
        self._occ_rows_safe = (
            self.occ_rows if self.n_occ
            else torch.tensor([[0, -1, -1, 0]], dtype=torch.int32, device=self.device)
        )


def minimizer_scan(c: torch.Tensor, k: int, m: int):
    """(best_v, best_o, bad) of every window; see ops.minimizer_front."""
    return minimizer_windows(c, k, m)[:3]


def pack_query_windows(c: torch.Tensor, k: int):
    """(NW, B, W) packed query windows; see ops.minimizer_front."""
    return minimizer_windows(c, k, m=min(k, 16))[3]


def _word_masks(k: int) -> list:
    """Per-word masks of the valid 2k bits across ceil(2k/32) words."""
    nw = n_words(k)
    masks = [U32] * nw
    rem = 2 * k - 32 * (nw - 1)
    if rem < 32:
        masks[-1] = (1 << rem) - 1
    return masks


def _funnel(lo, hi, sh, nz, inv):
    """The 32-bit word starting sh bits into lo, continuing into hi."""
    return ((lo >> sh) | torch.where(nz, hi << inv, 0)) & U32


def _bit_split(g):
    """Text base index -> (word index, bit shift, shift != 0, 32 - shift)."""
    bit = g.to(torch.int64) << 1
    sh = bit & 31
    nz = sh > 0
    return bit >> 5, sh, nz, torch.where(nz, 32 - sh, 0)


def _match_text_kmer(text, g, q_words, masks):
    """Compare the k-mer at text base g with the packed window q_words
    ((NW, ...) int32 bit patterns). Rolling word loads, any k; the pad
    words of the text keep every load in range."""
    w0, sh, nz, inv = _bit_split(g)
    prev = u32(text[w0])
    match = None
    for w, mask in enumerate(masks):
        cur = u32(text[w0 + w + 1])
        ok_w = ((_funnel(prev, cur, sh, nz, inv) ^ u32(q_words[w])) & mask) == 0
        match = ok_w if match is None else match & ok_w
        prev = cur
    return match


def _match_text_kmer_rows(text_rows, g, q_words, masks):
    """k <= 32: one overlapped 4-word row supplies the (up to) three
    words any 64-bit window spans."""
    w0, sh, nz, inv = _bit_split(g)
    row = u32(text_rows[w0 >> 1])  # (..., 4): words [2r, 2r+4)
    odd = (w0 & 1) == 1
    t0 = torch.where(odd, row[..., 1], row[..., 0])
    t1 = torch.where(odd, row[..., 2], row[..., 1])
    t2 = torch.where(odd, row[..., 3], row[..., 2])
    match = ((_funnel(t0, t1, sh, nz, inv) ^ u32(q_words[0])) & masks[0]) == 0
    if len(masks) > 1:
        match &= ((_funnel(t1, t2, sh, nz, inv) ^ u32(q_words[1])) & masks[1]) == 0
    return match


def _match_text_kmer_rows8(text_rows8, g, q_words, masks):
    """32 < k <= 64: one overlapped 8-word row supplies the (up to) five
    words any <= 128-bit window spans; the in-row offset (0..3) selects."""
    w0, sh, nz, inv = _bit_split(g)
    row = u32(text_rows8[w0 >> 2])  # (..., 8): words [4r, 4r+8)
    o = (w0 & 3).unsqueeze(-1)
    picked = torch.gather(row, -1, o + torch.arange(len(masks) + 1, device=row.device))
    match = None
    for w, mask in enumerate(masks):
        ok_w = ((_funnel(picked[..., w], picked[..., w + 1], sh, nz, inv)
                 ^ u32(q_words[w])) & mask) == 0
        match = ok_w if match is None else match & ok_w
    return match


def _match_text(dmi: DeviceMinimizerIndex, g, q_words, masks):
    if dmi.text_rows is not None and dmi.k <= 32:
        return _match_text_kmer_rows(dmi.text_rows, g, q_words, masks)
    if dmi.text_rows is not None:
        return _match_text_kmer_rows8(dmi.text_rows, g, q_words, masks)
    return _match_text_kmer(dmi.text, g, q_words, masks)


def _check_candidate(dmi: DeviceMinimizerIndex, idx, o, q_words, masks):
    """Verify occurrence idx against the window whose minimizer offset
    is o: one payload-row gather and one text compare. Returns (match,
    uid, off)."""
    row = dmi._occ_rows_safe[idx]  # (..., 4)
    g_m, uid, off_m, uend = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
    g_w = g_m - o
    off_w = off_m - o
    ok = (off_w >= 0) & (g_w + dmi.k <= uend)
    match = ok & _match_text(dmi, g_w.clamp(min=0), q_words, masks)
    return match, uid, off_w


def make_minimizer_locate(dmi: DeviceMinimizerIndex, K_slow: int,
                          count_occurrences: bool = False, work: bool = False):
    """Returns locate: (B, L) uint8 codes on dmi.device -> ((B, W) int32
    uid, off, n_slow () int32 tensor). Results are valid only when
    n_slow <= K_slow; the caller re-runs with a larger bound otherwise
    (the deferred-verify contract of query.engine).

    With work, the slow path's work follows n_slow: longest, the () max
    slot length, which is the trip count the locate reads, and s_len,
    the (K_slow,) slot length of each lane (0 on an empty lane); a lane
    scans it to its end only with count_occurrences, else up to its
    first hit.

    With count_occurrences a last output, (B, W) int32 cnt, is the
    exact number of text occurrences of each window's k-mer (all
    occurrences of a k-mer share its minimizer, hence its slot): the
    candidate scan then runs to the slot end instead of stopping at the
    first hit. kmer-mapper's "occurs in N unitigs" check reads it."""
    k = dmi.k
    masks = _word_masks(k)

    def locate(codes: torch.Tensor):
        best_v, best_o, bad, q_words = minimizer_windows(codes, k, dmi.m)
        # slot = slot32(v) >> (32 - h); hash collisions are harmless
        # (the text compare is the arbiter)
        slot = torch.where(bad, 0, slot32(best_v) >> (32 - dmi.h))
        if dmi.slot_rows is not None:
            # fused slot row: the single-occurrence payload rides in the
            # row, so the fast path is this gather and the text compare
            srow = dmi.slot_rows[slot]  # (B, W, 4)
            code = srow[..., 1]
            single = (code >= 0) & ~bad
            ln = torch.where(bad | (code == -1), 0, torch.where(single, 1, -code))
            start = srow[..., 0]  # slow path: occ_rows start of multi slots
            g_w = srow[..., 0] - best_o
            off_w = srow[..., 2] - best_o
            ok = single & (off_w >= 0) & (g_w + k <= srow[..., 3])
            found = ok & _match_text(dmi, g_w.clamp(min=0), q_words, masks)
            uid = torch.where(found, code, -1)
            off = torch.where(found, off_w, -1)
        else:
            # narrow descriptor: desc row gather, then the payload row
            # gather inside _check_candidate
            d = dmi.desc[slot]  # (B, W, 2)
            start = d[..., 0]
            ln = torch.where(bad, 0, d[..., 1])  # exact slot length
            fast = ln == 1
            match, uid_f, off_f = _check_candidate(
                dmi, torch.where(fast, start, 0), best_o, q_words, masks
            )
            found = fast & match
            uid = torch.where(found, uid_f, -1)
            off = torch.where(found, off_f, -1)

        # slow path: multi-occurrence slots, compacted; the exact slot
        # lengths bound the candidate scan (no key compare: a candidate
        # of another value fails the text compare)
        flat_idx, n_slow = compact_mask(ln >= 2, K_slow)
        valid = flat_idx >= 0
        safe = torch.where(valid, flat_idx, 0).to(torch.int64)
        s_start = start.reshape(-1)[safe]
        s_len = torch.where(valid, ln.reshape(-1)[safe], 0)
        s_end = s_start + s_len
        s_o = best_o.reshape(-1)[safe]
        s_qw = q_words.reshape(q_words.shape[0], -1)[:, safe]
        uid_s = torch.full((K_slow,), -1, dtype=torch.int32, device=codes.device)
        off_s = torch.full_like(uid_s, -1)
        cnt_s = torch.zeros_like(uid_s)
        # the one host read of the locate: the scan's trip count
        longest = s_len.max()
        trips = trace.host_read("locate.trips", lambda: int(longest))
        trace.count("trips.slow", trips)
        for t in range(trips):
            i = s_start + t
            scan = i < s_end
            if not count_occurrences:
                scan &= cnt_s == 0  # the first hit wins
            ci = torch.where(scan, i, 0).clamp(max=max(dmi.n_occ - 1, 0))
            match, uid_c, off_c = _check_candidate(dmi, ci, s_o, s_qw, masks)
            hit = scan & match
            first = hit & (cnt_s == 0)
            uid_s = torch.where(first, uid_c, uid_s)
            off_s = torch.where(first, off_c, off_s)
            cnt_s += hit

        # drop-mode scatter: invalid lanes land in a sink slot
        BW = uid.numel()
        scat = torch.where(valid, flat_idx, BW).to(torch.int64)
        uid = _scatter_drop(uid.reshape(-1), scat, uid_s).reshape(best_v.shape)
        off = _scatter_drop(off.reshape(-1), scat, off_s).reshape(best_v.shape)
        out = (uid, off, n_slow) + ((longest, s_len) if work else ())
        if not count_occurrences:
            return out
        # exact: a one-occurrence slot holds the k-mer's only possible
        # occurrence (equal values share a slot)
        cnt = _scatter_drop(found.to(torch.int32).reshape(-1), scat, cnt_s)
        return (*out, cnt.reshape(best_v.shape))

    return locate


def _span_masks(k: int, R_run: int, nw_span: int) -> np.ndarray:
    """(R_run, nw_span) static masks: the mismatch bits (even positions,
    base j at bit 2j of the span) of bases [t, t + k) of a run's span,
    i.e. of the run's t-th window."""
    masks = np.zeros((R_run, nw_span), np.int64)
    for t in range(R_run):
        for j in range(t, t + k):
            masks[t, (2 * j) >> 5] |= 1 << ((2 * j) & 31)
    return masks


def _span_mismatches(text, g0, span_read, masks):
    """Per (lane, t) count of mismatching bases between the text span
    starting at base g0 (int, may be negative) and the read span words
    span_read (int64 words), under masks (R_run, NW_SPAN). Zero means
    window t of the run equals the text at g0 + t.

    g0 splits by a floor shift and a non-negative residue (int64), so a
    span that starts before the text keeps its alignment; every word
    index is clamped into the text, and the words a clamp substitutes
    hold only bases outside the text, whose t the caller's validity
    check rejects."""
    g2 = g0.to(torch.int64) * 2
    w0 = g2 >> 5
    sh = g2 & 31
    nz = sh > 0
    inv = torch.where(nz, 32 - sh, 0)
    last = text.numel() - 1
    prev = u32(text[w0.clamp(0, last)])
    cnt = None
    for iw, rd in enumerate(span_read):
        cur = u32(text[(w0 + iw + 1).clamp(0, last)])
        x = _funnel(prev, cur, sh, nz, inv) ^ rd
        mm = (x | (x >> 1)) & 0x55555555  # one bit per mismatching base
        c = popcount32(mm[:, None] & masks[:, iw])
        cnt = c if cnt is None else cnt + c
        prev = cur
    return cnt


def make_minimizer_locate_v2(dmi: DeviceMinimizerIndex, K_slow: int, K_heads: int,
                             count_occurrences: bool = False, work: bool = False):
    """Run-deduplicated locate, the counterpart of the JAX
    make_minimizer_locate_v2: the big-table gathers and the text
    verification run once per minimizer RUN, not once per window.

    The minimizer position of sliding windows never decreases within a
    read, so windows sharing one minimizer occurrence form runs of at
    most R_run = k - m + 1 windows. Per (B, L) batch:
      1. the front end (ops.minimizer_front: the CUDA kernel on the card);
      2. run heads and their ordinals: one cumsum;
      3. per head: the descriptor row, the single-occurrence payload row,
         and the read span of k + R_run - 1 bases, packed;
      4. the fast verify: the head's candidate text span against its read
         span once; window t's verdict is zero mismatches under the
         static mask of bases [t, t + k);
      5. a (K_heads, 4 + NB) head table [len, uid, off0, head window,
         match bitmap words], from which every window decodes its bit;
      6. the slow path over heads of multi-occurrence slots (compacted
         with ops.streaming), each candidate verified against the whole
         span; a Python loop bounded by one host read of the largest
         slot length;
      7. the scatter of run results to their windows.
    Returns (uid, off, n_slow, n_heads[, longest, s_len][, cnt]), the
    slow path's work (longest, s_len) with work, over runs (see
    make_minimizer_locate); results are valid only when n_slow <= K_slow
    and n_heads <= K_heads. Runs on both index branches (it reads only
    the descriptor rows, never slot_rows)."""
    k = dmi.k
    R_run = k - dmi.m + 1  # most windows sharing one minimizer
    NW_SPAN = (2 * (k + R_run - 1) + 31) // 32 + 1
    NB = (R_run + 31) // 32  # match-bitmap words per run
    dev = dmi.device
    masks = torch.from_numpy(_span_masks(k, R_run, NW_SPAN)).to(dev)
    t_idx = torch.arange(R_run, device=dev)[None, :]

    def locate(codes: torch.Tensor):
        B, L = codes.shape
        W = L - k + 1
        BW = B * W
        with trace.span("v2.front"):
            best_v, best_o, bad = minimizer_scan(codes, k, dmi.m)

        with trace.span("v2.runs"):
            # run heads: pm, the in-read position of the minimizer, never
            # decreases along a read, so one cumsum gives every window its
            # head ordinal and every head its slot in the head buffers
            pm = best_o + torch.arange(W, dtype=torch.int32, device=dev)[None, :]
            head = torch.cat(
                [torch.ones((B, 1), dtype=torch.bool, device=dev), pm[:, 1:] != pm[:, :-1]], dim=1
            ).reshape(-1)
            ord_flat = torch.cumsum(head.to(torch.int32), 0) - 1  # int64
            n_heads = (ord_flat[-1] + 1).to(torch.int32)
            # heads past K_heads go to the sink with the non-heads
            head_pos = _scatter_drop(
                torch.zeros(K_heads, dtype=torch.int64, device=dev),
                torch.where(head & (ord_flat < K_heads), ord_flat, K_heads),
                torch.arange(BW, device=dev),
            )

            # per-head gathers, the only touches of the big tables. No bad-
            # masking: badness is per window and can differ inside a run; the
            # slot is always in range, and ln is zeroed per window below.
            h_v = best_v.reshape(-1)[head_pos]
            d = dmi.desc[slot32(h_v) >> (32 - dmi.h)]  # (K_heads, 2)
            h_start, h_ln = d[:, 0], d[:, 1]  # h_ln: exact slot length
            row = dmi._occ_rows_safe[torch.where(h_ln == 1, h_start, 0)]
            o_h_all = best_o.reshape(-1)[head_pos]

            # packed read words (16 bases a word, least significant first) and
            # each head's read span: the k + R_run - 1 bases from the head
            # window's first base, shared by the fast verify and the slow path
            NL = (L + 15) // 16 + NW_SPAN + 1
            cp = torch.zeros((B, NL * 16), dtype=torch.int64, device=dev)
            cp[:, :L] = codes.to(torch.int64) & 3
            rw = (cp.reshape(B, NL, 16) << (2 * torch.arange(16, device=dev))).sum(2).reshape(-1)
            hb = head_pos // W
            hw0 = head_pos - hb * W
            rbase = hb * NL + (hw0 >> 4)
            rsh = 2 * (hw0 & 15)
            rnz = rsh > 0
            rinv = torch.where(rnz, 32 - rsh, 0)
            span_read_h = []
            prev = rw[rbase]
            for iw in range(NW_SPAN):
                cur = rw[rbase + iw + 1]
                span_read_h.append(_funnel(prev, cur, rsh, rnz, rinv))
                prev = cur

            # run-level fast verify of the single-occurrence heads
            g0_h = row[:, 0] - o_h_all
            off0_h = row[:, 2] - o_h_all
            cnt_h = _span_mismatches(dmi.text, g0_h, span_read_h, masks)
            vt_h = (off0_h[:, None] + t_idx >= 0) & (g0_h[:, None] + t_idx + k <= row[:, 3:4])
            match_h = (h_ln == 1)[:, None] & vt_h & (cnt_h == 0)  # (K_heads, R_run)
            mb = []  # bitmap words in [0, 2^32): bit t of word t >> 5
            for wdi in range(NB):
                ts = slice(32 * wdi, min(32 * (wdi + 1), R_run))
                sh = torch.arange(ts.stop - ts.start, device=dev)
                mb.append((match_h[:, ts].to(torch.int64) << sh).sum(1))
            head_table = torch.stack(
                [h_ln.to(torch.int64), row[:, 1].to(torch.int64), off0_h.to(torch.int64),
                 head_pos, *mb], dim=1,
            )  # (K_heads, 4 + NB): small, gathered once per window

            # redistribute: each window decodes its own bit, no big-table touch
            wrow = head_table[ord_flat.clamp(max=K_heads - 1)]
            ln = torch.where(bad.reshape(-1), 0, wrow[:, 0])
            t_w = (torch.arange(BW, device=dev) - wrow[:, 3]).clamp(0, R_run - 1)
            mbits = wrow[:, 4]
            for wdi in range(1, NB):
                mbits = torch.where((t_w >> 5) == wdi, wrow[:, 4 + wdi], mbits)
            found = (ln == 1) & (((mbits >> (t_w & 31)) & 1) == 1)
            uid = torch.where(found, wrow[:, 1], -1).to(torch.int32)
            off = torch.where(found, wrow[:, 2] + t_w, -1).to(torch.int32)

        with trace.span("v2.slow"):
            # run-level slow path: slow-ness belongs to the run (its
            # minimizer's slot), so slow runs compact on the head domain and
            # each candidate is verified against the run's whole span
            valid_h = torch.arange(K_heads, device=dev) < n_heads
            sh_idx, n_slow = compact_mask(valid_h & (h_ln >= 2), K_slow)
            sh_valid = sh_idx >= 0
            sj = torch.where(sh_valid, sh_idx, 0).to(torch.int64)
            s_start = h_start[sj]
            s_end = torch.clamp(s_start + h_ln[sj], max=dmi.n_occ)
            f0 = head_pos[sj]  # the run's first window (flat)
            nxt = head_pos[(sj + 1).clamp(max=K_heads - 1)]
            r_len = (torch.where(sj + 1 < n_heads, nxt, BW) - f0).clamp(0, R_run)
            o_h = o_h_all[sj]
            span_read = [s[sj] for s in span_read_h]
            live = sh_valid[:, None] & (t_idx < r_len[:, None])

            uid_s = torch.full((K_slow, R_run), -1, dtype=torch.int32, device=dev)
            off_s = torch.full_like(uid_s, -1)
            cnt_s = torch.zeros_like(uid_s)
            s_len = torch.where(sh_valid, s_end - s_start, 0)
            # the one host read of the locate: the scan's trip count. Scanning
            # past a window's first hit leaves uid/off at that hit and is what
            # cnt needs, so the full trip count gives the JAX loop's answer
            # in both modes, though JAX stops early when not counting.
            longest = s_len.max()
            trips = trace.host_read("locate.trips", lambda: int(longest))
            trace.count("trips.slow", trips)
            for t in range(trips):
                i = s_start + t
                active = sh_valid & (i < s_end)
                crow = dmi._occ_rows_safe[torch.where(active, i, 0).clamp(max=max(dmi.n_occ - 1, 0))]
                g0 = crow[:, 0] - o_h
                off0 = crow[:, 2] - o_h
                cntm = _span_mismatches(dmi.text, g0, span_read, masks)
                vt = (off0[:, None] + t_idx >= 0) & (g0[:, None] + t_idx + k <= crow[:, 3:4])
                match = active[:, None] & live & vt & (cntm == 0)
                first = match & (cnt_s == 0)
                uid_s = torch.where(first, crow[:, 1:2], uid_s)
                off_s = torch.where(first, off0[:, None] + t_idx, off_s).to(torch.int32)
                cnt_s += match

        with trace.span("v2.scatter"):
            # scatter run results to their windows; bad windows and lanes
            # that are not live land in the sink
            f_t = f0[:, None] + t_idx
            bad_t = bad.reshape(-1)[f_t.clamp(max=BW - 1)]
            sink = torch.where(live & ~bad_t, f_t, BW).reshape(-1)
            uid = _scatter_drop(uid, sink, uid_s.reshape(-1)).reshape(B, W)
            off = _scatter_drop(off, sink, off_s.reshape(-1)).reshape(B, W)
            out = (uid, off, n_slow, n_heads) + ((longest, s_len) if work else ())
            if not count_occurrences:
                return out
            cnt = _scatter_drop(found.to(torch.int32), sink, cnt_s.reshape(-1))
            return (*out, cnt.reshape(B, W))

    return locate


def v2_by_size(dmi: DeviceMinimizerIndex) -> bool:
    """v2 from a V2_MIN_DESC_BYTES descriptor up: the device-resident
    pipeline's rule, as in the JAX engine; no variable overrides it."""
    return dmi.desc.numel() * dmi.desc.element_size() >= V2_MIN_DESC_BYTES


def pick_v2(dmi: DeviceMinimizerIndex) -> bool:
    """Whether the engine's and kmer-mapper's locate takes the v2 form:
    FINITO_MINIMIZER_V2=0/1 forces it, else v2_by_size."""
    forced = os.environ.get("FINITO_MINIMIZER_V2")
    if forced in ("0", "1"):
        return forced == "1"
    return v2_by_size(dmi)


def make_minimizer_locate_form(dmi: DeviceMinimizerIndex, v2: bool, K_slow: int, K_heads: int,
                               count_occurrences: bool = False):
    """The v2 or v1 locate (v1 takes no K_heads) with one return shape:
    locate(codes) -> (uid, off, counters[, cnt]), counters v1's (n_slow,
    longest, s_len) or v2's (n_slow, n_heads, longest, s_len), as
    query.locators.Optimistic reads them: longest and s_len are the slow
    path's work (make_minimizer_locate)."""
    if v2:
        locate, n = make_minimizer_locate_v2(dmi, K_slow, K_heads, count_occurrences, True), 4
    else:
        locate, n = make_minimizer_locate(dmi, K_slow, count_occurrences, True), 3

    def run(codes):
        out = locate(codes)
        return (out[0], out[1], out[2 : 2 + n], *out[2 + n :])

    return run


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    """dst with dst[idx] = src, where idx == dst.numel() is dropped (the
    JAX .at[].set(mode="drop")): a scatter into a buffer with one sink
    slot, then a slice."""
    buf = torch.cat([dst, dst.new_zeros(1)])
    buf.scatter_(0, idx, src)
    return buf[:-1]

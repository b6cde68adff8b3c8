"""Device query path of the minimizer seed-and-verify index, in PyTorch:
counterpart of finito_tpu/query/minimizer_engine.py (its v1 locate).

Per (B, W) window batch, make_minimizer_locate runs
  1. the front end (ops.minimizer_front: the CUDA kernel on the card)
     -- minimizer value and offset, window validity, packed windows;
  2. one fused slot-row gather (or, without slot rows, a descriptor
     gather then a payload gather);
  3. the packed-text compare of the single-occurrence candidate;
  4. compaction of the multi-occurrence windows (ops.streaming) and an
     exact candidate scan over their slots.
Output equals FinimizerIndex.search and the JAX engine: (uid, off) or
(-1, -1) per window.

Words follow ops.bits: tables hold int32 bit patterns, and every shift
or compare runs on int64 words in [0, 2^32). Every index a masked-off
lane can produce is clamped into its table: torch raises on an
out-of-range index on the CPU and kills the CUDA context on the card,
where jnp.take filled silently.
"""

from __future__ import annotations

import numpy as np
import torch

from finito_tpu.index.minimizer import MinimizerIndex
from finito_tpu_torch.ops.bits import U32, slot32, u32
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

    def __init__(self, mindex: MinimizerIndex, device="cpu"):
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
    def from_numpy(cls, arrays: dict, k: int, m: int, n_occ: int, h: int, device="cpu"):
        """The port's index from the JAX index's tables: arrays maps each
        name of LEAVES to np.asarray(leaf) (None for an absent leaf)."""
        obj = cls.__new__(cls)
        obj._set(arrays, k, m, n_occ, h, device)
        return obj

    def _set(self, arrays, k, m, n_occ, h, device):
        self.k, self.m, self.n_occ, self.h = int(k), int(m), int(n_occ), int(h)
        self.device = torch.device(device)

        def put(a):
            if a is None:
                return None
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            a = a.astype(np.int32, copy=not a.flags.writeable)  # torch wants writable
            return torch.from_numpy(a).to(self.device)

        for name in LEAVES:
            setattr(self, name, put(arrays[name]))
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
                          count_occurrences: bool = False):
    """Returns locate: (B, L) uint8 codes on dmi.device -> ((B, W) int32
    uid, off, n_slow () int32 tensor). Results are valid only when
    n_slow <= K_slow; the caller re-runs with a larger bound otherwise
    (the deferred-verify contract of query.engine)."""
    if count_occurrences:
        raise NotImplementedError("count_occurrences (kmer-mapper) is not ported yet")
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
        found_s = ~valid
        # the one host read of the locate: the scan's trip count
        for t in range(int(s_len.max())):
            i = s_start + t
            scan = ~found_s & (i < s_end)  # the first hit wins
            ci = torch.where(scan, i, 0).clamp(max=max(dmi.n_occ - 1, 0))
            match, uid_c, off_c = _check_candidate(dmi, ci, s_o, s_qw, masks)
            hit = scan & match
            uid_s = torch.where(hit, uid_c, uid_s)
            off_s = torch.where(hit, off_c, off_s)
            found_s |= hit

        # drop-mode scatter: invalid lanes land in a sink slot
        BW = uid.numel()
        scat = torch.where(valid, flat_idx, BW).to(torch.int64)
        uid = _scatter_drop(uid.reshape(-1), scat, uid_s)
        off = _scatter_drop(off.reshape(-1), scat, off_s)
        return uid.reshape(best_v.shape), off.reshape(best_v.shape), n_slow

    return locate


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    """dst with dst[idx] = src, where idx == dst.numel() is dropped (the
    JAX .at[].set(mode="drop")): a scatter into a buffer with one sink
    slot, then a slice."""
    buf = torch.cat([dst, dst.new_zeros(1)])
    buf.scatter_(0, idx, src)
    return buf[:-1]

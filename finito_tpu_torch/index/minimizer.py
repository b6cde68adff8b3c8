"""TPU-native minimizer seed-and-verify index.

The second index family of the framework, the TPU redesign of the
reference's Rust ``kmer-mapper`` stack (ref_implementation/src/
minimizer_index.rs:7-433, main.rs:42-105): each k-mer window is located
by (1) computing its leftmost-lowest lexicographic m-minimizer with pure
vector ops, (2) one gather into a direct-addressed bucket table keyed by
the minimizer's 2-bit packed value (replacing the reference's boomphf
MPHF -- on TPU a perfect hash saves no gathers over direct addressing,
and the table build is a sort+bincount instead of a multi-round MPHF
construction), and (3) verifying the candidate text position by
comparing packed 2-bit words of the unitig concatenation.

Unlike the SBWT engines (k sequential extension steps, or a chain scan
with a divergent repair phase), every query window costs a FIXED ~8
gathers regardless of present/absent -- the right shape for a TPU whose
batched-gather throughput is the only currency (~100-200M gathers/s on
v5e). Buckets with more than one occurrence (repeated minimizers) are
resolved in a compacted slow path; the answer is exact, never
probabilistic: a candidate counts only if the full k-mer text matches.

Bucket addressing is a HASH-SLOT table rather than a direct-address or
perfect-hash one: occurrences sort by slot = h2(value) >> (32-h), and
desc[slot] = (start << 6 | exact_len). Hash collisions are HARMLESS --
a candidate only counts if its full k-mer text matches, so scanning a
slot that mixes two values cannot produce a wrong answer, and the true
occurrence always lives in its own value's slot. This keeps the
duplicate-window rate governed by the LOAD FACTOR (table ~4x the
occurrence count) instead of text_len/4^m, so the engine scales to
arbitrary text sizes with m = 16 (exact uint32 keys) and a table ~2
bytes/base -- the direct-address form needed 4^m entries and drowned in
duplicate buckets past ~10 Mbp.

Key layout choices:
  * minimizer values pack the FIRST char into the MOST significant bits,
    so numeric compare == lexicographic compare (the reference's
    minimizer order, minimizer_index.rs:41-52);
  * selection order is mix32(value) ("random minimizers": removes the
    lexicographic small-value bias); the SLOT hash is a different mix
    (slot32) so slots are not skewed by the selection bias;
  * desc[slot] = (start << 6) | len, where the stored len SATURATES at
    63 (a value repeated more often cannot be split by a bigger table
    since equal values share a slot); saturation only affects the
    fast/slow classification -- the slow path derives the EXACT slot
    end from the next slot's start (slot starts are a cumsum, so
    desc[slot+1] >> 6 is the exclusive end).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_MAGIC = b"FTMIDX02"
_LEN_BITS = 6
_LEN_MAX = (1 << _LEN_BITS) - 1

# Bijective uint32 mixes (odd multiplier => invertible mod 2^32).
_MIX = np.uint32(0x9E3779B1)  # selection order
_MIX2 = np.uint32(0xC2B2AE35)  # slot addressing (independent of selection)


def _mulmix(v, c: np.uint32, shift: int) -> np.ndarray:
    # compute in uint64 and mask: numpy warns on uint32 SCALAR overflow
    v64 = np.asarray(v).astype(np.uint64)
    prod = (v64 * np.uint64(int(c))) & np.uint64(0xFFFFFFFF)
    return (prod ^ (v64 >> np.uint64(shift))).astype(np.uint32)


def mix32(v):
    return _mulmix(v, _MIX, 16)


def slot32(v):
    return _mulmix(v, _MIX2, 13)


def _pack_desc(counts: np.ndarray) -> np.ndarray:
    """(2^h + 1,) slot descriptors: start << 6 | min(len, 63); the extra
    last entry carries the total (exclusive end of the last slot, how the
    slow path derives exact ends for saturated lengths). uint32 while the
    start fits in 26 bits, uint64 beyond (< 2^26 occurrences was the
    round-1 cap; genome-scale indexes pay 8-byte descriptor gathers)."""
    starts = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    dt = np.uint32 if int(starts[-1]) < (1 << (32 - _LEN_BITS)) else np.uint64
    lens = np.minimum(counts, _LEN_MAX).astype(dt)
    desc = (starts[:-1].astype(dt) << dt(_LEN_BITS)) | lens
    return np.concatenate([desc, np.asarray([starts[-1] << _LEN_BITS], dtype=dt)])


def default_m(k: int) -> int:
    """m = 16 packs exactly into uint32 and keeps minimizer density
    ~2/(k-m+2); the hash-slot table makes bigger m pointless and smaller
    m only increases bucket sizes (measured m-sweep, round 2). Clamped
    to k for short k-mers. Independent of text length by design."""
    return max(4, min(16, k))


def pack_mvals(codes: np.ndarray, m: int) -> np.ndarray:
    """2-bit pack every m-window of a code sequence, first char most
    significant. codes: (n,) uint8 in [0,4). Returns (n-m+1,) uint32."""
    n = codes.size
    if n < m:
        return np.zeros(0, dtype=np.uint32)
    out = np.zeros(n - m + 1, dtype=np.uint32)
    for i in range(m):
        out |= codes[i : n - m + 1 + i].astype(np.uint32) << np.uint32(2 * (m - 1 - i))
    return out


@dataclass
class MinimizerIndex:
    """Host container; device upload happens in the query engine."""

    k: int
    m: int
    h: int  # slot bits: table has 2^h slots, slot = slot32(value) >> (32-h)
    desc: np.ndarray  # (2^h,) uint32: start << 6 | exact len (<= 63)
    occ_key: np.ndarray  # (n_occ,) uint32 minimizer value, sorted by (slot, value)
    occ_gstart: np.ndarray  # (n_occ,) int32 global start of the occurrence
    occ_uid: np.ndarray  # (n_occ,) int32 unitig id
    occ_off: np.ndarray  # (n_occ,) int32 local start offset within unitig
    concat: np.ndarray  # (n_text,) uint8 2-bit codes (shared with FinimizerIndex)
    ends: np.ndarray  # (n_unitigs,) int64 exclusive ends
    headers: list | None = None  # optional FASTA headers (kmer-mapper parity:
    # extract-index-unitigs reproduces records, main.rs:108-114)

    # ------------------------------------------------------------- build
    @staticmethod
    def build(
        concat: np.ndarray,
        ends: np.ndarray,
        k: int,
        m: int | None = None,
        slot_factor: int = 32,
    ) -> "MinimizerIndex":
        """concat: 2-bit codes of all unitigs back to back (permuted order,
        same layout as PackedStrings.concat); ends: exclusive end offsets.

        For every valid window (not crossing a unitig boundary) the
        leftmost-lowest m-minimizer position is recorded; positions are
        deduped and bucketed by minimizer value.

        Texts past 2^31 bases build fine on the host (occ_gstart widens
        to int64); they exceed int32 DEVICE addressing, so single-chip
        upload (DeviceMinimizerIndex) rejects them -- the text shards
        over the tp mesh axis instead
        (finito_tpu_torch/parallel/mesh.py ShardedMinimizerIndex.build;
        its uniform slot width comes from rebucket(), a no-op for
        already-matching h).
        """
        concat = np.asarray(concat, dtype=np.uint8)
        ends64 = np.asarray(ends, dtype=np.int64)
        if np.any(concat > 3):
            # Non-ACGT codes would carry across 2-bit slots in
            # pack_text_words and corrupt neighboring bases; the Rust
            # reference likewise fails at build time
            # (minimizer_index.rs:357 from_ascii().unwrap()).
            raise ValueError("unitig text contains non-ACGT characters")
        n = concat.size
        if m is None:
            m = default_m(k)
        if m > k:
            m = k
        mv = pack_mvals(concat, m)
        hv = mix32(mv)  # selection order; bucket addressing stays on mv
        R = k - m + 1

        from finito_tpu_torch import native

        pos = native.minimizer_positions(hv, ends64, k, m)
        if pos is None:
            occ_positions: list[np.ndarray] = []
            start = 0
            for e in ends64:
                e = int(e)
                if e - start >= k:
                    seg = hv[start : e - m + 1]
                    # windows s in [start, e-k]: leftmost-lowest over R
                    # shifted views (iterative strict-< min keeps the
                    # leftmost; ~R vectorized passes, vastly faster than
                    # argmin on a strided sliding_window_view); the native
                    # path is the O(n) monotone deque
                    n_w = e - k + 1 - start
                    best = seg[:n_w].copy()
                    j = np.zeros(n_w, dtype=np.int64)
                    for r in range(1, R):
                        cand = seg[r : r + n_w]
                        upd = cand < best
                        best[upd] = cand[upd]
                        j[upd] = r
                    occ_positions.append(np.arange(start, e - k + 1, dtype=np.int64) + j)
                start = e
            if occ_positions:
                pos = np.unique(np.concatenate(occ_positions))
            else:
                pos = np.zeros(0, dtype=np.int64)

        key = mv[pos] if pos.size else np.zeros(0, dtype=np.uint32)

        # hash-slot table ~32x the occurrence count: the slow-window
        # fraction is ~the window-weighted load factor (A/B-measured
        # 44.7 M q/s at 32x vs 23 M at 4x on 400kbp; flat beyond 32x),
        # at ~15 bytes/base of HBM -- sharded over tp at pangenome scale.
        # The h <= 28 cap bounds the descriptor at 2 GB; scripts/
        # h_sweep.py measures the qps-vs-h tradeoff at genome scale
        # (rebucket() re-derives any h from one serialized midx). The
        # round-5 16 Mbp TPU sweep (SWEEP_h.json, 2026-08-20, h in
        # 22..26) confirmed the policy: qps RISES with h (12.9 M at
        # h=22/32 MB descriptor -> 14.4 M at h=26/512 MB, same harness)
        # because the v2 run-dedup engine touches the descriptor once
        # per minimizer run, so the slow-window fraction (0.0442 ->
        # 0.004 across the sweep), not descriptor residency, governs.
        # slot_factor=32 (h=26 at 16 Mbp) stands as measured optimum.
        h = max(4, min(28, int(np.ceil(np.log2(max(16, slot_factor * max(1, pos.size)))))))
        slots = (slot32(key) >> np.uint32(32 - h)).astype(np.int64)
        order = native.argsort_u64((slots.astype(np.uint64) << np.uint64(32)) | key)
        if order is None:
            order = np.lexsort((key, slots))
        key = key[order]
        pos = pos[order]
        slots = slots[order]
        counts = np.bincount(slots, minlength=1 << h) if key.size else np.zeros(1 << h, np.int64)
        desc = _pack_desc(counts)

        uid = np.searchsorted(ends64, pos, side="right").astype(np.int64)
        ustart = np.where(uid > 0, ends64[np.maximum(uid - 1, 0)], 0)
        off = pos - ustart

        gstart_dt = np.int64 if n >= (1 << 31) else np.int32
        return MinimizerIndex(
            k=k,
            m=m,
            h=h,
            desc=desc,
            occ_key=key.astype(np.uint32),
            occ_gstart=pos.astype(gstart_dt),
            occ_uid=uid.astype(np.int32),
            occ_off=off.astype(gstart_dt),
            concat=concat,
            ends=ends64,
        )

    def rebucket(self, h: int) -> "MinimizerIndex":
        """Re-address the slot table with h slot bits (in place; returns
        self). Occurrences re-sort by (new slot, value) and desc is
        rebuilt -- answers are unchanged (the slot table is a pure
        lookup accelerator). Used by the tp-sharded form
        (parallel/mesh.py ShardedMinimizerIndex), which stacks per-shard
        tables and therefore needs a uniform h."""
        h = int(h)
        if h == self.h:
            return self
        slots = (slot32(self.occ_key) >> np.uint32(32 - h)).astype(np.int64)
        from finito_tpu_torch import native

        order = native.argsort_u64(
            (slots.astype(np.uint64) << np.uint64(32)) | self.occ_key
        )
        if order is None:
            order = np.lexsort((self.occ_key, slots))
        self.occ_key = self.occ_key[order]
        self.occ_gstart = self.occ_gstart[order]
        self.occ_uid = self.occ_uid[order]
        self.occ_off = self.occ_off[order]
        counts = (
            np.bincount(slots[order], minlength=1 << h)
            if self.occ_key.size
            else np.zeros(1 << h, np.int64)
        )
        self.desc = _pack_desc(counts)
        self.h = h
        return self

    @staticmethod
    def from_finimizer_index(index, m: int | None = None) -> "MinimizerIndex":
        return MinimizerIndex.build(
            np.asarray(index.unitigs.concat, dtype=np.uint8),
            np.asarray(index.unitigs.ends, dtype=np.int64),
            index.sbwt.get_k(),
            m,
        )

    # ----------------------------------------------------- serialization
    def serialize(self, path: str) -> int:
        """Single-file format: magic + header + raw little-endian arrays
        (the reference's kmer-mapper uses magic 'KMIDXv01' + a bincode
        payload, main.rs:63-72; ours is its spiritual twin)."""
        headers_blob = b"\n".join(self.headers) if self.headers is not None else b""
        # gstart/off widen to 8-byte little-endian past 2^31 bases; the
        # reader infers the width from the section size (element count
        # is pinned by occ_key)
        pos_dt = "<i8" if self.occ_gstart.dtype.itemsize == 8 else "<i4"
        arrs = [
            self.occ_key.astype("<u4"),
            self.occ_gstart.astype(pos_dt),
            self.occ_uid.astype("<i4"),
            self.occ_off.astype(pos_dt),
            self.concat.astype("u1"),
            self.ends.astype("<i8"),
            np.frombuffer(headers_blob, dtype="u1"),
        ]
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<qqqq", self.k, self.m, self.h, len(arrs)))
            for a in arrs:
                f.write(struct.pack("<q", a.nbytes))
                f.write(a.tobytes())
        return self.size_in_bytes()

    @staticmethod
    def load(path: str) -> "MinimizerIndex":
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise ValueError(f"{path}: not a finito minimizer index (expected {_MAGIC!r})")
            k, m, h, n_arrs = struct.unpack("<qqqq", f.read(32))
            raw = []
            for _ in range(n_arrs):
                (nb,) = struct.unpack("<q", f.read(8))
                raw.append(f.read(nb))
        occ_key = np.frombuffer(raw[0], dtype="<u4")
        pos_dt = "<i8" if len(raw[1]) == 8 * occ_key.size and occ_key.size else "<i4"
        occ_gstart = np.frombuffer(raw[1], dtype=pos_dt)
        occ_uid = np.frombuffer(raw[2], dtype="<i4")
        occ_off = np.frombuffer(raw[3], dtype=pos_dt)
        concat = np.frombuffer(raw[4], dtype="u1")
        ends = np.frombuffer(raw[5], dtype="<i8")
        headers = raw[6].split(b"\n") if len(raw) > 6 and raw[6] else None
        # desc rebuilt from the stored (slot-sorted) keys, like the
        # reference rebuilds its rank supports at load
        h = int(h)
        slots = (slot32(occ_key) >> np.uint32(32 - h)).astype(np.int64)
        counts = np.bincount(slots, minlength=1 << h) if occ_key.size else np.zeros(1 << h, np.int64)
        desc = _pack_desc(counts)
        return MinimizerIndex(
            k=int(k), m=int(m), h=h, desc=desc, occ_key=occ_key.copy(),
            occ_gstart=occ_gstart.copy(), occ_uid=occ_uid.copy(),
            occ_off=occ_off.copy(), concat=concat.copy(), ends=ends.copy(),
            headers=headers,
        )

    def size_in_bytes(self) -> int:
        return sum(
            a.nbytes
            for a in (
                self.desc, self.occ_key, self.occ_gstart, self.occ_uid,
                self.occ_off, self.ends,
            )
        ) + (self.concat.size + 3) // 4  # concat counts at 2 bits/base

    # -------------------------------------------------------- host query
    def lookup_kmer_host_all(self, codes: np.ndarray):
        """ALL occurrences of one k-mer as a list of (uid, off) -- the
        reference's lookup_kmer returns the full candidate-verified list
        so the CLI can error on multi-unitig k-mers (main.rs:89-92)."""
        k, m = self.k, self.m
        assert codes.size == k
        if np.any(codes > 3):
            return []
        mv = pack_mvals(codes, m)
        o = int(np.argmin(mix32(mv)))
        v = int(mv[o])
        slot = int(slot32(np.uint32(v))) >> (32 - self.h)
        start = int(self.desc[slot]) >> _LEN_BITS
        end = int(self.desc[slot + 1]) >> _LEN_BITS  # exact (cumsum starts)
        out = []
        for i in range(start, min(end, self.occ_key.size)):
            if int(self.occ_key[i]) != v:
                continue  # hash-collision neighbor in the same slot
            g = int(self.occ_gstart[i]) - o
            uid = int(self.occ_uid[i])
            off = int(self.occ_off[i]) - o
            if (
                off >= 0
                and g + k <= int(self.ends[uid])
                and np.array_equal(self.concat[g : g + k], codes)
            ):
                out.append((uid, off))
        return out

    def get_exact_alignment_candidates(self, query_codes: np.ndarray):
        """Distinct (unitig_id, align_start) pairs such that the full
        query could align at align_start of that unitig -- every k-mer
        window's occurrences shifted back by the window position, bounds-
        checked against the unitig (ref: the Rust reference's seed API,
        minimizer_index.rs:264-277)."""
        q = np.asarray(query_codes, np.uint8)
        k = self.k
        out = set()
        starts = np.concatenate([[0], np.asarray(self.ends[:-1], np.int64)])
        for qp in range(q.size - k + 1):
            for uid, tp in self.lookup_kmer_host_all(q[qp : qp + k]):
                a = tp - qp
                ulen = int(self.ends[uid]) - int(starts[uid])
                if a >= 0 and a + q.size <= ulen:
                    out.add((uid, a))
        return sorted(out)

    def lookup_kmer_host(self, codes: np.ndarray):
        """Host oracle for one k-mer: (uid, off) or (-1, -1). Mirrors the
        reference's lookup_kmer (minimizer_index.rs:228-260)."""
        k, m = self.k, self.m
        assert codes.size == k
        if np.any(codes > 3):
            return (-1, -1)
        occs = self.lookup_kmer_host_all(codes)
        return occs[0] if occs else (-1, -1)

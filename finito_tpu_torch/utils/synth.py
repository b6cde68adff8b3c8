"""Synthetic workload generators and an index-free all-window oracle: the
port's copy of finito_tpu/utils/synth.py (numpy only).

Uniform random text has almost no repeats, so dBG branching,
multi-occurrence minimizer slots and the cross-unitig overwrite rule run
far below real-genome rates. gen_repeat_genome composes tandem repeats,
divergent segmental duplications and SNP bubbles over a random backbone
-- the three repeat classes that dominate real genomes -- so the
engines' slow paths and dbg.py's dedup get real load.

The k-mer set of such a genome has its repeats collapsed (a DSPSS holds
every distinct k-mer once), so ground truth comes from
kmer_location_oracle: a sort and merge-join of the query windows against
the unitig windows, with no index structure involved, exact for k <= 32.

The DSPSS generator (gen_dspss, draw_cuts) and the repeat cell's
parameters (REPEAT_PARAMS) are numpy copies of bench.py's. The same rng
state gives the same arrays as the JAX package's copies: every rng call
stays in its order, with its dtype.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# the repeat cell's generator parameters (bench.py's REPEAT_PARAMS): these
# raise the surviving shared-minimizer k-mers until the cell stresses the
# multi-occurrence slow path; a change invalidates cached repeat indexes
REPEAT_PARAMS = dict(seg_frac=0.35, snp_rate=0.004, div_rate=0.04)


def draw_cuts(rng, genome_len: int, k: int, mean_unitig: int = 2000) -> np.ndarray:
    """Unitig cut points; unitig i = genome[cuts[i] : cuts[i+1] + k - 1].
    Deterministic in the rng state, so a cached genome's cuts can be
    regenerated by replaying the same rng (tools.cache)."""
    cuts = [0]
    while cuts[-1] < genome_len - k:
        step = int(rng.integers(mean_unitig // 2, mean_unitig * 2))
        cuts.append(min(genome_len - k + 1, cuts[-1] + step))
    return np.asarray(cuts, np.int64)


def gen_dspss(rng, genome_len: int, k: int, mean_unitig: int = 2000, return_cuts: bool = False):
    """Random genome cut into unitigs overlapping by k-1 (k-mer set
    preserved, each k-mer occurs exactly once). Returns (genome, unitigs
    as bytes[, cuts])."""
    from finito_tpu_torch.io.seqdb import decode_seq
    from finito_tpu_torch.sbwt import keys as kw

    while True:
        genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
        # k-mer distinctness (astronomically likely for k=31): native
        # rolling pack + radix sort, one pass each
        wk = kw.sort_keys(kw.pack_windows(genome, k))
        if not np.any(kw.eq_adjacent(wk)):
            break
    del wk
    cuts = draw_cuts(rng, genome_len, k, mean_unitig)
    unitigs = [decode_seq(genome[a : b + k - 1]) for a, b in zip(cuts[:-1], cuts[1:])]
    if return_cuts:
        return genome, unitigs, cuts
    return genome, unitigs


def gen_repeat_genome(
    rng: np.random.Generator,
    length: int,
    tandem_frac: float = 0.2,
    seg_frac: float = 0.2,
    snp_rate: float = 0.001,
    div_rate: float = 0.01,
) -> np.ndarray:
    """Repeat-dense genome of ~`length` bases (uint8 codes 0..3).

    Composition by draw: fresh random sequence, tandem repeats (unit
    20-500 bp x 2-16 copies), or a segmental duplication (a 1-40 kbp
    slice of what exists so far, re-inserted with `div_rate`
    divergence). Finally SNPs at snp_rate create bubble pairs against
    the duplicated copies.

    Exact repeats collapse in a DSPSS (one node per distinct k-mer);
    what stresses the engines' slow paths is near-duplication: k-mers
    within k of a divergence site survive as distinct nodes that share
    minimizer m-mers (multi-occurrence slots), so that pressure scales
    with div_rate + snp_rate, not with the duplicated fraction."""
    parts: List[np.ndarray] = []
    total = 0
    while total < length:
        u = rng.random()
        if u < tandem_frac:
            unit = rng.integers(0, 4, size=int(rng.integers(20, 500)), dtype=np.uint8)
            copies = int(rng.integers(2, 17))
            seg = np.tile(unit, copies)
        elif u < tandem_frac + seg_frac and total > 50_000:
            src_len = int(rng.integers(1_000, 40_000))
            genome_so_far = np.concatenate(parts)
            start = int(rng.integers(0, max(1, genome_so_far.size - src_len)))
            seg = genome_so_far[start : start + src_len].copy()
            n_div = max(1, int(div_rate * seg.size))
            pos = rng.integers(0, seg.size, size=n_div)
            seg[pos] = (seg[pos] + rng.integers(1, 4, size=n_div)) % 4
        else:
            seg = rng.integers(0, 4, size=int(rng.integers(2_000, 20_000)), dtype=np.uint8)
        parts.append(seg)
        total += seg.size
    genome = np.concatenate(parts)[:length]
    n_snp = int(snp_rate * genome.size)
    if n_snp:
        pos = rng.integers(0, genome.size, size=n_snp)
        genome[pos] = (genome[pos] + rng.integers(1, 4, size=n_snp)) % 4
    return genome


def _pack_all_windows(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-windows of a code array 2-bit packed into uint64, first
    char most significant. k <= 32."""
    codes = np.asarray(codes, np.uint64)
    if codes.size < k:
        return np.zeros(0, np.uint64)
    n = codes.size - k + 1
    out = np.zeros(n, np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | codes[i : i + n]
    return out


def kmer_location_oracle(
    unitigs_concat: np.ndarray,
    unitigs_ends: np.ndarray,
    reads: np.ndarray,
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact (uid, off) per read window by sort and merge-join against
    the unitig window set, with no index structure involved. reads:
    (B, L) codes (values > 3 = pad/invalid -> window absent). Returns
    (B, W) int32 uid / off with -1 for absent. Requires the unitig set to
    be k-mer-disjoint (a DSPSS; duplicate keys raise). k <= 32."""
    from finito_tpu_torch import native

    concat = np.asarray(unitigs_concat, np.uint8)
    ends = np.asarray(unitigs_ends, np.int64)
    B, L = reads.shape
    W = L - k + 1

    # unitig-side keys + (uid, off) payload, windows within one unitig
    keys, uids, offs = [], [], []
    start = 0
    for uid, e in enumerate(ends):
        e = int(e)
        if e - start >= k:
            kk = _pack_all_windows(concat[start:e], k)
            keys.append(kk)
            uids.append(np.full(kk.size, uid, np.int64))
            offs.append(np.arange(kk.size, dtype=np.int64))
        start = e
    ukeys = np.concatenate(keys) if keys else np.zeros(0, np.uint64)
    uuid = np.concatenate(uids) if uids else np.zeros(0, np.int64)
    uoff = np.concatenate(offs) if offs else np.zeros(0, np.int64)
    order = native.argsort_u64(ukeys)
    if order is None:
        order = np.argsort(ukeys, kind="stable")
    ukeys, uuid, uoff = ukeys[order], uuid[order], uoff[order]
    if ukeys.size and np.any(ukeys[1:] == ukeys[:-1]):
        raise ValueError("unitig set is not k-mer-disjoint (not a DSPSS)")

    # read-side keys; invalid chars poison their windows (their masked
    # 2-bit residue still lands in qk, so `bad` must gate the hit)
    r8 = np.asarray(reads, np.uint8)
    qk = np.zeros((B, W), np.uint64)
    badc = r8 > 3
    bad = np.zeros((B, W), bool)
    for i in range(k):
        col = r8[:, i : i + W].astype(np.uint64)
        qk = (qk << np.uint64(2)) | (col & np.uint64(3))
        bad |= badc[:, i : i + W]
    pos = np.searchsorted(ukeys, qk.reshape(-1))
    pos = np.minimum(pos, max(0, ukeys.size - 1))
    hit = (
        (ukeys.size > 0)
        & (ukeys[pos] == qk.reshape(-1))
        & ~bad.reshape(-1)
    )
    uid = np.where(hit, uuid[pos], -1).astype(np.int32).reshape(B, W)
    off = np.where(hit, uoff[pos], -1).astype(np.int32).reshape(B, W)
    return uid, off

"""The benchmark's data: the deployment's genome, its unitig set and a
traffic mix's read pool, made from the run's seed.

A configuration names its genome, and the genome decides its unitigs
(`genome_and_unitigs`): a uniform random genome is cut into unitigs (the
default), a repeat-dense genome is decomposed into the canonical unitigs
of its de Bruijn graph (`dbg_unitigs`), as ggcat gives them. Reads are
drawn from the genome either way.

Frozen copies, kept here so that a change to the program cannot change
what the benchmark feeds it:

  * draw_cuts, gen_dspss: finito_tpu_torch/utils/synth.py (itself a copy
    of bench.py's), with the same rng calls in the same order, so one rng
    state gives the same genome and cuts. The k-mer distinctness check
    sorts with numpy instead of the program's native sorter.
  * gen_repeat_genome: finito_tpu_torch/utils/synth.py's, with the same
    rng calls in the same order, so one rng state gives the same genome.
  * gen_reads: the read sampler of bench.py / chip_smoke.py
    (sample_reads: uniform starts, point substitutions at a fixed rate),
    widened to a traffic file's length distribution, strand mix and
    N-carrying reads.

Everything is numpy; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np

DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)
N_CODE = 4  # a non-ACGT base, written as 'N'
_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def draw_cuts(rng, genome_len: int, k: int, mean_unitig: int = 2000) -> np.ndarray:
    """Unitig cut points; unitig i = genome[cuts[i] : cuts[i+1] + k - 1]."""
    cuts = [0]
    while cuts[-1] < genome_len - k:
        step = int(rng.integers(mean_unitig // 2, mean_unitig * 2))
        cuts.append(min(genome_len - k + 1, cuts[-1] + step))
    return np.asarray(cuts, np.int64)


def pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Every k-window of a 0..3 code array as a uint64, first base most
    significant (k <= 32)."""
    codes = np.asarray(codes, np.uint64)
    n = codes.size - k + 1
    out = np.zeros(max(n, 0), np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | codes[i : i + n]
    return out


def gen_dspss(rng, genome_len: int, k: int, mean_unitig: int = 2000):
    """Random genome cut into unitigs overlapping by k - 1 bases: every
    k-mer of the genome occurs exactly once in the unitig set. Returns
    (genome codes uint8, cuts int64)."""
    while True:
        genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
        keys = np.sort(pack_kmers(genome, k))
        if not np.any(keys[1:] == keys[:-1]):
            break
    del keys
    return genome, draw_cuts(rng, genome_len, k, mean_unitig)


def gen_repeat_genome(rng, length: int, tandem_frac: float = 0.2, seg_frac: float = 0.2,
                      snp_rate: float = 0.001, div_rate: float = 0.01) -> np.ndarray:
    """Repeat-dense genome of `length` bases (uint8 codes 0..3): draws of
    fresh random sequence, tandem repeats (unit 20-500 bp x 2-16 copies)
    or segmental duplications (a 1-40 kbp slice of what exists so far,
    re-inserted with div_rate divergence), then SNPs at snp_rate."""
    parts = []
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


def cut_unitigs(genome: np.ndarray, cuts: np.ndarray, k: int):
    """The unitigs genome[cuts[i] : cuts[i+1] + k - 1] as flat codes and
    their exclusive ends."""
    lens = np.diff(cuts) + (k - 1)
    ends = np.cumsum(lens)
    offs = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(ends - lens, lens)
    return genome[np.repeat(cuts[:-1], lens) + offs], ends


def rc_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """The reverse complement of packed k-mers (pack_kmers' layout, k <= 32):
    complement every base, then reverse the order of the 2-bit groups."""
    x = ~np.asarray(keys, np.uint64)
    for shift, mask in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                        (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        s, m = np.uint64(shift), np.uint64(mask)
        x = ((x >> s) & m) | ((x & m) << s)
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    return x >> np.uint64(64 - 2 * k)


def _walk_back(prev: np.ndarray, rounds: int):
    """Pointer doubling along prev (-1 ends a path): each element's
    farthest element back and its distance. Elements still walking after
    `rounds` rounds lie on a cycle; they are returned as the last array."""
    ids = np.arange(prev.size, dtype=np.int64)
    up = np.where(prev >= 0, prev, ids)
    dist = (prev >= 0).astype(np.int64)
    live = ids[prev >= 0]
    live = live[prev[up[live]] >= 0]
    for _ in range(rounds):
        if live.size == 0:
            break
        a = up[live]
        dist[live] += dist[a]
        up[live] = up[a]
        live = live[prev[up[live]] >= 0]
    return up, dist, live


def _cycle_least(prev: np.ndarray, cyc: np.ndarray, rounds: int) -> np.ndarray:
    """The least element of each cycle, for the elements cyc that lie on
    cycles of prev (all of each cycle's elements)."""
    up, least = prev.copy(), np.arange(prev.size, dtype=np.int64)
    least[cyc] = np.minimum(cyc, prev[cyc])
    for _ in range(rounds):
        a = up[cyc]
        least[cyc] = np.minimum(least[cyc], least[a])
        up[cyc] = up[a]
    return least[cyc]


def dbg_unitigs(genome: np.ndarray, k: int):
    """The maximal unitigs of the bidirected de Bruijn graph over the
    genome's distinct canonical k-mers (odd k <= 31), as `ggcat build -k k
    --min-multiplicity 1` gives them. Returns (flat codes uint8, exclusive
    ends int64): each canonical k-mer of the genome once, in one orientation.

    Oriented node 2i is the i-th least canonical k-mer read forward, 2i+1
    its reverse complement. x -> y is an edge where x's last k-1 bases are
    y's first; x extends into y only where y is x's one successor, x is
    y's one predecessor and y is not x's own node. The chains of those
    links are the unitigs; a chain that closes on itself (an isolated
    cycle) is broken before its least oriented node. Every chain has a
    mirror, the same k-mers read on the other strand: the one emitted is
    spelt with its least canonical k-mer forward, and the unitigs come in
    the order of their least canonical k-mers."""
    if k % 2 == 0 or not 1 <= k <= 31:
        raise ValueError(f"canonical unitigs need an odd k <= 31, not {k}")
    fwd = pack_kmers(genome, k)
    rev = rc_keys(fwd, k)
    canon = np.minimum(fwd, rev)
    by_canon = np.argsort(canon)
    canon = canon[by_canon]
    new = np.ones(canon.size, bool)
    new[1:] = canon[1:] != canon[:-1]
    nodes = canon[new]
    seen_at = by_canon[new]  # where the genome meets each node, and on which strand
    seen_rc = (fwd > rev)[seen_at]
    del fwd, rev, canon, by_canon
    m = 2 * nodes.size
    key = np.empty(m, np.uint64)
    key[0::2], key[1::2] = nodes, rc_keys(nodes, k)
    # successors: the oriented nodes whose first k-1 bases are x's last;
    # the lookups go in sorted order, which keeps them in cache
    first = key >> np.uint64(2)
    by_first = np.argsort(first)
    first = first[by_first]
    last = key & np.uint64((1 << (2 * (k - 1))) - 1)
    by_last = np.argsort(last)
    last = last[by_last]
    lo = np.searchsorted(first, last, "left")
    n_succ = np.searchsorted(first, last, "right") - lo
    outdeg = np.empty(m, np.int64)
    outdeg[by_last] = n_succ
    one = by_last[n_succ == 1]
    succ = by_first[lo[n_succ == 1]]
    del first, last, by_last, by_first, lo, n_succ
    # y's predecessors are the successors of y's mirror, read backwards
    ok = (outdeg[succ ^ 1] == 1) & ((succ >> 1) != (one >> 1))
    del outdeg
    prev = np.full(m, -1, np.int64)
    prev[succ[ok]] = one[ok]
    # walk the chains in the genome's order, where neighbours sit close
    met = np.zeros(genome.size, bool)
    met[seen_at] = True
    rank = (np.cumsum(met) - 1)[seen_at]
    ids = np.arange(m, dtype=np.int64)
    to_walk = 2 * rank[ids >> 1] + ((ids & 1) ^ np.repeat(seen_rc, 2))
    from_walk = np.empty(m, np.int64)
    from_walk[to_walk] = ids
    walk_prev = np.full(m, -1, np.int64)
    has = prev >= 0
    walk_prev[to_walk[has]] = to_walk[prev[has]]
    rounds = int(np.ceil(np.log2(max(m, 2)))) + 2
    up, pos, cyc = _walk_back(walk_prev, rounds)
    if cyc.size:  # break each cycle before its least node, and walk again
        walk_prev[to_walk[np.unique(_cycle_least(prev, from_walk[cyc], rounds))]] = -1
        up, pos, _ = _walk_back(walk_prev, rounds)
    up, pos = from_walk[up[to_walk]], pos[to_walk]
    # group the elements by chain (its head), in chain order
    size = np.bincount(up, minlength=m)
    start = np.cumsum(size) - size
    order = np.empty(m, np.int64)
    order[start[up] + pos] = ids
    heads = np.flatnonzero(size)
    at = start[heads]
    low = np.minimum.reduceat(order, at)
    emit = low < np.minimum.reduceat(order ^ 1, at)
    heads = heads[emit][np.argsort(low[emit])]
    n_kmers = size[heads]
    ends = np.cumsum(n_kmers + (k - 1))
    codes = np.empty(int(ends[-1]), np.uint8)
    # the head's k bases, then the last base of each later k-mer
    begin = ends - n_kmers - (k - 1)
    head_key = key[heads]
    for j in range(k):
        codes[begin + j] = (head_key >> np.uint64(2 * (k - 1 - j))) & np.uint64(3)
    later = n_kmers - 1
    step = np.arange(int(later.sum()), dtype=np.int64) - np.repeat(np.cumsum(later) - later, later)
    members = order[np.repeat(start[heads] + 1, later) + step]
    codes[np.repeat(begin + k, later) + step] = key[members] & np.uint64(3)
    return codes, ends


def genome_and_unitigs(seed: int, cfg: dict):
    """A configuration's data step: its genome and its unitig set (flat
    codes, exclusive ends), drawn from the run's seed, or from
    cfg["genome_seed"] where the file fixes one genome for every run (a
    deployment serves one reference; the reads still follow the run's
    seed). cfg["genome"] is "uniform" (the default: gen_dspss's genome,
    every k-mer distinct, cut at cfg["mean_unitig"]) or "repeat"
    (gen_repeat_genome with the keywords cfg["repeat"], decomposed by
    dbg_unitigs: cuts of it would hold repeated k-mers)."""
    rng = np.random.default_rng([int(cfg.get("genome_seed", seed)), 0])
    k, n = int(cfg["k"]), int(cfg["genome_len"])
    kind = cfg.get("genome", "uniform")
    if kind == "repeat":
        genome = gen_repeat_genome(rng, n, **cfg["repeat"])
        return genome, dbg_unitigs(genome, k)
    if kind != "uniform":
        raise ValueError(f"configuration {cfg.get('name')!r}: genome {kind!r}")
    genome, cuts = gen_dspss(rng, n, k, int(cfg.get("mean_unitig", 2000)))
    return genome, cut_unitigs(genome, cuts, k)


def unitig_bytes(codes: np.ndarray, ends: np.ndarray) -> list:
    """The unitigs as ASCII, in the set's order."""
    text = DECODE[codes].tobytes()
    return [text[a:b] for a, b in zip([0] + ends[:-1].tolist(), ends.tolist())]


def read_lengths(rng, n: int, spec: dict) -> np.ndarray:
    """n read lengths from a traffic file's "length" entry:
    {"fixed": L} or {"lognormal_median": M, "sigma": s, "min": a, "max": b}
    (clipped to [a, b])."""
    if "fixed" in spec:
        return np.full(n, int(spec["fixed"]), np.int64)
    x = rng.lognormal(np.log(float(spec["lognormal_median"])), float(spec["sigma"]), size=n)
    return np.clip(np.rint(x), int(spec["min"]), int(spec["max"])).astype(np.int64)


def gen_reads(rng, genome: np.ndarray, traffic: dict):
    """A traffic mix's read pool: traffic["pool"] reads of traffic["length"]
    lengths, starts uniform over the genome, the reverse complement taken
    with probability traffic["rc_frac"], then substitutions at
    traffic["sub_rate"] per base, then one N in a traffic["n_frac"] share of
    the reads. Returns (codes uint8 with N as 4, read ends int64)."""
    n = int(traffic["pool"])
    lens = read_lengths(rng, n, traffic["length"])
    if lens.max() > genome.size:
        raise ValueError("a read is longer than the genome")
    starts = rng.integers(0, genome.size - lens + 1)
    ends = np.cumsum(lens)
    offs = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(ends - lens, lens)
    codes = genome[np.repeat(starts, lens) + offs]
    rc = rng.random(n) < float(traffic["rc_frac"])
    # reverse complement in place, read by read: position i of a reversed
    # read takes the complement of position len - 1 - i
    mirror = np.repeat(ends - lens, lens) + (np.repeat(lens, lens) - 1 - offs)
    flip = np.repeat(rc, lens)
    codes = np.where(flip, 3 - codes[mirror], codes).astype(np.uint8)
    n_sub = int(rng.binomial(codes.size, float(traffic["sub_rate"])))
    at = rng.integers(0, codes.size, size=n_sub)
    codes[at] = (codes[at] + rng.integers(1, 4, size=n_sub)) % 4
    with_n = np.flatnonzero(rng.random(n) < float(traffic["n_frac"]))
    codes[(ends - lens)[with_n] + (rng.random(with_n.size) * lens[with_n]).astype(np.int64)] = N_CODE
    return codes, ends


def fastq_bytes(codes: np.ndarray, ends: np.ndarray) -> bytes:
    """The pool as FASTQ (quality 'I' throughout), one record per read."""
    seq = _ASCII[codes]
    starts = np.concatenate([[0], ends[:-1]])
    parts = []
    for i, (a, b) in enumerate(zip(starts.tolist(), ends.tolist())):
        s = seq[a:b].tobytes()
        parts.append(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * (b - a)))
    return b"".join(parts)

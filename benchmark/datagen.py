"""The benchmark's data: the deployment's unitig set and a traffic mix's
read pool, made from the run's seed.

Frozen copies, kept here so that a change to the program cannot change
what the benchmark feeds it:

  * draw_cuts, gen_dspss: finito_tpu_torch/utils/synth.py (itself a copy
    of bench.py's), with the same rng calls in the same order, so one rng
    state gives the same genome and cuts. The k-mer distinctness check
    sorts with numpy instead of the program's native sorter.
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


def unitig_bytes(genome: np.ndarray, cuts: np.ndarray, k: int) -> list:
    """The unitigs as ASCII, in generation order."""
    return [DECODE[genome[a : b + k - 1]].tobytes() for a, b in zip(cuts[:-1], cuts[1:])]


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

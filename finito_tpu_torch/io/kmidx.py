"""One-way importer for the Rust kmer-mapper's ``KMIDXv01`` index files.

Layout (ref: ref_implementation/src/main.rs:20,63-72 and
minimizer_index.rs:139-215, all little-endian):

  magic            8 bytes  "KMIDXv01"
  kmer_width       u64      Kmer<W> monomorphization (64-bit words)
  k, m, n_mmers    u64 each
  n_locations      u64, then n x (u32 unitig_id, u32 pos)
  n_buckets        u64, then n x u64 bucket starts
  mphf             bincode(boomphf::Mphf<Kmer<W>>)
  unitigs          FASTA text to EOF

The boomphf blob is structurally SKIPPED, not used: finito's hash-slot
table replaces the MPHF, and everything the query path needs rebuilds
from (unitigs, k, m). The skip walks bincode's fixed-width framing of
Mphf { bitvecs: [BitVector{bits: u64, vector: [u64]}], ranks: [[u64]] }
with plausibility checks at every length field, and requires the byte
after the blob to start the FASTA ('>') -- a framing mismatch fails
loudly rather than mis-importing.

The file's `locations` section is cross-validated by RECOMPUTING the
reference's own minimizer definition over the imported unitigs: the
deduplicated leftmost-lowest LEXICOGRAPHIC m-minimizer occurrences
(minimizer_index.rs:41-52, strict `<`, leftmost wins ties) at the
file's own m. This is deliberately NOT finito's definition -- finito
selects by mix32 hash order with its own m (query answers are
independent of both, they only steer table load), so the stored set
from a genuine cargo-built file (default m = k-6) can never match
finito's occurrence set and is not compared against it.

Verification status: no Rust toolchain exists in this environment, so
the reader is exercised against synthetic files produced by
`write_kmidx` below (same framing, structurally-valid placeholder MPHF
blob) -- a real cargo-built artifact is the one input that could still
falsify the boomphf blob layout. The write direction produces a file
the READER accepts; it cannot produce a working boomphf MPHF (the
construction seeds and hasher are internal to the Rust crate), so files
written here are for finito's own consumption and testing only.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Tuple

import numpy as np

MAGIC = b"KMIDXv01"


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise IOError("truncated KMIDXv01 file")
    return b


def _u64(f: BinaryIO) -> int:
    return struct.unpack("<Q", _read_exact(f, 8))[0]


def _skip_mphf(f: BinaryIO) -> None:
    """Walk the bincode framing of boomphf::Mphf and leave the stream at
    the first byte after it. Every length is sanity-bounded."""
    n_bitvecs = _u64(f)
    if n_bitvecs > 4096:
        raise IOError(f"implausible boomphf bitvec count {n_bitvecs}")
    for _ in range(n_bitvecs):
        bits = _u64(f)
        if bits > (1 << 44):
            raise IOError(f"implausible boomphf bitvector size {bits}")
        vlen = _u64(f)
        if vlen != (bits + 63) // 64:
            raise IOError(
                f"boomphf bitvector word count {vlen} != ceil({bits}/64)"
            )
        _read_exact(f, 8 * vlen)
    n_ranks = _u64(f)
    if n_ranks != n_bitvecs:
        raise IOError(f"boomphf ranks count {n_ranks} != bitvecs {n_bitvecs}")
    for _ in range(n_ranks):
        rlen = _u64(f)
        if rlen > (1 << 40):
            raise IOError(f"implausible boomphf rank length {rlen}")
        _read_exact(f, 8 * rlen)


def read_kmidx(path: str):
    """Parse a KMIDXv01 file -> (k, m, locations(u32 pairs), unitig
    SeqDB). Raises IOError on any framing mismatch."""
    from finito_tpu_torch.io.seqdb import SeqDB

    with open(path, "rb") as f:
        if _read_exact(f, 8) != MAGIC:
            raise IOError(f"{path}: not a KMIDXv01 kmer-mapper index")
        kmer_width = _u64(f)
        if not (1 <= kmer_width <= 8):
            raise IOError(f"implausible k-mer width {kmer_width} (64-bit words)")
        k = _u64(f)
        m = _u64(f)
        _n_mmers = _u64(f)
        if not (0 < m <= k <= 64 * kmer_width // 2):
            raise IOError(f"implausible k={k} m={m} for width {kmer_width}")
        n_loc = _u64(f)
        if n_loc > (1 << 40):
            raise IOError(f"implausible location count {n_loc}")
        loc = np.frombuffer(_read_exact(f, 8 * n_loc), dtype="<u4").reshape(n_loc, 2)
        n_buckets = _u64(f)
        if n_buckets > (1 << 40):
            raise IOError(f"implausible bucket count {n_buckets}")
        _read_exact(f, 8 * n_buckets)  # bucket starts: superseded by our table
        _skip_mphf(f)
        fasta = f.read()
    if not fasta.lstrip().startswith(b">"):
        raise IOError(
            "bytes after the boomphf blob do not start a FASTA record -- "
            "blob framing mismatch (see finito_tpu_torch/io/kmidx.py docstring)"
        )
    from finito_tpu_torch.native import parse_fastx_bytes

    parsed = parse_fastx_bytes(fasta)
    if parsed is not None:
        codes, ends, headers = parsed
        db = SeqDB(concat=codes, ends=ends, headers=headers)
    else:
        import os
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".fna", delete=False) as tf:
            tf.write(fasta)
            tmp = tf.name
        try:
            db = SeqDB.from_file(tmp)
        finally:
            os.unlink(tmp)
    return int(k), int(m), loc.copy(), db


def _lex_minimizer_occurrences(
    concat: np.ndarray, ends: np.ndarray, k: int, m: int
) -> np.ndarray:
    """Deduplicated leftmost-lowest LEXICOGRAPHIC m-minimizer positions
    per k-window -- the Rust reference's definition (strict ``<`` over
    the m-mer bytes keeps the leftmost minimum, minimizer_index.rs:41-52;
    ACGT byte order equals 2-bit code order). Returns sorted (uid, off)
    int64 pairs. m <= 32 (uint64-packed m-mers)."""
    if m > 32:
        raise IOError(f"m={m} exceeds the 32-base uint64 m-mer packing")
    out = []
    start = 0
    for uid, e in enumerate(np.asarray(ends, np.int64)):
        e = int(e)
        L = e - start
        if L >= k:
            codes = np.asarray(concat[start:e], np.uint64)
            nmm = L - m + 1
            mv = np.zeros(nmm, dtype=np.uint64)
            for i in range(m):
                mv |= codes[i : nmm + i] << np.uint64(2 * (m - 1 - i))
            nw = L - k + 1
            best = mv[:nw].copy()
            pos = np.zeros(nw, dtype=np.int64)
            for r in range(1, k - m + 1):
                cand = mv[r : r + nw]
                upd = cand < best
                best[upd] = cand[upd]
                pos[upd] = r
            offs = np.unique(np.arange(nw, dtype=np.int64) + pos)
            pair = np.empty((offs.size, 2), np.int64)
            pair[:, 0] = uid
            pair[:, 1] = offs
            out.append(pair)
        start = e
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(out)


def import_kmidx(path: str):
    """KMIDXv01 -> finito MinimizerIndex (rebuilt hash-slot table). The
    file's locations are validated against the reference's lexicographic
    minimizer definition at the file's own m; the returned index is then
    built with finito's hashed selection and clamped m <= 16 (query
    answers are independent of the selection rule and of m)."""
    from finito_tpu_torch.index.minimizer import MinimizerIndex

    k, m, loc, db = read_kmidx(path)
    concat = np.asarray(db.concat, np.uint8)
    ends = np.asarray(db.ends, np.int64)
    theirs = loc.astype(np.int64)
    theirs = theirs[np.lexsort((theirs[:, 1], theirs[:, 0]))]
    ref_set = _lex_minimizer_occurrences(concat, ends, k, m)
    if ref_set.shape != theirs.shape or not np.array_equal(ref_set, theirs):
        raise IOError(
            f"the file's locations disagree with the reference minimizer "
            f"definition recomputed from its own unitigs "
            f"({theirs.shape[0]} stored vs {ref_set.shape[0]} recomputed "
            f"occurrences at k={k} m={m}) -- corrupt or incompatible file"
        )
    index = MinimizerIndex.build(concat, ends, k, min(m, 16))
    index.headers = db.headers
    return index


def write_kmidx(path: str, index, headers: List[bytes] | None = None) -> None:
    """Emit the KMIDXv01 framing from a finito MinimizerIndex (reader-
    compatible; the MPHF blob is a structurally-valid placeholder, NOT a
    working boomphf -- see the module docstring)."""
    from finito_tpu_torch.io.seqdb import decode_seq

    # locations follow the REFERENCE's definition (lexicographic
    # leftmost-lowest at this index's m), like a genuine cargo-built
    # file -- import_kmidx validates them by recomputation; finito's own
    # hashed occurrence set never appears on disk in this format.
    occ = _lex_minimizer_occurrences(
        np.asarray(index.concat, np.uint8),
        np.asarray(index.ends, np.int64),
        index.k,
        index.m,
    )
    n_occ = occ.shape[0]
    kmer_width = max(1, (2 * index.k + 63) // 64)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<QQQQ", kmer_width, index.k, index.m, n_occ))
        f.write(struct.pack("<Q", n_occ))
        f.write(occ.astype("<u4").tobytes())
        # bucket starts: leading 0 + cumulative (one bucket per occurrence
        # is framing-valid; the reader discards them)
        starts = np.arange(n_occ + 1, dtype="<u8")
        f.write(struct.pack("<Q", starts.size))
        f.write(starts.tobytes())
        # placeholder MPHF: one empty level pair
        f.write(struct.pack("<Q", 1))  # bitvecs
        f.write(struct.pack("<QQ", 0, 0))  # bits=0, words=[]
        f.write(struct.pack("<Q", 1))  # ranks
        f.write(struct.pack("<Q", 0))  # empty rank vec
        ends = np.asarray(index.ends, np.int64)
        start = 0
        hs = headers if headers is not None else (index.headers or [])
        for i, e in enumerate(ends):
            name = hs[i] if i < len(hs) else f"unitig-{i}".encode()
            seq = decode_seq(np.asarray(index.concat[start:int(e)], np.uint8))
            f.write(b">" + (name if isinstance(name, bytes) else name.encode()) + b"\n")
            f.write(seq + b"\n")
            start = int(e)

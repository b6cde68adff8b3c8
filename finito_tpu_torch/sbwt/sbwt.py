"""Plain-matrix SBWT: four bitvectors + rank + C array + interval ops.

Host-side (NumPy) structure mirroring the reference's
``plain_matrix_sbwt_t`` API surface (reconstructed in SURVEY.md section
2.3 from call sites in include/{common.hh,
FinimizerIndex.hh, lcs_basic_parallel_algorithm.hpp}):

  * get_k / number_of_subsets / number_of_kmers / get_C_array
  * update_sbwt_interval: one right-extension step,
      new.lo = C[c] + rank_c(lo),  new.hi = C[c] + rank_c(hi+1) - 1,
      {-1,-1} if empty            (ref: include/common.hh:26-36)
  * search(kmer) -> colex rank or -1
  * serialize / load

Instead of sdsl's rank_support_v5 pyramid, rank is a flat layout designed
for the device: 64-bit words + a cumulative popcount per word boundary
("rank superblock" of size 64). rank(i) = blocks[i>>6] + popcount(word &
((1<<(i&63))-1)). The JAX package uploads the same layout to its device
(finito_tpu/ops/bitvec.py, as uint32 word pairs); the port's device twin
is still to come.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Tuple, Union

import numpy as np

from finito_tpu_torch.io import sdsl
from finito_tpu_torch.utils.bits import pack_bits, unpack_bits, popcount_words

VARIANT = "plain-matrix"


@dataclass
class PlainMatrixSBWT:
    words: np.ndarray  # (4, n_words + 1) uint64, one zero pad word per row
    blocks: np.ndarray  # (4, n_words + 1) int64 cumulative popcount before word
    C: np.ndarray  # (4,) int64
    k: int
    n_nodes: int
    n_kmers: int

    # ---------- construction ----------

    @staticmethod
    def from_bit_rows(bit_rows: np.ndarray, k: int, n_kmers: int) -> "PlainMatrixSBWT":
        n_nodes = bit_rows.shape[1]
        return PlainMatrixSBWT.from_packed_rows(
            [pack_bits(bit_rows[c]) for c in range(4)], n_nodes, k, n_kmers
        )

    @staticmethod
    def from_packed_rows(
        packed_rows, n_nodes: int, k: int, n_kmers: int
    ) -> "PlainMatrixSBWT":
        """Construct from 4 already-packed uint64 word rows (tail bits
        past n_nodes must be zero) -- the load path feeds file words
        straight in, skipping the bytes-per-node unpack/re-pack round
        trip (which at genome scale costs more in first-touch page
        faults than the whole decode)."""
        rows = []
        blocks = []
        for c in range(4):
            w = np.concatenate([np.asarray(packed_rows[c], np.uint64), np.zeros(1, dtype=np.uint64)])
            pc = popcount_words(w).astype(np.int64)
            b = np.zeros(w.size, dtype=np.int64)
            np.cumsum(pc[:-1], out=b[1:])
            rows.append(w)
            blocks.append(b)
        counts = np.array([int(b[-1] + popcount_words(w[-1:])[0]) for w, b in zip(rows, blocks)])
        C = np.zeros(4, dtype=np.int64)
        C[0] = 1  # only the root $^k precedes the 'A' block
        for c in range(1, 4):
            C[c] = C[c - 1] + counts[c - 1]
        return PlainMatrixSBWT(
            words=np.stack(rows),
            blocks=np.stack(blocks),
            C=C,
            k=k,
            n_nodes=n_nodes,
            n_kmers=n_kmers,
        )

    # ---------- basic accessors (reference API names kept) ----------

    def get_k(self) -> int:
        return self.k

    def number_of_subsets(self) -> int:
        return self.n_nodes

    def number_of_kmers(self) -> int:
        return self.n_kmers

    def get_C_array(self) -> np.ndarray:
        return self.C

    def bit_rows(self) -> np.ndarray:
        """(4, n_nodes) uint8 0/1 matrix (for LCS construction and tests)."""
        return np.stack([unpack_bits(self.words[c], self.n_nodes) for c in range(4)])

    # ---------- rank / interval ops ----------

    def rank(self, c: int, i) -> np.ndarray:
        """rank_c(i) = # of set bits in positions [0, i); i in [0, n_nodes]."""
        i = np.asarray(i, dtype=np.int64)
        word = i >> 6
        bit = (i & 63).astype(np.uint64)
        mask = (np.uint64(1) << bit) - np.uint64(1)
        return self.blocks[c, word] + popcount_words(self.words[c, word] & mask).astype(np.int64)

    def update_interval(self, c: int, I: Tuple[int, int]) -> Tuple[int, int]:
        """Right-extend interval by char code c (0..3); scalar version."""
        lo, hi = I
        if lo == -1 or c < 0 or c > 3:
            return (-1, -1)
        new_lo = int(self.C[c] + self.rank(c, lo))
        new_hi = int(self.C[c] + self.rank(c, hi + 1) - 1)
        if new_lo > new_hi:
            return (-1, -1)
        return (new_lo, new_hi)

    def update_interval_batch(self, c: np.ndarray, lo: np.ndarray, hi: np.ndarray):
        """Vectorized right-extension. c, lo, hi arrays; empty stays (-1,-1).

        Invalid char code (>3) also maps to (-1,-1).
        """
        c = np.asarray(c, dtype=np.int64)
        valid = (lo != -1) & (c >= 0) & (c <= 3)
        cs = np.where(valid, c, 0)
        lo_s = np.where(valid, lo, 0)
        hi_s = np.where(valid, hi, 0)
        # gather per-char rank
        word_lo = lo_s >> 6
        word_hi = (hi_s + 1) >> 6
        bit_lo = (lo_s & 63).astype(np.uint64)
        bit_hi = ((hi_s + 1) & 63).astype(np.uint64)
        one = np.uint64(1)
        r_lo = self.blocks[cs, word_lo] + popcount_words(
            self.words[cs, word_lo] & ((one << bit_lo) - one)
        ).astype(np.int64)
        r_hi = self.blocks[cs, word_hi] + popcount_words(
            self.words[cs, word_hi] & ((one << bit_hi) - one)
        ).astype(np.int64)
        new_lo = self.C[cs] + r_lo
        new_hi = self.C[cs] + r_hi - 1
        ok = valid & (new_lo <= new_hi)
        return np.where(ok, new_lo, -1), np.where(ok, new_hi, -1)

    def search(self, kmer_codes: np.ndarray) -> int:
        """Colex rank of the full k-mer (codes 0..3), or -1 if absent."""
        lo, hi = 0, self.n_nodes - 1
        for c in np.asarray(kmer_codes):
            lo, hi = self.update_interval(int(c), (lo, hi))
            if lo == -1:
                return -1
        return int(lo)

    def search_batch(self, kmers: np.ndarray) -> np.ndarray:
        """Batched full-k-mer search: (n, k) codes -> (n,) colex ranks or -1."""
        n = kmers.shape[0]
        lo = np.zeros(n, dtype=np.int64)
        hi = np.full(n, self.n_nodes - 1, dtype=np.int64)
        for j in range(kmers.shape[1]):
            lo, hi = self.update_interval_batch(kmers[:, j].astype(np.int64), lo, hi)
        return np.where(lo == -1, -1, lo)

    # ---------- serialization ----------
    #
    # finito native .sbwt format (the reference's upstream binary format
    # depends on the absent SBWT submodule and cannot be verified here;
    # this is a documented replacement):
    #   magic "FINSBWT1", uint64 k, uint64 n_nodes, uint64 n_kmers,
    #   4x int64 C, then the 4 bitvectors as sdsl bit_vector streams.
    # The standalone `.sbwt` produced by our `sbwt-build` command is
    # prefixed with the variant string "plain-matrix" (sbwt::serialize_string
    # framing), mirroring the reference CLI's header check
    # (ref: include/build_fmin.hh:352-361). The `.sbwt`
    # written inside an index prefix has NO variant header, mirroring the
    # reference's asymmetry (ref: include/FinimizerIndex.hh:206,238).

    MAGIC = b"FINSBWT1"

    def serialize(self, out: Union[str, BinaryIO]) -> int:
        f, close = (open(out, "wb"), True) if isinstance(out, str) else (out, False)
        try:
            written = 0
            f.write(self.MAGIC)
            written += len(self.MAGIC)
            f.write(struct.pack("<QQQ", self.k, self.n_nodes, self.n_kmers))
            written += 24
            f.write(self.C.astype("<i8").tobytes())
            written += 32
            bits = self.bit_rows()
            for c in range(4):
                written += sdsl.write_bit_vector_stream(f, bits[c])
            return written
        finally:
            if close:
                f.close()

    @staticmethod
    def load(src: Union[str, BinaryIO]) -> "PlainMatrixSBWT":
        f, close = (open(src, "rb"), True) if isinstance(src, str) else (src, False)
        try:
            magic = f.read(8)
            if magic != PlainMatrixSBWT.MAGIC:
                raise IOError(f"bad .sbwt magic {magic!r} (expected finito FINSBWT1 format)")
            k, n_nodes, n_kmers = struct.unpack("<QQQ", f.read(24))
            _C = np.frombuffer(f.read(32), dtype="<i8")
            rows = [sdsl.read_bit_vector_words_stream(f)[0] for _ in range(4)]
            return PlainMatrixSBWT.from_packed_rows(
                rows, n_nodes=int(n_nodes), k=int(k), n_kmers=int(n_kmers)
            )
        finally:
            if close:
                f.close()

    def size_in_bytes(self) -> int:
        import io as _io

        buf = _io.BytesIO()
        return self.serialize(buf)

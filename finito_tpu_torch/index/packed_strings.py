"""2-bit packed unitig concatenation + the colex permutation.

Equivalent of the reference's PackedStrings / permute_unitigs
(ref: include/PackedStrings.hh:26-137): unitigs are
concatenated in colexicographic order of their *first k-mer*, stored as
2-bit codes (A=0 C=1 G=2 T=3) with exclusive end offsets, plus the Ustart
bitvector marking the colex rank of each unitig's first k-mer.

Host representation is a flat uint8 code array (device/serialized forms
pack to 2 bits); ends are serialized with width bit_width(total_length)
exactly like the reference (:44).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from finito_tpu_torch.io.seqdb import SeqDB
from finito_tpu_torch.utils.bits import bit_width_for_max


@dataclass
class PackedStrings:
    concat: np.ndarray  # uint8 2-bit codes
    ends: np.ndarray  # int64 exclusive ends

    def number_of_strings(self) -> int:
        return int(self.ends.size)

    def ends_width(self) -> int:
        """Serialization width of `ends`: 64 - clzll(total_length)."""
        return bit_width_for_max(int(self.concat.size))

    def get(self, i: int) -> np.ndarray:
        start = 0 if i == 0 else int(self.ends[i - 1])
        return self.concat[start : int(self.ends[i])]

    def global_offset_to_local_offset(self, global_offset: int) -> Tuple[int, int]:
        """(unitig_id, offset_in_unitig); binary search on exclusive ends
        (ref: PackedStrings.hh:91-100)."""
        idx = int(np.searchsorted(self.ends, global_offset, side="right"))
        start = 0 if idx == 0 else int(self.ends[idx - 1])
        return idx, global_offset - start

    def global_to_local_batch(self, global_offsets: np.ndarray):
        idx = np.searchsorted(self.ends, global_offsets, side="right")
        starts = np.where(idx == 0, 0, self.ends[np.maximum(idx - 1, 0)])
        return idx.astype(np.int64), (global_offsets - starts).astype(np.int64)


def permute_unitigs(sbwt, unitigs: SeqDB) -> Tuple[PackedStrings, np.ndarray, np.ndarray]:
    """Sort unitigs by colex order of their first k-mer; build Ustart.

    Returns (PackedStrings, Ustart bit row (uint8, len n_nodes), permutation).
    Ties between identical first k-mers cannot occur in a valid t=1 DSPSS
    (a repeated first k-mer would have frequency > 1); the stable argsort
    here is deterministic regardless (the reference's std::sort is not,
    see SURVEY.md Appendix A).
    (ref: include/PackedStrings.hh:104-137)
    """
    k = sbwt.get_k()
    n = len(unitigs)
    first_kmers = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        codes = unitigs.get_codes(i)
        if codes.size < k:
            raise ValueError(f"unitig {i} shorter than k={k}")
        first_kmers[i] = codes[:k]
    # colex: primary key = last column
    perm = np.lexsort(tuple(first_kmers[:, j] for j in range(k)))

    lens = unitigs.lengths()
    total = int(lens.sum())
    concat = np.empty(total, dtype=np.uint8)
    ends = np.empty(n, dtype=np.int64)
    pos = 0
    for out_i, i in enumerate(perm):
        c = unitigs.get_codes(int(i))
        if np.any(c > 3):
            raise ValueError("Invalid character in unitig (only ACGT allowed)")
        concat[pos : pos + c.size] = c
        pos += c.size
        ends[out_i] = pos

    ranks = sbwt.search_batch(first_kmers)
    if np.any(ranks == -1):
        bad = int(np.flatnonzero(ranks == -1)[0])
        raise ValueError(f"first k-mer of unitig {bad} not found in SBWT")
    ustart = np.zeros(sbwt.number_of_subsets(), dtype=np.uint8)
    ustart[ranks] = 1
    return PackedStrings(concat=concat, ends=ends), ustart, perm

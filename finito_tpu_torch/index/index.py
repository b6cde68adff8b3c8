"""FinimizerIndex: the product data structure + query + serialization.

Equivalent of the reference's FinimizerIndex
(ref: include/FinimizerIndex.hh:26-259). Holds the 7
components (SBWT, LCS, packed unitigs + ends, fmin marks, packed global
offsets, Ustart) and answers per-k-mer (unitig id, offset) localization
queries; serialized as 7 sdsl-codec files + one .sbwt under a prefix,
with the same file names as the reference (FinimizerIndex.hh:187-241).

`search` here is the exact oracle path (streaming search + branch /
finimizer dictionary lookups + the unitig-walk fast path). The batched
device engine in finito_tpu_torch.query produces identical output and are tested
against this.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from finito_tpu_torch.index.packed_strings import PackedStrings
from finito_tpu_torch.io import sdsl
from finito_tpu_torch.io.seqdb import encode_seq
from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT
from finito_tpu_torch.utils.bits import bit_width_for_max


@dataclass
class QueryResult:
    local_offsets: List[Tuple[int, int]] = field(default_factory=list)
    n_found: int = 0


class FinimizerIndex:
    sbwt: PlainMatrixSBWT
    LCS: np.ndarray  # integer values < k (int64 from the builder; loaded
    # as int32 -- consumers upcast in numpy arithmetic)
    lcs_width: int
    unitigs: PackedStrings
    fmin: np.ndarray  # uint8 0/1, length n_nodes
    global_offsets: np.ndarray  # uint64, one per set fmin bit, colex order
    offsets_width: int
    Ustart: np.ndarray  # uint8 0/1, length n_nodes
    # set by parallel.shard_build.sharded_index_build: per-shard dense
    # position slices ([(Mn,) int32 g_end per mesh shard], Mn) consumed
    # by parallel.mesh.ShardedIndex.build; None for host-built/loaded
    # indexes (not serialized -- a derived structure)
    mesh_pos = None

    def __init__(self):
        self._fmin_rank = None
        self._ustart_rank = None

    # ---------- rank supports (rebuilt, never serialized) ----------

    def rebuild_rank_supports(self) -> None:
        self._fmin_rank = np.zeros(self.fmin.size + 1, dtype=np.int64)
        np.cumsum(self.fmin, out=self._fmin_rank[1:])
        self._ustart_rank = np.zeros(self.Ustart.size + 1, dtype=np.int64)
        np.cumsum(self.Ustart, out=self._ustart_rank[1:])

    def fmin_rank(self, i) -> int:
        return self._fmin_rank[i]

    def ustart_rank(self, i) -> int:
        return self._ustart_rank[i]

    # ---------- dictionaries (ref: common.hh:61-72) ----------

    def lookup_from_branch_dictionary(self, kmer_colex: int) -> int:
        """Global (inclusive) end of the first k-mer of the unitig whose
        first k-mer has the given colex rank."""
        unitig_rank = int(self._ustart_rank[kmer_colex])
        global_unitig_start = 0 if unitig_rank == 0 else int(self.unitigs.ends[unitig_rank - 1])
        return global_unitig_start + self.sbwt.get_k() - 1

    def lookup_from_finimizer_dictionary(self, finimizer_colex: int) -> int:
        return int(self.global_offsets[int(self._fmin_rank[finimizer_colex])])

    # ---------- query (ref: FinimizerIndex.hh:119-185) ----------

    def _add_to_query_result(self, global_kmer_end: int, answer: QueryResult) -> None:
        global_kmer_start = global_kmer_end - self.sbwt.get_k() + 1
        answer.local_offsets.append(self.unitigs.global_offset_to_local_offset(global_kmer_start))
        answer.n_found += 1

    def _walk_in_unitigs(self, codes: np.ndarray, global_kmer_end: int, answer: QueryResult, kmer_end: int) -> int:
        """Extend a hit along the unitig by direct text comparison; emits one
        hit per matching base (ref: FinimizerIndex.hh:47-102). Returns the
        advanced kmer_end."""
        unitig_id = answer.local_offsets[-1][0]
        u_end = int(self.unitigs.ends[unitig_id])  # exclusive end
        max_match = min(u_end - global_kmer_end - 1, int(codes.size) - kmer_end - 1)
        if global_kmer_end > u_end or max_match <= 0:
            return kmer_end
        q = codes[kmer_end + 1 : kmer_end + 1 + max_match]
        u = self.unitigs.concat[global_kmer_end + 1 : global_kmer_end + 1 + max_match]
        neq = np.flatnonzero(q != u)
        n_match = int(neq[0]) if neq.size else max_match
        for i in range(1, n_match + 1):
            self._add_to_query_result(global_kmer_end + i, answer)
        return kmer_end + n_match

    def search(self, query) -> QueryResult:
        """Per-k-mer (unitig, offset) for every window of the query;
        (-1, -1) for absent k-mers. Non-ACGT queries return an empty
        result (the reference's behavior there is undefined; see
        SURVEY.md Appendix A item 8)."""
        from finito_tpu_torch.query.oracle import rarest_fmin_streaming_search

        if isinstance(query, str):
            query = query.encode()
        codes = encode_seq(query) if isinstance(query, bytes) else np.asarray(query, dtype=np.uint8)
        k = self.sbwt.get_k()
        query_len = int(codes.size)

        answer = QueryResult()
        res = rarest_fmin_streaming_search(self.sbwt, self.LCS, codes, self.Ustart)
        if res is None:
            return answer
        kmer_colex_ranks, finimizers_ends_colex, rightmost_Ustart = res

        kmer_end = k - 1
        while kmer_end < query_len:
            if kmer_colex_ranks[kmer_end] is not None:
                finimizer_end, finimizer_colex = finimizers_ends_colex[kmer_end]
                rb = rightmost_Ustart[kmer_end]
                if rb is not None:
                    p, colex = rb
                    global_kmer_end = self.lookup_from_branch_dictionary(colex) + (kmer_end - p)
                else:
                    global_kmer_end = self.lookup_from_finimizer_dictionary(finimizer_colex) + (
                        kmer_end - finimizer_end
                    )
                self._add_to_query_result(global_kmer_end, answer)
                if kmer_end + 1 < query_len:
                    kmer_end = self._walk_in_unitigs(codes, global_kmer_end, answer, kmer_end)
            else:
                answer.local_offsets.append((-1, -1))
            kmer_end += 1
        return answer

    # ---------- serialization (ref: FinimizerIndex.hh:187-241) ----------

    def serialize(self, index_prefix: str, sbwt_format: str = "finito") -> None:
        """Write the 7 sdsl files + .sbwt member under the prefix.

        sbwt_format selects the ``.sbwt`` member layout: "finito"
        (FINSBWT1, the native container) or "algbio" (the reference's
        in-prefix layout: a HEADERLESS algbio/SBWT plain-matrix payload,
        no variant string -- FinimizerIndex.hh:206,238-239 -- so a
        prefix written this way matches what the C++ binary writes and
        reads)."""
        sdsl.save_int_vector(index_prefix + ".O.sdsl", self.global_offsets, self.offsets_width)
        sdsl.save_bit_vector(index_prefix + ".FBV.sdsl", self.fmin)
        sdsl.save_int_vector(
            index_prefix + ".packed_unitigs.sdsl", self.unitigs.concat, 2, template_width=2
        )
        sdsl.save_int_vector(
            index_prefix + ".unitig_endpoints.sdsl", self.unitigs.ends, self.unitigs.ends_width()
        )
        sdsl.save_bit_vector(index_prefix + ".Ustart.sdsl", self.Ustart)
        sdsl.save_int_vector(index_prefix + ".LCS.sdsl", self.LCS, self.lcs_width)
        if sbwt_format == "finito":
            # Index-internal .sbwt is headerless (reference quirk: no variant
            # string, unlike standalone sbwt-build output; FinimizerIndex.hh:206).
            self.sbwt.serialize(index_prefix + ".sbwt")
        elif sbwt_format == "algbio":
            from finito_tpu_torch.io.algbio_sbwt import write_algbio_sbwt

            write_algbio_sbwt(
                index_prefix + ".sbwt", self.sbwt, LCS=self.LCS,
                variant_header=False,
            )
        else:
            raise ValueError(f"unknown sbwt_format {sbwt_format!r}")

    @staticmethod
    def load_sbwt_member(path: str) -> PlainMatrixSBWT:
        """Load the ``.sbwt`` member of an index prefix in ANY of the
        layouts found in the wild: finito's FINSBWT1, or the
        reference-written headerless algbio container (what the C++
        binary puts inside a prefix, FinimizerIndex.hh:206), or a
        variant-headed algbio file (defensive: a standalone `sbwt
        build` output copied into the prefix)."""
        import struct

        from finito_tpu_torch.io.algbio_sbwt import read_algbio_sbwt, sniff_format

        fmt = sniff_format(path)
        if fmt == "finito":
            with open(path, "rb") as f:
                head = f.read(8)
                if head == PlainMatrixSBWT.MAGIC:
                    f.seek(0)
                else:  # variant-string prefix ("plain-matrix") then payload
                    (n,) = struct.unpack("<Q", head)
                    f.seek(8 + n)
                return PlainMatrixSBWT.load(f)
        sbwt, _sgs = read_algbio_sbwt(path, variant_header=(fmt == "algbio"))
        return sbwt

    @staticmethod
    def load(index_prefix: str) -> "FinimizerIndex":
        index = FinimizerIndex()
        # Narrow load dtypes: on the microVM hosts first-touch page
        # faults dominate load time, so every resident vector decodes
        # straight into the narrowest dtype that holds its width (LCS
        # values < k <= 255; all consumers upcast in numpy arithmetic).
        lcs = sdsl.load_int_vector(index_prefix + ".LCS.sdsl", dtype=np.int32)
        index.LCS = lcs.values
        index.lcs_width = lcs.width
        index.fmin = sdsl.load_bit_vector(index_prefix + ".FBV.sdsl")
        offs = sdsl.load_int_vector(index_prefix + ".O.sdsl")
        if offs.width <= 32:  # width known only after decode; re-narrow
            offs.values = offs.values.astype(np.uint32)
        index.global_offsets = offs.values
        index.offsets_width = offs.width
        concat = sdsl.load_int_vector(
            index_prefix + ".packed_unitigs.sdsl", template_width=2, dtype=np.uint8
        )
        ends = sdsl.load_int_vector(index_prefix + ".unitig_endpoints.sdsl", dtype=np.int64)
        index.unitigs = PackedStrings(concat=concat.values, ends=ends.values)
        index.Ustart = sdsl.load_bit_vector(index_prefix + ".Ustart.sdsl")
        index.sbwt = FinimizerIndex.load_sbwt_member(index_prefix + ".sbwt")
        index.rebuild_rank_supports()
        return index

    def size_in_bytes(self) -> int:
        """Total size including rank supports (which are not serialized),
        mirroring the accounting of FinimizerIndex::size_in_bytes
        (ref: FinimizerIndex.hh:244-258). Our rank-support layout differs
        from sdsl rank_support_v5, so the rank terms reflect *our*
        structures."""
        n = self.fmin.size
        total = 0
        total += sdsl.int_vector_size_in_bytes(self.LCS.size, self.lcs_width)
        total += sdsl.int_vector_size_in_bytes(n, 1, template_width=1)  # fmin
        total += self._fmin_rank.nbytes
        total += sdsl.int_vector_size_in_bytes(self.global_offsets.size, self.offsets_width)
        total += sdsl.int_vector_size_in_bytes(self.unitigs.concat.size, 2, template_width=2)
        total += sdsl.int_vector_size_in_bytes(self.unitigs.ends.size, self.unitigs.ends_width())
        total += sdsl.int_vector_size_in_bytes(n, 1, template_width=1)  # Ustart
        total += self._ustart_rank.nbytes
        total += self.sbwt.size_in_bytes()
        return total

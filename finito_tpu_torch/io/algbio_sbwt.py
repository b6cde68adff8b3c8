"""Reader/writer for the algbio/SBWT ``plain_matrix_sbwt_t`` container.

The reference consumes/produces `.sbwt` files of the external SBWT
library (ref: include/build_fmin.hh:352-364 reads the
"plain-matrix" variant string then `plain_matrix_sbwt_t::load`;
include/FinimizerIndex.hh:206,238-239 serialize/load the
same container WITHOUT the variant header). The SBWT submodule is not
vendored in the reference checkout (SURVEY.md section 2.2), so this
module reconstructs the layout from the upstream algbio/SBWT +
sdsl-lite sources:

  [variant string]           uint64 length + chars ("plain-matrix";
                             standalone files only)
  SubsetMatrixRank           A/C/G/T sdsl bit_vectors, then the four
                             sdsl rank_support_v5 blobs (each an
                             int_vector<64> "basic block" array)
  suffix_group_starts        sdsl bit_vector (1 iff the node starts a
                             (k-1)-suffix group; equals LCS[i] < k-1)
  C                          std::vector<int64_t> (byte count + data)
  kmer_prefix_precalc        std::vector<pair<int64_t,int64_t>>:
                             colex interval per length-precalc_k string,
                             addressed by 2-bit codes packed LSB-first
                             (first char in the lowest bits), (-1,-1)
                             when absent
  precalc_k, n_nodes, n_kmers, k   int64 each

rank_support_v5 layout (sdsl-lite): one pair of words per 2048-bit
superblock -- word0 = absolute rank before the superblock, word1 = the
five cumulative in-superblock popcounts at 384-bit (6-word) sub-block
boundaries, 11 bits each, LSB-first.

VERIFICATION STATUS (be honest with downstream users): the reader and
writer round-trip each other byte-exactly, the rank_support_v5 blocks
are validated against an independent naive rank implementation via the
upstream QUERY algorithm, and every sdsl component follows the byte-
exact codec of finito_tpu_torch.io.sdsl. What cannot be validated in this
environment is a byte diff against a real C++-written file: the SBWT
submodule is absent and the machine has no network egress, so no
ground-truth binary exists here. Member ORDER inside the container is
reconstructed from upstream sources and is the one assumption a real
interop test could still falsify. DEVIATIONS.md item 9 tracks this.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

from finito_tpu_torch.io import sdsl
from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT, VARIANT
from finito_tpu_torch.utils.bits import pack_bits, popcount_words

DEFAULT_PRECALC_K = 3  # upstream SBWT default prefix-lookup depth


# ------------------------------------------------------------ rank v5


def rank_v5_basic_blocks(words: np.ndarray, n_bits: int) -> np.ndarray:
    """The rank_support_v5 basic-block array for a packed bit_vector.

    words: uint64 data words (ceil(n_bits/64)); returns int_vector<64>
    payload of ((capacity >> 11) + 1) * 2 words, capacity = words * 64.
    """
    words = np.asarray(words, dtype=np.uint64)
    capacity = words.size * 64
    n_super = (capacity >> 11) + 1
    out = np.zeros(2 * n_super, dtype=np.uint64)
    pc = popcount_words(words).astype(np.uint64)
    # cumulative popcount BEFORE each word, padded to superblock grid
    n_pad = n_super * 32
    pcp = np.zeros(n_pad, dtype=np.uint64)
    pcp[: pc.size] = pc
    cum = np.zeros(n_pad + 1, dtype=np.uint64)
    np.cumsum(pcp, out=cum[1:])
    out[0::2] = cum[0 : n_pad : 32]  # absolute rank before superblock
    base = cum[0 : n_pad : 32]
    second = np.zeros(n_super, dtype=np.uint64)
    for t in range(5):  # sub-block boundaries at words 6,12,18,24,30
        boundary = cum[6 * (t + 1) : n_pad + 1 : 32]
        rel = (boundary[:n_super] - base) & np.uint64(0x7FF)
        second |= rel << np.uint64(11 * t)
    out[1::2] = second
    return out


def rank_v5_query(words: np.ndarray, blocks: np.ndarray, i: int) -> int:
    """rank(i) via the upstream v5 query algorithm (used by tests to
    validate the block layout against a naive popcount rank)."""
    words = np.asarray(words, dtype=np.uint64)
    j = i >> 11
    word = (i >> 6) & 31
    t = word // 6
    r = int(blocks[2 * j])
    if t:
        r += int((int(blocks[2 * j + 1]) >> (11 * (t - 1))) & 0x7FF)
    first_word = 32 * j + 6 * t
    for w in range(first_word, i >> 6):
        if w < words.size:
            r += int(popcount_words(words[w : w + 1])[0])
    if (i & 63) and (i >> 6) < words.size:
        mask = np.uint64((1 << (i & 63)) - 1)
        r += int(popcount_words(np.asarray([words[i >> 6] & mask]))[0])
    return r


# ----------------------------------------------------- vector framing


def _write_std_vector(f: BinaryIO, data: bytes) -> int:
    """sbwt::serialize_std_vector: uint64 BYTE count + raw data."""
    f.write(struct.pack("<q", len(data)))
    f.write(data)
    return 8 + len(data)


def _read_std_vector(f: BinaryIO) -> bytes:
    (n,) = struct.unpack("<q", f.read(8))
    if n < 0 or n > (1 << 48):
        raise IOError(f"implausible std::vector byte count {n}")
    data = f.read(n)
    if len(data) != n:
        raise IOError("truncated std::vector payload")
    return data


def _write_int_vector64(f: BinaryIO, values: np.ndarray) -> int:
    """sdsl int_vector<64>: 8-byte bit-size header + raw words."""
    values = np.asarray(values, dtype="<u8")
    f.write(struct.pack("<Q", values.size * 64))
    f.write(values.tobytes())
    return 8 + values.size * 8


def _read_int_vector64(f: BinaryIO) -> np.ndarray:
    (m_size,) = struct.unpack("<Q", f.read(8))
    if m_size % 64:
        raise IOError("int_vector<64> bit size not word aligned")
    raw = f.read(m_size // 8)
    if len(raw) != m_size // 8:
        raise IOError("truncated int_vector<64>")
    return np.frombuffer(raw, dtype="<u8").copy()


# ------------------------------------------------------------- precalc


def build_precalc(sbwt: PlainMatrixSBWT, precalc_k: int) -> np.ndarray:
    """(4^precalc_k, 2) int64 colex interval per prefix string; (-1,-1)
    for absent prefixes. Address = 2-bit codes packed LSB-first (the
    first character in the lowest bits)."""
    p = precalc_k
    n = 4**p
    ids = np.arange(n, dtype=np.int64)
    lo = np.zeros(n, dtype=np.int64)
    hi = np.full(n, sbwt.number_of_subsets() - 1, dtype=np.int64)
    for pos in range(p):
        c = (ids >> (2 * pos)) & 3
        lo, hi = sbwt.update_interval_batch(c, lo, hi)
    out = np.stack([lo, hi], axis=1)
    out[lo < 0] = -1
    return out


# ------------------------------------------------------------ container


def suffix_group_starts_from_lcs(LCS: np.ndarray, k: int) -> np.ndarray:
    """1 iff the node begins a (k-1)-suffix group: LCS[i] < k-1."""
    return (np.asarray(LCS, dtype=np.int64) < k - 1).astype(np.uint8)


def write_algbio_sbwt(
    out: Union[str, BinaryIO],
    sbwt: PlainMatrixSBWT,
    LCS: np.ndarray | None = None,
    variant_header: bool = True,
    precalc_k: int = DEFAULT_PRECALC_K,
) -> int:
    """Serialize in the algbio/SBWT plain-matrix layout (see module
    docstring for verification status). LCS (for suffix_group_starts)
    is computed on the fly when not supplied."""
    if LCS is None:
        from finito_tpu_torch.sbwt.lcs import lcs_array

        LCS = lcs_array(sbwt)
    f, close = (open(out, "wb"), True) if isinstance(out, str) else (out, False)
    try:
        written = 0
        if variant_header:
            written += sdsl.serialize_string(f, VARIANT)
        bit_rows = sbwt.bit_rows()
        packed = [pack_bits(bit_rows[c]) for c in range(4)]
        n_bits = sbwt.number_of_subsets()
        for c in range(4):
            written += sdsl.write_bit_vector_stream(f, bit_rows[c])
        for c in range(4):
            written += _write_int_vector64(f, rank_v5_basic_blocks(packed[c], n_bits))
        written += sdsl.write_bit_vector_stream(
            f, suffix_group_starts_from_lcs(LCS, sbwt.get_k())
        )
        written += _write_std_vector(f, sbwt.get_C_array().astype("<i8").tobytes())
        written += _write_std_vector(
            f, build_precalc(sbwt, precalc_k).astype("<i8").tobytes()
        )
        f.write(struct.pack("<qqqq", precalc_k, sbwt.number_of_subsets(),
                            sbwt.number_of_kmers(), sbwt.get_k()))
        written += 32
        return written
    finally:
        if close:
            f.close()


def read_algbio_sbwt(
    src: Union[str, BinaryIO], variant_header: bool = True
) -> Tuple[PlainMatrixSBWT, np.ndarray]:
    """Parse an algbio/SBWT plain-matrix container -> (sbwt,
    suffix_group_starts). The rank_support_v5 blobs are length-checked
    and skipped (rank is rebuilt in our flat layout); every recoverable
    invariant (equal bitvector lengths, C-array consistency, trailer
    sanity) is validated so a mis-framed file fails loudly instead of
    mis-parsing."""
    f, close = (open(src, "rb"), True) if isinstance(src, str) else (src, False)
    try:
        if variant_header:
            variant = sdsl.load_string(f)
            if variant != VARIANT:
                raise IOError(
                    f"wrong SBWT variant: expected '{VARIANT}', got '{variant}'"
                )
        rows = [sdsl.read_bit_vector_stream(f) for _ in range(4)]
        n = rows[0].size
        if any(r.size != n for r in rows):
            raise IOError("A/C/G/T bitvector lengths differ")
        capacity = ((n + 63) // 64) * 64
        expect_blocks = ((capacity >> 11) + 1) * 2
        for c in range(4):
            blocks = _read_int_vector64(f)
            if blocks.size != expect_blocks:
                raise IOError(
                    f"rank_support_v5 block count {blocks.size} != expected "
                    f"{expect_blocks} (layout mismatch?)"
                )
        sgs = sdsl.read_bit_vector_stream(f)
        if sgs.size != n:
            raise IOError("suffix_group_starts length mismatch")
        C = np.frombuffer(_read_std_vector(f), dtype="<i8")
        if C.size != 4:
            raise IOError(f"C array has {C.size} entries, expected 4")
        precalc_raw = np.frombuffer(_read_std_vector(f), dtype="<i8")
        precalc_k, n_nodes, n_kmers, k = struct.unpack("<qqqq", f.read(32))
        if n_nodes != n:
            raise IOError(f"n_nodes trailer {n_nodes} != bitvector length {n}")
        if precalc_raw.size != 2 * 4**precalc_k:
            raise IOError("precalc size inconsistent with precalc_k")
        if not (1 < k <= 255) or not (0 <= n_kmers <= n_nodes):
            raise IOError("implausible k / n_kmers trailer")
        sbwt = PlainMatrixSBWT.from_bit_rows(
            np.stack(rows), k=int(k), n_kmers=int(n_kmers)
        )
        if not np.array_equal(sbwt.get_C_array(), C):
            raise IOError("stored C array disagrees with the bit matrix")
        return sbwt, sgs
    finally:
        if close:
            f.close()


def sniff_format(path: str) -> str:
    """'finito' (FINSBWT1 payload, with or without the variant-string
    prefix), 'algbio' (variant header + algbio payload), or
    'algbio-headerless' (neither marker: assume a bare algbio payload,
    as written inside an index prefix)."""
    with open(path, "rb") as f:
        head = f.read(32)
    if head[:8] == PlainMatrixSBWT.MAGIC:
        return "finito"
    if len(head) >= 8:
        (n,) = struct.unpack("<Q", head[:8])
        if n == len(VARIANT) and head[8 : 8 + n] == VARIANT.encode():
            if head[8 + n : 16 + n] == PlainMatrixSBWT.MAGIC:
                return "finito"
            return "algbio"
    return "algbio-headerless"

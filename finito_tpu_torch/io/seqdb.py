"""SeqDB: concatenated in-memory sequence store with offset arrays.

The ragged-buffer layout used device-side: one flat uint8 code array plus
exclusive end offsets -- structurally the same design as jseqio's SeqDB
(ref: ref_implementation/jseqio/src/seq_db.rs:3-13) and
the reference's PackedStrings, and the natural feed format for batched
TPU kernels (pad/bucket views are derived from it).

Codes: A=0 C=1 G=2 T=3, 255 = non-ACGT. Case-insensitive encode
(matching the reference's ``c & ~32`` uppercase trick).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Sequence, Tuple

import numpy as np

# Lookup: byte -> 2-bit code, 255 for non-ACGT. Upper and lower case.
ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ENCODE_LUT[_c] = _i
    ENCODE_LUT[_c | 32] = _i

DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_seq(seq: bytes) -> np.ndarray:
    return ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> bytes:
    return DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes()


@dataclass
class SeqDB:
    concat: np.ndarray  # uint8 codes, all sequences back to back
    ends: np.ndarray  # int64 exclusive ends, one per sequence
    headers: List[bytes] = field(default_factory=list)

    @staticmethod
    def from_sequences(seqs: Sequence[bytes], headers: Sequence[bytes] = ()) -> "SeqDB":
        if seqs:
            codes = [encode_seq(s if isinstance(s, bytes) else s.encode()) for s in seqs]
            concat = np.concatenate(codes) if codes else np.zeros(0, np.uint8)
            lens = np.array([c.size for c in codes], dtype=np.int64)
            ends = np.cumsum(lens)
        else:
            concat = np.zeros(0, np.uint8)
            ends = np.zeros(0, np.int64)
        return SeqDB(concat=concat, ends=ends, headers=list(headers))

    @staticmethod
    def from_file(path: str) -> "SeqDB":
        """Parse a FASTA/FASTQ (+gzip) file straight into the code buffer.

        Uses the native C++ parser+encoder when available (single pass,
        ~20x the Python reader); transparently falls back to the Python
        SequenceReader."""
        import gzip as _gzip

        from finito_tpu_torch.io.fastx import _is_gzipped
        from finito_tpu_torch.native import get_lib, parse_fastx_bytes

        if get_lib() is not None:
            opener = _gzip.open if _is_gzipped(path) else open
            with opener(path, "rb") as f:
                data = f.read()
            parsed = parse_fastx_bytes(data)
            if parsed is not None:
                codes, ends, headers = parsed
                return SeqDB(concat=codes, ends=ends, headers=headers)

        from finito_tpu_torch.io.fastx import SequenceReader

        headers = []
        seqs: List[bytes] = []
        with SequenceReader(path) as r:
            for h, s in r:
                headers.append(h)
                seqs.append(s)
        db = SeqDB.from_sequences(seqs)
        db.headers = headers
        return db

    def __len__(self) -> int:
        return int(self.ends.size)

    def start(self, i: int) -> int:
        return 0 if i == 0 else int(self.ends[i - 1])

    def get_codes(self, i: int) -> np.ndarray:
        return self.concat[self.start(i) : int(self.ends[i])]

    def get_bytes(self, i: int) -> bytes:
        return decode_seq(self.get_codes(i))

    def lengths(self) -> np.ndarray:
        starts = np.concatenate([[0], self.ends[:-1]]) if len(self) else np.zeros(0, np.int64)
        return self.ends - starts

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self.get_codes(i)

    def padded_batch(self, pad_to_multiple: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        """(n_seqs, L_pad) uint8 code matrix (255-padded) + int32 lengths.

        The dense feed format for the batched TPU engines; L_pad rounded up
        to a lane-friendly multiple.
        """
        n = len(self)
        lens = self.lengths()
        L = int(lens.max()) if n else 0
        L_pad = max(pad_to_multiple, -(-L // pad_to_multiple) * pad_to_multiple)
        out = np.full((n, L_pad), 255, dtype=np.uint8)
        for i in range(n):
            c = self.get_codes(i)
            out[i, : c.size] = c
        return out, lens.astype(np.int32)

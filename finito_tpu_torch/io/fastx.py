"""FASTA/FASTQ (+ gzip) streaming IO.

Semantics follow the reference's two IO stacks:
  * SBWT SeqIO::Reader -- streaming reads, gzip autodetect
    (ref: include/search_fmin.hh:104-109)
  * jseqio -- format autodetect from the first byte ('>' FASTA, '@' FASTQ),
    multi-line FASTA supported, multi-line FASTQ NOT supported
    (ref: ref_implementation/jseqio/src/reader.rs:170-188,
     README.md:46-47)

A pure-Python implementation is provided here; a C++ fast path with the
same interface lives in finito_tpu_torch/native (used automatically when built).
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

_COMP = bytes.maketrans(
    b"ACGTacgtNnRYKMrykm", b"TGCAtgcaNnYRMKyrmk"
)


def reverse_complement(seq) -> bytes:
    """Reverse complement; equivalent of sbwt::get_rc
    (ref: include/search_fmin.hh:50)."""
    if isinstance(seq, str):
        return seq.translate(str.maketrans("ACGTacgt", "TGCAtgca"))[::-1]
    return seq.translate(_COMP)[::-1]


@dataclass
class FileFormat:
    gzipped: bool
    fasta: bool  # else fastq
    extension: str


def _is_gzipped(path: str) -> bool:
    if path.endswith(".gz"):
        return True
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
        return magic == b"\x1f\x8b"
    except OSError:
        return False


def figure_out_file_format(path: str) -> FileFormat:
    """Autodetect gzip (extension or magic) and FASTA/FASTQ (first byte)."""
    gzipped = _is_gzipped(path)
    opener = gzip.open if gzipped else open
    with opener(path, "rb") as f:
        first = f.read(1)
    if first == b">":
        fasta = True
    elif first == b"@":
        fasta = False
    else:
        raise ValueError(f"{path}: cannot detect FASTA/FASTQ (first byte {first!r})")
    ext = os.path.splitext(path[:-3] if path.endswith(".gz") else path)[1]
    return FileFormat(gzipped=gzipped, fasta=fasta, extension=ext)


class SequenceReader:
    """Streaming FASTA/FASTQ reader.

    Mirrors SeqIO::Reader::get_next_read_to_buffer(): yields raw sequence
    bytes (no case normalization -- downstream code uppercases per char
    like the reference's ``c & ~32``).
    """

    def __init__(self, path: str):
        self.path = path
        fmt = figure_out_file_format(path)
        self.format = fmt
        opener = gzip.open if fmt.gzipped else open
        self._f = io.BufferedReader(opener(path, "rb"), buffer_size=1 << 20)
        self._fasta = fmt.fasta
        self._pending_header: Optional[bytes] = None
        if self._fasta:
            line = self._f.readline()
            if line and not line.startswith(b">"):
                raise ValueError(f"{path}: FASTA must start with '>'")
            self._pending_header = line.rstrip(b"\r\n")[1:] if line else None

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        return self

    def __next__(self) -> Tuple[bytes, bytes]:
        rec = self.read_record()
        if rec is None:
            raise StopIteration
        return rec

    def read_record(self) -> Optional[Tuple[bytes, bytes]]:
        """Returns (header, seq) or None at EOF."""
        if self._fasta:
            if self._pending_header is None:
                return None
            header = self._pending_header
            chunks: List[bytes] = []
            while True:
                line = self._f.readline()
                if not line:
                    self._pending_header = None
                    break
                if line.startswith(b">"):
                    self._pending_header = line.rstrip(b"\r\n")[1:]
                    break
                chunks.append(line.rstrip(b"\r\n"))
            return header, b"".join(chunks)
        else:
            hline = self._f.readline()
            if not hline:
                return None
            if not hline.startswith(b"@"):
                raise ValueError(f"{self.path}: malformed FASTQ header line {hline!r}")
            seq = self._f.readline().rstrip(b"\r\n")
            plus = self._f.readline()
            if not plus.startswith(b"+"):
                raise ValueError(f"{self.path}: malformed FASTQ '+' line (multi-line FASTQ is not supported)")
            qual = self._f.readline().rstrip(b"\r\n")
            if len(qual) != len(seq):
                raise ValueError(f"{self.path}: FASTQ quality length != sequence length")
            return hline.rstrip(b"\r\n")[1:], seq

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SequenceWriter:
    """FASTA/FASTQ writer; gzip chosen by '.gz' extension (jseqio writer.rs:49)."""

    def __init__(self, path: str, fasta: Optional[bool] = None):
        gz = path.endswith(".gz")
        base = path[:-3] if gz else path
        if fasta is None:
            ext = os.path.splitext(base)[1].lower()
            fasta = ext not in (".fq", ".fastq")
        self.fasta = fasta
        opener = gzip.open if gz else open
        self._f = opener(path, "wb")

    def write_record(self, header: bytes, seq: bytes, qual: Optional[bytes] = None) -> None:
        if isinstance(header, str):
            header = header.encode()
        if isinstance(seq, str):
            seq = seq.encode()
        if self.fasta:
            self._f.write(b">" + header + b"\n" + seq + b"\n")
        else:
            if qual is None:
                qual = b"I" * len(seq)
            self._f.write(b"@" + header + b"\n" + seq + b"\n+\n" + qual + b"\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_all_records(path: str) -> List[Tuple[bytes, bytes]]:
    with SequenceReader(path) as r:
        return list(r)

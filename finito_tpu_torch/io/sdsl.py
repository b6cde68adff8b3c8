"""Byte-exact reader/writer for sdsl-lite ``int_vector`` / ``bit_vector`` files.

The reference serializes its index as 7 sdsl files under one prefix
(ref: include/FinimizerIndex.hh:187-241). The on-disk
format of ``sdsl::int_vector<t_width>::serialize`` is:

  * uint64 little-endian ``m_size``  -- the length in BITS (n * width)
  * uint8 ``m_width``                -- ONLY for ``int_vector<0>``
    (run-time width); fixed-width vectors (bit_vector = int_vector<1>,
    int_vector<2>, ...) do not store it
  * ceil(m_size / 64) uint64 little-endian data words, elements packed
    LSB-first, zero padding in the tail word

This is reconstructed from sdsl-lite upstream (the reference's SBWT
submodule carrying sdsl is not vendored; see SURVEY.md section 2.2).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import BinaryIO, Union

import numpy as np

from finito_tpu_torch.utils.bits import pack_values, unpack_values, pack_bits, unpack_bits

PathOrFile = Union[str, BinaryIO]


@dataclass
class IntVector:
    """A decoded sdsl int_vector: values plus the on-disk element width."""

    values: np.ndarray  # uint64
    width: int

    def __len__(self) -> int:
        return int(self.values.size)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, IntVector):
            return NotImplemented
        return self.width == other.width and np.array_equal(self.values, other.values)


def _open(path_or_file: PathOrFile, mode: str):
    if isinstance(path_or_file, (str, bytes)):
        return open(path_or_file, mode), True
    return path_or_file, False


def write_int_vector_stream(f: BinaryIO, values: np.ndarray, width: int, template_width: int = 0) -> int:
    """Serialize; returns bytes written (sdsl serialize() convention)."""
    values = np.asarray(values, dtype=np.uint64)
    if width < 1 or width > 64:
        raise ValueError(f"invalid int_vector width {width}")
    if template_width not in (0, width):
        raise ValueError("template width must be 0 or equal to width")
    m_size = values.size * width
    f.write(struct.pack("<Q", m_size))
    written = 8
    if template_width == 0:
        f.write(struct.pack("<B", width))
        written += 1
    words = pack_values(values, width)
    f.write(words.tobytes())
    return written + words.size * 8


def read_int_vector_stream(f: BinaryIO, template_width: int = 0, dtype=None) -> IntVector:
    """dtype narrows the decoded values array (it must hold width-bit
    values; see utils.bits.unpack_values) -- callers that keep a
    genome-scale vector resident pass e.g. int32 to avoid touching 8
    bytes/element on load."""
    (m_size,) = struct.unpack("<Q", f.read(8))
    if template_width == 0:
        (width,) = struct.unpack("<B", f.read(1))
    else:
        width = template_width
    n_words = (m_size + 63) // 64
    raw = f.read(n_words * 8)
    if len(raw) != n_words * 8:
        raise IOError("truncated sdsl int_vector")
    words = np.frombuffer(raw, dtype=np.uint64)
    n = m_size // width if width else 0
    return IntVector(values=unpack_values(words, n, width, dtype=dtype), width=width)


def save_int_vector(path_or_file: PathOrFile, values: np.ndarray, width: int, template_width: int = 0) -> int:
    f, close = _open(path_or_file, "wb")
    try:
        return write_int_vector_stream(f, values, width, template_width)
    finally:
        if close:
            f.close()


def load_int_vector(path_or_file: PathOrFile, template_width: int = 0, dtype=None) -> IntVector:
    f, close = _open(path_or_file, "rb")
    try:
        return read_int_vector_stream(f, template_width, dtype=dtype)
    finally:
        if close:
            f.close()


def write_bit_vector_stream(f: BinaryIO, bits: np.ndarray) -> int:
    """bit_vector = int_vector<1>: size header then packed words, no width byte."""
    bits = np.asarray(bits).astype(np.uint8)
    f.write(struct.pack("<Q", bits.size))
    words = pack_bits(bits)
    f.write(words.tobytes())
    return 8 + words.size * 8


def read_bit_vector_stream(f: BinaryIO) -> np.ndarray:
    words, m_size = read_bit_vector_words_stream(f)
    return unpack_bits(words, m_size)


def read_bit_vector_words_stream(f: BinaryIO):
    """(packed uint64 words, bit length) without expanding to a byte per
    bit -- for consumers whose working form is the packed words (the
    SBWT loader feeds these straight into its rank layout)."""
    (m_size,) = struct.unpack("<Q", f.read(8))
    n_words = (m_size + 63) // 64
    raw = f.read(n_words * 8)
    if len(raw) != n_words * 8:
        raise IOError("truncated sdsl bit_vector")
    return np.frombuffer(raw, dtype=np.uint64), m_size


def save_bit_vector(path_or_file: PathOrFile, bits: np.ndarray) -> int:
    f, close = _open(path_or_file, "wb")
    try:
        return write_bit_vector_stream(f, bits)
    finally:
        if close:
            f.close()


def load_bit_vector(path_or_file: PathOrFile) -> np.ndarray:
    f, close = _open(path_or_file, "rb")
    try:
        return read_bit_vector_stream(f)
    finally:
        if close:
            f.close()


def int_vector_size_in_bytes(n: int, width: int, template_width: int = 0) -> int:
    """On-disk byte count, matching sdsl::size_in_bytes for int_vector."""
    header = 8 + (1 if template_width == 0 else 0)
    return header + ((n * width + 63) // 64) * 8


def serialize_string(f: BinaryIO, s: str) -> int:
    """sbwt::serialize_string: uint64 length then raw chars (variant header)."""
    data = s.encode()
    f.write(struct.pack("<Q", len(data)))
    f.write(data)
    return 8 + len(data)


def load_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode()

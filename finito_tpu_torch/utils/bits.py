"""Bit-packing helpers shared by the sdsl codec and the device index layouts.

All packing is little-endian within 64-bit words, element bits stored
LSB-first and contiguously across word boundaries -- the same layout as
sdsl-lite's ``int_vector`` data words, which we must reproduce byte-exactly
for index interop (ref: SURVEY.md section 2.2 codec notes).
"""

from __future__ import annotations

import numpy as np

# Elements per chunk when expanding to a bit matrix; multiple of 8 so that
# chunk boundaries land on byte boundaries for every element width.
_CHUNK = 1 << 19


def bit_width_for_max(max_value: int) -> int:
    """Number of bits sdsl-style code uses for values up to ``max_value``.

    Matches ``64 - __builtin_clzll(x)`` (= bit_length) used throughout the
    reference (e.g. PackedStrings ends width, LCS width, offset width).
    Undefined for x == 0 in C; the reference never hits that, we return 1.
    """
    if max_value <= 0:
        return 1
    return int(max_value).bit_length()


def pack_values(values: np.ndarray, width: int) -> np.ndarray:
    """Pack unsigned integers into a uint64 word array, LSB-first.

    Element i occupies bits [i*width, (i+1)*width) of the bitstream; bit j
    of the stream is bit (j % 64) of word (j // 64).
    """
    values = np.ascontiguousarray(values, dtype=np.uint64)
    n = values.size
    total_bits = n * width
    n_words = (total_bits + 63) // 64
    buf = np.zeros(n_words * 8, dtype=np.uint8)
    if n == 0 or width == 0:
        return buf.view(np.uint64)
    from finito_tpu_torch import native

    packed = native.pack_values_native(values, width)
    if packed is not None:
        return packed
    shifts = np.arange(width, dtype=np.uint64)
    for s in range(0, n, _CHUNK):
        chunk = values[s : s + _CHUNK]
        bits = ((chunk[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
        packed = np.packbits(bits.reshape(-1), bitorder="little")
        byte_off = s * width // 8  # s % 8 == 0 so this is exact
        buf[byte_off : byte_off + packed.size] = packed
    return buf.view(np.uint64)


def unpack_values(words: np.ndarray, n: int, width: int, dtype=None) -> np.ndarray:
    """Inverse of :func:`pack_values`; returns an array of length n.

    dtype (default uint64) narrows the output element type -- the decode
    then touches width-matched bytes instead of 8/element, which on this
    project's microVM hosts (first-touch page faults ~2 orders of
    magnitude dearer than the decode) dominates index load time. The
    dtype must hold width-bit values exactly."""
    dt = np.dtype(dtype) if dtype is not None else np.dtype(np.uint64)
    if n == 0 or width == 0:
        return np.zeros(n, dtype=dt)
    words = np.ascontiguousarray(words, dtype=np.uint64)
    from finito_tpu_torch import native

    unpacked = native.unpack_values_native(words, n, width, dt)
    if unpacked is not None:
        return unpacked
    out = np.empty(n, dtype=np.uint64)
    byte_view = words.view(np.uint8)
    shifts = np.arange(width, dtype=np.uint64)
    for s in range(0, n, _CHUNK):
        m = min(_CHUNK, n - s)
        bit_lo = s * width  # multiple of 8 bits
        bit_hi = (s + m) * width
        b_lo = bit_lo // 8
        b_hi = (bit_hi + 7) // 8
        bits = np.unpackbits(byte_view[b_lo:b_hi], bitorder="little")
        bits = bits[: m * width].reshape(m, width).astype(np.uint64)
        out[s : s + m] = (bits << shifts).sum(axis=1, dtype=np.uint64)
    if dt != np.dtype(np.uint64):
        bits_avail = 8 * dt.itemsize - (1 if dt.kind == "i" else 0)
        if dt.kind not in ("u", "i") or width > bits_avail:
            raise ValueError(f"dtype {dt} cannot hold width-{width} values")
        out = out.astype(dt)
    return out


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 (or bool) array into uint64 words, LSB-first."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    n_words = (bits.size + 63) // 64
    buf = np.zeros(n_words * 8, dtype=np.uint8)
    packed = np.packbits(bits, bitorder="little")
    buf[: packed.size] = packed
    return buf.view(np.uint64)


def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns uint8 array of length n."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    return np.unpackbits(words.view(np.uint8), count=n, bitorder="little")


def popcount_words(words: np.ndarray) -> np.ndarray:
    return np.bitwise_count(words)

"""One convention for 32-bit unsigned words in torch.

torch's uint32 dtype has almost no arithmetic (on the CPU ``<<``, ``>>``
and ``<`` raise NotImplementedError), and its int32 differs from the
JAX package's uint32 in three ways that silently change answers:
``>>`` is an arithmetic shift, ``<`` is a signed compare, and
``torch.cumsum`` of int32 returns int64. So the port carries every
32-bit word as an **int64 holding a value in [0, 2^32)**, where shifts
and compares are the unsigned ones, and masks with ``U32`` after ``*``
and ``<<``. Where bytes matter (device tables, kernel outputs) words
are **stored as int32 bit patterns**; ``u32`` widens such a tensor back
into the int64 convention and ``to_i32`` narrows it again. XOR, AND and
equality of two int32 bit patterns are already exact.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
MIX32 = 0x9E3779B1  # selection order, index.minimizer._MIX
MIX2 = 0xC2B2AE35  # slot addressing, index.minimizer._MIX2


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor of 32-bit words (int32 bit patterns included)
    -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & U32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns (the low 32 bits)."""
    return x.to(torch.int32)


def shr32(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of 32-bit words (int32 bit patterns or int64
    words); returns int64 words."""
    return u32(x) >> s


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 words x and a 32-bit constant c,
    without int64 overflow: the high half of x contributes only the low
    16 bits of its product."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & U32


def mix32(v: torch.Tensor) -> torch.Tensor:
    """Twin of index.minimizer.mix32 (the minimizer selection order)."""
    v = u32(v)
    return mul32(v, MIX32) ^ (v >> 16)


def slot32(v: torch.Tensor) -> torch.Tensor:
    """Twin of index.minimizer.slot32 (slot addressing)."""
    v = u32(v)
    return mul32(v, MIX2) ^ (v >> 13)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of 32-bit words; torch has no popcount op."""
    x = u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24

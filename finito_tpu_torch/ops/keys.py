"""Device-side multiword packed k-mer keys as 32-bit planes: the twin of
finito_tpu/ops/keys_jax.py, used by the port's mesh build
(parallel.shard_build, parallel.shard_dbg).

A length-k row over {$=0, A=1..T=4}, 3 bits a char, colex order equal
to numeric order (the host keys of sbwt/keys.py), is an (n, P) matrix
of 32-bit planes, plane 0 the least significant, P = 2 * ceil(3k/64):
two planes per host uint64 word. Planes follow the port's word
convention (ops/bits.py): a plane value in [0, 2^32) is held in int64,
where ``>>`` and ``<`` are the unsigned ones, and every ``<<`` is masked
with U32. int64 and not int32 bit patterns: twice the memory, but no
widening before each compare or shift.

Padding and overflow slots are the all-ones SENTINEL row: no valid key
is all-ones (chars are <= 4 = 0b100, so some bit of every 3-bit group is
0), sentinels compare greater than every valid key (they sort to the end
and stay in the last sample-sort bucket), and equality tests mask them
out where needed.

Host twins: sbwt/keys.py (tests/test_torch_keys.py holds every function
to it and to keys_jax).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from finito_tpu_torch.ops.bits import U32

SENT = U32
# XOR into a 64-bit key of two planes (hi << 32 | lo) so that the signed
# int64 order is the unsigned one: a sentinel pair must sort last
_TOP = -(1 << 63)


def n_planes(k: int) -> int:
    return 2 * ((3 * k + 63) // 64)


def from_host(words: List[np.ndarray]) -> np.ndarray:
    """Host uint64 key words (least significant first) -> (n, P) uint32
    planes (host numpy, as keys_jax.from_host)."""
    planes = []
    for w in words:
        planes.append((w & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        planes.append((w >> np.uint64(32)).astype(np.uint32))
    return np.stack(planes, axis=1)


def to_host(planes) -> List[np.ndarray]:
    """(n, P) planes (numpy, or a tensor in the int64 convention) -> host
    uint64 key words (least significant first)."""
    if isinstance(planes, torch.Tensor):
        planes = planes.cpu().numpy()
    planes = np.asarray(planes)
    out = []
    for i in range(0, planes.shape[1], 2):
        lo = planes[:, i].astype(np.uint64) & np.uint64(0xFFFFFFFF)
        hi = planes[:, i + 1].astype(np.uint64) & np.uint64(0xFFFFFFFF)
        out.append(lo | (hi << np.uint64(32)))
    return out


def to_device(planes: np.ndarray, device) -> torch.Tensor:
    """(n, P) uint32 host planes -> int64 planes on device (moved as
    int32 bit patterns, widened there)."""
    t = torch.from_numpy(np.ascontiguousarray(planes).view(np.int32)).to(device)
    return t.to(torch.int64) & U32


def sentinel_rows(n: int, P: int, device="cpu") -> torch.Tensor:
    return torch.full((n, P), SENT, dtype=torch.int64, device=device)


def is_sentinel(keys: torch.Tensor) -> torch.Tensor:
    return (keys == SENT).all(dim=1)


def argsort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Indices sorting rows ascending (colex of the packed strings): LSD
    radix, least significant first, one stable sort per two planes fused
    into one 64-bit key. The stable order is unique, so it equals
    keys_jax's one stable sort per plane."""
    n, P = keys.shape
    order = torch.arange(n, device=keys.device)
    for p in range(0, P, 2):
        rows = keys[order]
        col = ((rows[:, p + 1] << 32) | rows[:, p]) ^ _TOP if p + 1 < P else rows[:, p]
        order = order[torch.sort(col, stable=True).indices]
    return order


def eq_adjacent_rows(keys: torch.Tensor) -> torch.Tensor:
    """mask[i] = row i == row i-1 (for sorted input); mask[0] = False."""
    eq = (keys[1:] == keys[:-1]).all(dim=1)
    return torch.cat([torch.zeros(min(1, keys.shape[0]), dtype=torch.bool, device=keys.device), eq])


def cmp_rows(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Rowwise three-way compare of key matrices (B may be one row,
    broadcast): -1 / 0 / +1 int8 per row. Planes scanned least
    significant first; a more significant difference overrides."""
    cmp = torch.zeros(A.shape[0], dtype=torch.int8, device=A.device)
    for p in range(A.shape[1]):
        a, b = A[:, p], B[:, p]
        c = (a > b).to(torch.int8) - (a < b).to(torch.int8)
        cmp = torch.where(c != 0, c, cmp)
    return cmp


def bucket_of(keys: torch.Tensor, splitters: torch.Tensor) -> torch.Tensor:
    """bucket[i] = number of splitters <= keys[i] (splitters: (S-1, P),
    sorted ascending). Sentinels land in the last bucket."""
    b = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for s in range(splitters.shape[0]):
        b = b + (cmp_rows(keys, splitters[s : s + 1]) >= 0).to(torch.int64)
    return b


def shift_right3_rows(keys: torch.Tensor) -> torch.Tensor:
    """Drop the first char: value >> 3 across planes."""
    P = keys.shape[1]
    cols = []
    for i in range(P):
        w = keys[:, i] >> 3
        if i + 1 < P:
            w = w | ((keys[:, i + 1] << 29) & U32)
        cols.append(w)
    return torch.stack(cols, dim=1)


def mask_low_rows(keys: torch.Tensor, chars: int) -> torch.Tensor:
    """Keep only the low `chars` characters (3*chars bits)."""
    bit = 3 * chars
    cols = []
    for i in range(keys.shape[1]):
        lo, hi = 32 * i, 32 * i + 32
        if bit >= hi:
            cols.append(keys[:, i])
        elif bit <= lo:
            cols.append(torch.zeros_like(keys[:, i]))
        else:
            cols.append(keys[:, i] & ((1 << (bit - lo)) - 1))
    return torch.stack(cols, dim=1)


def shift_left_rows(keys: torch.Tensor, chars: int) -> torch.Tensor:
    """value << 3*chars (planes beyond P drop; the caller guarantees the
    result fits)."""
    bit = 3 * chars
    q, r = bit >> 5, bit & 31
    P = keys.shape[1]
    cols = [torch.zeros_like(keys[:, 0]) for _ in range(P)]
    for i in range(P):
        j = i + q
        if j < P:
            cols[j] = cols[j] | ((keys[:, i] << r) & U32)
        if r and j + 1 < P:
            cols[j + 1] = cols[j + 1] | (keys[:, i] >> (32 - r))
    return torch.stack(cols, dim=1)


def char_at_rows(keys: torch.Tensor, p: int) -> torch.Tensor:
    """The char (0..7) at position p: bits [3p, 3p+3), which straddle two
    planes when 3p mod 32 > 29."""
    bit = 3 * p
    q, r = bit >> 5, bit & 31
    v = keys[:, q] >> r
    if r > 29 and q + 1 < keys.shape[1]:
        v = v | (keys[:, q + 1] << (32 - r))
    return v & 7


def top_char_rows(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The last (most significant) char: bits [3(k-1), 3k)."""
    return char_at_rows(keys, k - 1)


def or_char_rows_(keys: torch.Tensor, p: int, c) -> torch.Tensor:
    """In place: keys |= c << 3p across planes (the slot must be zero);
    c is an int or an int64 tensor of chars. Returns keys."""
    bit = 3 * p
    q, r = bit >> 5, bit & 31
    keys[:, q] |= (c << r) & U32
    if r > 29 and q + 1 < keys.shape[1]:
        keys[:, q + 1] |= c >> (32 - r)
    return keys


def match_rows(Q: torch.Tensor, R: torch.Tensor, Rvals: torch.Tensor) -> torch.Tensor:
    """For each Q row, Rvals of an equal R row, else -1. One combined
    stable sort, then the R value spread over its run (R rows unique
    among non-sentinels; sentinel Q rows return -1). Rvals' dtype."""
    nQ, nR = Q.shape[0], R.shape[0]
    comb = torch.cat([Q, R])
    order = argsort_rows(comb)
    new_run = ~eq_adjacent_rows(comb[order])
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    is_r = order >= nQ
    val = torch.where(is_r, Rvals[(order - nQ).clamp(min=0)], -1)
    n_cap = nQ + nR
    # keys_jax's .at[].max(mode="drop"): Q rows add -1 to the last slot
    rep = torch.full((n_cap,), -1, dtype=val.dtype, device=Q.device)
    rep.scatter_reduce_(0, torch.where(is_r, run_id, n_cap - 1), val, reduce="amax")
    out = torch.empty_like(rep).scatter_(0, order, rep[run_id])[:nQ]
    return torch.where(is_sentinel(Q), -1, out)

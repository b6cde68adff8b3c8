"""Single-gather rank and LCS-jump structures of the stream and replica
engines: counterpart of finito_tpu/ops/rank24.py.

The numpy table builders are the port's own copies:

  * rank24: one 32-bit entry per 8 SBWT positions per char,
        entry = (rank_before_byte << 8) | bits_byte
    so rank_c(i) = (e >> 8) + popcount(e & ((1 << (i&7)) - 1)) is one
    gather; past RANK24_MAX_NODES positions the "wide" form keeps
    [rank, byte] rows instead.
  * packed LCS-jump arrays for drop_first_char (ref common.hh:38-48):
        jl[i] = ((i - prev_smaller(i)) << 8) | LCS[i]
        jr[i] = ((next_smaller(i) - i) << 8) | LCS[i]
  * contract_k: per node x, the (k-1)-widening of the singleton [x, x].
  * the forward-edge automaton (plain, or augmented with the target
    node's shortest-unique-suffix length and Ustart bit).

The device functions (rank24, select_C, update_interval24,
widen_interval) take those tables as int32 tensors (ops.bits.put_i32)
and compute on int64 words in [0, 2^32) (ops.bits).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from finito_tpu_torch.ops.bits import popcount32, u32

RANK24_MAX_NODES = 1 << 24


def build_rank24_tables(bit_rows: np.ndarray) -> np.ndarray:
    """(R, n) 0/1 -> rank entries, one per 8 positions per row
    (R = 4 for the SBWT out-edge matrix; R = 1 for a plain bitvector).

    Two forms, chosen by size and told apart by ndim:
      * n <  RANK24_MAX_NODES: flat (R * n8,) uint32, entry = rank << 8 | byte;
      * n >= RANK24_MAX_NODES: "wide" (R * n8, 2) uint32 rows [rank, byte]."""
    n = bit_rows.shape[1]
    wide = n >= RANK24_MAX_NODES
    n8 = (n + 7) // 8 + 1  # pad entry so i == n is addressable
    R = bit_rows.shape[0]
    out = np.zeros((R, n8, 2), dtype=np.uint32) if wide else np.zeros(
        (R, n8), dtype=np.uint32
    )
    weights = (1 << np.arange(8)).astype(np.uint32)
    for c in range(R):
        padded = np.zeros(n8 * 8, dtype=np.uint8)
        padded[:n] = bit_rows[c]
        by = padded.reshape(n8, 8)
        byte_vals = (by * weights).sum(axis=1, dtype=np.uint32)
        counts = by.sum(axis=1, dtype=np.int64)
        csum = np.zeros(n8, dtype=np.int64)
        np.cumsum(counts[:-1], out=csum[1:])
        if wide:
            out[c, :, 0] = csum.astype(np.uint32)
            out[c, :, 1] = byte_vals
        else:
            out[c] = (csum.astype(np.uint32) << np.uint32(8)) | byte_vals
    return out.reshape(-1, 2) if wide else out.reshape(-1)


def rank24(tab: torch.Tensor, n8: int, c, i):
    """Batched rank_c(i) in one gather; c in [0, 4), i in [0, n]. Both
    table forms (told apart by tab.dim()). Returns int64."""
    mask = (1 << (i & 7)) - 1
    e = tab[c * n8 + (i >> 3)]
    if tab.dim() == 2:  # wide form: [rank, byte] rows
        return u32(e[..., 0]) + popcount32(e[..., 1] & mask)
    e = u32(e)
    return (e >> 8) + popcount32(e & mask)


def select_C(C: torch.Tensor, cs):
    """C[cs] for cs in [0, 4)."""
    return C[cs]


def extend_interval(rank_c, C, c, lo, hi):
    """Batched SBWT right-extension (ref formula: common.hh:26-36) over a
    rank function rank_c(cs, i): empty intervals are (-1, -1), and so is
    every char code > 3 (e.g. pad 255). Returns int64."""
    c = c.to(torch.int64)
    valid = (lo >= 0) & (c >= 0) & (c <= 3)
    cs = torch.where(valid, c, 0)
    los = torch.where(valid, lo, 0)
    his = torch.where(valid, hi, 0)
    Cc = select_C(C, cs)
    nlo = Cc + rank_c(cs, los)
    nhi = Cc + rank_c(cs, his + 1) - 1
    ok = valid & (nlo <= nhi)
    return torch.where(ok, nlo, -1), torch.where(ok, nhi, -1)


def update_interval24(tab, n8: int, C, c, lo, hi):
    """Batched SBWT right-extension using rank24 (2 gathers)."""
    return extend_interval(lambda cs, i: rank24(tab, n8, cs, i), C, c, lo, hi)


def _prev_smaller(a: np.ndarray) -> np.ndarray:
    """out[i] = max j < i with a[j] < a[i]; 0 where none (a[0]=0 in LCS)."""
    n = a.size
    out = np.zeros(n, dtype=np.int64)
    stack_pos = np.empty(n + 1, dtype=np.int64)
    stack_val = np.empty(n + 1, dtype=np.int64)
    top = -1
    for i in range(n):
        v = a[i]
        while top >= 0 and stack_val[top] >= v:
            top -= 1
        out[i] = stack_pos[top] if top >= 0 else 0
        top += 1
        stack_pos[top] = i
        stack_val[top] = v
    return out


def _next_smaller(a: np.ndarray) -> np.ndarray:
    """out[i] = min j > i with a[j] < a[i]; n where none."""
    n = a.size
    out = np.full(n, n, dtype=np.int64)
    stack_pos = np.empty(n + 1, dtype=np.int64)
    stack_val = np.empty(n + 1, dtype=np.int64)
    top = -1
    for i in range(n - 1, -1, -1):
        v = a[i]
        while top >= 0 and stack_val[top] >= v:
            top -= 1
        out[i] = stack_pos[top] if top >= 0 else n
        top += 1
        stack_pos[top] = i
        stack_val[top] = v
    return out


def build_lcs_jump_tables(LCS: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Packed (delta << 8 | lcs) jump arrays jl, jr (uint32, length n+1).

    jr has one pad entry at index n (delta 0, lcs 0) so `hi+1 == n` probes
    are safe and immediately inactive.
    """
    a = np.asarray(LCS, dtype=np.int64)
    n = a.size
    if np.any(a > 255):
        raise ValueError("LCS values must fit in 8 bits (k <= 256)")
    prev = _prev_smaller(a)
    nxt = _next_smaller(a)
    jl = ((np.arange(n) - prev).astype(np.uint32) << np.uint32(8)) | a.astype(np.uint32)
    jr = np.zeros(n + 1, dtype=np.uint32)
    jr[:n] = ((nxt - np.arange(n)).astype(np.uint32) << np.uint32(8)) | a.astype(np.uint32)
    return jl, jr


def build_contract_k_table(LCS: np.ndarray, k: int) -> np.ndarray:
    """(n, 2) int32: for each node x, the (k-1)-widened interval of [x, x].

    lo[x] = max j <= x with (j == 0 or LCS[j] < k-1)
    hi[x] = min j >= x with (j == n-1 or LCS[j+1] < k-1)
    """
    a = np.asarray(LCS, dtype=np.int64)
    n = a.size
    idx = np.arange(n, dtype=np.int64)
    small = a < (k - 1)
    small[0] = True
    lo = np.maximum.accumulate(np.where(small, idx, 0))
    # first j >= x with LCS[j+1] < k-1 (or n-1)
    small_next = np.empty(n, dtype=bool)
    small_next[: n - 1] = a[1:] < (k - 1)
    small_next[n - 1] = True
    hi = np.minimum.accumulate(np.where(small_next, idx, n - 1)[::-1])[::-1]
    return np.stack([lo, hi], axis=1).astype(np.int32)


_NO_CAND = 255  # candidate-length sentinel shared by the scan engines


def build_su_table(LCS: np.ndarray) -> np.ndarray:
    """SU[x] = max(LCS[x], LCS[x+1]) + 1: length of the shortest unique
    suffix whose singleton interval is {x} (pad LCS[n] = 0). Closed form
    of the reference's shrink-from-the-left loop (common.hh:145-154)."""
    a = np.asarray(LCS, dtype=np.int64)
    nxt = np.concatenate([a[1:], [0]])
    su = np.maximum(a, nxt) + 1
    if np.any(su >= _NO_CAND):
        raise ValueError("SU table requires k <= 254")
    return su.astype(np.uint8)


def build_su_ustart_table(LCS: np.ndarray, Ustart: np.ndarray) -> np.ndarray:
    """uint16 per node: SU length (low 8 bits) | Ustart bit << 8 -- one
    gather serves both the candidate closed form and the branch carry."""
    su = build_su_table(LCS).astype(np.uint16)
    return su | (np.asarray(Ustart, np.uint16) << np.uint16(8))


EDGE_AUG_MIN = 1 << 25  # cand values >= this carry inline (su, ustart)
EDGE_NODE_MASK = (1 << 24) - 1


def can_augment_edges(n_nodes: int, k: int) -> bool:
    """Augmented edge entries pack su (6 bits, su <= k <= 63) | ustart
    (1 bit) | node (24 bits) into a positive int32 -- possible exactly
    when the flat rank24 form applies and k <= 63."""
    return n_nodes < RANK24_MAX_NODES and k <= 63


def build_edge_aug_table(
    bit_rows: np.ndarray, C, contract_k: np.ndarray,
    LCS: np.ndarray, Ustart: np.ndarray,
) -> np.ndarray:
    """Forward-edge table with the TARGET node's (SU, Ustart) packed into
    bits [25:31] and [24], so the chain scan's edge gather also yields
    the replica tail's candidate length and Ustart flag. Entries stay -1
    when the slid k-mer is absent; requires can_augment_edges."""
    base = build_edge_table(bit_rows, C, contract_k)
    n = bit_rows.shape[1]
    su = build_su_table(LCS).astype(np.int32)
    if n >= RANK24_MAX_NODES or (su.size and int(su.max()) > 63):
        raise ValueError("index too large or k too big for augmented edges")
    us = np.asarray(Ustart, np.int32)
    tgt = np.where(base >= 0, base, 0)
    aug = base | (su[tgt] << 25) | (us[tgt] << 24)
    return np.where(base >= 0, aug, base).astype(np.int32)


def build_edge_table(bit_rows: np.ndarray, C, contract_k: np.ndarray) -> np.ndarray:
    """(4n,) int32 forward-edge automaton: edge[4x + c] = colex rank of
    the k-mer obtained by sliding the window of k-mer x one base (drop
    first char, append c), or -1 when that k-mer is absent: the
    contract_k widening and the two rank gathers of a mature step of the
    streaming chain (ref common.hh:114-143) collapsed to one gather."""
    n = bit_rows.shape[1]
    Ca = np.asarray(C, dtype=np.int64)
    cl = contract_k[:, 0].astype(np.int64)
    ch = contract_k[:, 1].astype(np.int64)
    edge = np.empty((n, 4), dtype=np.int32)
    r = np.zeros(n + 1, dtype=np.int64)
    for c in range(4):
        np.cumsum(bit_rows[c], out=r[1:])
        lo = Ca[c] + r[cl]
        hi = Ca[c] + r[ch + 1] - 1
        edge[:, c] = np.where(lo <= hi, lo, -1).astype(np.int32)
    return edge.reshape(-1)


def widen_interval(jl, jr, lo, hi, new_len, n_nodes: int):
    """Batched drop_first_char (ref common.hh:38-48) by packed jump hops:
    one gather per hop and side. jl, jr: the jump tables as int32 bit
    patterns (put_i32), each entry hop << 8 | LCS, the hop unpacked by a
    logical shift (ops.bits). Empty intervals (lo < 0) pass through;
    new_len <= 0 gives the full interval. The JAX while loops become
    loops that stop when no lane hops, one host read a trip. Returns
    int64 (lo, hi)."""
    empty = lo < 0
    full = (new_len <= 0) & ~empty
    act0 = ~(empty | full)

    def hops(table, x, sign, in_range):
        act = act0
        while bool(act.any()):
            e = u32(table[torch.where(act, x, 0)])
            act = act & in_range(x) & ((e & 0xFF) >= new_len)
            x = torch.where(act, x + sign * (e >> 8), x)
        return x

    new_lo = hops(jl, torch.where(act0, lo, 0).to(torch.int64), -1, lambda x: x > 0)
    new_hi = hops(jr, torch.where(act0, hi + 1, 0).to(torch.int64), 1, lambda x: x < n_nodes) - 1
    out_lo = torch.where(empty, lo, torch.where(full, 0, new_lo))
    out_hi = torch.where(empty, hi, torch.where(full, n_nodes - 1, new_hi))
    return out_lo.to(torch.int64), out_hi.to(torch.int64)

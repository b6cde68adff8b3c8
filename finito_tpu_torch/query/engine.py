"""Batched device query engine producing `search-fmin`-identical output:
counterpart of finito_tpu/query/engine.py, minimizer mode only.

DeviceQueryEngine uploads a FinimizerIndex's minimizer tables to one
device and locates strand-interleaved read batches there with the locate
of query.minimizer_engine: the per-window v1 form below a 64 MB slot
descriptor, the run-deduplicated v2 form from there up (the JAX
engine's rule; FINITO_MINIMIZER_V2=0/1 forces either). The forward /
reverse-complement merge and a run-length encoding of its output run on
the device too (merge_rle), so the host reads back O(runs), not
O(windows). The serving split merged_pairs_flat_begin / _end keeps the
dispatch half free of capacity checks: the slow-path overflow counter
is read in _end (the deferred verify).
"""

from __future__ import annotations

import os
import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from finito_tpu.index.index import FinimizerIndex, QueryResult
from finito_tpu.index.minimizer import MinimizerIndex
from finito_tpu_torch.query.minimizer_engine import (
    DeviceMinimizerIndex,
    make_minimizer_locate,
    make_minimizer_locate_v2,
)
from finito_tpu_torch.query.minimizer_tables import grow_capacities, initial_capacities

# v2 from this descriptor size up: the JAX engine's threshold
# (finito_tpu/query/engine.py), which is also its slot-row cap
V2_MIN_DESC_BYTES = 64 << 20


def pick_v2(dmi: DeviceMinimizerIndex) -> bool:
    """Whether the locate takes the v2 form: FINITO_MINIMIZER_V2=0/1
    forces it, else v2 from a V2_MIN_DESC_BYTES descriptor up."""
    forced = os.environ.get("FINITO_MINIMIZER_V2")
    if forced in ("0", "1"):
        return forced == "1"
    return dmi.desc.numel() * dmi.desc.element_size() >= V2_MIN_DESC_BYTES


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """x[:, j - 1] at column j, fill at column 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def merge_rle(uid: torch.Tensor, off: torch.Tensor, lens: torch.Tensor, K: int):
    """Strand-interleaved (B2, Wp) locate results -> the reference's
    merged (u, p) per window, run-length encoded on the device: port of
    the JAX engine's _merge_rle_fn, in plain torch.

    Rows 2j / 2j+1 are read j forward / reverse complement; lens (B2/2,)
    holds window counts (0 for padding rows). The merge rule is the
    reference's (search_fmin.hh:62-71): the forward hit, else the RC hit
    of the mirrored window n-1-w. A run is a maximal stretch with one
    unitig id and offsets stepping by +1 or -1, or of absent windows;
    runs are stored as (u0, p0, p_last, len) in K-capacity buffers (runs
    past K land in a sink slot; the caller falls back to the host merge
    when stats[0] > K). Returns (u0, p0, p1, rl, stats) with stats =
    [n_runs, found forward, found reverse]."""
    uf, of = uid[0::2], off[0::2]
    ur, orr = uid[1::2], off[1::2]
    Wp = uid.shape[1]
    w = torch.arange(Wp, dtype=torch.int64, device=uid.device)[None, :]
    n = lens.to(torch.int64)[:, None]
    valid = w < n
    ridx = (n - 1 - w).clamp(0, Wp - 1)
    take_rc = valid & (uf < 0)
    u = torch.where(take_rc, torch.gather(ur, 1, ridx), torch.where(valid, uf, -1))
    p = torch.where(take_rc, torch.gather(orr, 1, ridx), torch.where(valid, of, -1))
    kf = (valid & (uf >= 0)).sum()
    kr = (valid & (ur >= 0)).sum()
    # run heads: a window continues the previous run iff same unitig and
    # the offset step is the run's step (+-1; the first step after a head
    # is free), or both are absent
    prev_u = _shift_right(u, -2)
    d = p - _shift_right(p, -2)
    step_ok = (u == prev_u) & (u >= 0) & ((d == 1) | (d == -1))
    cont = (step_ok & (~_shift_right(step_ok, False) | (d == _shift_right(d, 0)))) | (
        (u == prev_u) & (u < 0)
    )
    head = (valid & ((w == 0) | ~cont)).reshape(-1)
    flat_valid = valid.reshape(-1)
    flat_u = u.reshape(-1)
    flat_p = p.reshape(-1)
    rid = torch.cumsum(head.to(torch.int32), 0) - 1
    n_runs = rid[-1] + 1
    in_cap = (rid >= 0) & (rid < K)
    nxt_head = torch.cat([head[1:], head.new_ones(1)])
    nxt_valid = torch.cat([flat_valid[1:], flat_valid.new_zeros(1)])
    last = flat_valid & (nxt_head | ~nxt_valid)

    def to_slots(sel, src):
        buf = torch.zeros(K + 1, dtype=torch.int32, device=uid.device)
        return buf.scatter_(0, torch.where(sel & in_cap, rid, K), src)[:K]

    u0 = to_slots(head, flat_u)
    p0 = to_slots(head, flat_p)
    p1 = to_slots(last, flat_p)
    rl = torch.zeros(K + 1, dtype=torch.int32, device=uid.device).scatter_add_(
        0, torch.where(flat_valid & in_cap, rid, K), torch.ones_like(flat_u)
    )[:K]
    stats = torch.stack([n_runs, kf, kr])
    return u0, p0, p1, rl, stats


def _pad_codes(codes: np.ndarray) -> np.ndarray:
    """Shape bucketing: L up to a multiple of 128 (at least 128), B up to
    a power of two, padding with 255 (invalid, so padded windows are
    absent)."""
    B, L = codes.shape
    L_pad = max(128, -(-L // 128) * 128)
    B_pad = 1 << max(0, (B - 1).bit_length())
    if (B_pad, L_pad) == (B, L):
        return codes
    padded = np.full((B_pad, L_pad), 255, dtype=np.uint8)
    padded[:B, :L] = codes
    return padded


class DeviceQueryEngine:
    """Batched (unitig, offset) localization over a loaded FinimizerIndex
    on one torch device (minimizer engine; ``use_v2`` names the locate
    form it runs)."""

    def __init__(self, index: FinimizerIndex, mode: str = "minimizer", device="cuda",
                 mindex_cache: str | None = None):
        """device: where the tables live and the locate runs ("cuda",
        "cuda:1", "cpu"). mindex_cache: optional path; the derived
        MinimizerIndex is loaded from it when it matches this index and
        serialized to it after a build."""
        if mode != "minimizer":
            raise NotImplementedError(f"engine mode {mode!r} is not ported (minimizer only)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        self.k = index.sbwt.get_k()
        self._dmi = DeviceMinimizerIndex(self._minimizer_index(index, mindex_cache), self.device)
        self.use_v2 = pick_v2(self._dmi)
        self._sizes = {}  # (B, W) -> last sufficient (K_slow, K_heads)

    def _minimizer_index(self, index: FinimizerIndex, cache: str | None) -> MinimizerIndex:
        if cache and os.path.exists(cache):
            mindex = MinimizerIndex.load(cache)
            # a cache of another index would give wrong (uid, off): check
            # what ties it to this one
            if (
                mindex.k == self.k
                and mindex.concat.size == np.asarray(index.unitigs.concat).size
                and np.array_equal(np.asarray(mindex.ends), np.asarray(index.unitigs.ends))
            ):
                return mindex
            warnings.warn(f"minimizer cache {cache} does not match this index "
                          "(k/text/ends differ); rebuilding")
        mindex = MinimizerIndex.from_finimizer_index(index)
        if cache:
            mindex.serialize(cache)
        return mindex

    # ---------------- batched core ----------------

    def _dispatch(self, codes: torch.Tensor, K: int, KH: int):
        if self.use_v2:
            return make_minimizer_locate_v2(self._dmi, K, KH)(codes)
        return make_minimizer_locate(self._dmi, K)(codes)

    def _locate_async(self, codes: torch.Tensor):
        """Dispatch with the last-known-sufficient capacities and defer the
        overflow readback: returns (uid, off, verify). verify() reads the
        counters and, on the rare overflow, re-runs at larger capacities
        and returns the corrected (uid, off), else None."""
        B, L = codes.shape
        W = L - self.k + 1
        K, KH = self._sizes.get((B, W)) or initial_capacities(B * W, self.use_v2)
        k0 = int(os.environ.get("FINITO_MIN_K0", "0"))
        if k0 > 0:  # tests: force the overflow/verify path
            K, KH = k0, max(k0, 4)
            self._sizes.pop((B, W), None)
        first = self._dispatch(codes, K, KH)

        def verify(K=K, KH=KH):
            out = first
            while True:
                # one read of both counters (v1 has no head buffer)
                n_slow, n_heads = torch.stack(out[2:4]).tolist() if self.use_v2 else (int(out[2]), 0)
                grown = grow_capacities(K, KH, n_slow, n_heads, B * W)
                if grown is None:
                    self._sizes[(B, W)] = (K, KH)
                    return None if out is first else (out[0], out[1])
                K, KH = grown
                out = self._dispatch(codes, K, KH)

        return first[0], first[1], verify

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        # a copy from pageable memory can block the host until the kernels
        # still queued from the previous chunk are done; from pinned memory
        # it is queued like a kernel
        return t.pin_memory().to(self.device, non_blocking=True)

    def _locate_batch_deferred(self, codes: np.ndarray):
        """Bucketed dispatch with the capacity check deferred: returns
        (uid_dev, off_dev, B, W, verify); the device arrays are padded
        and the (B, W) slice applies at readback."""
        B, L = codes.shape
        padded = _pad_codes(codes)
        uid, off, verify = self._locate_async(self._to_device(padded))
        return uid, off, B, L - self.k + 1, verify

    def locate_batch(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """codes: (B, L) uint8 (pad with 255), L >= k. Returns (B, W) unitig
        ids and offsets, -1 where the k-mer is absent/invalid."""
        uid, off, B, W, verify = self._locate_batch_deferred(codes)
        fixed = verify()
        if fixed is not None:
            uid, off = fixed
        return uid[:B, :W].cpu().numpy(), off[:B, :W].cpu().numpy()

    # ---------------- per-read CLI-parity API ----------------

    def search_fwd_rc(self, read: bytes) -> Tuple[QueryResult, QueryResult]:
        """Forward and reverse-complement QueryResults for one read,
        matching FinimizerIndex.search (empty for non-ACGT reads and
        reads shorter than k)."""
        return self.process_reads([read])[0]

    def _encode_both_strands(self, reads: Sequence[bytes]):
        """Encode, filter short/invalid reads, pad, and stack forward and
        reverse-complement strands in one (2B, L) host batch, strand-
        interleaved (row 2j = read j forward, row 2j+1 = its RC).
        Returns (batch_idx, batch_codes, both), both None when every read
        was filtered."""
        from finito_tpu.io.seqdb import encode_seq

        k = self.k
        batch_idx: List[int] = []
        batch_codes: List[np.ndarray] = []
        for i, read in enumerate(reads):
            codes = encode_seq(read if isinstance(read, bytes) else read.encode())
            if codes.size >= k and not np.any(codes == 255):
                batch_idx.append(i)
                batch_codes.append(codes)
        if not batch_idx:
            return batch_idx, batch_codes, None
        L = max(c.size for c in batch_codes)
        both = np.full((2 * len(batch_codes), L), 255, dtype=np.uint8)
        for j, c in enumerate(batch_codes):
            both[2 * j, : c.size] = c
            both[2 * j + 1, : c.size] = (3 - c)[::-1]
        return batch_idx, batch_codes, both

    def merged_pairs_flat(self, reads: Sequence[bytes]):
        """Bulk-output form of the fwd+RC merge: (line_lens, u_flat,
        p_flat, kmers_fwd, kmers_rc); line_lens[i] is read i's pair count
        (0 for short/invalid reads, which emit an empty line)."""
        return self.merged_pairs_flat_end(self.merged_pairs_flat_begin(reads))

    def merged_pairs_flat_begin(self, reads: Sequence[bytes]):
        """Dispatch half: encode, locate, and the device merge/RLE, with
        no capacity check (that waits for _end). Returns an opaque
        handle for merged_pairs_flat_end."""
        k = self.k
        line_lens = np.zeros(len(reads), np.int64)
        batch_idx, batch_codes, both = self._encode_both_strands(reads)
        if both is None:
            return (line_lens, None)
        lens = np.array([c.size - k + 1 for c in batch_codes], dtype=np.int64)
        line_lens[np.asarray(batch_idx, dtype=np.int64)] = lens
        uid_d, off_d, _, _, verify = self._locate_batch_deferred(both)
        B2, Wp = uid_d.shape
        lens_pad = np.zeros(B2 // 2, np.int32)
        lens_pad[: len(batch_codes)] = lens
        lens_d = self._to_device(lens_pad)
        K = int(min((B2 // 2) * Wp, max(4096, 16 * (B2 // 2))))
        out = merge_rle(uid_d, off_d, lens_d, K)
        return (line_lens, (batch_codes, lens, uid_d, off_d, K, out, verify, lens_d))

    def merged_pairs_flat_end(self, handle):
        """Readback half: the deferred verify, then an O(runs) transfer
        and host re-expansion (or the full-window host merge when the
        runs overflow their capacity)."""
        line_lens, rest = handle
        if rest is None:
            z = np.zeros(0, np.int32)
            return line_lens, z, z, 0, 0
        (batch_codes, lens, uid_d, off_d, K, out, verify, lens_d) = rest
        fixed = verify()
        if fixed is not None:
            # slow-path overflow: the optimistic locate and the merge
            # chained on it were invalid; redo both exactly
            uid_d, off_d = fixed
            out = merge_rle(uid_d, off_d, lens_d, K)
        u0d, p0d, p1d, rld, stats = out
        n_runs, kf, kr = (int(x) for x in stats.cpu().tolist())
        if n_runs > K:
            return self._merged_pairs_host(
                line_lens, batch_codes, lens, uid_d.cpu().numpy(), off_d.cpu().numpy()
            )
        runs = torch.stack([u0d, p0d, p1d, rld])[:, :n_runs].cpu().numpy()
        u0, p0, p1 = runs[0], runs[1], runs[2]
        rl = runs[3].astype(np.int64)
        total = int(rl.sum())
        starts = np.cumsum(rl) - rl
        u = np.repeat(u0, rl)
        step = np.sign(p1.astype(np.int64) - p0)
        off_in = np.arange(total, dtype=np.int64) - np.repeat(starts, rl)
        p = np.repeat(p0.astype(np.int64), rl) + np.repeat(step, rl) * off_in
        return line_lens, u.astype(np.int32), p.astype(np.int32), kf, kr

    def _merged_pairs_host(self, line_lens, batch_codes, lens, uid_b, off_b):
        """Full-window host merge: the fallback when runs overflow, and
        the arbiter the device RLE path is tested against."""
        B = len(batch_codes)
        total = int(lens.sum())
        j_of = np.repeat(np.arange(B), lens)
        w_of = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        uf = uid_b[2 * j_of, w_of]
        of_ = off_b[2 * j_of, w_of]
        w_rc = lens[j_of] - 1 - w_of
        ur = uid_b[2 * j_of + 1, w_rc]
        orr = off_b[2 * j_of + 1, w_rc]
        absent = uf == -1
        u = np.where(absent, ur, uf).astype(np.int32)
        p = np.where(absent, orr, of_).astype(np.int32)
        # ur gathered at the mirrored windows is a permutation of the RC
        # row's valid windows, so counting it counts the RC strand
        kf = int(np.count_nonzero(uf >= 0))
        kr = int(np.count_nonzero(ur >= 0))
        return line_lens, u, p, kf, kr

    def process_reads(self, reads: Sequence[bytes]) -> List[Tuple[QueryResult, QueryResult]]:
        """Per-read (forward, reverse-complement) QueryResults."""
        k = self.k
        results: List[Tuple[QueryResult, QueryResult]] = [
            (QueryResult([], 0), QueryResult([], 0)) for _ in reads
        ]
        batch_idx, batch_codes, both = self._encode_both_strands(reads)
        if both is None:
            return results
        uid_b, off_b = self.locate_batch(both)
        for j, i in enumerate(batch_idx):
            n = batch_codes[j].size - k + 1
            f, r = (
                QueryResult(
                    list(zip(uid_b[row, :n].tolist(), off_b[row, :n].tolist())),
                    int(np.count_nonzero(uid_b[row, :n] >= 0)),
                )
                for row in (2 * j, 2 * j + 1)
            )
            results[i] = (f, r)
        return results

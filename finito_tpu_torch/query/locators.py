"""The locate layer under DeviceQueryEngine's host shell (query.engine):
one locator a mode, holding its device tables and capacity memo, with
dispatch((B, L) codes on its device) -> (uid, off, verify) and pipeline,
its device-resident step; and Optimistic, the capacity protocol of every
locate with fixed-size buffers, written once (the locators defer its
verify() to a chunk's readback half, kmer-mapper and the tools call it
at once), with its policies minimizer_policy and segment_policy.
"""

from __future__ import annotations

import os
import warnings
from functools import partial

import numpy as np
import torch

from finito_tpu_torch.index.index import FinimizerIndex
from finito_tpu_torch.index.minimizer import MinimizerIndex
from finito_tpu_torch.ops.bits import put_i32
from finito_tpu_torch.ops.bitvec import DeviceSBWT, kmer_ranks_fixed, search_batch_device
from finito_tpu_torch.ops.streaming import make_chain_stream_ranks
from finito_tpu_torch.query.minimizer_engine import (
    DeviceMinimizerIndex,
    make_minimizer_locate,
    make_minimizer_locate_form,
    make_minimizer_locate_v2,
    pick_v2,
    v2_by_size,
)
from finito_tpu_torch.query.minimizer_tables import grow_capacities, initial_capacities
from finito_tpu_torch.query.replica import make_replica_locate_v2, replica_tables, two_phase_tables
from finito_tpu_torch.utils import trace


class Optimistic:
    """run(caps) dispatches at the capacity tuple caps and returns (uid,
    off, counters, ...), counters one () device tensor or a tuple of
    them; grow(caps, counters) takes them as host ints and returns None
    when caps sufficed, else the next capacities, or raises at the
    ceiling. The dispatch runs at construction, at sizes[key] when an
    earlier verify settled the key, else at `first`. FINITO_MIN_K0=k0 > 0
    (tests) makes every dispatch start at k0 (further capacities at
    max(k0, 4)) and drops the key's memo.

    verify() reads the counters in one host read (utils.trace site
    `verify`) and re-runs while grow asks; then it counts the final
    counters under the trace names `counted`, keeps the capacities in
    sizes[key], and returns None when the first output stands, else the
    exact (uid, off). caps, out and counters are then the final run's."""

    def __init__(self, run, first, grow, counted=(), sizes=None, key=None):
        self.run, self.grow, self.counted, self.key = run, grow, counted, key
        self.sizes = {} if sizes is None else sizes
        caps = self.sizes.get(key) or first
        k0 = int(os.environ.get("FINITO_MIN_K0", "0"))
        if k0 > 0:
            caps = (k0,) + (max(k0, 4),) * (len(caps) - 1)
            self.sizes.pop(key, None)
        self.caps, self.counters = caps, None
        self.first = self.out = run(caps)

    def verify(self):
        while True:
            c = self.out[2]
            self.counters = trace.host_read(
                "verify", lambda: torch.stack(c).tolist() if isinstance(c, tuple) else [int(c)])
            grown = self.grow(self.caps, self.counters)
            if grown is None:
                break
            self.caps = grown
            self.out = self.run(grown)
        for name, n in zip(self.counted, self.counters):
            trace.count(name, n)
        self.sizes[self.key] = self.caps
        return None if self.out is self.first else (self.out[0], self.out[1])


def minimizer_policy(B: int, L: int, k: int, v2: bool, slow_divisor: int | None = None):
    """(first, grow) of a minimizer locate on a (B, L) batch: (K_slow,
    K_heads) by initial_capacities, grown by grow_capacities from the
    counters (n_slow,) (v1, the mesh) or (n_slow, n_heads) (v2)."""
    BW = B * (L - k + 1)

    def grow(caps, counters):
        return grow_capacities(*caps, counters[0], counters[1] if v2 else 0, BW)

    return initial_capacities(BW, v2, slow_divisor), grow


def segment_policy(B: int, L: int, k: int, stream: bool):
    """(first, grow) of the segment repair on a (B, L) batch, W = L-k+1:
    K segments, first max(1024, B*W/64) (stream) or max(1024, B*W/16)
    (replica), x4 while n_seg exceeds it, up to B*W (stream) or B*L
    (replica): the JAX engine's rule."""
    W = L - k + 1
    cap = B * W if stream else B * L

    def grow(caps, counters):
        (K,), (n_seg,) = caps, counters
        if n_seg <= K:
            return None
        if K >= cap:
            raise AssertionError(f"segment overflow at K == {cap}")
        return (min(cap, K * 4),)

    return (max(1024, (B * W) // (64 if stream else 16)),), grow


def build_position_table(dsbwt: DeviceSBWT, concat: np.ndarray, ends: np.ndarray,
                         chunk: int = 1 << 20) -> torch.Tensor:
    """pos[colex] = global end offset of the k-mer with that colex rank,
    -1 for dummy nodes: int32 (n_nodes,) on dsbwt's device, built by
    searching every valid unitig window (windows never cross unitig
    boundaries) in chunks of `chunk` windows."""
    k, n = dsbwt.k, dsbwt.n_nodes
    dev = dsbwt.words.device
    table = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)  # slot n: sink
    total = int(concat.size)
    if total < k:
        return table[:n]
    ends64 = np.asarray(ends, dtype=np.int64)
    n_pos = total - k + 1
    for s in range(0, n_pos, chunk):
        m = min(chunk, n_pos - s)
        starts = np.arange(s, s + m, dtype=np.int64)
        # valid iff the window fits inside the unitig containing its start
        uid = np.searchsorted(ends64, starts, side="right")
        valid = starts + k <= ends64[uid]
        win = np.lib.stride_tricks.sliding_window_view(concat[s : s + m + k - 1], k).copy()
        win[~valid] = 255  # absent -> rank -1 -> the sink slot
        ranks = search_batch_device(dsbwt, torch.from_numpy(win).to(dev)).to(torch.int64)
        g_end = torch.from_numpy((starts + k - 1).astype(np.int32)).to(dev)
        table.scatter_(0, torch.where(ranks < 0, n, ranks), g_end)
    return table[:n]


def build_locate_tables(pos_table: torch.Tensor, ends_dev: torch.Tensor, k: int) -> torch.Tensor:
    """Per-colex global end offsets -> an (n, 2) int32 row table
    [unitig id, local offset] (-1 rows for dummy nodes), so each query
    k-mer costs one row gather."""
    g_end = pos_table.to(torch.int64)
    ends = ends_dev.to(torch.int64)
    found = g_end >= 0
    g_start = g_end - k + 1
    uid = torch.searchsorted(ends, g_start, right=True)
    u_start = torch.where(uid > 0, ends[(uid - 1).clamp(0, max(ends.numel() - 1, 0))], 0)
    off = g_start - u_start
    return torch.stack([torch.where(found, uid, -1), torch.where(found, off, -1)],
                       dim=1).to(torch.int32)


def _ranks_to_locations(loc_table: torch.Tensor, ranks: torch.Tensor):
    """colex ranks (B, W) -> ((B, W) unitig ids, (B, W) offsets), int32;
    one (n, 2) row gather."""
    with trace.span("ranks_to_locations"):
        found = ranks >= 0
        rows = loc_table[torch.where(found, ranks, 0)]
        uid, off = rows[..., 0], rows[..., 1]
        found = found & (uid >= 0)
        return torch.where(found, uid, -1), torch.where(found, off, -1)


def _row_tables(index: FinimizerIndex, device):
    """The dense and stream engines' DeviceSBWT and (n, 2) row table."""
    dsbwt = DeviceSBWT.from_host(index.sbwt, device)
    pos = build_position_table(dsbwt, index.unitigs.concat, index.unitigs.ends)
    return dsbwt, build_locate_tables(pos, put_i32(index.unitigs.ends, device), dsbwt.k)


def load_minimizer_index(index: FinimizerIndex, cache: str | None) -> MinimizerIndex:
    """The MinimizerIndex derived from index: loaded from cache (a path)
    when the file there matches index, else built, and serialized to
    cache when one is given."""
    if cache and os.path.exists(cache):
        mindex = MinimizerIndex.load(cache)
        # a cache of another index would give wrong (uid, off): check
        # what ties it to this one
        if (
            mindex.k == index.sbwt.get_k()
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


class _Locator:
    """dispatch at capacities: locate_at(caps) (make(caps), kept per
    caps), policy(B, L) -> (first, grow), the trace names `counted` of
    the final counters, sizes the memo. v2: the minimizer form (None in
    the other modes); min_rows: a dispatch's least rows (a mesh's dp)."""

    v2 = None
    min_rows = 1
    counted = ()

    def dispatch(self, codes: torch.Tensor):
        B, L = codes.shape
        check = Optimistic(lambda caps: self.locate_at(caps)(codes), *self.policy(B, L),
                           self.counted, self.sizes, (B, L))
        return check.out[0], check.out[1], check.verify

    def locate_at(self, caps):
        if caps not in self._locates:
            self._locates[caps] = self.make(caps)
        return self._locates[caps]


class MinimizerLocator(_Locator):
    """The minimizer locate on one device at (K_slow, K_heads).
    FINITO_MINIMIZER_V2=0/1 forces its form (pick_v2), except in
    pipeline, which, as JAX's, goes by size alone (v2_by_size)."""

    def __init__(self, index: FinimizerIndex, device, mindex_cache: str | None = None):
        self.device, self.k, self.sizes = device, index.sbwt.get_k(), {}
        self.dmi = DeviceMinimizerIndex(load_minimizer_index(index, mindex_cache), device)
        self.v2 = pick_v2(self.dmi)
        self.counted = ("slow_runs", "heads") if self.v2 else ()
        self.policy = partial(minimizer_policy, k=self.k, v2=self.v2)

    def locate_at(self, caps):
        return make_minimizer_locate_form(self.dmi, self.v2, *caps)

    def pipeline(self, batch: int, read_len: int, unknown_frac: float):
        BW = batch * (read_len - self.k + 1)
        K, K_heads = max(256, int(BW * unknown_frac)), None
        if v2_by_size(self.dmi):
            K_heads = max(1024, int(BW * (2.8 / (self.k - self.dmi.m + 2))))
            pipe = make_minimizer_locate_v2(self.dmi, K, K_heads)
        else:
            pipe = make_minimizer_locate(self.dmi, K)
        pipe.K, pipe.K_heads = K, K_heads
        return pipe


class DenseLocator(_Locator):
    """k fixed extension steps over every window, then one row gather:
    no capacity."""

    def __init__(self, index: FinimizerIndex, device):
        self.device, self.k = device, index.sbwt.get_k()
        self.dsbwt, self.loc_table = _row_tables(index, device)

    def dispatch(self, codes: torch.Tensor):
        with trace.span("kmer_ranks_fixed"):
            ranks = kmer_ranks_fixed(self.dsbwt, codes, self.k)
        return (*_ranks_to_locations(self.loc_table, ranks), None)

    def pipeline(self, batch: int, read_len: int, unknown_frac: float):
        zero = torch.zeros((), dtype=torch.int32, device=self.device)

        def pipe(codes):
            return (*self.dispatch(codes)[:2], zero)

        pipe.K, pipe.K_heads = batch * (read_len - self.k + 1), None
        return pipe


class SegmentLocator(_Locator):
    """stream (replica=False) and replica: make_two_phase's scan at (K,)
    repaired segments, then the row table (stream: dsbwt and loc_table,
    as dense) or the dictionary tail. tables: query.replica's
    two_phase_tables (stream) or replica_tables. chunk: the chain scan's
    chunk length (None = auto_chunk, 0 = whole reads)."""

    counted = ("segments",)

    def __init__(self, index: FinimizerIndex, device, replica: bool, chunk: int | None = None):
        self.device, self.k = device, index.sbwt.get_k()
        self.sizes, self._locates = {}, {}
        if replica:
            self.tables = P = replica_tables(index, device)

            def make(caps):
                return make_replica_locate_v2(index, caps[0], chunk=chunk, device=device, tables=P)
        else:
            self.dsbwt, self.loc_table = _row_tables(index, device)
            self.tables = P = two_phase_tables(index, device)

            def make(caps):
                ranks_fn = make_chain_stream_ranks(P["n8"], self.k, P["n_nodes"], caps[0], chunk)

                def locate(codes):
                    ranks, n_seg = ranks_fn(P["tab"], P["C"], P["ck"], P["jl"], P["jr"], P["edge"],
                                            codes)
                    return (*_ranks_to_locations(self.loc_table, ranks), n_seg)

                return locate

        self.make = make  # caps -> locate(codes) -> (uid, off, n_seg)
        self.policy = partial(segment_policy, k=self.k, stream=not replica)

    def pipeline(self, batch: int, read_len: int, unknown_frac: float):
        K = max(1024, int(batch * (read_len - self.k + 1) * unknown_frac))
        pipe = self.make((K,))
        pipe.K, pipe.K_heads = K, None
        return pipe


class MeshLocator(_Locator):
    """minimizer mode over a (dp, tp) mesh (JAX engine.py's locate_mesh),
    at minimizer v1's capacities: a text-sharded ShardedMinimizerIndex
    built from the unitig text and placed once; the answers land on the
    first mesh device, its device. devices: the mesh's (may repeat one),
    by default those device stands for (shard_build.shard_devices)."""

    def __init__(self, index: FinimizerIndex, shape, device, devices=None):
        from finito_tpu_torch.parallel.mesh import (
            ShardedMinimizerIndex,
            make_mesh,
            place_minimizer_shards,
        )
        from finito_tpu_torch.parallel.shard_build import shard_devices

        dp, tp = shape
        try:
            if devices is None:
                devices = shard_devices(device, dp * tp)
            self.mesh = make_mesh(dp * tp, tp=tp, devices=devices)
        except RuntimeError as e:
            raise RuntimeError(f"--mesh {dp},{tp} {e}") from None
        self.device, self.k, self.min_rows = self.mesh.devices[0, 0], index.sbwt.get_k(), dp
        self.sharded = ShardedMinimizerIndex.build(np.asarray(index.unitigs.concat, np.uint8),
                                                   np.asarray(index.unitigs.ends, np.int64),
                                                   self.k, tp=tp)
        self.tables = place_minimizer_shards(self.mesh, self.sharded)
        self.sizes, self._locates = {}, {}
        self.policy = partial(minimizer_policy, k=self.k, v2=False)

    def make(self, caps):
        from finito_tpu_torch.parallel.mesh import sharded_minimizer_locate_fn

        return sharded_minimizer_locate_fn(self.mesh, self.sharded, caps[0], tables=self.tables)

    def pipeline(self, batch: int, read_len: int, unknown_frac: float):
        raise ValueError("make_device_pipeline has no mesh form (nor has the JAX engine); "
                         "build the engine without mesh=")

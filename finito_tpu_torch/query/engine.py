"""Batched device query engines producing `search-fmin`-identical
output: counterpart of finito_tpu/query/engine.py.

DeviceQueryEngine uploads a FinimizerIndex's tables to one device, or
shards them over a (dp, tp) mesh of devices (minimizer mode,
search-fmin --mesh; parallel.mesh), and locates strand-interleaved read
batches there. Modes (search-fmin --engine):

  * "minimizer": the seed-and-verify locate of query.minimizer_engine:
    the per-window v1 form below a 64 MB slot descriptor, the
    run-deduplicated v2 form from there up (the JAX engine's rule;
    FINITO_MINIMIZER_V2=0/1 forces either, except in make_device_pipeline,
    which, as JAX's, goes by size alone);
  * "dense": a per-colex (unitig, offset) row table built at init by
    searching every unitig window (build_position_table), then per
    batch k fixed extension steps over all windows and one row gather;
  * "stream": the same row table, reached through the two-phase
    streaming ranks of ops.streaming (optimistic chain + segment repair);
  * "replica": the compact engine of query.replica, resolving positions
    through the index's own dictionaries (no per-node position table).

The forward / reverse-complement merge and a run-length encoding of its
output run on the device too (merge_rle), so the host reads back
O(runs), not O(windows). The serving split merged_pairs_flat_begin /
_end keeps the dispatch half free of capacity checks: the minimizer's
slow-path counters and the stream and replica engines' segment counts
are read in _end (the deferred verify; dense has none).
make_device_pipeline gives the bare device-resident step of every mode
(reads already on the device, fixed capacities, no readback), the step
a benchmark times.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from finito_tpu_torch.index.index import FinimizerIndex, QueryResult
from finito_tpu_torch.index.minimizer import MinimizerIndex
from finito_tpu_torch.ops.bitvec import DeviceSBWT, kmer_ranks_fixed, search_batch_device
from finito_tpu_torch.ops.bits import put_i32
from finito_tpu_torch.query.minimizer_engine import (
    DeviceMinimizerIndex,
    make_minimizer_locate,
    make_minimizer_locate_v2,
)
from finito_tpu_torch.query.minimizer_tables import grow_capacities, initial_capacities
from finito_tpu_torch.utils import trace

MODES = ("minimizer", "dense", "stream", "replica")

# v2 from this descriptor size up: the JAX engine's threshold
# (finito_tpu/query/engine.py), which is also its slot-row cap
V2_MIN_DESC_BYTES = 64 << 20


def v2_by_size(dmi: DeviceMinimizerIndex) -> bool:
    """v2 from a V2_MIN_DESC_BYTES descriptor up: make_device_pipeline's
    rule, as in the JAX engine; no variable overrides it."""
    return dmi.desc.numel() * dmi.desc.element_size() >= V2_MIN_DESC_BYTES


def pick_v2(dmi: DeviceMinimizerIndex) -> bool:
    """Whether the engine's and kmer-mapper's locate takes the v2 form:
    FINITO_MINIMIZER_V2=0/1 forces it, else v2_by_size."""
    forced = os.environ.get("FINITO_MINIMIZER_V2")
    if forced in ("0", "1"):
        return forced == "1"
    return v2_by_size(dmi)


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


def _locate_dense(dsbwt: DeviceSBWT, loc_table: torch.Tensor, codes: torch.Tensor, k: int):
    """(B, L) codes -> ((B, W) unitig ids, (B, W) offsets); -1 for absent."""
    with trace.span("kmer_ranks_fixed"):
        ranks = kmer_ranks_fixed(dsbwt, codes, k)
    return _ranks_to_locations(loc_table, ranks)


def _pad_codes(codes: np.ndarray, min_rows: int = 1) -> np.ndarray:
    """Shape bucketing: L up to a multiple of 128 (at least 128), B up to
    a power of two and at least min_rows (a mesh's dp, so that a chunk of
    1-2 reads still splits over dp), padding with 255 (invalid, so padded
    windows are absent)."""
    B, L = codes.shape
    L_pad = max(128, -(-L // 128) * 128)
    B_pad = max(1 << max(0, (B - 1).bit_length()), min_rows)
    if (B_pad, L_pad) == (B, L):
        return codes
    padded = np.full((B_pad, L_pad), 255, dtype=np.uint8)
    padded[:B, :L] = codes
    return padded


class DeviceQueryEngine:
    """Batched (unitig, offset) localization over a loaded FinimizerIndex
    on one torch device, in one of MODES (``use_v2`` names the minimizer
    locate form; None in the other modes)."""

    def __init__(self, index: FinimizerIndex, mode: str = "minimizer", device="cuda",
                 mesh=None, devices=None, mindex_cache: str | None = None,
                 chunk: int | None = None):
        """device: where the tables live and the locate runs ("cuda",
        "cuda:1", "cpu"). mesh: optional (dp, tp); with dp * tp > 1
        (minimizer mode only) the locate runs sharded over a (dp, tp)
        mesh (_init_mesh), with the same output. devices: the mesh's
        devices (may repeat one); by default those that device stands for
        (parallel.shard_build.shard_devices: "cpu" or a named card such
        as "cuda:0" holds every shard, "cuda" takes dp * tp cards).
        mindex_cache (minimizer mode): optional path; the derived
        MinimizerIndex is loaded from it when it matches this index and
        serialized to it after a build. chunk (stream and replica): the
        chain scan's chunk length (ops.streaming chunk_reads); None =
        auto_chunk, 0 = whole reads."""
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r} (one of {', '.join(MODES)})")
        self.device = torch.device(device)
        self.mode = mode
        self.k = index.sbwt.get_k()
        # the process-wide tally of utils.trace, reset by each search-fmin query file
        self.trace_ms, self.trace_counts = trace.ms, trace.counts
        self.use_v2 = None
        self.mesh_shape = tuple(mesh) if mesh and int(np.prod(mesh)) > 1 else None
        if self.mesh_shape:
            if mode != "minimizer":
                raise ValueError("--mesh requires the minimizer engine")
            self._init_mesh(index, devices)
            return
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        # (B, W) -> last sufficient (K_slow, K_heads) (minimizer);
        # (B, L) -> last sufficient segment capacity (stream, replica)
        self._sizes = {}
        if mode == "minimizer":
            self._dmi = DeviceMinimizerIndex(self._minimizer_index(index, mindex_cache),
                                             self.device)
            self.use_v2 = pick_v2(self._dmi)
            self._locate_async = self._locate_minimizer_async
            return
        self._segment_locates = {}  # K -> locate(codes) -> (uid, off, n_seg)
        self._locate_async = self._locate_segments_async
        if mode == "replica":
            from finito_tpu_torch.query.replica import make_replica_locate_v2, replica_tables

            self._replica_tables = tables = replica_tables(index, self.device)
            self._make_segment_locate = lambda K: make_replica_locate_v2(
                index, K, chunk=chunk, device=self.device, tables=tables)
            return
        self.dsbwt = DeviceSBWT.from_host(index.sbwt, self.device)
        self.loc_table = build_locate_tables(
            build_position_table(self.dsbwt, index.unitigs.concat, index.unitigs.ends),
            put_i32(index.unitigs.ends, self.device), self.k)
        if mode == "dense":
            self._locate_async = lambda codes: (
                *_locate_dense(self.dsbwt, self.loc_table, codes, self.k), None)
            return
        from finito_tpu_torch.ops.rank24 import (
            build_contract_k_table,
            build_edge_table,
            build_lcs_jump_tables,
            build_rank24_tables,
        )
        from finito_tpu_torch.ops.streaming import make_chain_stream_ranks

        bit_rows = index.sbwt.bit_rows()
        tab = build_rank24_tables(bit_rows)
        ck = build_contract_k_table(index.LCS, self.k)
        jl, jr = build_lcs_jump_tables(index.LCS)
        edge = build_edge_table(bit_rows, index.sbwt.get_C_array(), ck)
        # (tab, C, ck, jl, jr, edge): make_chain_stream_ranks's tables
        self._stream_tables = tables = [put_i32(a, self.device)
                                        for a in (tab, index.sbwt.get_C_array(), ck, jl, jr, edge)]
        self._n8 = n8 = tab.shape[0] // 4
        k, n_nodes = self.k, index.sbwt.number_of_subsets()

        def make_stream(K):
            ranks_fn = make_chain_stream_ranks(n8, k, n_nodes, K, chunk=chunk)

            def locate(codes):
                ranks, n_seg = ranks_fn(*tables, codes)
                return (*_ranks_to_locations(self.loc_table, ranks), n_seg)

            return locate

        self._make_segment_locate = make_stream

    def _init_mesh(self, index: FinimizerIndex, devices):
        """The mesh mode (JAX engine.py's locate_mesh): a text-sharded
        ShardedMinimizerIndex built straight from the unitig text (no
        single-host minimizer index), placed on the mesh once; merge_rle
        and the readback run on the first mesh device."""
        from finito_tpu_torch.parallel.mesh import (
            ShardedMinimizerIndex,
            make_mesh,
            place_minimizer_shards,
        )
        from finito_tpu_torch.parallel.shard_build import shard_devices

        dp, tp = self.mesh_shape
        try:
            if devices is None:
                devices = shard_devices(self.device, dp * tp)
            self.mesh = make_mesh(dp * tp, tp=tp, devices=devices)
        except RuntimeError as e:
            raise RuntimeError(f"--mesh {dp},{tp} {e}") from None
        self.device = self.mesh.devices[0, 0]
        self._sharded = ShardedMinimizerIndex.build(
            np.asarray(index.unitigs.concat, np.uint8),
            np.asarray(index.unitigs.ends, np.int64),
            self.k,
            tp=tp,
        )
        self._mesh_tables = place_minimizer_shards(self.mesh, self._sharded)
        self._mesh_locates = {}  # K_slow -> sharded_minimizer_locate_fn
        self._locate_async = self._locate_mesh_async

    def _mesh_locate(self, K: int):
        from finito_tpu_torch.parallel.mesh import sharded_minimizer_locate_fn

        if K not in self._mesh_locates:
            self._mesh_locates[K] = sharded_minimizer_locate_fn(
                self.mesh, self._sharded, K, tables=self._mesh_tables)
        return self._mesh_locates[K]

    def _locate_mesh_async(self, codes: torch.Tensor):
        """The mesh locate with JAX's capacity rule: B divisible by dp
        (_pad_codes pads B to at least dp, where JAX raises),
        first K = max(256, B*W/32), and a run whose n_slow exceeds K
        redone at 4x K up to B*W; the check is deferred to verify(), as
        in _locate_minimizer_async."""
        B, L = codes.shape
        W = L - self.k + 1
        K = max(256, (B * W) // 32)
        first = self._mesh_locate(K)(codes)

        def verify(K=K):
            out = first
            while trace.host_read("verify", lambda: int(out[2])) > K:
                if K >= B * W:
                    raise AssertionError("slow-path overflow at K == B*W")
                K = min(B * W, K * 4)
                out = self._mesh_locate(K)(codes)
            return None if out is first else (out[0], out[1])

        return first[0], first[1], verify

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

    def _locate_minimizer_async(self, codes: torch.Tensor):
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
                n_slow, n_heads = trace.host_read(
                    "verify", lambda: torch.stack(out[2:4]).tolist() if self.use_v2
                    else (int(out[2]), 0))
                grown = grow_capacities(K, KH, n_slow, n_heads, B * W)
                if grown is None:
                    if self.use_v2:
                        trace.count("slow_runs", n_slow)
                        trace.count("heads", n_heads)
                    self._sizes[(B, W)] = (K, KH)
                    return None if out is first else (out[0], out[1])
                K, KH = grown
                out = self._dispatch(codes, K, KH)

        return first[0], first[1], verify

    def _segment_locate(self, K: int):
        if K not in self._segment_locates:
            self._segment_locates[K] = self._make_segment_locate(K)
        return self._segment_locates[K]

    def _locate_segments_async(self, codes: torch.Tensor):
        """The stream and replica engines' dispatch with the deferred
        segment-capacity check (the contract of _locate_minimizer_async):
        K repaired segments, first max(1024, B*W/64) (stream) or
        max(1024, B*W/16) (replica), then the last sufficient K for the
        shape; verify() reads n_seg and re-runs at 4x K while it
        exceeds K, up to B*W (stream) or B*L (replica), the JAX
        engine's bounds. FINITO_MIN_K0 forces the first K, as in
        minimizer mode."""
        B, L = codes.shape
        W = L - self.k + 1
        stream = self.mode == "stream"
        cap = B * W if stream else B * L
        K = self._sizes.get((B, L)) or max(1024, (B * W) // (64 if stream else 16))
        k0 = int(os.environ.get("FINITO_MIN_K0", "0"))
        if k0 > 0:  # tests: force the overflow/verify path
            K = k0
            self._sizes.pop((B, L), None)
        first = self._segment_locate(K)(codes)

        def verify(K=K):
            out = first
            while (n_seg := trace.host_read("verify", lambda: int(out[2]))) > K:
                if K >= cap:
                    raise AssertionError(f"segment overflow at K == {cap}")
                K = min(cap, K * 4)
                out = self._segment_locate(K)(codes)
            trace.count("segments", n_seg)
            self._sizes[(B, L)] = K
            return None if out is first else (out[0], out[1])

        return first[0], first[1], verify

    def make_device_pipeline(self, batch: int, read_len: int, unknown_frac: float = 0.5):
        """The device-resident query step (the JAX engine's
        make_device_pipeline): pipe(codes), for (batch, read_len) uint8
        codes already on this engine's device, returns device tensors
        (uid, off, n_unknown[, n_heads]), with no padding, bucketing,
        host copy or re-run. Results are valid only when n_unknown <=
        pipe.K (and n_heads <= pipe.K_heads when that is set); the caller
        re-sizes through unknown_frac. JAX's capacities, W = read_len - k + 1:
          minimizer: K = max(256, B*W*frac) slow windows (v1) or slow runs
            (v2, as v2_by_size decides: FINITO_MINIMIZER_V2 is the
            engine's, not the pipeline's), K_heads = max(1024, B*W*2.8/(k-m+2))
            run heads in v2, None in v1;
          dense: n_unknown is 0 and K = B*W;
          stream, replica: K = max(1024, B*W*frac) repair segments.
        The pipeline adds no host read: the minimizer locates read their
        slow-path trip count, the stream and replica repairs their
        straggler flags."""
        if self.mesh_shape:
            raise ValueError("make_device_pipeline has no mesh form (nor has the JAX engine); "
                             "build the engine without mesh=")
        BW = batch * (read_len - self.k + 1)
        K_heads = None
        if self.mode == "minimizer":
            K = max(256, int(BW * unknown_frac))
            if v2_by_size(self._dmi):
                K_heads = max(1024, int(BW * (2.8 / (self.k - self._dmi.m + 2))))
                pipe = make_minimizer_locate_v2(self._dmi, K, K_heads)
            else:
                pipe = make_minimizer_locate(self._dmi, K)
        elif self.mode == "dense":
            K = BW
            zero = torch.zeros((), dtype=torch.int32, device=self.device)

            def pipe(codes):
                return (*_locate_dense(self.dsbwt, self.loc_table, codes, self.k), zero)
        else:
            K = max(1024, int(BW * unknown_frac))
            pipe = self._make_segment_locate(K)
        pipe.K, pipe.K_heads = K, K_heads
        return pipe

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
        and the (B, W) slice applies at readback. verify is None when
        the mode has nothing to check (dense)."""
        B, L = codes.shape
        with trace.span("query.locate", trace.dispatching()):
            padded = _pad_codes(codes, self.mesh_shape[0] if self.mesh_shape else 1)
            uid, off, verify = self._locate_async(self._to_device(padded))
        return uid, off, B, L - self.k + 1, verify

    def locate_batch_async(self, codes: np.ndarray):
        """locate_batch without the readback of the answers: returns
        (uid_dev, off_dev, B, W), device tensors padded as dispatched
        (the (B, W) slice applies at readback), for callers that chain
        more device work. The capacity check runs here (its counters are
        the only host read), so the tensors are final."""
        uid, off, B, W, verify = self._locate_batch_deferred(codes)
        fixed = verify() if verify is not None else None
        if fixed is not None:
            uid, off = fixed
        return uid, off, B, W

    def locate_batch(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """codes: (B, L) uint8 (pad with 255), L >= k. Returns (B, W) unitig
        ids and offsets, -1 where the k-mer is absent/invalid."""
        uid, off, B, W = self.locate_batch_async(codes)
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
        from finito_tpu_torch.io.seqdb import encode_seq

        k = self.k
        chunk = trace.dispatching()
        batch_idx: List[int] = []
        batch_codes: List[np.ndarray] = []
        with trace.span("query.encode", chunk):
            with trace.span("query.encode_seq", chunk):
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

    def _batch_both_strands(self, reads: Sequence[bytes]):
        """_encode_both_strands, then locate_batch: (batch_idx,
        batch_codes, uid_b, off_b), uid_b and off_b None when every read
        was filtered."""
        batch_idx, batch_codes, both = self._encode_both_strands(reads)
        if both is None:
            return batch_idx, batch_codes, None, None
        uid_b, off_b = self.locate_batch(both)
        return batch_idx, batch_codes, uid_b, off_b

    def locate_reads_arrays(self, reads: Sequence[bytes]):
        """Per read, None (a short or non-ACGT read: empty result) or
        (uid_f, off_f, uid_r, off_r, n_found_f, n_found_r), the (W,)
        arrays of the forward strand and of the reverse complement."""
        k = self.k
        out = [None] * len(reads)
        batch_idx, batch_codes, uid_b, off_b = self._batch_both_strands(reads)
        if uid_b is not None:
            for j, i in enumerate(batch_idx):
                n = batch_codes[j].size - k + 1
                uf, of = uid_b[2 * j, :n], off_b[2 * j, :n]
                ur, orr = uid_b[2 * j + 1, :n], off_b[2 * j + 1, :n]
                out[i] = (uf, of, ur, orr,
                          int(np.count_nonzero(uf >= 0)), int(np.count_nonzero(ur >= 0)))
        return out

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
        chunk = trace.new_chunk(len(reads))
        line_lens = np.zeros(len(reads), np.int64)
        batch_idx, batch_codes, both = self._encode_both_strands(reads)
        if both is None:
            return (line_lens, None)
        uid_d, off_d, _, _, verify = self._locate_batch_deferred(both)
        with trace.span("query.merge", chunk):
            # the window counts wait for the locate's dispatch: the card
            # starts on it while the host computes them
            lens = np.array([c.size - k + 1 for c in batch_codes], dtype=np.int64)
            line_lens[np.asarray(batch_idx, dtype=np.int64)] = lens
            B2, Wp = uid_d.shape
            lens_pad = np.zeros(B2 // 2, np.int32)
            lens_pad[: len(batch_codes)] = lens
            lens_d = self._to_device(lens_pad)
            K = int(min((B2 // 2) * Wp, max(4096, 16 * (B2 // 2))))
            out = merge_rle(uid_d, off_d, lens_d, K)
        return (line_lens, (batch_codes, lens, uid_d, off_d, K, out, verify, lens_d, chunk))

    def merged_pairs_flat_end(self, handle):
        """Readback half: the deferred verify, then an O(runs) transfer
        and host re-expansion (or the full-window host merge when the
        runs overflow their capacity)."""
        line_lens, rest = handle
        if rest is None:
            z = np.zeros(0, np.int32)
            return line_lens, z, z, 0, 0
        (batch_codes, lens, uid_d, off_d, K, out, verify, lens_d, chunk) = rest
        with trace.span("query.verify", chunk):
            fixed = verify() if verify is not None else None
            if fixed is not None:
                # capacity overflow: the optimistic locate and the merge
                # chained on it were invalid; redo both exactly
                trace.count("capacity_reruns")
                uid_d, off_d = fixed
                out = merge_rle(uid_d, off_d, lens_d, K)
        u0d, p0d, p1d, rld, stats = out
        with trace.span("query.readback", chunk):
            n_runs, kf, kr = (int(x) for x in trace.host_read("stats", lambda: stats.cpu().tolist()))
            trace.count("runs", n_runs)
            if n_runs > K:
                uid_b = trace.host_read("host_merge", lambda: uid_d.cpu().numpy())
                off_b = trace.host_read("host_merge", lambda: off_d.cpu().numpy())
            else:
                runs = trace.host_read(
                    "runs", lambda: torch.stack([u0d, p0d, p1d, rld])[:, :n_runs].cpu().numpy())
        if n_runs > K:
            return self._merged_pairs_host(line_lens, batch_codes, lens, uid_b, off_b, chunk)
        with trace.span("query.expand", chunk):
            u0, p0, p1 = runs[0], runs[1], runs[2]
            rl = runs[3].astype(np.int64)
            total = int(rl.sum())
            starts = np.cumsum(rl) - rl
            u = np.repeat(u0, rl)
            step = np.sign(p1.astype(np.int64) - p0)
            off_in = np.arange(total, dtype=np.int64) - np.repeat(starts, rl)
            p = np.repeat(p0.astype(np.int64), rl) + np.repeat(step, rl) * off_in
        return line_lens, u.astype(np.int32), p.astype(np.int32), kf, kr

    def _merged_pairs_host(self, line_lens, batch_codes, lens, uid_b, off_b, chunk=None):
        """Full-window host merge: the fallback when runs overflow, and
        the arbiter the device RLE path is tested against."""
        trace.count("host_merges")
        with trace.span("query.host_merge", chunk):
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
        batch_idx, batch_codes, uid_b, off_b = self._batch_both_strands(reads)
        if uid_b is None:
            return results
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

"""Batched device query engine producing `search-fmin`-identical output:
counterpart of finito_tpu/query/engine.py.

DeviceQueryEngine is the host shell around one locator of
query.locators, the mode's device tables on one device or over a (dp,
tp) mesh (search-fmin --engine, --mesh). The shell encodes a chunk's
reads, both strands interleaved, buckets and uploads them, and merges
the strands on the device with a run-length encoding of the output
(merge_rle), so the host reads back O(runs), not O(windows). The
serving split merged_pairs_flat_begin / _end keeps the dispatch half
free of capacity checks: the locator's verify runs in _end.
make_device_pipeline gives the bare device-resident step of every mode,
the step a benchmark times.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from finito_tpu_torch.index.index import FinimizerIndex, QueryResult
from finito_tpu_torch.query.locators import (
    DenseLocator,
    MeshLocator,
    MinimizerLocator,
    SegmentLocator,
)
from finito_tpu_torch.utils import trace

MODES = ("minimizer", "dense", "stream", "replica")


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


def padded_shape(B: int, L: int, min_rows: int = 1) -> Tuple[int, int]:
    """The shape bucket of a (B, L) batch: L up to a multiple of 128 (at
    least 128), B up to a power of two and at least min_rows (a mesh's
    dp, so that a chunk of 1-2 reads still splits over dp)."""
    return max(1 << max(0, (B - 1).bit_length()), min_rows), max(128, -(-L // 128) * 128)


def _pad_codes(codes: np.ndarray, min_rows: int = 1) -> np.ndarray:
    """Shape bucketing (padded_shape), padding with 255 (invalid, so
    padded windows are absent)."""
    B, L = codes.shape
    B_pad, L_pad = padded_shape(B, L, min_rows)
    if (B_pad, L_pad) == (B, L):
        return codes
    padded = np.full((B_pad, L_pad), 255, dtype=np.uint8)
    padded[:B, :L] = codes
    return padded


class DeviceQueryEngine:
    """Batched (unitig, offset) localization over a loaded FinimizerIndex
    on one torch device, in one of MODES: the host shell around
    `locator` (query.locators). ``use_v2`` names the minimizer locate
    form (None in the other modes and on a mesh)."""

    def __init__(self, index: FinimizerIndex, mode: str = "minimizer", device="cuda",
                 mesh=None, devices=None, mindex_cache: str | None = None,
                 chunk: int | None = None):
        """device: where the tables live and the locate runs ("cuda",
        "cuda:1", "cpu"). mesh: optional (dp, tp); with dp * tp > 1
        (minimizer mode only) the locate runs sharded over a (dp, tp)
        mesh (query.locators.MeshLocator), with the same output.
        devices: the mesh's devices (may repeat one); by default those
        that device stands for (parallel.shard_build.shard_devices: "cpu"
        or a named card such as "cuda:0" holds every shard, "cuda" takes
        dp * tp cards). mindex_cache (minimizer mode): optional path; the
        derived MinimizerIndex is loaded from it when it matches this
        index and serialized to it after a build. chunk (stream and
        replica): the chain scan's chunk length (ops.streaming
        chunk_reads); None = auto_chunk, 0 = whole reads."""
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r} (one of {', '.join(MODES)})")
        self.mode = mode
        self.k = index.sbwt.get_k()
        # the process-wide tally of utils.trace, reset by each search-fmin query file
        self.trace_ms, self.trace_counts = trace.ms, trace.counts
        self.mesh_shape = tuple(mesh) if mesh and int(np.prod(mesh)) > 1 else None
        device = torch.device(device)
        if self.mesh_shape:
            if mode != "minimizer":
                raise ValueError("--mesh requires the minimizer engine")
            self.locator = MeshLocator(index, self.mesh_shape, device, devices)
        elif device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available")
        elif mode == "minimizer":
            self.locator = MinimizerLocator(index, device, mindex_cache)
        elif mode == "dense":
            self.locator = DenseLocator(index, device)
        else:
            self.locator = SegmentLocator(index, device, mode == "replica", chunk)
        self.device, self.use_v2 = self.locator.device, self.locator.v2
        # the minimizer tables (None in the other modes), whose m the benchmark reads
        self._dmi = getattr(self.locator, "dmi", None)

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
        The pipeline adds no host read beyond its locate's own: the
        minimizer locates read their slow-path trip count, and on the CPU
        the stream and replica repairs read their straggler flags. A mesh
        engine raises."""
        return self.locator.pipeline(batch, read_len, unknown_frac)

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
            padded = _pad_codes(codes, self.locator.min_rows)
            uid, off, verify = self.locator.dispatch(self._to_device(padded))
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
            # the padded dispatch's window slots against the windows of its
            # reads, both strands: what the shape bucket costs
            trace.count("window_slots", B2 * Wp)
            trace.count("windows", 2 * int(lens.sum()))
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
            trace.count("host_merge_windows", 2 * total)  # both strands, as `windows`
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

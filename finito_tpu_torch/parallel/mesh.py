"""Multi-device scale-out of the query path: (dp, tp) sharding, the
counterpart of finito_tpu/parallel/mesh.py. ShardedIndex.build takes
the index that the mesh build (parallel.shard_build) produces.

  * dp ("data parallel"): query reads are sharded along the batch axis.
  * tp ("table parallel"): the index is sharded. For the SBWT locate
    the colex axis -- the four bitvectors, their rank blocks and the
    (unitig, offset) table -- splits into contiguous word-aligned
    ranges. Because rank is a prefix sum, a global rank is a sum of
    clamped shard-local ranks:

        rank_c(i) = sum_shards rank_c^local(clip(i - start_s, 0, n_s))

    For the minimizer locate the unitig text splits into contiguous
    ranges, each with its own complete minimizer index.

The JAX package runs each locate as one shard_map program over a mesh
of devices. Here a Mesh is a (dp, tp) grid of torch devices, each held
by one process (Mesh.owners), the per-shard work is issued shard after
shard from Python, and each process runs only the shards its own
devices hold. In one process the collectives are plain tensor moves: a
psum or pmax over tp is a sum or max of the shards' tensors moved to the
dp row's first device, an all_gather a torch.cat, a ppermute a move. A
grid may repeat one device (JAX's tests use 8 virtual CPU devices the
same way); each shard's tables are then placed on that device once, not
once per dp row. A mesh over distributed.global_devices spans processes
(JAX's global mesh): the psum of a dp row sums the local shards' parts,
then takes one dist.all_reduce over the row's processes (one process
group a row, made with the mesh); the rows are all-gathered so that
every rank gets the whole answer, as JAX's replicated output; the LCS
label column is all-gathered each round. These go through
parallel.shard_build's collectives layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from finito_tpu_torch.ops.bits import popcount32, put_i32, slot32, u32
from finito_tpu_torch.ops.lcs_device import first_labels, lcs_scatter_indices
from finito_tpu_torch.ops.minimizer_front import minimizer_windows
from finito_tpu_torch.ops.streaming import compact_mask
from finito_tpu_torch.parallel.distributed import Devices
from finito_tpu_torch.parallel.shard_build import (
    _all_gather,
    _all_reduce,
    _host,
    _move,
    flat_devices,
)
from finito_tpu_torch.query.minimizer_engine import (
    _match_text_kmer,
    _match_text_kmer_rows,
    _match_text_kmer_rows8,
    _scatter_drop,
    _word_masks,
)
from finito_tpu_torch.utils import trace


class Mesh:
    """A grid of torch devices with named axes: ``devices`` is an object
    array of torch.device, (dp, tp) with axis_names ("dp", "tp"). The
    grid may repeat a device. flat: the grid flattened as a
    distributed.Devices, which names the process holding each entry
    (owners: the same, as a grid; all this process's by default). Where
    a dp row spans processes it gets a process group, made here (every
    rank makes the mesh together)."""

    def __init__(self, devices: np.ndarray, axis_names=("dp", "tp"), flat: Devices = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.flat = Devices(devices.reshape(-1)) if flat is None else flat
        self.owners = np.asarray(self.flat.owners).reshape(devices.shape)
        self.rank = self.flat.rank
        self.row_groups = [None] * devices.shape[0]
        if self.flat.spans:
            import torch.distributed as dist

            for i in range(devices.shape[0]):
                ranks = sorted(set(self.owners[i].tolist()))
                if len(ranks) > 1:  # every rank makes every group, in order
                    group = dist.new_group(ranks)
                    self.row_groups[i] = group if self.rank in ranks else None

    def local(self, i: int) -> list:
        """The tp indices of row i that this process holds."""
        return [j for j in range(self.devices.shape[1]) if self.owners[i, j] == self.rank]

    @property
    def out_device(self) -> torch.device:
        """Where a locate's answer lands: this process's first device."""
        return self.flat[self.flat.local[0]]


def make_mesh(n_devices: int, tp: int = 2, devices=None) -> Mesh:
    """A (dp, tp) mesh of n_devices devices: the given ``devices`` (which
    may repeat one device; a distributed.global_devices list makes a
    mesh that spans processes), else the first n_devices visible CUDA
    devices. tp falls back to 1 when it does not divide n_devices (the
    JAX package's rule)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        pool = Devices([torch.device("cuda", i) for i in range(n)])
    else:
        pool = devices if isinstance(devices, Devices) else Devices(devices)
    if len(pool) < n_devices:
        raise RuntimeError(f"needs {n_devices} devices, found {len(pool)}")
    if n_devices % tp != 0:
        tp = 1
    flat = Devices(pool[:n_devices], pool.owners[:n_devices], pool.rank, pool.backend)
    grid = np.empty(n_devices, dtype=object)
    grid[:] = list(flat)
    return Mesh(grid.reshape(n_devices // tp, tp), flat=flat)


def _place(mesh: Mesh, shard_tables: list) -> np.ndarray:
    """shard_tables[j]: name -> numpy table of tp shard j. Returns a
    (dp, tp) object grid of name -> int32 tensor on that shard's device,
    for the entries this process holds (None for the others); a shard's
    tables are moved to each distinct local device once (keyed by shard
    and device: another process's equal device name is another
    device)."""
    placed, grid = {}, np.empty(mesh.devices.shape, dtype=object)
    for (i, j), dev in np.ndenumerate(mesh.devices):
        if mesh.owners[i, j] != mesh.rank:
            continue
        if (j, dev) not in placed:
            placed[(j, dev)] = {name: put_i32(a, dev) for name, a in shard_tables[j].items()}
        grid[i, j] = placed[(j, dev)]
    return grid


def _psum(mesh: Mesh, i: int, parts, device):
    """lax.psum over tp in dp row i: the local shards' parts summed on
    device, then summed over the row's processes."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    if mesh.row_groups[i] is not None:
        out = _all_reduce(mesh.flat, out, group=mesh.row_groups[i])
    return out


def _gather_rows(mesh: Mesh, rows: dict, out_dev) -> torch.Tensor:
    """The (B, ...) answer from each dp row's (B/dp, ...) part (rows: i
    -> part, for the rows this process takes part in), whole on every
    rank: where some row lacks a process, the rows are all-gathered,
    each from its lowest rank."""
    dp = mesh.devices.shape[0]
    everyone = set(mesh.flat.owners)
    if all(set(mesh.owners[i].tolist()) == everyone for i in range(dp)):
        return torch.cat([rows[i].to(out_dev) for i in range(dp)])
    leaders = [int(mesh.owners[i].min()) for i in range(dp)]
    like = next(iter(rows.values()))
    got = _all_gather(mesh.flat, [rows[i] if leaders[i] == mesh.rank else None for i in range(dp)],
                      owners=leaders, like=(tuple(like.shape), like.dtype))
    return torch.cat([rows[i].to(out_dev) if i in rows else _move(mesh.flat, got[i], out_dev)
                      for i in range(dp)])


def _codes(codes) -> torch.Tensor:
    return codes if isinstance(codes, torch.Tensor) else torch.from_numpy(np.asarray(codes))


def _dp_rows(mesh: Mesh, codes: torch.Tensor):
    """The batch split over dp, for the rows with a shard this process
    holds: (row index, row device: its first local device, that row's
    codes on it)."""
    dp = mesh.devices.shape[0]
    B = codes.shape[0]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    Bd = B // dp
    out = []
    for i in range(dp):
        mine = mesh.local(i)
        if mine:
            rd = mesh.devices[i, mine[0]]
            out.append((i, rd, codes[i * Bd : (i + 1) * Bd].to(rd)))
    return out


@dataclass
class ShardedIndex:
    """Host-side container of per-shard arrays, stacked on a leading tp axis."""

    words: np.ndarray  # (tp, 4, words_per_shard) uint32
    blocks: np.ndarray  # (tp, 4, words_per_shard) int32  (shard-local cumsum)
    loc_table: np.ndarray  # (tp, nodes_per_shard, 2) int32 (unitig id, offset), -1 dummy
    node_start: np.ndarray  # (tp,) int32 first colex rank of each shard
    C: np.ndarray  # (4,) int32
    ends: np.ndarray  # (n_unitigs,) int32 (replicated; small)
    k: int
    n_nodes: int
    words_per_shard: int
    nodes_per_shard: int

    @staticmethod
    def from_index(index, pos_table, tp: int) -> "ShardedIndex":
        """Shard a loaded FinimizerIndex over tp, given its dense
        per-colex position table (query.locators.build_position_table; a
        tensor or a numpy array)."""
        if isinstance(pos_table, torch.Tensor):
            pos_table = pos_table.cpu().numpy()
        g_end = np.asarray(pos_table, dtype=np.int64)
        return ShardedIndex._shard(index, tp, lambda lo, hi: g_end[lo:hi])

    @staticmethod
    def build(index, tp: int) -> "ShardedIndex":
        """Shard-local construction from a mesh-built index
        (parallel.shard_build.sharded_index_build): the per-colex dense
        position slices came out of the mesh finimizer routing
        (index.mesh_pos), so unlike from_index no position table is built
        on one device. Equals from_index on the same index."""
        if getattr(index, "mesh_pos", None) is None:
            raise ValueError(
                "ShardedIndex.build needs a mesh-built index "
                "(sharded_index_build attaches index.mesh_pos); for a "
                "loaded index use from_index with a dense pos_table"
            )
        pos_shards, Mn = index.mesh_pos

        def pos_range(lo: int, hi: int) -> np.ndarray:
            """g_end of colex range [lo, hi) out of the width-Mn mesh
            blocks (no full-length concatenation)."""
            out = np.full(hi - lo, -1, np.int64)
            i = lo
            while i < hi:
                s = i // Mn
                a = i - s * Mn
                b = min(Mn, a + (hi - i))
                out[i - lo : i - lo + (b - a)] = pos_shards[s][a:b]
                i += b - a
            return out

        return ShardedIndex._shard(index, tp, pos_range)

    @staticmethod
    def _shard(index, tp: int, pos_range) -> "ShardedIndex":
        """The shards of from_index and build, one target shard at a
        time; pos_range(lo, hi) -> the global window end of each colex
        rank in [lo, hi) (-1 for dummies). The per-colex (uid, offset)
        is resolved here on the host: 2 gathers a k-mer in the locate
        instead of a searchsorted."""
        from finito_tpu_torch.utils.bits import pack_bits

        sbwt = index.sbwt
        n = sbwt.number_of_subsets()
        k = sbwt.get_k()
        ends64 = np.asarray(index.unitigs.ends, dtype=np.int64)
        bit_rows = sbwt.bit_rows()
        nodes_per_shard = -(-n // (32 * tp)) * 32  # word-aligned shard width
        words_per_shard = nodes_per_shard // 32
        words = np.zeros((tp, 4, words_per_shard), dtype=np.uint32)
        blocks = np.zeros((tp, 4, words_per_shard), dtype=np.int32)
        loc_sh = np.full((tp, nodes_per_shard, 2), -1, dtype=np.int32)
        node_start = np.zeros(tp, dtype=np.int32)
        for s in range(tp):
            lo = s * nodes_per_shard
            hi = min(n, lo + nodes_per_shard)
            node_start[s] = lo
            if lo >= n:
                continue
            for c in range(4):
                w64 = pack_bits(bit_rows[c, lo:hi])
                w32 = w64.view(np.uint32)[:words_per_shard]
                words[s, c, : w32.size] = w32
                pc = np.bitwise_count(words[s, c]).astype(np.int64)
                blocks[s, c, 1:] = np.cumsum(pc[:-1])
            g_end = pos_range(lo, hi)
            found = g_end >= 0
            g_start = g_end - k + 1
            uid = np.searchsorted(ends64, g_start, side="right").astype(np.int32)
            u_start = np.where(uid > 0, ends64[np.maximum(uid - 1, 0)], 0)
            off = (g_start - u_start).astype(np.int32)
            loc_sh[s, : hi - lo, 0] = np.where(found, uid, -1)
            loc_sh[s, : hi - lo, 1] = np.where(found, off, -1)
        return ShardedIndex(
            words=words,
            blocks=blocks,
            loc_table=loc_sh,
            node_start=node_start,
            C=np.asarray(sbwt.get_C_array(), dtype=np.int32),
            ends=np.asarray(index.unitigs.ends, dtype=np.int32),
            k=k,
            n_nodes=n,
            words_per_shard=words_per_shard,
            nodes_per_shard=nodes_per_shard,
        )


def _local_rank(words, blocks, c, local_i):
    """rank within one shard; local_i already clipped to
    [0, nodes_per_shard]. words: (4, n_words) int32 bit patterns."""
    n_words = words.shape[-1]
    local_i = local_i.to(torch.int64)
    w = local_i >> 5
    b = local_i & 31
    # one pad word: clamp w to n_words-1 and count the whole word when
    # local_i is at the end
    at_end = w >= n_words
    flat = c.to(torch.int64) * n_words + w.clamp(max=n_words - 1)
    word = u32(words.reshape(-1)[flat])
    blk = blocks.reshape(-1)[flat]
    partial_pc = popcount32(word & ((1 << b) - 1))
    full_pc = popcount32(word)
    return torch.where(at_end, blk + full_pc, blk + partial_pc).to(torch.int32)


def sharded_locate_fn(mesh: Mesh, sh: ShardedIndex):
    """The SBWT locate over (dp, tp): returns call((B, L) codes) ->
    ((B, W) uid, (B, W) off) int32 on mesh.out_device (the first mesh
    device in one process; on every rank, whole, across processes).
    Every rank of the k extension steps is a psum over tp of clamped
    shard-local ranks, and the (uid, off) gather a psum of the owner
    shard's row (the others contribute 0; a found-but-dummy rank sums to
    -1)."""
    k, n_nodes, nps = sh.k, sh.n_nodes, sh.nodes_per_shard
    dp, tp = mesh.devices.shape
    if tp != sh.words.shape[0]:
        raise ValueError(f"the mesh has tp={tp}, the index {sh.words.shape[0]} shards")
    tables = _place(mesh, [{"words": sh.words[j], "blocks": sh.blocks[j], "loc": sh.loc_table[j]}
                           for j in range(tp)])
    starts = [int(s) for s in sh.node_start]
    C = {}

    def locate_row(i, rd, codes):
        row = [(mesh.devices[i, j], tables[i, j], starts[j]) for j in mesh.local(i)]
        if rd not in C:
            C[rd] = put_i32(sh.C, rd)

        def rank_g(c, pos):
            return _psum(mesh, i, [_local_rank(t["words"], t["blocks"], c.to(dev),
                                      (pos.to(dev) - start).clamp(0, nps))
                          for dev, t, start in row], rd)

        L = codes.shape[-1]
        W = L - k + 1
        c = codes.to(torch.int32)
        lo = torch.zeros((codes.shape[0], W), dtype=torch.int32, device=rd)
        hi = torch.full_like(lo, n_nodes - 1)
        for j in range(k):
            cj = c[:, j : j + W]
            valid = (lo >= 0) & (cj >= 0) & (cj <= 3)
            cs = torch.where(valid, cj, 0)
            los = torch.where(valid, lo, 0)
            his = torch.where(valid, hi, 0)
            base = C[rd][cs.to(torch.int64)]
            nlo = base + rank_g(cs, los)
            nhi = base + rank_g(cs, his + 1) - 1
            ok = valid & (nlo <= nhi)
            lo = torch.where(ok, nlo, -1)
            hi = torch.where(ok, nhi, -1)
        found = lo >= 0

        # sharded gather from the (uid, off) table: the owner contributes
        uid_parts, off_parts = [], []
        for dev, t, start in row:
            local_idx = (torch.where(found, lo, 0) - start).to(dev)
            in_shard = (local_idx >= 0) & (local_idx < nps)
            rows = t["loc"][local_idx.clamp(0, nps - 1).to(torch.int64)]
            uid_parts.append(torch.where(in_shard, rows[..., 0], 0))
            off_parts.append(torch.where(in_shard, rows[..., 1], 0))
        uid, off = _psum(mesh, i, uid_parts, rd), _psum(mesh, i, off_parts, rd)
        found = found & (uid >= 0)
        return torch.where(found, uid, -1), torch.where(found, off, -1)

    def call(codes):
        outs = {i: locate_row(i, rd, c) for i, rd, c in _dp_rows(mesh, _codes(codes))}
        return (_gather_rows(mesh, {i: u for i, (u, _) in outs.items()}, mesh.out_device),
                _gather_rows(mesh, {i: o for i, (_, o) in outs.items()}, mesh.out_device))

    return call


@dataclass
class ShardedMinimizerIndex:
    """The minimizer engine's index sharded for (dp, tp).

    TEXT-sharded: the unitigs split into tp contiguous ranges balanced by
    text size, and each shard is a complete shard-local minimizer index
    over its own slice -- its own packed text, occurrence rows and
    hash-slot table (a uniform h across shards, so the tables stack on a
    leading tp axis). Nothing is replicated: each shard holds ~1/tp of
    everything, and shard texts stay int32-addressable at any total
    size.

    Queries broadcast over tp: every shard runs the single-device locate
    against its own tables. A present k-mer's text occurrence lives in
    exactly one shard, so the combine is one psum of owner contributions
    over tp; absent k-mers fail the text compare everywhere.
    Construction never builds a global index: each shard builds from its
    own text slice (ShardedMinimizerIndex.build), which also lifts the
    2^31-base cap of one device.
    """

    desc: np.ndarray  # (tp, V + 1, 2) int32 rows [start, exact_len]
    occ_rows: np.ndarray  # (tp, occ_per_shard, 4) int32 (shard-local g/uend, GLOBAL uid)
    n_occ: np.ndarray  # (tp,) int32 true occurrence count per shard
    text_arr: np.ndarray  # (tp, ...) shard-local text: overlapped rows
    # (k <= 32: (rows,4); k <= 64: (rows,8)) or packed words (k > 64)
    k: int
    m: int
    h: int  # uniform shard-local slot bits
    V: int  # slots per shard table (2^h)
    uid_base: np.ndarray  # (tp,) int32 first global unitig id of each shard
    text_base: np.ndarray  # (tp,) int64 first global base of each shard

    @staticmethod
    def build(
        concat: np.ndarray,
        ends: np.ndarray,
        k: int,
        tp: int,
        m: int | None = None,
        slot_factor: int = 32,
    ) -> "ShardedMinimizerIndex":
        """Construct directly from the unitig text, one shard at a time:
        no single-host full index is built, and peak host memory is one
        shard's working set. Each shard's text must stay below 2^31
        bases (raise tp for larger inputs)."""
        from finito_tpu_torch.index.minimizer import MinimizerIndex

        concat = np.asarray(concat, dtype=np.uint8)
        ends64 = np.asarray(ends, dtype=np.int64)
        total = int(concat.size)
        # contiguous unitig ranges with balanced text sizes
        targets = (np.arange(1, tp + 1) * total) // tp
        cut = np.unique(np.searchsorted(ends64, targets, side="left"))
        cut = np.concatenate([[0], np.minimum(cut + 1, ends64.size)])
        if cut.size < tp + 1:  # degenerate: fewer unitigs than shards
            cut = np.concatenate([cut, np.full(tp + 1 - cut.size, ends64.size)])
        shards = []
        for s in range(tp):
            a, b = int(cut[s]), int(cut[s + 1])
            t0 = int(ends64[a - 1]) if a > 0 else 0
            t1 = int(ends64[b - 1]) if b > a else t0
            if t1 - t0 >= (1 << 31):
                raise ValueError(
                    f"shard {s} holds {t1 - t0} bases >= 2^31; increase tp"
                )
            mi = MinimizerIndex.build(
                concat[t0:t1], ends64[a:b] - t0, k, m, slot_factor
            )
            shards.append((mi, a, t0))
        h_u = max(mi.h for mi, _, _ in shards)
        for mi, _, _ in shards:
            mi.rebucket(h_u)
        return ShardedMinimizerIndex._stack(shards, k, tp, h_u)

    @staticmethod
    def from_minimizer_index(mindex, tp: int) -> "ShardedMinimizerIndex":
        """Shard an existing single-host index (its per-shard tables are
        rebuilt from its text; build() skips the single-host index)."""
        return ShardedMinimizerIndex.build(
            np.asarray(mindex.concat, np.uint8),
            np.asarray(mindex.ends, np.int64),
            mindex.k,
            tp,
            m=mindex.m,
        )

    @staticmethod
    def _stack(shards, k: int, tp: int, h_u: int) -> "ShardedMinimizerIndex":
        from finito_tpu_torch.ops.minimizer_front import n_words
        from finito_tpu_torch.query.minimizer_tables import (
            build_occ_rows,
            build_text_rows,
            build_text_rows8,
            desc_to_rows,
            pack_text_words,
        )

        V = 1 << h_u
        m = shards[0][0].m
        per = int(max(1, max(mi.occ_key.size for mi, _, _ in shards)))
        desc = np.zeros((tp, V + 1, 2), dtype=np.int32)
        # rows past a shard's n_occ stay zero: uend 0 never matches, so an
        # empty shard's one row plays the one-row table of the single-
        # device index without occurrences
        occ_rows = np.zeros((tp, per, 4), dtype=np.int32)
        n_occ = np.zeros(tp, dtype=np.int32)
        uid_base = np.zeros(tp, dtype=np.int32)
        text_base = np.zeros(tp, dtype=np.int64)
        texts = []
        for s, (mi, a, t0) in enumerate(shards):
            desc[s] = desc_to_rows(mi.desc)
            rows = build_occ_rows(mi)  # shard-local g/off/uend, local uid
            occ_rows[s, : rows.shape[0]] = rows
            n_occ[s] = rows.shape[0]
            uid_base[s] = a
            text_base[s] = t0
            words = pack_text_words(np.asarray(mi.concat, np.uint8), n_words(k) + 5)
            if k <= 32:
                texts.append(build_text_rows(words))
            elif k <= 64:
                texts.append(build_text_rows8(words))
            else:
                texts.append(words)
        shape1 = max(t.shape[0] for t in texts)
        text_arr = np.zeros((tp, shape1) + texts[0].shape[1:], texts[0].dtype)
        for s, t in enumerate(texts):
            text_arr[s, : t.shape[0]] = t
        return ShardedMinimizerIndex(
            desc=desc, occ_rows=occ_rows, n_occ=n_occ, text_arr=text_arr,
            k=k, m=m, h=h_u, V=V, uid_base=uid_base, text_base=text_base,
        )


def place_minimizer_shards(mesh: Mesh, sh: ShardedMinimizerIndex) -> np.ndarray:
    """The shards' device tables for sharded_minimizer_locate_fn: a
    (dp, tp) grid of {desc, occ_rows, text}, each shard moved to each
    distinct device once."""
    tp = mesh.devices.shape[1]
    if tp != sh.desc.shape[0]:
        raise ValueError(f"the mesh has tp={tp}, the index {sh.desc.shape[0]} shards")
    return _place(mesh, [{"desc": sh.desc[j], "occ_rows": sh.occ_rows[j], "text": sh.text_arr[j]}
                         for j in range(tp)])


def sharded_minimizer_locate_fn(mesh: Mesh, sh: ShardedMinimizerIndex, K_slow: int = 4096,
                                tables=None):
    """The minimizer locate over (dp, tp): batch sharded over dp, the
    unitig text over tp. Returns call((B, L) codes) -> ((B, W) uid,
    (B, W) off, () n_slow), int32 on mesh.out_device (whole on every
    rank when the mesh spans processes; the codes are then the same on
    every rank); the results are valid only when n_slow <= K_slow
    (n_slow is the largest shard's slow-window count, over every
    process). tables: place_minimizer_shards(mesh, sh), to share one
    placement between capacities.

    Every shard runs the single-device v1 locate (narrow-descriptor
    branch) on its dp slice against its own tables: the front end
    (ops.minimizer_front, the CUDA kernel on the card; dp * tp launches a
    batch), the descriptor and payload gathers and the text compare, then
    the compacted slow path, a Python loop bounded by one host read of
    the shard's largest slot length (utils.trace's host_reads.locate.trips
    counts them). The shards' front ends and fast paths are all issued
    before the first read. A process runs only the shards it holds. A present k-mer
    verifies in exactly one shard's text, so one psum of owner
    contributions combines the answers. Any k <= 255."""
    k, m, hbits = sh.k, sh.m, sh.h
    masks = _word_masks(k)
    dp, tp = mesh.devices.shape
    tables = place_minimizer_shards(mesh, sh) if tables is None else tables
    n_occ = [int(x) for x in sh.n_occ]
    uid_base = [int(x) for x in sh.uid_base]

    def check(t, idx, o, qws):
        # the single-device candidate check, on shard-local rows
        row = t["occ_rows"][idx.to(torch.int64)]
        g_m, uid, off_m, uend = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
        g_w = g_m - o
        off_w = off_m - o
        ok = (off_w >= 0) & (g_w + k <= uend)
        g_safe = g_w.clamp(min=0)
        if k <= 32:
            mt = _match_text_kmer_rows(t["text"], g_safe, qws, masks)
        elif k <= 64:
            mt = _match_text_kmer_rows8(t["text"], g_safe, qws, masks)
        else:
            mt = _match_text_kmer(t["text"], g_safe, qws, masks)
        return ok & mt, uid, off_w

    def shard_fast(t, codes):
        """Front end, fast path and slow-window compaction of one shard:
        everything before its host read."""
        best_v, best_o, bad, q_words = minimizer_windows(codes, k, m)
        # shard-local slot lookup: no ownership test -- a window whose
        # k-mer lives elsewhere fails this shard's text compare
        slot = torch.where(bad, 0, slot32(best_v) >> (32 - hbits))
        d = t["desc"][slot]  # (B, W, 2)
        start = d[..., 0]
        ln = torch.where(bad, 0, d[..., 1])
        fast = ln == 1
        match, uid_f, off_f = check(t, torch.where(fast, start, 0), best_o, q_words)
        found = fast & match
        flat_idx, n_slow = compact_mask(ln >= 2, K_slow)
        valid = flat_idx >= 0
        safe = torch.where(valid, flat_idx, 0).to(torch.int64)
        s_len = torch.where(valid, ln.reshape(-1)[safe], 0)
        return {
            "uid": torch.where(found, uid_f, -1), "off": torch.where(found, off_f, -1),
            "flat_idx": flat_idx, "valid": valid, "n_slow": n_slow,
            "s_start": start.reshape(-1)[safe], "s_len": s_len, "trips": s_len.max(),
            "s_o": best_o.reshape(-1)[safe],
            "s_qw": q_words.reshape(q_words.shape[0], -1)[:, safe],
        }

    def shard_slow(t, st, n_occ_s, trips):
        """The shard's slow path: the candidates of each compacted window
        in slot order, the first text match wins."""
        s_start, s_o, s_qw = st["s_start"], st["s_o"], st["s_qw"]
        s_end = s_start + st["s_len"]
        uid_s = torch.full(s_start.shape, -1, dtype=torch.int32, device=s_start.device)
        off_s = torch.full_like(uid_s, -1)
        done = ~st["valid"]
        for step in range(trips):
            i = s_start + step
            in_range = (i < s_end) & (i < n_occ_s)
            mt, uc, oc = check(t, torch.where(in_range, i, 0), s_o, s_qw)
            hit = ~done & in_range & mt
            uid_s = torch.where(hit, uc, uid_s)
            off_s = torch.where(hit, oc, off_s)
            done = done | hit
        B, W = st["uid"].shape
        sink = torch.where(st["valid"], st["flat_idx"], B * W).to(torch.int64)
        uid = _scatter_drop(st["uid"].reshape(-1), sink, uid_s).reshape(B, W)
        off = _scatter_drop(st["off"].reshape(-1), sink, off_s).reshape(B, W)
        return uid, off

    def call(codes):
        rows = _dp_rows(mesh, _codes(codes))
        with trace.span("mesh_shards"):
            states = {(i, j): shard_fast(tables[i, j], c.to(mesh.devices[i, j]))
                      for i, _, c in rows for j in mesh.local(i)}
            trips = {}
            for key, st in states.items():  # the host reads: one per shard
                trips[key] = trace.host_read("locate.trips", lambda: int(st["trips"]))
                trace.count("trips.slow", trips[key])
            results = {(i, j): shard_slow(tables[i, j], st, n_occ[j], trips[(i, j)])
                       for (i, j), st in states.items()}
        with trace.span("mesh_combine"):
            # owner-shard psum combine (not-found shards contribute 0);
            # local unitig ids globalize with the shard's uid base
            out_dev = mesh.out_device
            uid_rows, off_rows = {}, {}
            for i, rd, _ in rows:
                uid_rows[i] = _psum(mesh, i, [torch.where(results[i, j][0] >= 0,
                                                          results[i, j][0] + (uid_base[j] + 1), 0)
                                              for j in mesh.local(i)], rd) - 1
                off_rows[i] = _psum(mesh, i, [torch.where(results[i, j][1] >= 0,
                                                          results[i, j][1] + 1, 0)
                                              for j in mesh.local(i)], rd) - 1
            # the largest shard's slow count anywhere on the mesh
            n_slow = torch.stack([st["n_slow"].to(out_dev) for st in states.values()]).max()
            if mesh.flat.spans:
                n_slow = _all_reduce(mesh.flat, n_slow, "max")
            return (_gather_rows(mesh, uid_rows, out_dev), _gather_rows(mesh, off_rows, out_dev),
                    n_slow)

    return call


def sharded_lcs_fn(mesh, sbwt) -> np.ndarray:
    """The LCS array computed with the node axis sharded over every mesh
    device (mesh: a Mesh, or the flat device list of
    parallel.shard_build.flat_devices): the k label-propagation rounds
    of ops.lcs_device, each round per shard a first-difference mark that
    needs one halo element (the previous shard's last label, a
    ppermute), then the de-Bruijn propagation as an all_gather of the
    label column and a shard-local scatter of the edges whose
    destination falls in the shard (edge lists bucketed by destination
    shard host-side, padded to one width; the padding lands in a sink
    slot). A process runs the shards it holds; across processes the
    round's one collective is the column's all_gather, and the halo is
    read from it. Returns host int64 on every rank, equal to
    sbwt.lcs_array."""
    k = sbwt.get_k()
    n = sbwt.number_of_subsets()
    src, dst = lcs_scatter_indices(sbwt)

    devs = flat_devices(mesh)
    S = len(devs)
    loc = devs.local
    per = -(-n // S)
    npad = S * per

    # bucket edges by destination shard, pad buckets to a common width
    shard_of = dst // per
    order = np.argsort(shard_of, kind="stable")
    src_o, dst_o = src[order], dst[order]
    counts = np.bincount(shard_of[order], minlength=S)
    M = int(counts.max()) if counts.size else 1
    src_sh = np.zeros((S, M), np.int32)
    dstl_sh = np.full((S, M), per, np.int32)  # per = the sink slot, dropped
    pos = 0
    for s in range(S):
        c = int(counts[s])
        src_sh[s, :c] = src_o[pos : pos + c]
        dstl_sh[s, :c] = dst_o[pos : pos + c] - s * per
        pos += c

    cur0 = first_labels(sbwt, npad)
    cur, src_t, dst_t, lcs = [None] * S, {}, {}, [None] * S
    for s in loc:
        dev = devs[s]
        cur[s] = torch.from_numpy(cur0[s * per : (s + 1) * per]).to(dev)
        src_t[s] = torch.from_numpy(src_sh[s]).to(dev).to(torch.int64)
        dst_t[s] = torch.from_numpy(dstl_sh[s]).to(dev).to(torch.int64)
        lcs[s] = torch.full((per,), k, dtype=torch.int32, device=dev)
    first = {devs[s]: torch.ones(1, dtype=torch.bool, device=devs[s]) for s in loc}
    for r in range(k):
        full = _all_gather(devs, cur)  # the label column, every shard's
        col = {}  # on each local device once
        for s in loc:
            dev = devs[s]
            if dev not in col:
                col[dev] = torch.cat([_move(devs, c, dev) for c in full])
            if s == 0:  # its first node is always a global first-difference
                diff = torch.cat([first[dev], cur[0][1:] != cur[0][:-1]])
            else:
                # halo: the previous shard's last label
                left = torch.cat([_move(devs, full[s - 1][-1:], dev), cur[s][:-1]])
                diff = cur[s] != left
            lcs[s] = torch.where((lcs[s] == k) & diff, r, lcs[s])
        nxt = [None] * S
        for s in loc:
            buf = torch.zeros(per + 1, dtype=torch.int32, device=devs[s])
            buf.scatter_(0, dst_t[s], col[devs[s]][src_t[s]])
            nxt[s] = buf[:per]
        cur = nxt
    return np.concatenate(_host(devs, lcs))[:n].astype(np.int64)

"""Mesh-sharded index construction: the twin of
finito_tpu/parallel/shard_build.py.

The plain-matrix SBWT, then the finimizer selection, built with the node
set sharded over S devices by a distributed sample sort:

  * k-mer windows are packed per shard on the host and moved to the
    shard's device; each shard radix-sorts its windows (LSD over 32-bit
    planes, ops.keys), routes them to the shard owning their splitter
    bucket with one padded all_to_all, and dedups locally: equal keys
    land on one shard, so local dedup is global dedup.
  * sources ((k-1)-prefix not among (k-1)-suffixes) are a distributed
    join: both sides re-route by a common (k-1)-space splitter set, the
    owner resolves membership by a combined sort, and the answers ride
    the inverse all_to_all back.
  * $-padded dummies are made per shard from the sources and merged with
    the k-mers by a second sample-sort round: the node set, colex-sharded
    in contiguous ranges.
  * in-edges: suffix-group firsts need one halo row from the left
    (groups may straddle shard seams); the (group suffix -> global first
    index) map and the per-node prefix queries meet by the same
    (k-1)-space routing; the (target, char) edge bits are routed once
    more by node-range ownership and set in the shard's bit rows.
  * the finimizer selection (sharded_finimizer_select) routes each text
    shard's windows to the node shard owning them, realigns the
    candidates with one halo from the left, takes the k-step window
    minimum with one halo from the right, and resolves the cross-unitig
    overwrite rule at the owning node shard by one multiword sort.

The JAX package runs each phase as one shard_map program. Here the
shards' devices are a flat distributed.Devices list (parallel.mesh's
model; a device may repeat), and each phase splits at its collectives
into per-shard stages issued shard after shard. A process holds and
computes only its own shards (Devices.local): per-shard lists have an
entry for every shard, None where another process holds it. The
collectives layer below is the one place where a collective crosses
processes; in one process (no group, or every shard held here) it calls
no torch.distributed function and is a tensor move:
  lax.all_to_all(x, tiled=True)  -> _all_to_all, an exact block
      transpose: shard j receives cat_i(send_i[j*M:(j+1)*M]), in source
      order; applied twice it is the identity, so it also carries the
      answers back. Across processes: the local blocks first, then one
      dist.all_to_all_single of the per-destination-process blocks,
      reassembled in source-shard order;
  lax.ppermute halos             -> _all_gather of each shard's edge
      rows (a few rows a shard), the neighbour's picked; the end shards
      take JAX's fill values;
  lax.psum / pmax of counts      -> one host read of the local shards
      (_total), then one dist.all_reduce (_sum_all, _max_all,
      _shard_ints), so that every rank takes the same retry and
      capacity decision;
  process_allgather (_host)      -> _host: every shard's part on every
      rank, for the final assembly of the bit rows, node keys, fmin and
      offsets.
The JAX package's _put_shard_blocks packs only the shards this process
holds, and so does this one's; _per_device is its replicated _put. The
input sequences are the same on every rank; what is split is what lives
on the devices. Under gloo a CUDA tensor is staged through the host for
a collective, explicitly, and Devices.stats counts the collectives and
the staged bytes; under nccl it moves card to card.

All exchanges use fixed-capacity blocks: exact where a prior pass
counted them, else slack with an overflow retry (each try reads the
summed overflow count once, and doubles the capacity on overflow), so
exactness is never traded away.

Output equals build_plain_matrix_sbwt and FinimizerIndexBuilder bit for
bit, in one process (tests/test_torch_shard_build.py) and across
processes (tests/test_torch_xproc.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from finito_tpu_torch.ops import keys as kj
from finito_tpu_torch.ops.bits import U32
from finito_tpu_torch.parallel.distributed import Devices
from finito_tpu_torch.sbwt import keys as kw
from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT


def flat_devices(mesh=None, n_devices: Optional[int] = None, devices=None) -> Devices:
    """The shards' devices, one a shard, in order, with the process that
    holds each (JAX's _flat_mesh): `devices` as given (a device may
    repeat: ["cpu"] * 8 runs 8 shards on the CPU; a
    distributed.global_devices list spans processes); else a
    parallel.mesh.Mesh's grid, flattened; else the first `mesh` (an int)
    or n_devices visible CUDA cards, all of them by default, and fewer
    where fewer are visible (the output does not depend on the shard
    count). Without a card this raises: the build never falls back to
    the CPU unless asked."""
    from finito_tpu_torch.parallel.mesh import Mesh

    for given in (devices, mesh):
        if isinstance(given, Devices):
            return given
    if devices is not None:
        return Devices(devices)
    if isinstance(mesh, Mesh):
        return mesh.flat
    if mesh is not None and not isinstance(mesh, int):
        return Devices(mesh)
    n = mesh if isinstance(mesh, int) else (n_devices or torch.cuda.device_count() or 1)
    return Devices(shard_devices("cuda", n, fewer_ok=True))


def shard_devices(name, n: int, fewer_ok: bool = False) -> List[torch.device]:
    """The n shard devices that a --device name stands for, the one rule
    of every entry point with a mesh: "cpu" repeats the CPU and a card
    named by index ("cuda:0") repeats that card; "cuda" takes the first
    n visible cards, one a shard, and raises when fewer are visible,
    unless fewer_ok (then the visible ones: for a build whose output
    does not depend on the shard count). A card asked for and missing
    raises: nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type != "cuda":
        return [dev] * n
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards == 0:
        raise RuntimeError(f"needs {n} devices: CUDA is not available, none is visible "
                           "(--device cpu, or devices=['cpu'] * N, runs every shard on the CPU)")
    if dev.index is not None:
        if dev.index >= n_cards:
            raise RuntimeError(f"device {name!r}: {n_cards} CUDA device(s) visible")
        return [dev] * n
    if n_cards < n and not fewer_ok:
        raise RuntimeError(f"needs {n} devices, found {n_cards} card(s) (--device cuda puts one "
                           "shard on each card, a named card such as cuda:0 every shard on it)")
    return [torch.device("cuda", i) for i in range(min(n, n_cards))]


# ---- the collectives layer: the one place a collective crosses processes


def _spans(devs) -> bool:
    return isinstance(devs, Devices) and devs.spans


def _local(devs) -> List[int]:
    """The shards this process holds (all of a plain device list)."""
    return devs.local if isinstance(devs, Devices) else list(range(len(devs)))


def _by_rank(owners) -> List[List[int]]:
    """The items each rank holds (owners[s]: item s's rank), rank order."""
    import torch.distributed as dist

    return [[s for s, o in enumerate(owners) if o == r] for r in range(dist.get_world_size())]


def _move(devs: Devices, t: torch.Tensor, dev) -> torch.Tensor:
    """t on dev, for a collective; under gloo a move between a card and
    the host is staging, and its bytes are counted."""
    dev = torch.device(dev)
    if devs.backend == "gloo" and (t.device.type == "cuda") != (dev.type == "cuda"):
        devs.stats["staged_bytes"] += t.numel() * t.element_size()
    return t.to(dev)


def _all_reduce(devs: Devices, t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """dist.all_reduce (op "sum" or "max") of t over group (the world by
    default), through the stage; returns a new tensor on t's device."""
    import torch.distributed as dist

    x = _move(devs, t, devs.stage).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=group)
    devs.stats["collectives"] += 1
    return _move(devs, x, t.device)


def _sum_all(devs, n: int) -> int:
    """A host count summed over the processes (n itself in one)."""
    if not _spans(devs):
        return n
    return int(_all_reduce(devs, torch.tensor([n], dtype=torch.int64))[0])


def _max_all(devs, n: int) -> int:
    """A host count's maximum over the processes (n itself in one)."""
    if not _spans(devs):
        return n
    return int(_all_reduce(devs, torch.tensor([n], dtype=torch.int64), "max")[0])


def _total(parts) -> int:
    """Sum of the local shards' scalar tensors (None: another process's
    shard): one host read. _sum_all makes it the mesh's."""
    mine = [p for p in parts if p is not None]
    dev = mine[0].device
    return int(sum(p.to(dev) for p in mine))


def _shard_ints(devs, parts) -> np.ndarray:
    """Every shard's scalar tensor as one host int64 array: one host
    read of the local shards, then (across processes) one all_reduce in
    which each shard's holder alone contributes."""
    loc = _local(devs)
    vals = np.zeros(len(devs), np.int64)
    vals[loc] = torch.stack([parts[s].to(devs[loc[0]]) for s in loc]).cpu().numpy()
    if _spans(devs):
        vals = _all_reduce(devs, torch.from_numpy(vals)).numpy()
    return vals


def _all_gather(devs, parts, owners=None, like=None) -> list:
    """lax.all_gather of equal-shaped items: parts[s] is item s where
    this process holds it (owners[s], default devs.owners), else None;
    like = (shape, dtype) for a process that holds none. Returns every
    item, on the stage (in one process: parts as given)."""
    if not _spans(devs):
        return list(parts)
    import torch.distributed as dist

    owners = devs.owners if owners is None else owners
    by_rank = _by_rank(owners)
    mine = by_rank[devs.rank]
    shape, dtype = (tuple(parts[mine[0]].shape), parts[mine[0]].dtype) if mine else like
    n_max = max(len(b) for b in by_rank)
    stacked = torch.zeros((n_max, *shape), dtype=dtype, device=devs.stage)
    for i, s in enumerate(mine):
        stacked[i] = _move(devs, parts[s], devs.stage)
    outs = [torch.empty_like(stacked) for _ in by_rank]
    dist.all_gather(outs, stacked)
    devs.stats["collectives"] += 1
    got = [None] * len(owners)
    for r, items in enumerate(by_rank):
        for i, s in enumerate(items):
            got[s] = outs[r][i]
    return got


def _host(devs, parts) -> List[np.ndarray]:
    """JAX's _host (a tiled process_allgather): every shard's tensor as
    a host array on every rank; parts[s] is None where another process
    holds shard s. Shapes may differ between shards."""
    loc = _local(devs)
    if not _spans(devs):
        return [parts[s].cpu().numpy() for s in loc]
    import torch.distributed as dist

    S = len(devs)
    ref = parts[loc[0]]
    shapes = torch.zeros((S, ref.dim()), dtype=torch.int64)
    for s in loc:
        shapes[s] = torch.tensor(parts[s].shape)
    shapes = _all_reduce(devs, shapes)
    sizes = shapes.prod(dim=1).tolist()
    by_rank = _by_rank(devs.owners)
    n_max = max(sum(sizes[s] for s in b) for b in by_rank)
    flat = torch.zeros(n_max, dtype=ref.dtype, device=devs.stage)
    pos = 0
    for s in loc:
        flat[pos : pos + sizes[s]] = _move(devs, parts[s].reshape(-1), devs.stage)
        pos += sizes[s]
    outs = [torch.empty_like(flat) for _ in by_rank]
    dist.all_gather(outs, flat)
    devs.stats["collectives"] += 1
    got = [None] * S
    for r, items in enumerate(by_rank):
        pos = 0
        for s in items:
            got[s] = outs[r][pos : pos + sizes[s]].reshape(shapes[s].tolist()).cpu().numpy()
            pos += sizes[s]
    return got


def _all_to_all(sends: Sequence[Optional[torch.Tensor]], devs) -> List[Optional[torch.Tensor]]:
    """lax.all_to_all(x, "D", 0, 0, tiled=True) over the flat mesh:
    sends[i] is shard i's (S*M, ...) block stack (None where another
    process holds shard i); shard j receives cat_i(sends[i][j*M:(j+1)*M])
    on devs[j]. Across processes: the blocks for each destination
    process first, one dist.all_to_all_single, then each local shard's
    blocks in source-shard order."""
    S = len(devs)
    loc = _local(devs)
    M = sends[loc[0]].shape[0] // S
    if not _spans(devs):
        return [torch.cat([sends[i][j * M : (j + 1) * M].to(devs[j]) for i in range(S)])
                for j in range(S)]
    import torch.distributed as dist

    by_rank = _by_rank(devs.owners)
    blocks, in_splits = [], []
    for dests in by_rank:
        blocks += [sends[i][j * M : (j + 1) * M] for i in loc for j in dests]
        in_splits.append(len(loc) * len(dests) * M)
    x = torch.cat([_move(devs, b, devs.stage) for b in blocks])
    out_splits = [len(srcs) * len(loc) * M for srcs in by_rank]
    y = x.new_empty((sum(out_splits), *x.shape[1:]))
    dist.all_to_all_single(y, x, out_splits, in_splits)
    devs.stats["collectives"] += 1
    got, pos = {}, 0
    for srcs in by_rank:  # from each process: its shards' blocks to each local shard
        for i in srcs:
            for j in loc:
                got[i, j] = y[pos : pos + M]
                pos += M
    return [_move(devs, torch.cat([got[i, j] for i in range(S)]), devs[j]) if j in loc else None
            for j in range(S)]


def _each(devs, fn) -> list:
    """[fn(s) for each shard s this process holds], None for the others."""
    out = [None] * len(devs)
    for s in _local(devs):
        out[s] = fn(s)
    return out


def _per_device(devs, a: np.ndarray) -> dict:
    """A host table (the same on every rank) on each distinct device of
    this process's shards, int64 (uint32 planes widened by
    ops.keys.to_device): JAX's replicated _put."""
    out = {}
    for s in _local(devs):
        d = devs[s]
        if d not in out:
            out[d] = (kj.to_device(a, d) if a.dtype == np.uint32
                      else torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(d))
    return out


def _put_shard_blocks(devs, block_fn) -> List[Optional[torch.Tensor]]:
    """One tensor a shard this process holds (None for the others):
    block_fn(s) -> host block, called only for the local shards, moved
    to devs[s] and freed, so the host working set peaks at one shard's
    block. uint32 blocks (key planes) are widened to the int64
    convention on the device."""
    parts = [None] * len(devs)
    for s in _local(devs):
        b = block_fn(s)
        if b.dtype == np.uint32:
            parts[s] = kj.to_device(b, devs[s])
        else:
            parts[s] = torch.from_numpy(b).to(devs[s])
        del b
    return parts


# ---- the build


def _resent(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rows where mask is True back to the sentinel (key algebra on
    sentinel rows makes valid-looking garbage)."""
    return torch.where(mask[:, None], kj.SENT, keys)


def _scatter_rows(fill: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor, n: int):
    """fill.at[slot].set(rows)[:n]: fill has one sink row past n, where
    every dropped row goes."""
    fill[slot] = rows
    return fill[:n]


def _exchange_send(keys, splitters, S: int, M: int, payloads=()):
    """One shard's half of the sample-sort exchange, before the
    all_to_all: every non-sentinel row to the block of the shard owning
    its splitter bucket, at most M a block. Returns (send (S*M, P),
    payload sends (S*M,) each, overflow count, (order, slot, ok)): the
    last lets _answers_back scatter per-slot answers onto the rows."""
    n, Pp = keys.shape
    dev = keys.device
    order = kj.argsort_rows(keys)
    skeys = keys[order]
    b = kj.bucket_of(skeys, splitters)  # monotone over the sorted keys
    start = torch.searchsorted(b, torch.arange(S, dtype=b.dtype, device=dev))
    off = torch.arange(n, device=dev) - start[b.clamp(max=S - 1)]
    sent = kj.is_sentinel(skeys)
    ok = ~sent & (off < M)
    overflow = (~sent & (off >= M)).sum()
    slot = torch.where(ok, b * M + off, S * M)
    send = _scatter_rows(kj.sentinel_rows(S * M + 1, Pp, dev), slot, skeys, S * M)
    spay = [_scatter_rows(torch.full((S * M + 1,), -1, dtype=p.dtype, device=dev), slot,
                          p[order], S * M) for p in payloads]
    return send, spay, overflow, (order, slot, ok)


def _exchange(keys_l, spl, S: int, M: int, devs, payloads_l=None):
    """The sample-sort exchange on every local shard: keys_l[s] is shard
    s's (n_s, P) rows, spl a device -> splitters map, payloads_l[s]
    shard s's aligned payloads (None entries: other processes' shards).
    Returns (recv (S*M, P) per shard, received payloads per shard,
    overflow count per shard, context per shard)."""
    sends, pays, ovf, ctx = [None] * S, [None] * S, [None] * S, [None] * S
    for s in _local(devs):
        sends[s], pays[s], ovf[s], ctx[s] = _exchange_send(
            keys_l[s], spl[devs[s]], S, M, payloads_l[s] if payloads_l else ())
    recv = _all_to_all(sends, devs)
    n_pay = len(payloads_l[_local(devs)[0]]) if payloads_l else 0
    rpay = [_all_to_all([None if p is None else p[i] for p in pays], devs) for i in range(n_pay)]
    return recv, [[r[s] for r in rpay] for s in range(S)], ovf, ctx


def _answers_back(ans_l, ctx_l, n_l, S: int, M: int, devs) -> List[torch.Tensor]:
    """The inverse all_to_all of per-slot answers -> per-row answers of
    each local shard (-1 where the row was not sent)."""
    back = _all_to_all(ans_l, devs)
    out = [None] * S
    for s in _local(devs):
        order, slot, ok = ctx_l[s]
        got = torch.where(ok, back[s][slot.clamp(max=S * M - 1)], -1)
        out[s] = torch.full((n_l[s],), -1, dtype=got.dtype, device=devs[s]).scatter_(0, order, got)
    return out


def _sort_dedup_compact(recv, cap: int):
    """Sort received rows, drop duplicates and sentinels, compact to the
    front; returns (keys (cap, P) sentinel-padded, count)."""
    Pp, dev = recv.shape[1], recv.device
    r = recv[kj.argsort_rows(recv)]
    keep = ~kj.eq_adjacent_rows(r) & ~kj.is_sentinel(r)
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    out = _scatter_rows(kj.sentinel_rows(cap + 1, Pp, dev),
                        torch.where(keep, pos.clamp(max=cap), cap), r, cap)
    return out, keep.sum()


def _route_send(own, payloads, S: int, M: int):
    """One shard's half of _route_by_owner before the all_to_all: the
    payload rows in blocks by the owner `own` names (S = dropped), at
    most M a block. Fill is -1 for payload 0 (the validity channel) and
    0 for the others. Returns (sends, overflow count)."""
    dev = own.device
    n = own.shape[0]
    order = torch.sort(own, stable=True).indices
    own_s = own[order]
    start = torch.searchsorted(own_s, torch.arange(S, dtype=own_s.dtype, device=dev))
    off = torch.arange(n, device=dev) - start[own_s.clamp(max=S - 1)]
    ok = (own_s < S) & (off < M)
    overflow = ((own_s < S) & (off >= M)).sum()
    slot = torch.where(ok, own_s * M + off, S * M)
    sends = [_scatter_rows(torch.full((S * M + 1,), -1 if i == 0 else 0, dtype=p.dtype,
                                      device=dev), slot, p[order], S * M)
             for i, p in enumerate(payloads)]
    return sends, overflow


def _route_by_owner(own_l, payloads_l, S: int, M: int, devs):
    """Route payload rows to the shard named by own_l[s] (S = dropped),
    one padded all_to_all a payload. Returns (received payloads per
    shard, each (S*M,); overflow count per shard)."""
    sends, ovf = [None] * S, [None] * S
    for s in _local(devs):
        sends[s], ovf[s] = _route_send(own_l[s], payloads_l[s], S, M)
    n_pay = len(payloads_l[_local(devs)[0]])
    recv = [_all_to_all([None if x is None else x[i] for x in sends], devs) for i in range(n_pay)]
    return [[r[s] for r in recv] for s in range(S)], ovf


def _host_splitters(samples: List[np.ndarray], S: int, Pp: int) -> np.ndarray:
    """S-1 quantile splitters from a small host sample (a few KB)."""
    planes = kj.from_host(kw.sort_keys(samples))
    n = planes.shape[0]
    if n == 0:
        return np.full((S - 1, Pp), 0xFFFFFFFF, np.uint32)
    idx = ((np.arange(1, S) * n) // S).clip(0, n - 1)
    return planes[idx]


def _pack_shards(segs: Sequence[np.ndarray], k: int, devs, key_fn):
    """Host prep shared by the mesh builders: a greedy contiguous split
    of the segments over the shards by window count, per-shard packing
    by key_fn(seg) -> key words, and a strided splitter sample (the key
    sets are never concatenated on the host). Shards are packed one at a
    time and moved to their devices (_put_shard_blocks). Returns (keys0
    per shard (N0, P) int64, None where another process holds the shard;
    the sample, the same on every rank)."""
    S = len(devs)
    Pp = kj.n_planes(k)
    wins = np.array([c.size - k + 1 for c in segs], np.int64)
    total = int(wins.sum())
    if total == 0:
        raise ValueError("no k-mers in input")
    bounds = np.searchsorted(np.cumsum(wins), np.arange(1, S) * (total / S))
    groups = np.split(np.arange(len(segs)), bounds)
    W = (3 * k + 63) // 64
    # one window per position of each segment: the padded block size is
    # known without packing (key_fn keeps the window count)
    N0 = max(1, max((int(wins[g].sum()) for g in groups), default=1))

    def block(s):
        g = groups[s]
        ks = kw.concat([key_fn(segs[i]) for i in g]) if len(g) else kw.empty(W)
        blk = np.full((N0, Pp), 0xFFFFFFFF, np.uint32)
        if ks[0].size:
            blk[: ks[0].size] = kj.from_host(ks)
        return blk

    keys0 = _put_shard_blocks(devs, block)
    # splitter sample: strided single windows packed straight from the
    # segments, O(64 * S) windows
    stride = max(1, total // (64 * S))
    samples = []
    g0 = 0
    nxt = 0
    for seg in segs:
        w = seg.size - k + 1
        while nxt < g0 + w:
            i = nxt - g0
            samples.append(key_fn(seg[i : i + k]))
            nxt += stride
        g0 += w
    sample = kw.concat(samples) if samples else kw.empty(W)
    return keys0, sample


def _distinct(keys0, spl, devs):
    """Phases A and B of both mesh builds: local sort with exact bucket
    counts, the window exchange and dedup. Returns (distinct keys per
    shard, (R1, P) sentinel-padded, their counts on the host (every
    shard's), R1)."""
    S = len(devs)
    skeys, counts = [None] * S, []
    for s in _local(devs):
        ks = keys0[s]
        sk = ks[kj.argsort_rows(ks)]
        b = kj.bucket_of(sk, spl[devs[s]])
        counts.append(torch.zeros(S, dtype=torch.int64, device=devs[s])
                      .index_add_(0, b, (~kj.is_sentinel(sk)).to(torch.int64)).max())
        skeys[s] = sk
    # exact
    M1 = max(1, _max_all(devs, int(torch.stack([c.to(counts[0].device) for c in counts]).max())))
    R1 = S * M1
    recv, _, ovf, _ = _exchange(skeys, spl, S, M1, devs)
    del skeys
    if _sum_all(devs, _total(ovf)) != 0:
        raise AssertionError("sample sort: the exact window capacity overflowed")
    out, m = [None] * S, [None] * S
    for s in _local(devs):
        out[s], m[s] = _sort_dedup_compact(recv[s], R1)
    return out, _shard_ints(devs, m), R1


def sharded_sbwt_build(
    seqs: Sequence,
    k: int,
    mesh=None,
    n_devices: Optional[int] = None,
    slack: float = 1.5,
    return_keys: bool = False,
    devices=None,
):
    """The plain-matrix SBWT of `seqs` with the node set sharded over the
    mesh (module docstring; the shards' devices: flat_devices). Returns
    a PlainMatrixSBWT (and the colex-sorted node keys if return_keys),
    bit-identical to build_plain_matrix_sbwt."""
    from finito_tpu_torch.io.seqdb import encode_seq

    if k < 2:
        raise ValueError("k must be >= 2")
    devs = flat_devices(mesh, n_devices, devices)
    S = len(devs)
    loc = _local(devs)
    Pp = kj.n_planes(k)

    # ---- host prep: encode, split contiguously by window count, pack
    codes_all = []
    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode_seq(
            s if isinstance(s, bytes) else s.encode()
        )
        if np.any(codes == 255):
            raise ValueError("Invalid character in input sequence (only ACGT allowed)")
        if codes.size >= k:
            codes_all.append(codes)
    keys0, sample = _pack_shards(codes_all, k, devs, lambda seg: kw.pack_windows(seg, k))

    # splitters: node-key space (1) and (k-1)-suffix space (2)
    spl1 = _per_device(devs, _host_splitters(sample, S, Pp))
    spl2 = _per_device(devs, _host_splitters(kw.shift_right3(sample), S, Pp))

    # ---- phases A, B: distinct k-mers, sharded
    kmers, m_host, R1 = _distinct(keys0, spl1, devs)
    del keys0
    n_kmers = int(m_host.sum())

    # ---- phase C: sources ((k-1)-prefix not among (k-1)-suffixes)
    M2 = max(1, int(np.ceil(slack * R1 / S)))
    sents = _each(devs, lambda s: kj.is_sentinel(kmers[s]))
    sufs = _each(devs, lambda s: _resent(kj.shift_right3_rows(kmers[s]), sents[s]))
    pres = _each(devs, lambda s: _resent(kj.mask_low_rows(kmers[s], k - 1), sents[s]))
    while True:
        recvR, _, ovf1, _ = _exchange(sufs, spl2, S, M2, devs)
        recvQ, _, ovf2, ctxQ = _exchange(pres, spl2, S, M2, devs)
        ans = _each(devs, lambda s: kj.match_rows(
            recvQ[s], recvR[s], torch.where(kj.is_sentinel(recvR[s]), -1, 1)))
        got = _answers_back(ans, ctxQ, [None if km is None else km.shape[0] for km in kmers],
                            S, M2, devs)
        is_source = _each(devs, lambda s: ~sents[s] & (got[s] < 0))
        if _sum_all(devs, _total(ovf1 + ovf2)) == 0:
            break
        M2 *= 2
    del sufs, pres, recvR, recvQ
    cap_src = max(1, _max_all(devs, int(torch.stack(
        [is_source[s].sum().to(devs[loc[0]]) for s in loc]).max())))

    # ---- phase D: dummies + node sample-sort
    send_max = R1 + (k - 1) * cap_src + 1
    M3 = max(1, int(np.ceil(slack * send_max / S)))
    allk = [None] * S
    for s in loc:
        km, src_mask = kmers[s], is_source[s]
        pos = torch.cumsum(src_mask.to(torch.int64), 0) - 1
        srcbuf = _scatter_rows(kj.sentinel_rows(cap_src + 1, Pp, devs[s]),
                               torch.where(src_mask, pos.clamp(max=cap_src), cap_src),
                               km, cap_src)
        ssent = kj.is_sentinel(srcbuf)
        blocks = [km]
        for j in range(1, k):
            blocks.append(_resent(kj.shift_left_rows(kj.mask_low_rows(srcbuf, j), k - j), ssent))
        root = (torch.zeros((1, Pp), dtype=torch.int64, device=devs[s]) if s == 0
                else kj.sentinel_rows(1, Pp, devs[s]))
        allk[s] = torch.cat(blocks + [root])
    del kmers, is_source
    while True:
        capN = S * M3
        recv, _, ovf, _ = _exchange(allk, spl1, S, M3, devs)
        if _sum_all(devs, _total(ovf)) == 0:
            break
        M3 *= 2
    del allk
    nodes, mn = [None] * S, [None] * S
    for s in loc:
        nodes[s], mn[s] = _sort_dedup_compact(recv[s], capN)
    del recv
    mn_host = _shard_ints(devs, mn)
    n_nodes = int(mn_host.sum())
    node_start = np.zeros(S, np.int64)
    node_start[1:] = np.cumsum(mn_host)[:-1]

    # ---- phase E: suffix-group firsts + in-edges -> sharded bit rows
    M4 = max(1, int(np.ceil(slack * capN / S)))
    M5 = max(1, int(np.ceil(slack * capN / S)))
    idx = {devs[s]: torch.arange(capN, device=devs[s]) for s in loc}
    nstart = _per_device(devs, node_start)
    valid = _each(devs, lambda s: idx[devs[s]] < int(mn_host[s]))
    nsuf = _each(devs, lambda s: _resent(kj.shift_right3_rows(nodes[s]), ~valid[s]))
    # the halo: the last valid suffix of the nearest non-empty shard left
    # (JAX's all_gather + carry loop, on the counts already read); an
    # empty shard's row is a sentinel, never picked
    lasts = _all_gather(devs, _each(devs, lambda s: nsuf[s][max(int(mn_host[s]) - 1, 0):][:1]))
    firsts, gidxs = [None] * S, [None] * S
    for s in loc:
        left = [t for t in range(s) if mn_host[t] > 0]
        carry = (_move(devs, lasts[left[-1]], devs[s]) if left
                 else kj.sentinel_rows(1, Pp, devs[s]))
        prev_row = torch.cat([carry, nsuf[s][:-1]])
        diff = (nsuf[s] != prev_row).any(dim=1)
        gidxs[s] = int(node_start[s]) + idx[devs[s]]
        firsts[s] = valid[s] & (diff | (gidxs[s] == 0))
    gkeys = _each(devs, lambda s: _resent(nsuf[s], ~firsts[s]))
    gvals = _each(devs, lambda s: [torch.where(firsts[s], gidxs[s], -1)])
    chs = _each(devs, lambda s: kj.top_char_rows(nodes[s], k))
    nonroot = _each(devs, lambda s: valid[s] & (chs[s] != 0))
    qks = _each(devs, lambda s: _resent(kj.mask_low_rows(nodes[s], k - 1), ~nonroot[s]))
    del nsuf, firsts, lasts
    while True:
        recvR, rpay, ovfA, _ = _exchange(gkeys, spl2, S, M4, devs, gvals)
        recvQ, _, ovfB, ctxQ = _exchange(qks, spl2, S, M4, devs)
        ans = _each(devs, lambda s: kj.match_rows(recvQ[s], recvR[s], rpay[s][0]))
        tf = _answers_back(ans, ctxQ, [capN] * S, S, M4, devs)
        miss = _each(devs, lambda s: (nonroot[s] & (tf[s] < 0)).sum())
        # route (target first, char) to the owning node-range shard
        own = _each(devs, lambda s: torch.where(
            nonroot[s] & (tf[s] >= 0),
            torch.searchsorted(nstart[devs[s]], tf[s].clamp(min=0), right=True) - 1, S))
        recvE, ovfC = _route_by_owner(own, _each(devs, lambda s: (tf[s], chs[s])), S, M5, devs)
        if _sum_all(devs, _total(ovfA + ovfB + ovfC)) == 0:
            break
        M4 *= 2
        M5 *= 2
    if _sum_all(devs, _total(miss)) != 0:
        raise AssertionError("sharded SBWT construction: missing predecessor group")

    bit_parts = [None] * S
    for s in loc:
        tf_r, ch_r = recvE[s]
        okR = tf_r >= 0
        locp = tf_r - int(node_start[s])
        okR = okR & (locp >= 0) & (locp < capN)
        bits = torch.zeros((4, capN + 1), dtype=torch.uint8, device=devs[s])
        bits[torch.where(okR, ch_r - 1, 0), torch.where(okR, locp, capN)] = 1
        bit_parts[s] = bits[:, : int(mn_host[s])]
    bit_rows = np.concatenate(_host(devs, bit_parts), axis=1)
    sbwt = PlainMatrixSBWT.from_bit_rows(bit_rows, k=k, n_kmers=n_kmers)
    if return_keys:
        segs = _host(devs, _each(devs, lambda s: nodes[s][: int(mn_host[s])]))
        return sbwt, kj.to_host(np.concatenate(segs, axis=0))
    return sbwt


def sharded_finimizer_select(sbwt, LCS, packed, node_keys, mesh,
                             slack: float = 1.3, return_pos: bool = False):
    """Mesh finimizer selection: the O(text) stages of
    FinimizerIndexBuilder sharded over the mesh (the twin of the JAX
    package's; its docstring has the stages). The NODE axis is sharded
    in S contiguous colex blocks of width Mn, the TEXT axis in S
    contiguous position blocks of width B. mesh: a parallel.mesh.Mesh, a
    device count or a list of devices (flat_devices).

    Returns (fmin_bv, global_offsets, stats) as full-length host arrays
    and a FinimizerStatsSet, all equal to the host builder's; with
    return_pos also (pos_shards, Mn): each node shard's (Mn,) int32
    global window end a colex rank (-1 for dummies), the input of
    parallel.mesh.ShardedIndex.build."""
    from finito_tpu_torch.index.builder import FinimizerStatsSet, prefix_candidates

    devs = flat_devices(mesh)
    S = len(devs)
    loc = _local(devs)
    k = sbwt.get_k()
    n_nodes = sbwt.number_of_subsets()
    Pp = kj.n_planes(k)
    concat = np.asarray(packed.concat, dtype=np.uint8)
    ends = np.asarray(packed.ends, dtype=np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    N = concat.size
    n_u = ends.size

    if n_nodes >= (1 << 31) or N + S >= (1 << 31):
        raise ValueError("sharded_finimizer_select: int32 plane encoding "
                         "requires < 2^31 nodes and text positions")
    if k > 255:
        raise ValueError("k > 255 exceeds the packed window-min encoding")
    if node_keys[0].size != n_nodes:
        raise ValueError("node_keys must cover every SBWT node (colex-sorted)")

    LCS = np.asarray(LCS, dtype=np.int64)
    su = (np.maximum(LCS, np.concatenate([LCS[1:], [0]])) + 1).astype(np.int32)

    # ---- node sharding: S uniform colex blocks (ownership = division)
    Mn = -(-n_nodes // S)
    realmask = (node_keys[0] & np.uint64(7)) != 0  # no $ at label start
    real_counts = np.zeros(S, np.int64)
    for s in range(S):
        a, b = s * Mn, min((s + 1) * Mn, n_nodes)
        if b > a:
            real_counts[s] = int(realmask[a:b].sum())

    def node_block(s):
        a, b = s * Mn, min((s + 1) * Mn, n_nodes)
        blk = np.full((Mn, Pp), 0xFFFFFFFF, np.uint32)
        if b > a:
            blk[: b - a] = kj.from_host(kw.take(node_keys, np.arange(a, b)))
        return blk

    def su_block(s):
        a, b = s * Mn, min((s + 1) * Mn, n_nodes)
        blk = np.zeros(Mn, np.int64)
        if b > a:
            blk[: b - a] = su[a:b]
        return blk

    nodes_d = _put_shard_blocks(devs, node_block)
    su_d = _put_shard_blocks(devs, su_block)
    bidx = (np.arange(1, S) * Mn).clip(0, max(n_nodes - 1, 0))
    spl = np.where(
        (np.arange(1, S) * Mn < n_nodes)[:, None],
        kj.from_host(kw.take(node_keys, bidx)),
        np.uint32(0xFFFFFFFF),
    ).astype(np.uint32)
    spl_d = _per_device(devs, spl)
    M1 = max(1, int(real_counts.max()))  # exact: one window per real node

    # ---- text sharding: S contiguous position blocks, B >= k; window
    # keys packed per shard from the text slice
    B = max(-(-N // S), k)
    n_pos = N - k + 1
    if n_pos <= 0:
        raise ValueError("no k-mer windows in input")
    # host control plane: prefix candidates, scattered to end-position owners
    pc_pos, pc_len, pc_colex = prefix_candidates(sbwt, su, starts, ends, concat)

    def shard_valid(s):
        a = s * B
        b = min(a + B, n_pos)
        v = np.zeros(B, np.bool_)
        if a < n_pos:
            pos_s = np.arange(a, b, dtype=np.int64)
            uid_s = np.searchsorted(ends, pos_s, side="right")
            v[: b - a] = pos_s + k <= ends[uid_s]
        return v

    # per-shard valid counts -> the order bases
    vcounts = np.array([int(shard_valid(s).sum()) for s in range(S)], np.int64)
    n_valid = int(vcounts.sum())
    base_ord = np.zeros(S, np.int64)
    base_ord[1:] = np.cumsum(vcounts)[:-1]

    def wk_block(s):
        a = s * B
        b = min(a + B, n_pos)
        blk = np.full((B, Pp), 0xFFFFFFFF, np.uint32)
        if a < n_pos:
            v = shard_valid(s)[: b - a]
            seg = kj.from_host(kw.pack_windows(concat[a : b - 1 + k], k))
            blk[: b - a][v] = seg[v]
        return blk

    def pc_block(vals, fill):
        def f(s):
            a = s * B
            blk = np.full(B, fill, np.int64)
            sel = (pc_pos >= a) & (pc_pos < a + B)
            blk[pc_pos[sel] - a] = vals[sel]
            return blk

        return f

    wk_d = _put_shard_blocks(devs, wk_block)
    val_d = _put_shard_blocks(devs, shard_valid)
    pcl_d = _put_shard_blocks(devs, pc_block(pc_len, k + 2))
    pcc_d = _put_shard_blocks(devs, pc_block(pc_colex, 0))
    ends_d = _per_device(devs, ends)
    starts_d = _per_device(devs, starts)
    BIG = ((k + 2) << 16) << 32  # (BIGHI, 0) as one 64-bit key

    # ---- phase A: ranks + realignment + window minimum
    # window keys to their node shard, the windows' starts as payload
    ar = {devs[s]: torch.arange(max(B, Mn), device=devs[s]) for s in loc}
    recv, rpay, ovfA, ctx = _exchange(wk_d, spl_d, S, M1, devs,
                                      _each(devs, lambda s: [s * B + ar[devs[s]][:B]]))
    del wk_d
    colex_a, su_a, pos_sh = [None] * S, [None] * S, [None] * S
    for s in loc:
        idx = kj.match_rows(recv[s], nodes_d[s], ar[devs[s]][:Mn])
        # the shard's dense position table: the routed window's global
        # END lands at its node's local slot (one window a real node in a
        # DSPSS; dummies stay -1), the input of ShardedIndex.build
        pos = torch.full((Mn + 1,), -1, dtype=torch.int64, device=devs[s])
        pos_sh[s] = _scatter_rows(pos, torch.where(idx >= 0, idx, Mn), rpay[s][0] + (k - 1), Mn)
        colex_a[s] = torch.where(idx >= 0, s * Mn + idx, -1)
        su_a[s] = torch.where(idx >= 0, su_d[s][idx.clamp(min=0)], -1)
    del recv, rpay, nodes_d
    colex_b = _answers_back(colex_a, ctx, [B] * S, S, M1, devs)
    su_b = _answers_back(su_a, ctx, [B] * S, S, M1, devs)
    miss = _each(devs, lambda s: (val_d[s] & (colex_b[s] < 0)).sum())
    wlen = _each(devs, lambda s: torch.where(val_d[s], su_b[s], k + 2))
    wcol = _each(devs, lambda s: torch.where(val_d[s], colex_b[s], 0))
    # per-START candidate -> per-END candidate: shift right k-1 across
    # shards (the left neighbour's last k-1, a halo; shard 0 takes the
    # fill)
    tails = _all_gather(devs, _each(devs, lambda s: torch.stack(
        [wlen[s][B - (k - 1):], wcol[s][B - (k - 1):]])))
    e = [None] * S
    for s in loc:
        if s == 0:
            halo_l = torch.full((k - 1,), k + 2, dtype=torch.int64, device=devs[s])
            halo_c = torch.zeros(k - 1, dtype=torch.int64, device=devs[s])
        else:
            halo_l, halo_c = _move(devs, tails[s - 1], devs[s])
        e_len = torch.cat([halo_l, wlen[s][: B - (k - 1)]])
        e_col = torch.cat([halo_c, wcol[s][: B - (k - 1)]])
        has_pc = pcl_d[s] <= k + 1
        e_len = torch.where(has_pc, pcl_d[s], e_len)
        e_col = torch.where(has_pc, pcc_d[s], e_col)
        # the (hi, lo) uint32 pair of JAX as one 64-bit key: hi = len << 16
        # | col >> 15, lo = (col & 0x7FFF) << 8 | r
        e[s] = ((((e_len & U32) << 16) | (e_col >> 15)) << 32) | ((e_col & 0x7FFF) << 8)
    del wlen, wcol, pcl_d, pcc_d, tails
    # right halo for the window minimum (ends t1 .. t1+k-2): the right
    # neighbour's first k-1; the last shard takes the fill
    heads = _all_gather(devs, _each(devs, lambda s: e[s][: k - 1]))
    outs = [None] * S
    for s in loc:
        rh = (_move(devs, heads[s + 1], devs[s]) if s + 1 < S
              else torch.full((k - 1,), BIG, dtype=torch.int64, device=devs[s]))
        ext = torch.cat([e[s], rh])
        fin = torch.full((B,), BIG, dtype=torch.int64, device=devs[s])
        for r in range(k):
            c = ext[r : r + B] | r
            bad = (c >> 48) > r + 1
            fin = torch.minimum(fin, torch.where(bad, BIG, c))
        valid = val_d[s]
        fin_hi, fin_lo = fin >> 32, fin & U32
        none_cnt = (valid & (fin_hi >= BIG >> 32)).sum()
        fin_col = ((fin_hi & 0xFFFF) << 15) | (fin_lo >> 8)
        fin_r = fin_lo & 0xFF
        ws_g = s * B + ar[devs[s]][:B]
        uid = torch.searchsorted(ends_d[devs[s]], ws_g, right=True)
        st_u = starts_d[devs[s]][uid.clamp(max=n_u - 1)]
        local_end = ws_g - st_u + fin_r
        order_g = int(base_ord[s]) + torch.cumsum(valid.to(torch.int64), 0) - 1
        outs[s] = (fin_col, local_end, order_g, ws_g + fin_r, valid, none_cnt)
    del e, heads
    if _sum_all(devs, _total(miss)) != 0:
        raise AssertionError("sharded finimizer build: window k-mer missing "
                             "from the node set (input not a DSPSS?)")
    if _sum_all(devs, _total(ovfA)) != 0:
        raise AssertionError("sharded finimizer build: the exact window capacity overflowed")
    if _sum_all(devs, _total([None if o is None else o[5] for o in outs])) != 0:
        raise AssertionError("sharded finimizer build: window without a "
                             "candidate (impossible for a valid t=1 DSPSS)")
    max_end = int(torch.stack([outs[s][1].max().to(devs[loc[0]]) for s in loc]).max())
    if _max_all(devs, max_end) >= (1 << 30):
        raise ValueError("unitig longer than 2^30: scatter key overflow")

    # ---- phase B: route rows to node owners, resolve the overwrite rule
    M2 = max(1, int(np.ceil(slack * n_valid / S)))
    own = _each(devs, lambda s: torch.where(outs[s][4], outs[s][0] // Mn, S))
    rows = _each(devs, lambda s: outs[s][:4])
    while True:
        recvB, ovfB = _route_by_owner(own, rows, S, M2, devs)
        if _sum_all(devs, _total(ovfB)) == 0:
            break
        M2 *= 2
    del outs, own, rows
    fmin_parts, glob_parts = [None] * S, [None] * S
    for s in loc:
        col_r, le_r, od_r, ge_r = recvB[s]
        got = col_r >= 0
        coll = torch.where(got, col_r - s * Mn, 0)
        # scatter-max key (local_end << 33 | (2^33-1 - order), or order
        # when local_end == 0) as three uint32 planes: order < 2^31 makes
        # bit 32 of (2^33-1 - order) always 1
        key_hi = torch.where(le_r > 0, ((le_r << 1) | 1) & U32, 0)
        key_lo = torch.where(le_r > 0, U32 - (od_r & U32), od_r & U32)
        planes = torch.stack([key_lo, key_hi, torch.where(got, coll, kj.SENT)], dim=1)
        order2 = kj.argsort_rows(planes)
        s_col, s_ge, s_got = coll[order2], ge_r[order2], got[order2]
        nxt_col = torch.cat([s_col[1:], s_col.new_full((1,), -1)])
        nxt_got = torch.cat([s_got[1:], s_got.new_zeros(1)])
        winner = s_got & ((s_col != nxt_col) | ~nxt_got)
        fmin_parts[s] = _scatter_rows(torch.zeros(Mn + 1, dtype=torch.uint8, device=devs[s]),
                                      torch.where(s_got, s_col, Mn),
                                      torch.ones_like(s_col, dtype=torch.uint8), Mn)
        glob_parts[s] = _scatter_rows(torch.zeros(Mn + 1, dtype=torch.int64, device=devs[s]),
                                      torch.where(winner, s_col, Mn), s_ge, Mn)

    fmin_bv = np.concatenate(_host(devs, fmin_parts))[:n_nodes].astype(np.uint8)
    global_offsets = np.concatenate(_host(devs, glob_parts))[:n_nodes].clip(0).astype(np.uint64)
    marked = np.flatnonzero(fmin_bv).astype(np.int64)
    stats_packed = np.sort((su[marked].astype(np.int64) << 41) | (marked << 1))
    stats = FinimizerStatsSet(stats_packed, n_nodes)
    if return_pos:
        pos_shards = [p.astype(np.int32) for p in _host(devs, pos_sh)]
        return fmin_bv, global_offsets, stats, (pos_shards, Mn)
    return fmin_bv, global_offsets, stats


def sharded_index_build(seqs, k: int, mesh=None, n_devices: Optional[int] = None,
                        devices=None):
    """End-to-end mesh-sharded finimizer index: the sample-sort SBWT
    (sharded_sbwt_build), the node-sharded LCS (parallel.mesh.
    sharded_lcs_fn), the mesh finimizer selection
    (sharded_finimizer_select). The host keeps the O(n_unitigs * k)
    control plane (unitig permutation, prefix candidates). Equals
    FinimizerIndexBuilder's index (tests/test_torch_shard_build.py), and
    carries index.mesh_pos for parallel.mesh.ShardedIndex.build. Over a
    distributed.global_devices list every rank runs it together, holds
    only its own shards, and returns the whole index."""
    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.index.packed_strings import permute_unitigs
    from finito_tpu_torch.io.seqdb import SeqDB
    from finito_tpu_torch.parallel.mesh import sharded_lcs_fn
    from finito_tpu_torch.utils.bits import bit_width_for_max

    devs = flat_devices(mesh, n_devices, devices)
    if not isinstance(seqs, SeqDB):
        unitigs = SeqDB.from_sequences([s if isinstance(s, bytes) else s.encode() for s in seqs])
    else:
        unitigs = seqs
    sbwt, node_keys = sharded_sbwt_build(
        [unitigs.get_codes(i) for i in range(len(unitigs))], k, devices=devs, return_keys=True,
    )
    LCS = sharded_lcs_fn(devs, sbwt)
    packed, ustart, _perm = permute_unitigs(sbwt, unitigs)
    fmin_bv, global_offsets, stats, mesh_pos = sharded_finimizer_select(
        sbwt, LCS, packed, node_keys, devs, return_pos=True
    )
    index = FinimizerIndex()
    index.mesh_pos = mesh_pos
    index.sbwt = sbwt
    index.LCS = np.asarray(LCS, dtype=np.int64)
    index.lcs_width = bit_width_for_max(k - 1)
    index.unitigs = packed
    index.fmin = fmin_bv
    index.global_offsets = global_offsets[fmin_bv == 1].astype(np.uint64)
    index.offsets_width = bit_width_for_max(int(global_offsets.max()) if fmin_bv.size else 0)
    index.Ustart = ustart
    index.rebuild_rank_supports()
    index.finimizer_stats = stats
    return index

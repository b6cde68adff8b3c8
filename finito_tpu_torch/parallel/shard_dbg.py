"""Mesh-sharded compacted-dBG unitig construction: the twin of
finito_tpu/parallel/shard_dbg.py.

The memory-heavy phases of dbg.build_unitigs -- the canonical k-mer node
set (dedup of all windows) and the successor resolution (8 candidate
lookups a node) -- run sharded over the mesh with the sample-sort and
routed-join machinery of the mesh SBWT build (parallel.shard_build):

  * canonical windows are packed per shard on the host (forward or
    reverse complement by a rowwise compare), sample-sorted into
    colex-range shards with one padded all_to_all and deduped locally;
  * successor candidates (2 orientations x 4 chars, made by device key
    algebra: drop-first == >>3, the candidate's reverse complement from
    the parent's) route to their owning shard, which joins them against
    its node range, and the answers (global node index) ride the
    inverse all_to_all back;
  * out-degrees and successors reduce on the host; in-degrees come from
    the bidirected identity indeg(y) == outdeg(rc(y));
  * the host keeps the O(n) link and chain control plane, and emission
    runs through the same dbg.links_to_unitigs as the host builder, so
    the strings are bit-identical (tests/test_torch_shard_dbg.py).

Canonical mode only (odd k). Shards are a flat list of torch devices in
one process (parallel.shard_build.flat_devices); each exchange has a
fixed capacity with an overflow retry. A device list that spans
processes is refused: the JAX package's build reads every shard's nodes
on the host (np.asarray of the sharded array), so it runs in one
process too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from finito_tpu_torch.ops import keys as kj
from finito_tpu_torch.ops.bits import U32
from finito_tpu_torch.parallel.shard_build import (
    _answers_back,
    _distinct,
    _exchange,
    _host_splitters,
    _pack_shards,
    _per_device,
    _resent,
    _total,
    flat_devices,
)
from finito_tpu_torch.sbwt import keys as kw


def _rc_rows(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of (n, P) key planes: char c at position p
    (values 1..4) -> 5-c at position k-1-p; k passes of plane arithmetic
    (dbg._rc_keys on host words). Chars whose 3 bits straddle two planes
    are read and written across both."""
    out = torch.zeros_like(keys)
    for p in range(k):
        comp = (5 - kj.char_at_rows(keys, p)) & U32
        kj.or_char_rows_(out, k - 1 - p, comp)
    return out


def _set_top_char_rows(keys: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """keys | (c << 3(k-1)) on (n, P) planes (the top slot must be zero)."""
    return kj.or_char_rows_(keys.clone(), k - 1, c)


def sharded_unitig_build(
    seqs: Sequence,
    k: int,
    mesh=None,
    n_devices: Optional[int] = None,
    slack: float = 1.5,
    devices=None,
) -> List[np.ndarray]:
    """build_unitigs(canonical=True) with the node set and the successor
    joins sharded over the mesh (the shards' devices: flat_devices);
    returns the same unitig code arrays bit for bit."""
    from finito_tpu_torch.dbg import _split_valid, links_to_unitigs
    from finito_tpu_torch.io.seqdb import encode_seq
    from finito_tpu_torch.sbwt.keys import cmp_keys, rc_keys, select_keys, unpack_char

    if not (2 <= k <= 250) or k % 2 == 0:
        raise ValueError("sharded unitig build: canonical mode needs odd k in [3, 249]")
    devs = flat_devices(mesh, n_devices, devices)
    if devs.spans:
        raise NotImplementedError("sharded_unitig_build runs in one process (as the JAX "
                                  "package's); give it this process's devices")
    S = len(devs)
    Pp = kj.n_planes(k)

    # ---- host prep: canonical window keys, split contiguously ----------
    segs: List[np.ndarray] = []
    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode_seq(
            s if isinstance(s, bytes) else s.encode()
        )
        segs.extend(g for g in _split_valid(np.asarray(codes, np.uint8)) if g.size >= k)
    if not segs:
        return []

    def canon_keys(seg):
        fwd = kw.pack_windows(seg, k)
        rc = kw.pack_windows((3 - seg)[::-1], k)
        rc = [w[::-1] for w in rc]
        return select_keys(cmp_keys(fwd, rc) <= 0, fwd, rc)

    keys0, sample = _pack_shards(segs, k, devs, canon_keys)
    spl = _per_device(devs, _host_splitters(sample, S, Pp))

    # ---- phases A, B: sample sort + dedup -> nodes, colex-range sharded
    nodes, m_host, _ = _distinct(keys0, spl, devs)
    del keys0
    n = int(m_host.sum())
    if 2 * n >= (1 << 31):
        # oriented ids and exchange answers are int32 in the JAX package;
        # the same limit here
        raise ValueError(f"sharded unitig build supports < 2^30 nodes, got {n}")
    base = np.concatenate([[0], np.cumsum(m_host)[:-1]]).astype(np.int64)

    # nodes occupy the front of each shard's capacity-R1 block: reslice
    # before the 8 successor exchanges scale their shapes
    R2 = max(1, int(m_host.max()))
    nodes = [nd[:R2] for nd in nodes]

    # ---- phase S: successor resolution (routed join) -------------------
    # Each shard makes 8 candidate canonical keys a node (orientation o
    # in {fwd, rc} x extension char c in 1..4), tagged with is_f
    # (candidate stored fwd?). They route by the nodes' splitters; the
    # owner joins them against its node range and answers the global
    # node index (base + local row).
    M3 = max(1, int(np.ceil(slack * R2 / S)))
    sents = [kj.is_sentinel(nd) for nd in nodes]
    rcns = [torch.where(se[:, None], kj.SENT, _rc_rows(nd, k)) for nd, se in zip(nodes, sents)]
    gid0 = [int(base[s]) + torch.arange(R2, device=devs[s]) for s in range(S)]
    cands = []  # (o, c) -> (per-shard canonical candidate, per-shard is_f)
    for o in (0, 1):
        for c in range(1, 5):
            ycs, isfs = [], []
            for s in range(S):
                X, X_rc = (nodes[s], rcns[s]) if o == 0 else (rcns[s], nodes[s])
                y = _set_top_char_rows(kj.shift_right3_rows(X), k, c)
                y_rc = kj.shift_left_rows(kj.mask_low_rows(X_rc, k - 1), 1)
                y_rc[:, 0] |= 5 - c
                is_f = kj.cmp_rows(y, y_rc) <= 0
                ycs.append(_resent(torch.where(is_f[:, None], y, y_rc), sents[s]))
                isfs.append(is_f)
            cands.append((ycs, isfs))
    del rcns
    while True:
        anss, ovf_tot = [], []
        for ycs, _ in cands:
            recvQ, _, ovf, ctx = _exchange(ycs, spl, S, M3, devs)
            ans = [kj.match_rows(recvQ[s], nodes[s], gid0[s]) for s in range(S)]
            anss.append(_answers_back(ans, ctx, [R2] * S, S, M3, devs))
            ovf_tot += ovf
        if _total(ovf_tot) == 0:
            break
        M3 *= 2

    # ---- host: assemble degrees/links over global oriented ids ---------
    ans8 = np.stack([np.stack([a[s].cpu().numpy() for a in anss]) for s in range(S)])  # (S, 8, R2)
    isf8 = np.stack([np.stack([f[s].cpu().numpy() for _, f in cands]) for s in range(S)])
    del anss, cands
    outdeg = np.zeros(2 * n, np.int8)
    succ = np.full(2 * n, -1, np.int64)
    for s in range(S):
        m = int(m_host[s])
        if m == 0:
            continue
        src_gid = base[s] + np.arange(m, dtype=np.int64)
        for oc in range(8):
            o, _c = divmod(oc, 4)
            a = ans8[s, oc, :m].astype(np.int64)
            f = isf8[s, oc, :m].astype(bool)
            hit = a >= 0
            so = 2 * a + np.where(f, 0, 1)
            src = 2 * src_gid + o
            outdeg[src[hit]] += 1
            succ[src[hit]] = so[hit]
    indeg = outdeg.reshape(-1, 2)[:, ::-1].reshape(-1)  # indeg(y) = outdeg(y^1)

    # ---- emission: the host builder's logic, key rows from the shards ---
    nodes_np = np.stack([nd.cpu().numpy() for nd in nodes])  # (S, R2, P)
    del nodes

    def fetch_rows(gids: np.ndarray) -> List[np.ndarray]:
        sh = np.searchsorted(base, gids, side="right") - 1
        loc = gids - base[sh]
        return kj.to_host(nodes_np[sh, loc])

    # per-node top chars (fwd + rc) in global id order
    all_keys = kj.to_host(np.concatenate([nodes_np[s, : m_host[s]] for s in range(S)], axis=0))
    top_f = kw.top_char(all_keys, k)
    top_r = kw.top_char(rc_keys(all_keys, k), k)

    def fetch_head_mat(fnode, fori):
        keys = fetch_rows(fnode)
        rck = rc_keys(keys, k)
        sel = [np.where(fori, r, f) for f, r in zip(keys, rck)]
        head_mat = np.empty((fnode.size, k), dtype=np.uint8)
        for p in range(k):
            head_mat[:, p] = unpack_char(sel, p) - 1
        return head_mat

    return links_to_unitigs(outdeg, succ, indeg, top_f, top_r, fetch_head_mat, k, True)

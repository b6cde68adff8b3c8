"""The "replica" device engine: the reference's exact streaming query,
resolving positions through the index's own dictionaries with no dense
per-node position table; counterpart of make_replica_locate_v2 and of
the in-scan twin make_replica_locate in finito_tpu/query/replica.py, in
plain torch.

FinimizerIndex::search (FinimizerIndex.hh:119-185) and
rarest_fmin_streaming_search (common.hh:78-186) reshaped for a batch:

  * phases A and B are the stream engine's: ops.streaming.make_two_phase
    (the optimistic chain, then the segment repair) on the tables of
    two_phase_tables, with (SU, Ustart) of the target node packed into
    the edge entry (rank24.build_edge_aug_table) when the index allows
    (n < 2^24, k <= 63); replica_tables adds the tail's tables;
  * the tail (resolve_windows): finimizer candidates in closed form --
    when the interval of the scanned suffix is a singleton {x}, the
    shortest unique suffix ending there has length SU[x] and colex x;
    the per-window (len, colex, end)-minimum over in-window candidates;
    the rightmost Ustart singleton as a running carry; then one row
    gather per window resolves both dictionaries
    (build_resolution_table) and one rank gather gives the unitig id
    (build_uend_table).

make_replica_locate is the in-scan twin kept as the arbiter: one exact
chain scan with the reference's drop-and-widen recovery inside each
step, then the same closed-form candidates and both dictionaries
resolved by rank.

Output equals FinimizerIndex.search bit-exactly (tested against the host
oracle and the JAX engine).
"""

from __future__ import annotations

import numpy as np
import torch

from finito_tpu_torch.ops.bits import put_i32
from finito_tpu_torch.ops.rank24 import (
    _NO_CAND,
    EDGE_AUG_MIN,
    EDGE_NODE_MASK,
    build_contract_k_table,
    build_edge_aug_table,
    build_edge_table,
    build_lcs_jump_tables,
    build_rank24_tables,
    build_su_table,
    build_su_ustart_table,
    can_augment_edges,
    rank24,
    update_interval24,
    widen_interval,
)
from finito_tpu_torch.ops.streaming import auto_chunk, make_two_phase, n_chunks
from finito_tpu_torch.utils import trace


def rank1(tab: torch.Tensor, i):
    """Batched rank over a single-bitvector rank24 table (both forms):
    rank24 of its only row; returns int64."""
    return rank24(tab, 0, 0, i)


def build_uend_table(ends) -> np.ndarray:
    """rank24 table over the unitig-END positions of the concatenated
    text: uid(g_start) == #{ends <= g_start} == rank(g_start + 1) -- one
    gather in place of a binary search over the ends."""
    e = np.asarray(ends, dtype=np.int64)
    bits = np.zeros(int(e[-1]) + 2 if e.size else 2, dtype=np.uint8)
    bits[e] = 1
    return build_rank24_tables(bits[None, :])


def build_resolution_table(fmin, global_offsets, Ustart, ends) -> np.ndarray:
    """(n, 2) int32 rows [ustart_gstart, fin_gend]: the branch- and
    finimizer-dictionary lookups (ref common.hh:61-72) with their rank
    indirections precomputed per node.

      ustart_gstart[x] = ends[rank_Ustart(x) - 1] (0 for the first
          unitig): start of the unitig whose first k-mer has colex x;
          meaningful only at Ustart nodes, gather-safe elsewhere.
      fin_gend[x] = global_offsets[rank_fmin(x)]: global end of the
          canonical occurrence of the finimizer with colex x; meaningful
          only at fmin nodes."""
    fm = np.asarray(fmin, np.int64)
    us = np.asarray(Ustart, np.int64)
    e = np.asarray(ends, np.int64)
    go = np.asarray(global_offsets, np.int64)
    n = fm.size
    ur = np.cumsum(us) - us  # exclusive rank
    g = np.where(ur > 0, e[np.maximum(ur - 1, 0)] if e.size else 0, 0)
    fr = np.cumsum(fm) - fm
    fe = go[np.clip(fr, 0, max(go.size - 1, 0))] if go.size else np.zeros(n, np.int64)
    return np.stack([g, fe], axis=1).astype(np.int32)


def two_phase_tables(index, device="cuda", aug: bool = False) -> dict:
    """ops.streaming.make_two_phase's device tables of one FinimizerIndex,
    the stream and replica engines' both: rank24 rows (tab, n8), C,
    contract_k (ck), the LCS jumps (jl, jr), the forward edges (edge,
    augmented when aug), k and n_nodes."""
    k = index.sbwt.get_k()
    bit_rows = index.sbwt.bit_rows()
    C = index.sbwt.get_C_array()
    ck = build_contract_k_table(index.LCS, k)
    jl, jr = build_lcs_jump_tables(index.LCS)
    edge = (build_edge_aug_table(bit_rows, C, ck, index.LCS, np.asarray(index.Ustart, np.uint8))
            if aug else build_edge_table(bit_rows, C, ck))
    tab = build_rank24_tables(bit_rows)
    arrays = {"tab": tab, "C": C, "ck": ck, "jl": jl, "jr": jr, "edge": edge}
    P = {name: put_i32(a, device) for name, a in arrays.items()}
    P.update(n8=tab.shape[0] // 4, k=k, n_nodes=index.sbwt.number_of_subsets(), aug=aug)
    return P


def replica_tables(index, device="cuda") -> dict:
    """The replica engine's device tables: two_phase_tables (edges
    augmented when the index allows), the SU|Ustart table (suu), ends,
    the unitig-end rank table (uend_tab), the resolution rows (res_tab)."""
    P = two_phase_tables(index, device,
                         can_augment_edges(index.sbwt.number_of_subsets(), index.sbwt.get_k()))
    ustart = np.asarray(index.Ustart, np.uint8)
    arrays = {
        "suu": build_su_ustart_table(index.LCS, ustart),
        "ends": index.unitigs.ends,
        "uend_tab": build_uend_table(index.unitigs.ends),
        "res_tab": build_resolution_table(np.asarray(index.fmin, np.uint8),
                                          index.global_offsets, ustart, index.unitigs.ends),
    }
    P.update((name, put_i32(a, device)) for name, a in arrays.items())
    return P


def window_finimizers(cl, cc, k: int):
    """The per-window finimizer: the (len, colex, end)-minimum over the
    in-window candidates whose start lies inside the window (len <= r + 1
    at window offset r; _NO_CAND never qualifies). cl, cc: (B, L) int64
    candidate lengths and colex ranks. Returns (B, W) (len, colex, r)."""
    B, L = cl.shape
    W = L - k + 1
    fin_len = torch.full((B, W), _NO_CAND, dtype=torch.int64, device=cl.device)
    fin_colex = torch.zeros_like(fin_len)
    fin_r = torch.zeros_like(fin_len)
    for r in range(k):
        cl_r = cl[:, r : r + W]
        cc_r = cc[:, r : r + W]
        better = (cl_r <= r + 1) & (
            (cl_r < fin_len) | ((cl_r == fin_len) & (cc_r < fin_colex))
        )
        fin_len = torch.where(better, cl_r, fin_len)
        fin_colex = torch.where(better, cc_r, fin_colex)
        fin_r = torch.where(better, r, fin_r)
    return fin_len, fin_colex, fin_r


def unitig_locations(P: dict, found, g_start):
    """Global window starts -> (B, W) int32 (uid, off), -1 where not
    found: the uid by one rank gather on the unitig-end bitvector; the
    clamps only keep a masked-off lane's index in its table."""
    ends = P["ends"]
    n_bits = 8 * P["uend_tab"].shape[0] - 1
    uid = rank1(P["uend_tab"], (torch.where(found, g_start, 0) + 1).clamp(0, n_bits))
    off = g_start - torch.where(uid > 0, ends[(uid - 1).clamp(0, ends.numel() - 1)], 0)
    return (torch.where(found, uid, -1).to(torch.int32),
            torch.where(found, off, -1).to(torch.int32))


def resolve_windows(P: dict, emit, cand, chunk: int = 0):
    """The replica tail: repaired (B, L) emit and cand grids -> (B, W)
    int32 (uid, off), -1 where absent. chunk is the chain's chunk length
    (0 = whole reads): with augmented edges, raw candidates occur only at
    the read head j < k and at each chunk's seeding close."""
    k, aug, suu = P["k"], P["aug"], P["suu"]
    L = emit.shape[1]
    W = L - k + 1
    dev = emit.device
    ranks = emit[:, k - 1 :]  # (B, W)
    found = ranks >= 0
    cand = cand.to(torch.int64)

    # candidate grids: length, colex, Ustart flag per position
    if aug:
        augm = cand >= EDGE_AUG_MIN
        x = torch.where(augm, cand & EDGE_NODE_MASK, cand)
        cl = torch.where(augm, cand >> 25, _NO_CAND)
        uf = augm & (((cand >> 24) & 1) == 1)
        cols = list(range(min(k, L)))
        if k <= chunk < L:
            S = chunk - k + 1
            cols += [s * S + k - 1 for s in range(1, n_chunks(L, k, chunk))
                     if s * S + k - 1 < L]
        cidx = torch.tensor(sorted(set(cols)), dtype=torch.int64, device=dev)
        sl = cand[:, cidx]
        raw = (sl >= 0) & (sl < EDGE_AUG_MIN)
        sw = suu[torch.where(raw, sl, 0)].to(torch.int64)
        cl[:, cidx] = torch.where(raw, sw & 0xFF, cl[:, cidx])
        uf[:, cidx] = uf[:, cidx] | (raw & (((sw >> 8) & 1) == 1))
    else:
        x = cand
        sw = suu[torch.where(cand >= 0, cand, 0)].to(torch.int64)
        cl = torch.where(cand >= 0, sw & 0xFF, _NO_CAND)
        uf = (cand >= 0) & (((sw >> 8) & 1) == 1)
    cl = torch.where(cand >= 0, cl, _NO_CAND)

    # rightmost Ustart singleton carry: the JAX "last non-null"
    # associative scan; its positions increase along a row, so it is a
    # running max of the positions and a gather of their nodes
    jpos = torch.arange(L, device=dev)[None, :]
    up = torch.cummax(torch.where(uf, jpos, -1), dim=1).values
    ux = torch.gather(torch.where(uf, x, 0), 1, up.clamp(min=0))

    _, fin_colex, fin_r = window_finimizers(cl, torch.where(cand >= 0, x, 0), k)

    up_w = up[:, k - 1 :]
    ux_w = ux[:, k - 1 :]
    ws = torch.arange(W, device=dev)[None, :]
    use_branch = found & (up_w >= ws + fin_r)

    # both dictionaries resolve through one precomputed row gather
    ridx = torch.where(use_branch, ux_w, torch.where(found, fin_colex, 0))
    rows = P["res_tab"][ridx].to(torch.int64)
    g_end_branch = rows[..., 0] + (k - 1) + ((ws + k - 1) - up_w)
    g_end_fin = rows[..., 1] + ((k - 1) - fin_r)
    g_end = torch.where(use_branch, g_end_branch, g_end_fin)
    return unitig_locations(P, found, g_end - k + 1)


def make_replica_locate_v2(index, K_seg: int = 4096, chunk: int | None = None,
                           device="cuda", tables: dict | None = None):
    """Two-phase exact replica: optimistic chain + segment repair, then
    the dictionary tail. Returns locate(codes) -> (uid, off, n_seg) for
    (B, L) uint8 codes (tensor on the tables' device, or numpy); results
    are valid only when n_seg <= K_seg (the caller re-runs larger).
    tables: replica_tables(index, device), built here when None (an
    engine passes its own so that a re-run at another K rebuilds
    nothing).

    chunk (None = auto_chunk, 0/>= L = off) splits each read into
    k-1-overlapped chunks scanned as extra lanes (chunk_reads); the
    output is the same."""
    P = replica_tables(index, device) if tables is None else tables
    k = P["k"]
    two_phase = make_two_phase(P["n8"], k, P["n_nodes"], K_seg, aug=P["aug"])

    def locate(codes):
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(codes).to(P["tab"].device)
        B, L = codes.shape
        cc_len = auto_chunk(k, B, L) if chunk is None else chunk
        emit, cand, n_seg = two_phase(P["tab"], P["C"], P["ck"], P["jl"], P["jr"], P["suu"],
                                      P["edge"], codes, cc_len)
        with trace.span("replica_tail"):
            uid, off = resolve_windows(P, emit, cand, cc_len)
        return uid, off, n_seg

    return locate


def make_replica_locate(index, device="cuda"):
    """The in-scan twin, the arbiter the two-phase form is held to: one
    exact chain scan whose interval evolves as the reference's does --
    extension, and on failure left-contraction by widen_interval
    (drop_first_char) until the extension succeeds or the suffix is
    empty -- with no restart and no repair phase. Returns locate(codes)
    -> ((B, W) int32 uid, off) for (B, L) uint8 codes (a tensor on
    device, or numpy; pad 255).

    It derives its own tables from the loaded index. Not a serving path:
    each recovery-loop trip and each widen hop round reads one flag back
    to the host."""
    k = index.sbwt.get_k()
    n_nodes = index.sbwt.number_of_subsets()
    tab_np = build_rank24_tables(index.sbwt.bit_rows())
    n8 = tab_np.shape[0] // 4
    jl_np, jr_np = build_lcs_jump_tables(index.LCS)
    fmin = np.asarray(index.fmin, np.uint8)
    ustart = np.asarray(index.Ustart, np.uint8)
    goffs = index.global_offsets.astype(np.int64)
    arrays = {
        "tab": tab_np, "C": index.sbwt.get_C_array(),
        "ck": build_contract_k_table(index.LCS, k), "jl": jl_np, "jr": jr_np,
        "su": build_su_table(index.LCS),
        "fmin_tab": build_rank24_tables(fmin[None, :]),
        "ustart_tab": build_rank24_tables(ustart[None, :]),
        "ustart_bits": ustart,
        # one never-read row when the index holds no finimizer
        "goffs": goffs if goffs.size else np.zeros(1, np.int64),
        "ends": index.unitigs.ends,
        "uend_tab": build_uend_table(index.unitigs.ends),
    }
    P = {name: put_i32(a, device) for name, a in arrays.items()}
    tab, C, jl, jr = P["tab"], P["C"], P["jl"], P["jr"]

    def upd(c, lo, hi):
        return update_interval24(tab, n8, C, c, lo, hi)

    def chain(codes):
        """The exact scan: per position the emitted rank (-1 none), the
        candidate length (_NO_CAND none) and colex, and the rightmost
        Ustart singleton's position and node so far; each (B, L)."""
        B, L = codes.shape
        dev = codes.device
        cs = codes.to(torch.int64)
        lo = torch.zeros(B, dtype=torch.int64, device=dev)
        hi = torch.full_like(lo, n_nodes - 1)
        ks = torch.zeros_like(lo)
        up = torch.full_like(lo, -1)
        ux = torch.zeros_like(lo)
        outs = []
        for j in range(L):
            c = cs[:, j]
            invalid = c > 3
            nlo, nhi = upd(c, lo, hi)
            # recovery: advance ks and widen until the extension succeeds
            # or the suffix empties (ref common.hh:116-127); invalid
            # chars reset at once instead
            ks = torch.where(invalid, j + 1, ks)
            need = (nlo < 0) & ~invalid
            while bool(need.any()):
                ks = torch.where(need, ks + 1, ks)
                emptied = need & (ks > j)
                wlo, whi = widen_interval(jl, jr, lo, hi, torch.where(need, j - ks, k + 1),
                                          n_nodes)
                lo = torch.where(need & ~emptied, wlo, lo)
                hi = torch.where(need & ~emptied, whi, hi)
                rlo, rhi = upd(c, lo, hi)
                # emptied lanes: the empty string's interval, c unconsumed
                nlo = torch.where(emptied, 0, torch.where(need, rlo, nlo))
                nhi = torch.where(emptied, n_nodes - 1, torch.where(need, rhi, nhi))
                need = need & ~emptied & (rlo < 0)
            nlo = torch.where(invalid, 0, nlo)
            nhi = torch.where(invalid, n_nodes - 1, nhi)

            # candidate: a singleton suffix => the shortest unique suffix
            # ends here, with length SU[x] and colex x
            single = (nlo == nhi) & (ks <= j) & ~invalid
            sx = torch.where(single, nlo, 0)
            cand_len = torch.where(single, P["su"][sx], _NO_CAND)
            cand_colex = torch.where(single, nlo, 0)
            u_here = single & (P["ustart_bits"][sx] == 1)
            up = torch.where(u_here, j, up)
            ux = torch.where(u_here, nlo, ux)

            close = (j - ks + 1 == k) & ~invalid
            emit = torch.where(close, nlo, -1)
            # window slide on close (ref lines 124-125): ks++ and contract
            pair = P["ck"][torch.where(close, nlo, 0)].to(torch.int64)
            lo = torch.where(close, pair[:, 0], nlo)
            hi = torch.where(close, pair[:, 1], nhi)
            ks = torch.where(close, ks + 1, ks)
            outs.append(torch.stack([emit, cand_len.to(torch.int64), cand_colex, up, ux]))
        return torch.stack(outs, dim=2)  # (5, B, L)

    def locate(codes):
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(codes).to(tab.device)
        W = codes.shape[1] - k + 1
        dev = codes.device
        emit, cl, cc, up, ux = chain(codes)
        found = emit[:, k - 1 :] >= 0
        _, fin_colex, fin_r = window_finimizers(cl, cc, k)

        # the rightmost Ustart singleton at the window close, used iff it
        # sits at or after the finimizer's end (FinimizerIndex.hh:158-164)
        up_w, ux_w = up[:, k - 1 :], ux[:, k - 1 :]
        ws = torch.arange(W, device=dev)[None, :]
        use_branch = found & (up_w >= ws + fin_r)
        ends = P["ends"]
        # branch dictionary (common.hh:61-67)
        urank = rank1(P["ustart_tab"], torch.where(use_branch, ux_w, 0))
        u_gstart = torch.where(urank > 0, ends[(urank - 1).clamp(0, ends.numel() - 1)], 0)
        g_end_branch = u_gstart + (k - 1) + ((ws + k - 1) - up_w)
        # finimizer dictionary (common.hh:69-72)
        frank = rank1(P["fmin_tab"], torch.where(found, fin_colex, 0))
        goffs = P["goffs"]
        g_end_fin = goffs[frank.clamp(0, goffs.numel() - 1)] + ((k - 1) - fin_r)
        return unitig_locations(P, found, torch.where(use_branch, g_end_branch, g_end_fin) - k + 1)

    return locate

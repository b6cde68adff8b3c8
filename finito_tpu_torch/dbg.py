"""Compacted de Bruijn graph construction: sequences -> unitigs (DSPSS).

The reference framework requires a DSPSS as input and points users at
the external `ggcat` tool to produce canonical unitigs from raw FASTA
(the reference's README.md:79-84); it contains no construction code of
its own. This module closes that gap natively: it builds the maximal
non-branching paths (unitigs) of the (bidirected) de Bruijn graph over
the distinct (canonical) k-mers of the input, so the full
reads -> index pipeline runs inside finito_tpu_torch with no external
dependency.

Everything is vectorized over the packed multiword k-mer keys of
sbwt.keys (3 bits/char, colex = numeric compare) with the native radix
sort / merge-join underneath:

  * node set        = radix sort + dedup of all (canonical) window keys;
  * graph degrees   = per-char successor candidates built by word
                      arithmetic (drop-first == >>3, RC incrementally
                      from the parent's RC), resolved with one
                      merge-join per char per orientation;
  * unitig chains   = the standard maximal-path rule (out-degree 1 into
                      in-degree 1, never re-entering the same node),
                      decomposed by pointer doubling (O(log n) rounds of
                      gathers) -- no sequential walk;
  * mirror/cycle dedup = every chain's reverse-complement traversal is
                      also a maximal chain; exactly one of each pair is
                      emitted (head id vs mirrored tail id; cycles are
                      broken at their minimum oriented node and emitted
                      iff that minimum beats the mirror cycle's).

Canonical mode (the default, matching `ggcat build --min-multiplicity 1
-k <k>`) requires odd k so no k-mer equals its own reverse complement.
Forward mode (`canonical=False`) builds the ordinary directed dBG of
the exact k-mers seen.

Output is a DSPSS: each input (canonical) k-mer occurs in exactly one
unitig exactly once; tested against a brute-force oracle and round-trip
through the SBWT/finimizer pipeline.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from finito_tpu_torch.sbwt import keys as kw

U64 = np.uint64

# generic packed-key arithmetic lives with the other multiword-key ops;
# kept under the old private names for this module's internal callers
_cmp_words = kw.cmp_keys
_select_keys = kw.select_keys
_rc_keys = kw.rc_keys
_set_top_char = kw.set_top_char
_unpack_char = kw.unpack_char







def _collect_nodes(
    seqs: Sequence[np.ndarray], k: int, canonical: bool,
    batch_windows: int = 16 << 20, min_mult: int = 1,
):
    """Sorted unique (canonical) window keys of all sequences, keeping
    only k-mers seen >= min_mult times (ggcat's --min-multiplicity:
    with sequencing reads, singletons are usually errors).

    Incremental: windows accumulate into ~batch_windows-sized chunks,
    each chunk is sorted + deduped (run-length counted when min_mult >
    1), then linear-merged into the running sorted-unique set
    (kw.merge_sorted_unique). Peak memory is ~(distinct + batch) keys
    instead of every window of every sequence at once -- on a redundant
    pangenome that is the redundancy factor."""
    counted = min_mult > 1
    acc = kw.empty(kw.n_words(k))
    acc_counts = np.zeros(0, np.int64)
    parts: List[List[np.ndarray]] = []
    pending = 0

    def flush():
        nonlocal acc, acc_counts, parts, pending
        if not parts:
            return
        srt = kw.sort_keys(kw.concat(parts))
        parts = []
        pending = 0
        dup = kw.eq_adjacent(srt)
        chunk = [w[~dup] for w in srt]
        if not counted:
            acc = kw.merge_sorted_unique(acc, chunk)
            return
        # run-length counts of the sorted chunk
        starts = np.flatnonzero(~dup)
        cnt = np.diff(np.append(starts, dup.size))
        # counts of chunk keys already in acc accumulate in place;
        # new keys merge in with their counts aligned by position
        hit = kw.match_into(chunk, acc)
        old = hit >= 0
        np.add.at(acc_counts, hit[old], cnt[old])
        new_keys = [w[~old] for w in chunk]
        if new_keys[0].size:
            merged = kw.merge_sorted_unique(acc, new_keys)
            pos_of_old = kw.match_into(acc, merged)
            pos_of_new = kw.match_into(new_keys, merged)
            nc = np.zeros(merged[0].size, np.int64)
            nc[pos_of_old] = acc_counts
            nc[pos_of_new] = cnt[~old]
            acc, acc_counts = merged, nc

    for codes in seqs:
        codes = np.asarray(codes, dtype=np.uint8)
        # split at invalid characters (codes > 3): windows must not span
        for seg in _split_valid(codes):
            if seg.size < k:
                continue
            # slice long segments too (k-1 overlap keeps every window):
            # one whole-genome segment must not defeat the batching
            for a in range(0, seg.size - k + 1, batch_windows):
                piece = seg[a : a + batch_windows + k - 1]
                fwd = kw.pack_windows(piece, k)
                if canonical:
                    rc = kw.pack_windows((3 - piece)[::-1], k)
                    rc = [w[::-1] for w in rc]  # align: rc[i] == RC(fwd[i])
                    canon = _select_keys(_cmp_words(fwd, rc) <= 0, fwd, rc)
                else:
                    canon = fwd
                parts.append(canon)
                pending += canon[0].size
                if pending >= batch_windows:
                    flush()
    flush()
    if counted:
        keep = acc_counts >= min_mult
        return [w[keep] for w in acc]
    return acc


def _split_valid(codes: np.ndarray) -> List[np.ndarray]:
    bad = np.flatnonzero(codes > 3)
    if bad.size == 0:
        return [codes]
    segs = []
    prev = 0
    for b in bad:
        if b > prev:
            segs.append(codes[prev:b])
        prev = b + 1
    if prev < codes.size:
        segs.append(codes[prev:])
    return segs


def _chain_decompose(
    nxt: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Functional-graph chain decomposition by pointer doubling.

    nxt[x] in [-1, m): the unique successor link (the target's indeg is
    1 by construction, so chains never merge). Returns
    (head, pos, was_cycle, mirror_min):
      * head[x], pos[x]: the chain head of x and its 0-based position --
        cycles are first broken at their minimum element, which becomes
        that chain's head;
      * was_cycle[x]: True iff x was on a cycle;
      * mirror_min[x]: for cycle elements, min over the cycle of (y ^ 1)
        (== the mirror cycle's minimum, used for mirror-pair dedup);
        undefined elsewhere.
    """
    m = nxt.size
    ids = np.arange(m, dtype=np.int64)
    prev = np.full(m, -1, dtype=np.int64)
    tgt = nxt >= 0
    prev[nxt[tgt]] = ids[tgt]

    # --- find cycles + their minima by doubling on prev -----------------
    # After ceil(log2(m))+1 rounds the chased window covers >= m hops:
    # chain elements' chase dies at a prev==-1 element; cycle elements
    # keep a live ancestor and their window min converges to the cycle
    # minimum (same for the mirrored ids).
    anc = prev.copy()
    mn = np.where(prev >= 0, np.minimum(ids, prev), ids)
    mno = np.where(prev >= 0, np.minimum(ids ^ 1, prev ^ 1), ids ^ 1)
    rounds = max(1, int(np.ceil(np.log2(max(m, 2)))) + 1)
    for _ in range(rounds):
        live = anc >= 0
        if not np.any(live):
            break
        a = anc[live]
        mn[live] = np.minimum(mn[live], mn[a])
        mno[live] = np.minimum(mno[live], mno[a])
        anc[live] = anc[a]
    was_cycle = anc >= 0
    if np.any(was_cycle):
        brk = was_cycle & (ids == mn)  # one per cycle: its minimum
        prev[brk] = -1

    # --- head/pos by doubling on prev (now cycle-free) -------------------
    # Invariant: anc[x] is 'pos[x] - d-ish' hops back... concretely
    # (anc, d): anc is some ancestor d hops back, or -1 when x is a
    # head. Jump only while the ancestor itself has an ancestor, so the
    # final anc IS the head and d the distance.
    anc = prev.copy()
    d = (prev >= 0).astype(np.int64)
    for _ in range(rounds):
        live = np.flatnonzero(anc >= 0)
        if live.size == 0:
            break
        a = anc[live]
        hop = anc[a] >= 0
        if not np.any(hop):
            break
        idx = live[hop]
        aa = a[hop]
        d[idx] += d[aa]
        anc[idx] = anc[aa]
    head = np.where(anc >= 0, anc, ids)
    pos = np.where(anc >= 0, d, 0)
    return head, pos, was_cycle, mno


def build_unitigs(
    seqs: Sequence[np.ndarray], k: int, canonical: bool = True,
    min_mult: int = 1,
) -> List[np.ndarray]:
    """Sequences (uint8 code arrays, 0..3 = ACGT, >3 splits) -> unitig
    code arrays (uint8 0..3), a DSPSS of the input's (canonical) k-mer
    set. min_mult drops k-mers seen fewer times (ggcat
    --min-multiplicity; the dBG is built over the survivors). See
    module docstring for the graph rules."""
    if not (2 <= k <= 250):
        raise ValueError("need 2 <= k <= 250")
    if canonical and k % 2 == 0:
        raise ValueError("canonical mode requires odd k (no self-RC k-mers)")

    nodes = _collect_nodes(seqs, k, canonical, min_mult=min_mult)
    n = nodes[0].size
    if n == 0:
        return []
    nodes_rc = _rc_keys(nodes, k) if canonical else None

    # ---- oriented successor resolution ---------------------------------
    # oriented id = 2*node + o (o=0 fwd, o=1 rc); forward mode uses o=0
    # only but keeps the same id layout for shared code below.
    n_ori = 2 * n
    outdeg = np.zeros(n_ori, dtype=np.int8)
    succ = np.full(n_ori, -1, dtype=np.int64)
    indeg = np.zeros(n_ori, dtype=np.int8)

    orients = (0, 1) if canonical else (0,)
    for o in orients:
        X = nodes if o == 0 else nodes_rc
        X_rc = nodes_rc if o == 0 else nodes
        base = kw.shift_right3(X)
        if canonical:
            base_rc = kw.shift_left(kw.mask_low(X_rc, k - 1), 1)
        for c in range(1, 5):
            y = _set_top_char(base, k, c)
            if canonical:
                y_rc = [w.copy() for w in base_rc]
                y_rc[0] = y_rc[0] | U64(5 - c)
                is_f = _cmp_words(y, y_rc) <= 0
                y_canon = _select_keys(is_f, y, y_rc)
            else:
                is_f = np.ones(n, dtype=bool)
                y_canon = y
            idx = kw.match_into(y_canon, nodes)
            hit = idx >= 0
            # successor oriented id
            so = 2 * idx + np.where(is_f, 0, 1)
            src = 2 * np.arange(n, dtype=np.int64) + o
            outdeg[src[hit]] += 1
            # last-writer is fine: succ is only used where outdeg == 1
            succ[src[hit]] = so[hit]
            np.add.at(indeg, so[hit], 1)

    def fetch_head_mat(fnode, fori):
        if canonical:
            headkeys = _select_keys(
                ~fori, [w[fnode] for w in nodes], [w[fnode] for w in nodes_rc]
            )
        else:
            headkeys = [w[fnode] for w in nodes]
        head_mat = np.empty((fnode.size, k), dtype=np.uint8)
        for p in range(k):
            head_mat[:, p] = _unpack_char(headkeys, p) - 1
        return head_mat

    top_f = kw.top_char(nodes, k)
    top_r = kw.top_char(nodes_rc, k) if canonical else top_f
    return links_to_unitigs(
        outdeg, succ, indeg, top_f, top_r, fetch_head_mat, k, canonical
    )


def links_to_unitigs(
    outdeg: np.ndarray,
    succ: np.ndarray,
    indeg: np.ndarray,
    top_f: np.ndarray,
    top_r: np.ndarray,
    fetch_head_mat,
    k: int,
    canonical: bool,
) -> List[np.ndarray]:
    """Degrees/successors (per oriented node id, 2*node + o) -> emitted
    unitig code arrays. The host builder and the mesh-sharded builder
    (parallel/shard_dbg.py) share it, so both emit bit-identical
    strings.
    fetch_head_mat(fnode, fori) -> (n_sel, k) uint8 head k-mer chars."""
    n_ori = outdeg.size

    # ---- links: maximal-path rule --------------------------------------
    # link x->y iff outdeg(x)==1, indeg(y)==1, and y is not (either
    # orientation of) x's node (no self loops / hairpins).
    has_succ = outdeg == 1
    y_ok = np.zeros(n_ori, dtype=bool)
    sv = succ[has_succ]
    y_ok[has_succ] = (indeg[sv] == 1) & ((sv >> 1) != (np.flatnonzero(has_succ) >> 1))
    link = np.where(has_succ & y_ok, succ, -1)
    if not canonical:
        # forward mode: odd oriented ids are unused; ensure isolated
        link[1::2] = -1

    head, pos, was_cycle, mirror_min = _chain_decompose(link)

    # ---- one emission per mirror pair ----------------------------------
    from finito_tpu_torch import native

    sort_key = head.astype(np.uint64) * U64(max(n_ori, 1)) + pos.astype(np.uint64)
    order = native.argsort_u64(sort_key)
    if order is None:
        order = np.argsort(sort_key, kind="stable")
    h_sorted = head[order]
    new_chain = np.ones(h_sorted.size, dtype=bool)
    if h_sorted.size:
        new_chain[1:] = h_sorted[1:] != h_sorted[:-1]
    chain_starts = np.flatnonzero(new_chain)
    chain_lens = np.diff(np.append(chain_starts, h_sorted.size))
    chain_head = h_sorted[chain_starts]
    chain_tail = order[chain_starts + chain_lens - 1]

    if canonical:
        # linear chains: the mirror chain's head is (tail ^ 1); broken
        # cycles: the mirror cycle's head is ITS minimum (mirror_min) --
        # tail^1 would be an arbitrary rotation point of the mirror.
        cyc = was_cycle[chain_head]
        emit = np.where(
            cyc,
            chain_head <= mirror_min[chain_head],
            chain_head <= (chain_tail ^ 1),
        )
    else:
        emit = (chain_head & 1) == 0  # only even (fwd) ids are real

    # ---- decode emitted chains to code arrays --------------------------
    node_of = order >> 1
    ori_of = (order & 1).astype(bool)
    last_char = (
        np.where(ori_of, top_r[node_of], top_f[node_of]).astype(np.uint8) - 1
    )
    emit_idx = np.flatnonzero(emit)
    firsts = order[chain_starts[emit_idx]]
    head_mat = fetch_head_mat(firsts >> 1, (firsts & 1).astype(bool))
    out: List[np.ndarray] = []
    for i, ci in enumerate(emit_idx):
        s, ln = chain_starts[ci], chain_lens[ci]
        if ln > 1:
            out.append(np.concatenate([head_mat[i], last_char[s + 1 : s + ln]]))
        else:
            out.append(head_mat[i].copy())
    return out


def unitigs_from_fasta(
    path: str, k: int, canonical: bool = True, min_mult: int = 1
) -> List[np.ndarray]:
    """Convenience: FASTA/FASTQ (± gzip) -> unitig code arrays.
    Non-ACGT characters split sequences (no k-mer spans them)."""
    from finito_tpu_torch.io.fastx import SequenceReader
    from finito_tpu_torch.io.seqdb import encode_seq

    seqs = []
    with SequenceReader(path) as r:
        for _hdr, seq in r:
            seqs.append(encode_seq(seq))
    return build_unitigs(seqs, k, canonical=canonical, min_mult=min_mult)


# ---------------------------------------------------------------- flipping


def flip_unitigs(unitigs: Sequence[np.ndarray], k: int) -> List[np.ndarray]:
    """Re-orient unitigs so as many as possible have an incoming
    (k-1)-overlap -- the native equivalent of the external
    `unitig_flipper` the reference README recommends before `sbwt build`
    (the reference's README.md:87-91).

    Why it shrinks the index: the SBWT adds a $-padded dummy chain (up
    to k-1 extra subsets) for every k-mer whose (k-1)-prefix is no
    k-mer's (k-1)-suffix; a unitig whose first k-mer has an incoming
    overlap from another stored unitig needs no chain. Flipping replaces
    a unitig by its reverse complement (same canonical k-mer set; the
    fwd+RC query merge is orientation-blind), so orientations can be
    chosen to chain unitigs head-to-tail. Like the reference tool this
    is a heuristic: a BFS forest over the bidirected overlap graph,
    orienting each newly reached unitig consistently with the edge that
    reached it (one potential chain-head per component instead of per
    unitig). Endpoint matching is one vectorized sort over the 4n
    endpoint keys; the BFS touches each run by array slicing.
    """
    n = len(unitigs)
    if n == 0:
        return []
    for i, u in enumerate(unitigs):
        if u.size < k:
            raise ValueError(
                f"flip-unitigs: record {i} is shorter than k ({u.size} < {k})"
            )
        if np.any(np.asarray(u) > 3):
            raise ValueError(
                f"flip-unitigs: record {i} contains non-ACGT characters"
            )
    firsts = kw.pack_rows(
        np.stack([np.asarray(u[: k - 1], np.uint8) for u in unitigs]) + 1
    )
    lasts = kw.pack_rows(
        np.stack([np.asarray(u[-(k - 1):], np.uint8) for u in unitigs]) + 1
    )
    rc_firsts = kw.rc_keys(firsts, k - 1)  # = last (k-1)-mer of RC(u)
    rc_lasts = kw.rc_keys(lasts, k - 1)  # = first (k-1)-mer of RC(u)

    # one sort groups all 4n endpoint keys into equal-key runs; member
    # m of the concatenation encodes (kind = m // n, unitig = m % n):
    # kind 0: first(o=0), 1: first(o=1), 2: last(o=0), 3: last(o=1)
    comb = kw.concat([firsts, rc_lasts, lasts, rc_firsts])
    order = kw.sort_order(comb)
    skeys = kw.take(comb, order)
    new_run = ~kw.eq_adjacent(skeys)
    run_of_sorted = np.cumsum(new_run) - 1
    run_of = np.empty(4 * n, np.int64)
    run_of[order] = run_of_sorted
    run_start = np.flatnonzero(new_run)
    run_end = np.append(run_start[1:], 4 * n)

    orient = np.full(n, -1, np.int8)
    from collections import deque

    def visit_run(r, want_first, dq):
        # want_first: reach unitigs via their FIRST endpoint (kinds 0/1,
        # giving them an incoming overlap); else via LAST (kinds 2/3)
        for m in order[run_start[r] : run_end[r]]:
            kind, j = int(m) // n, int(m) % n
            if orient[j] >= 0:
                continue
            if want_first and kind in (0, 1):
                orient[j] = 0 if kind == 0 else 1
                dq.append(j)
            elif not want_first and kind in (2, 3):
                orient[j] = 0 if kind == 2 else 1
                dq.append(j)

    for root in range(n):
        if orient[root] >= 0:
            continue
        orient[root] = 0
        dq = deque([root])
        while dq:
            i = dq.popleft()
            o = int(orient[i])
            # my chosen last endpoint key == their first -> they chain in
            visit_run(run_of[(2 + o) * n + i], True, dq)
            # my chosen first endpoint key == their last -> I chain in
            visit_run(run_of[o * n + i], False, dq)
    return [
        u if orient[i] == 0 else (3 - np.asarray(u, np.uint8)[::-1]).astype(np.uint8)
        for i, u in enumerate(unitigs)
    ]


# --------------------------------------------------------------- simplitigs


def build_simplitigs(
    seqs: Sequence[np.ndarray], k: int, min_mult: int = 1
) -> List[np.ndarray]:
    """Greedy maximal-walk SPSS (simplitigs, Brinda et al. 2021) over
    the canonical k-mer set: like unitigs this covers every canonical
    k-mer exactly once (a valid t=1 DSPSS for the index), but walks may
    pass THROUGH branch nodes, so there are far fewer strings and
    (k-1) fewer overlap characters per string -- a direct index-size
    win at pangenome scale where unitigs fragment at variant bubbles.
    Near-minimal in practice; the provably minimal variant (eulertigs)
    is out of scope (DEVIATIONS item 15).

    Hot traversal is native C++ (binary-searched successor probes over
    the sorted canonical key set, deterministic first-fit char order);
    the Python fallback walks a dict at small scale. Odd k only.
    """
    if not (2 <= k <= 250) or k % 2 == 0:
        raise ValueError("simplitigs: canonical mode needs odd k in [3, 249]")
    from finito_tpu_torch import native

    nodes = _collect_nodes(seqs, k, True, min_mult=min_mult)
    n = nodes[0].size
    if n == 0:
        return []
    res = native.simplitigs(nodes, k)
    if res is not None:
        concat, ends = res
        out = []
        prev = 0
        for e in ends:
            out.append(concat[prev:e].copy())
            prev = int(e)
        return out
    return _simplitigs_python(nodes, k)


def _simplitigs_python(nodes: List[np.ndarray], k: int) -> List[np.ndarray]:
    """Fallback: the same deterministic greedy walk over a host dict
    (same first-fit char order as the native kernel -> same output)."""
    n = nodes[0].size
    key_of = {}
    for i in range(n):
        key_of[tuple(int(w[i]) for w in nodes)] = i
    used = np.zeros(n, bool)
    nodes_rc = _rc_keys(nodes, k)

    def one(i):
        return [np.asarray([w[i]]) for w in nodes]

    def extend(cur, cur_rc):
        chars = []
        while True:
            base = kw.shift_right3(cur)
            base_rc = kw.shift_left(kw.mask_low(cur_rc, k - 1), 1)
            found = False
            for c in range(1, 5):
                y = _set_top_char(base, k, c)
                yr = [w.copy() for w in base_rc]
                yr[0] = yr[0] | U64(5 - c)
                q = y if _cmp_words(y, yr)[0] <= 0 else yr
                j = key_of.get(tuple(int(w[0]) for w in q), -1)
                if j >= 0 and not used[j]:
                    used[j] = True
                    chars.append(c)
                    cur, cur_rc = y, yr
                    found = True
                    break
            if not found:
                return chars

    out = []
    for seed in range(n):
        if used[seed]:
            continue
        used[seed] = True
        right = extend(one(seed), [np.asarray([w[seed]]) for w in nodes_rc])
        left = extend([np.asarray([w[seed]]) for w in nodes_rc], one(seed))
        chars = np.empty(k + len(left) + len(right), np.uint8)
        for i, c in enumerate(reversed(left)):
            chars[i] = (5 - c) - 1
        hk = one(seed)
        for p in range(k):
            chars[len(left) + p] = _unpack_char(hk, p)[0] - 1
        for i, c in enumerate(right):
            chars[len(left) + k + i] = c - 1
        out.append(chars)
    return out

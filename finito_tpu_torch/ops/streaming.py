"""Stream compaction and the two-phase streaming rank engine of the
port: counterpart of finito_tpu/ops/streaming.py (compact_mask, the
chunking helpers, make_chain_scan, make_chain_opt, make_segment_repair's
default path and make_chain_stream_ranks), in plain torch but for the
kernels of the chain and the repair. make_two_phase runs both phases
for the stream and replica engines.

Phase A -- the optimistic chain scan (make_chain_opt): a hybrid
automaton per lane; on the card one launch of csrc/chain_opt.cu (a
thread a lane), on the CPU one Python step per read position
(make_chain_opt_ref). Immature lanes track the SBWT interval of
seq[ks..j] (2 rank gathers a step); at the first window close a lane
follows the forward-edge table (1 gather a step). Any failure marks a
k-wide shadow of positions UNTRUSTED and resets the lane.

Phase B -- the segment repair (make_segment_repair): untrusted runs are
compacted to one lane each (split every Q payload positions), seeded
from the trusted predecessor's post-close slide state where possible,
and walked once with the reference's exact recovery state machine
(plateau-jump drops and LCS-widening hops). On the card one launch of
csrc/segment_repair.cu walks each lane to its end (utils.trace counts
`repair.kernel`). On the CPU (make_segment_repair_ref) a fixed number of
Python trips, then straggler trips while any lane is still active, each
straggler check one device-to-host read (straggler_pending; utils.trace
counts them as host_reads.straggler and the trips as trips.repair_fixed
and trips.straggler).

Output equals ops.bitvec.kmer_ranks_fixed exactly (tested).
"""

from __future__ import annotations

import torch

from finito_tpu_torch.ops.bits import u32
from finito_tpu_torch.ops.rank24 import update_interval24
from finito_tpu_torch.utils import trace

UNKNOWN = -2
# extra fixed repair trips beyond a segment's k-1 + Q walk, for recovery
# stalls: moves work between the fixed trips and the straggler loop,
# never the output (the JAX package's FINITO_REPAIR_STALL default)
REPAIR_STALL = 8


def compact_mask(mask: torch.Tensor, K: int):
    """Indices of the first K set positions of a bool mask (flattened),
    in ascending order and padded with -1, plus the true count: the
    JAX compact_mask's contract.

    One cumsum gives every set position its output rank; a scatter into
    a K+1 buffer whose last slot is a sink drops ranks >= K and the
    unset positions. Nothing here reads a value back to the host (unlike
    torch.nonzero), so the count stays a device tensor. Returns
    ((K,) int32, () int32)."""
    flat = mask.reshape(-1)
    dev = flat.device
    if flat.numel() == 0:
        return (torch.full((K,), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    rank = torch.cumsum(flat.to(torch.int32), 0) - 1  # int64 (torch's cumsum rule)
    n = (rank[-1] + 1).to(torch.int32)
    sink = torch.where(flat & (rank < K), rank, K)
    out = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, sink, torch.arange(flat.numel(), dtype=torch.int32, device=dev))
    return out[:K], n


def auto_chunk(k: int, B: int, L: int) -> int:
    """Default chain-scan chunk length: 0, scan whole reads (the JAX
    package's rule, from its TPU lane sweep; chunking stays available
    through an explicit chunk=, with the same output)."""
    del k, B, L
    return 0


def n_chunks(L: int, k: int, C: int) -> int:
    """Chunks of length C with k-1 overlap covering a length-L read."""
    S = C - k + 1
    return -(-(L - (k - 1)) // S)


def chunk_reads(codes: torch.Tensor, k: int, C: int) -> torch.Tensor:
    """(B, L) codes -> (B * n_ch, C) overlapping chunks, stride C-k+1,
    positions past L padded with 255 (invalid). The chain state at any
    mature position is a function of the last k characters only, so a
    chunk seeded k-1 characters early reproduces the full-read chain at
    every payload position."""
    B, L = codes.shape
    if not (k <= C <= L):
        raise ValueError(f"need k <= chunk <= L (k={k}, chunk={C}, L={L})")
    S = C - k + 1
    dev = codes.device
    idx = (torch.arange(n_chunks(L, k, C), device=dev)[:, None] * S
           + torch.arange(C, device=dev)[None, :])
    ch = codes[:, idx.clamp(max=L - 1)]  # (B, n_ch, C)
    ch = torch.where(idx[None, :, :] < L, ch, torch.full_like(ch, 255))
    return ch.reshape(B * idx.shape[0], C)


def unchunk_grid(grid_ch: torch.Tensor, B: int, L: int, k: int, C: int) -> torch.Tensor:
    """(B * n_ch, C) per-position grid -> (B, L): chunk 0 contributes
    its first k-1 positions, every chunk its payload [k-1, C)."""
    g = grid_ch.reshape(B, -1, C)
    head = g[:, 0, : k - 1]
    payload = g[:, :, k - 1 :].reshape(B, -1)
    return torch.cat([head, payload], dim=1)[:, :L]


def make_chain_scan(n8: int, k: int, n_nodes: int):
    """The exact hybrid chain without repair (the JAX package's phase A
    before make_chain_opt; its caller is tools.micro's step-latency
    benchmark). run(tab, C, contract_k, edge, codes): (B, L) codes ->
    (B, L) int32 status of the window ending at each position: rank >= 0
    found, -1 definitively absent, -2 unknown (positions < k-1 are
    meaningless). contract_k is accepted for the JAX signature and not
    read.

    An immature lane tracks the SBWT interval of seq[ks..j] (2 rank
    gathers a step); at its first window close it hands the singleton to
    the mature mode, which follows the forward-edge table (1 gather a
    step). Any failure resets the lane to immature with ks = j+1. One
    Python step per read position, stacked once at the end."""

    def run(tab, C, contract_k, edge, codes):
        del contract_k
        B, L = codes.shape
        dev = codes.device
        cs = codes.to(torch.int64)
        lo = torch.zeros(B, dtype=torch.int64, device=dev)
        hi = torch.full_like(lo, n_nodes - 1)
        ks = torch.zeros_like(lo)
        x = torch.full_like(lo, -1)
        emits = []
        for j in range(L):
            c = cs[:, j]
            invalid = c > 3
            em = x >= 0
            xe = edge[torch.where(em, x * 4 + torch.where(invalid, 0, c), 0)].to(torch.int64)
            e_found = em & ~invalid & (xe >= 0)
            nlo, nhi = update_interval24(tab, n8, C, c, lo, hi)
            failed = invalid | (nlo < 0)
            had_full_context = ks == j - k + 1
            close = ~em & ~failed & (j - ks + 1 == k)
            emit_i = torch.where(
                close, nlo, torch.where(failed & had_full_context & ~invalid, -1, UNKNOWN)
            )
            emit_i = torch.where(invalid, -1, emit_i)
            emits.append(torch.where(em, torch.where(e_found, xe, -1), emit_i))
            x = torch.where(e_found, xe, torch.where(close, nlo, -1))
            any_fail = torch.where(em, ~e_found, failed)
            lo = torch.where(failed | em, 0, nlo)
            hi = torch.where(failed | em, n_nodes - 1, nhi)
            ks = torch.where(any_fail, j + 1, torch.where(em | close, j - k + 2, ks))
        return torch.stack(emits, dim=1).to(torch.int32)

    return run


def make_chain_opt_ref(n8: int, k: int, n_nodes: int, aug: bool = False):
    """Optimistic hybrid chain producing repairable untrusted RUNS: the
    plain version, on any device (make_chain_opt runs it for CPU
    tensors; chip_smoke.py holds the kernel to it on the card).

    run(tab, C, edge, codes) -> (emit, cand, untrusted), each (B, L):
      emit:  int32, >= 0 trusted node rank of the k-mer ending at j; -1
             trusted definitive absent; -2 meaningless (covered by
             untrusted or by the pre-window prefix j < k-1).
      cand:  int32, -1 none; else the singleton node of the longest
             tracked suffix ending at j -- raw (< 2^24) at immature
             positions, or, when `aug` (edge built by
             rank24.build_edge_aug_table), the augmented
             (su << 25 | ustart << 24 | node) entry at mature positions.
      untrusted: bool, position needs exact repair (make_segment_repair):
             j - k <= the last failure, one position past the k-1
             post-failure shadow, so every trusted position >= k is
             either mature or -1.

    The JAX lax.scan is a Python loop of L steps; the per-step outputs
    are stacked once at the end."""

    def run(tab, C, edge, codes):
        B, L = codes.shape
        dev = codes.device
        cs = codes.to(torch.int64)
        lo = torch.zeros(B, dtype=torch.int64, device=dev)
        hi = torch.full_like(lo, n_nodes - 1)
        ks = torch.zeros_like(lo)
        x = torch.full_like(lo, -1)
        lastfail = torch.full_like(lo, -(k + 2))
        emits, cands, untr = [], [], []
        for j in range(L):
            c = cs[:, j]
            invalid = c > 3
            em = x >= 0  # mature: x = node of the k-mer ending at j-1
            xe_raw = edge[torch.where(em, x * 4 + torch.where(invalid, 0, c), 0)]
            e_found = em & ~invalid & (xe_raw >= 0)
            xe = (xe_raw & ((1 << 24) - 1)) if aug else xe_raw
            nlo, nhi = update_interval24(tab, n8, C, c, lo, hi)
            failed = invalid | (nlo < 0)
            mature = ks == j - k + 1
            close = ~em & ~failed & (j - ks + 1 == k)
            emit_i = torch.where(
                close, nlo, torch.where(failed & mature & ~invalid, -1, UNKNOWN)
            )
            emit_i = torch.where(invalid, -1, emit_i)
            emits.append(torch.where(em, torch.where(e_found, xe, -1), emit_i))
            single_i = ~failed & (nlo == nhi)
            cands.append(torch.where(
                em,
                torch.where(e_found, xe_raw, -1),
                torch.where(single_i, nlo, -1),
            ))
            any_fail = torch.where(em, ~e_found, failed)
            lastfail = torch.where(any_fail, j, lastfail)
            untr.append(j - k <= lastfail)

            x = torch.where(e_found, xe, torch.where(close, nlo, -1))
            lo = torch.where(failed | em, 0, nlo)
            hi = torch.where(failed | em, n_nodes - 1, nhi)
            ks = torch.where(any_fail, j + 1, torch.where(em | close, j - k + 2, ks))
        return (torch.stack(emits, dim=1).to(torch.int32),
                torch.stack(cands, dim=1).to(torch.int32),
                torch.stack(untr, dim=1))

    return run


_chain_kernel = None  # the ctypes function, loaded on the first launch


def make_chain_opt(n8: int, k: int, n_nodes: int, aug: bool = False):
    """The optimistic chain (make_chain_opt_ref's contract and outputs):
    run(tab, C, edge, codes) -> (emit, cand, untrusted). The plain
    version for a CPU tensor; for a CUDA tensor one launch of the
    hand-written kernel (csrc/chain_opt.cu), whose rank24 form (flat or
    wide) follows tab.dim() and whose edge form follows `aug`, or an
    error. The kernel takes codes as a contiguous (B, L) uint8 tensor
    with B * L < 2^31, and tab, C and edge as contiguous int32 tensors
    (ops.bits.put_i32) on the same card. ``make_chain_opt.launches``
    counts kernel launches, as does utils.trace's `chain.kernel`."""
    plain = make_chain_opt_ref(n8, k, n_nodes, aug)

    def run(tab, C, edge, codes):
        if codes.device.type not in ("cpu", "cuda"):
            raise ValueError(f"make_chain_opt: unsupported device {codes.device}")
        with trace.span("chain_opt"):
            if codes.device.type == "cpu":
                return plain(tab, C, edge, codes)
            return _chain_opt_kernel(n8, k, n_nodes, aug, tab, C, edge, codes)

    return run


make_chain_opt.launches = 0


def _chain_opt_kernel(n8, k, n_nodes, aug, tab, C, edge, codes):
    """One launch of csrc/chain_opt.cu into buffers allocated here."""
    global _chain_kernel
    dev = codes.device
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("make_chain_opt: codes must be a contiguous (B, L) uint8 tensor")
    for name, t in (("tab", tab), ("C", C), ("edge", edge)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"make_chain_opt: {name} must be a contiguous int32 tensor on {dev}")
    wide = tab.dim() == 2
    if (tab.dim() not in (1, 2) or (wide and tab.shape[1] != 2) or tab.shape[0] < 4 * n8
            or n8 < 1 or C.numel() < 4 or edge.dim() != 1 or edge.numel() < 4 * n_nodes
            or n_nodes < 1):
        raise ValueError(f"make_chain_opt: tables {tuple(tab.shape)}, {tuple(C.shape)}, "
                         f"{tuple(edge.shape)} do not hold n8={n8}, n_nodes={n_nodes}")
    B, L = codes.shape
    if B * L >= 1 << 31:
        raise ValueError(f"make_chain_opt: B * L = {B * L} reaches 2^31 (32-bit indexing)")
    emit = torch.empty((B, L), dtype=torch.int32, device=dev)
    cand = torch.empty_like(emit)
    untrusted = torch.empty((B, L), dtype=torch.bool, device=dev)
    if B * L == 0:
        return emit, cand, untrusted
    if _chain_kernel is None:
        from finito_tpu_torch.ops import _build

        _chain_kernel = _build.library().fin_chain_opt
    args = (codes.data_ptr(), B, L, k, tab.data_ptr(), int(wide), n8, C.data_ptr(),
            edge.data_ptr(), n_nodes, int(aug), emit.data_ptr(), cand.data_ptr(),
            untrusted.data_ptr())
    if dev.index == torch.cuda.current_device():
        rc = _chain_kernel(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = _chain_kernel(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chain_opt kernel launch failed: CUDA error {rc}")
    make_chain_opt.launches += 1
    trace.count("chain.kernel")
    return emit, cand, untrusted


def straggler_pending(active: torch.Tensor) -> bool:
    """Whether any repair lane is still active. Each call is one
    device-to-host read (utils.trace site `straggler`)."""
    return trace.host_read("straggler", lambda: bool(active.any()))


def _split_segments(untrusted: torch.Tensor, Q: int, K_seg: int):
    """The repair's segments: untrusted runs split every Q positions.
    Returns (is_start, the (B, L) run starts; seg_idx, the first K_seg
    split positions of the flattened grid, ascending, -1 past the count;
    n_seg, the true count as a () int32 device tensor)."""
    B, L = untrusted.shape
    u = untrusted
    dev = u.device
    prev = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev), u[:, :-1]], dim=1)
    is_start = u & ~prev
    jpos = torch.arange(L, device=dev)[None, :].expand(B, L)
    # run starts are increasing within a read, so a running max
    # propagates each run's start over the run; split every Q positions
    rs = torch.cummax(torch.where(is_start, jpos, -1), dim=1).values
    split = u & ((jpos - rs) % Q == 0)
    seg_idx, n_seg = compact_mask(split, K_seg)
    return is_start, seg_idx, n_seg


def make_segment_repair_ref(n8: int, k: int, n_nodes: int, K_seg: int, Q: int | None = None,
                            aug: bool = False):
    """Exact repair of untrusted runs with the reference's recovery
    state machine (drop_first_char widening, ref common.hh:116-127): the
    plain version of make_segment_repair, on any device (make_segment_repair
    runs it for CPU tensors; chip_smoke.py holds the kernel to it on the
    card), and the default path of the JAX make_segment_repair (one mixed
    loop, two hop rounds a trip).

      * a run-start segment at p_start >= k is seeded from its trusted
        found predecessor's post-close slide (ks = p_start-k+1, interval
        = contract_k[emit[p_start-1]]); every other segment re-derives
        its context from a k-1 preamble;
      * runs are split every Q payload positions, so a segment walks at
        most ~k-1+Q positions;
      * per-step values land in (K_seg, Q + 1) lane-local buffers (column
        Q is a sink) scattered into the (B, L) grids once after the loop;
      * the untrusted flag rides bit 8 of the character gather.

    run(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted) ->
    (emit2, cand2, n_seg), emit2 and cand2 int32 (B, L); valid only
    when n_seg <= K_seg. With `aug`, repaired cand values are written in
    the augmented (su << 25 | ustart << 24 | node) form (one suu gather a
    trip) so the caller's candidate unpack stays gather-free.

    The JAX form runs a fixed-trip lax.scan, then a lax.while_loop on
    any lane still active; here T_c Python trips, then trips while
    straggler_pending() (one host read each, and one that ends the
    loop). The JAX lax.cond that skips the widening hops when no lane is
    mid-recovery is gone: the hop code always runs, and with no lane
    mid-recovery it returns exactly what the skip branch returns (x, y
    and ks unchanged, no hop, nlen = j - ks), with no host read.
    """
    if Q is None:
        Q = k + 1  # an isolated failure's run is exactly k+1 positions
    T_c = (k - 1) + Q + REPAIR_STALL

    def run(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted):
        B, L = codes.shape
        dev = codes.device
        u = untrusted
        # bit 8 of the packed stream = untrusted flag at that position
        pk = codes.reshape(-1).to(torch.int64) | (u.reshape(-1).to(torch.int64) << 8)
        is_start, seg_idx, n_seg = _split_segments(u, Q, K_seg)
        sv = seg_idx >= 0
        f_start = torch.where(sv, seg_idx, 0).to(torch.int64)
        b_of = f_start // L
        p_start = f_start - b_of * L
        p_end = (p_start + Q).clamp(max=L)
        x_prev = emit.reshape(-1)[(f_start - 1).clamp(min=0)].to(torch.int64)
        run_start = is_start.reshape(-1)[f_start]
        fastl = sv & run_start & (p_start >= k) & (x_prev >= 0)
        pair0 = ck[torch.where(fastl, x_prev, 0)].to(torch.int64)
        j0 = torch.where(fastl, p_start, (p_start - (k - 1)).clamp(min=0))
        lo0 = torch.where(fastl, pair0[:, 0], 0)
        hi0 = torch.where(fastl, pair0[:, 1], n_nodes - 1)
        ks0 = torch.where(fastl, p_start - k + 1, j0)
        arangeK = torch.arange(K_seg, device=dev)

        def body(st):
            j, ks, lo, hi, rec, wx, wy, active, buf_e, buf_c = st
            fj = b_of * L + j.clamp(max=L - 1)
            pc = torch.where(active, pk[fj], 0)
            c = pc & 0xFF
            # retire lanes that walked past their payload or onto a
            # trusted position (recovering lanes sit on untrusted ones)
            active = active & (j < p_end) & ((j <= p_start) | (pc >= 256))
            invalid = active & (c > 3)
            mid = active & (rec > 0)  # rec: 0 none, 1 fresh drop, 2 hopping

            # --- recovery: plateau-jump drops + LCS-widening hops, two
            # hop rounds a trip (a deeper widen stalls its lane a trip)
            el0 = u32(jl[torch.where(mid, wx, 0)])
            er0 = u32(jr[torch.where(mid, wy, 0)])
            lcsL = el0 & 0xFF
            lcsR = er0 & 0xFF
            fresh = mid & (rec == 1)
            nlen = torch.where(fresh, torch.maximum(lcsL, lcsR), j - ks)
            ks_h = torch.where(fresh, j - nlen, ks)
            hl = mid & (wx > 0) & (lcsL >= nlen)
            x = torch.where(hl, wx - (el0 >> 8), wx)
            hr = mid & (wy < n_nodes) & (lcsR >= nlen)
            y = torch.where(hr, wy + (er0 >> 8), wy)
            el = u32(jl[torch.where(mid, x, 0)])
            er = u32(jr[torch.where(mid, y, 0)])
            hl = mid & (x > 0) & ((el & 0xFF) >= nlen)
            x = torch.where(hl, x - (el >> 8), x)
            hr = mid & (y < n_nodes) & ((er & 0xFF) >= nlen)
            y = torch.where(hr, y + (er >> 8), y)

            zero_len = mid & (nlen <= 0)  # widen to the empty suffix: full
            done = (mid & ~hl & ~hr) | zero_len
            still = mid & ~done
            lo_c = torch.where(done, torch.where(zero_len, 0, x), lo)
            hi_c = torch.where(done, torch.where(zero_len, n_nodes - 1, y - 1), hi)

            # --- extension (stalled lanes excluded; completed widens
            # retry with the same character this trip) ---
            can_ext = active & ~still
            nlo, nhi = update_interval24(tab, n8, C, torch.where(invalid, 0, c), lo_c, hi_c)
            ok = can_ext & ~invalid & (nlo >= 0)
            fail = can_ext & ~invalid & (nlo < 0)
            emptied = fail & (ks_h >= j)  # empty suffix failed: consume c
            start_w = fail & ~emptied  # fresh drop: jump next trip

            single = ok & (nlo == nhi)
            close = ok & (j - ks_h + 1 == k)
            advance = active & (ok | invalid | emptied)
            write = advance & (j >= p_start)
            rank_j = torch.where(close, nlo, -1)
            if aug:
                sw = suu[torch.where(single, nlo, 0)].to(torch.int64)
                cand_j = torch.where(single, ((sw & 0xFF) << 25) | ((sw >> 8) << 24) | nlo, -1)
            else:
                cand_j = torch.where(single, nlo, -1)
            loc = torch.where(write, j - p_start, Q)
            buf_e[arangeK, loc] = rank_j.to(torch.int32)
            buf_c[arangeK, loc] = cand_j.to(torch.int32)

            pair = ck[torch.where(close, nlo, 0)].to(torch.int64)
            lo2 = torch.where(close, pair[:, 0], torch.where(ok, nlo, lo_c))
            hi2 = torch.where(close, pair[:, 1], torch.where(ok, nhi, hi_c))
            lo3 = torch.where(invalid | emptied, 0, lo2)
            hi3 = torch.where(invalid | emptied, n_nodes - 1, hi2)
            ks2 = torch.where(close, ks_h + 1, ks_h)
            ks3 = torch.where(invalid | emptied, j + 1, ks2)

            wx2 = torch.where(start_w, lo_c, torch.where(still, x, wx))
            wy2 = torch.where(start_w, hi_c + 1, torch.where(still, y, wy))
            rec2 = torch.where(start_w, 1, torch.where(still, 2, 0))
            j2 = torch.where(advance, j + 1, j)
            return j2, ks3, lo3, hi3, rec2, wx2, wy2, active, buf_e, buf_c

        zero = torch.zeros(K_seg, dtype=torch.int64, device=dev)
        st = (j0, ks0, lo0, hi0, zero, zero, zero, sv,
              torch.full((K_seg, Q + 1), -1, dtype=torch.int32, device=dev),
              torch.full((K_seg, Q + 1), -1, dtype=torch.int32, device=dev))
        with trace.span("segment_repair.fixed"):
            for _ in range(T_c):
                st = body(st)
        trace.count("trips.repair_fixed", T_c)
        with trace.span("segment_repair.straggler"):
            while straggler_pending(st[7]):
                trace.count("trips.straggler")
                st = body(st)
        jf, buf_e, buf_c = st[0], st[8], st[9]
        cols = torch.arange(Q, device=dev)[None, :]
        wrote = sv[:, None] & (cols < (jf - p_start)[:, None])
        # positions no segment wrote go to the sink slot B * L
        idx = torch.where(wrote, f_start[:, None] + cols, B * L).reshape(-1)

        def put(grid, buf):
            flat = torch.cat([grid.reshape(-1), grid.new_zeros(1)])
            return flat.scatter_(0, idx, buf[:, :Q].reshape(-1))[: B * L].reshape(B, L)

        return put(emit, buf_e), put(cand, buf_c), n_seg

    return run


_repair_kernel = None  # the ctypes function, loaded on the first launch


def make_segment_repair(n8: int, k: int, n_nodes: int, K_seg: int, Q: int | None = None,
                        aug: bool = False):
    """The segment repair (make_segment_repair_ref's contract and
    outputs): run(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted)
    -> (emit2, cand2, n_seg). The plain version's trip loop for a CPU
    tensor; for a CUDA tensor the split mask's compaction in torch and
    one launch of the hand-written kernel (csrc/segment_repair.cu), which
    walks every lane to its end (no trips, no host read), or an error.
    Its rank24 form (flat or wide) follows tab.dim() and its cand form
    follows `aug`. The kernel takes codes as a contiguous (B, L) uint8
    tensor with B * L < 2^31, the grids as (B, L) int32 and bool, and
    tab, C, ck, jl, jr (and suu with `aug`) as contiguous int32 tensors
    (ops.bits.put_i32) on the same card; emit2 and cand2 are new
    tensors, the inputs stay unchanged. ``make_segment_repair.launches``
    counts kernel launches, as does utils.trace's `repair.kernel`."""
    if Q is None:
        Q = k + 1
    plain = make_segment_repair_ref(n8, k, n_nodes, K_seg, Q, aug)

    def run(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted):
        if codes.device.type == "cpu":
            return plain(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted)
        if codes.device.type != "cuda":
            raise ValueError(f"make_segment_repair: unsupported device {codes.device}")
        with trace.span("segment_repair"):
            return _segment_repair_kernel(n8, k, n_nodes, K_seg, Q, aug, tab, C, ck, jl, jr,
                                          suu, codes, emit, cand, untrusted)

    return run


make_segment_repair.launches = 0


def _segment_repair_kernel(n8, k, n_nodes, K_seg, Q, aug, tab, C, ck, jl, jr, suu, codes, emit,
                           cand, untrusted):
    """The split compaction, then one launch of csrc/segment_repair.cu
    into copies of the chain's grids."""
    global _repair_kernel
    dev = codes.device
    B, L = codes.shape
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("make_segment_repair: codes must be a contiguous (B, L) uint8 tensor")
    for name, t, dtype in (("emit", emit, torch.int32), ("cand", cand, torch.int32),
                           ("untrusted", untrusted, torch.bool)):
        if t.device != dev or t.dtype != dtype or t.shape != codes.shape:
            raise ValueError(f"make_segment_repair: {name} must be a (B, L) {dtype} tensor on {dev}")
    tables = (("tab", tab), ("C", C), ("ck", ck), ("jl", jl), ("jr", jr))
    for name, t in tables + ((("suu", suu),) if aug else ()):
        if t is None or t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"make_segment_repair: {name} must be a contiguous int32 tensor on {dev}")
    wide = tab.dim() == 2
    if (tab.dim() not in (1, 2) or (wide and tab.shape[1] != 2) or tab.shape[0] < 4 * n8
            or n8 < 1 or C.numel() < 4 or tuple(ck.shape) != (n_nodes, 2)
            or jl.numel() < n_nodes or jr.numel() < n_nodes + 1
            or (aug and suu.numel() < n_nodes) or n_nodes < 1):
        raise ValueError(f"make_segment_repair: tables {tuple(tab.shape)}, {tuple(ck.shape)}, "
                         f"{tuple(jl.shape)}, {tuple(jr.shape)} do not hold n8={n8}, "
                         f"n_nodes={n_nodes}")
    if B * L >= 1 << 31:
        raise ValueError(f"make_segment_repair: B * L = {B * L} reaches 2^31 (32-bit indexing)")
    untrusted, emit_in = untrusted.contiguous(), emit.contiguous()
    _, seg_idx, n_seg = _split_segments(untrusted, Q, K_seg)
    emit2 = emit.clone(memory_format=torch.contiguous_format)
    cand2 = cand.clone(memory_format=torch.contiguous_format)
    if B * L == 0 or K_seg == 0:
        return emit2, cand2, n_seg
    if _repair_kernel is None:
        from finito_tpu_torch.ops import _build

        _repair_kernel = _build.library().fin_segment_repair
    args = (seg_idx.data_ptr(), K_seg, codes.data_ptr(), untrusted.data_ptr(),
            emit_in.data_ptr(), B, L, k, Q, tab.data_ptr(), int(wide), n8, C.data_ptr(),
            ck.data_ptr(), jl.data_ptr(), jr.data_ptr(), suu.data_ptr() if aug else None,
            n_nodes, int(aug), emit2.data_ptr(), cand2.data_ptr())
    if dev.index == torch.cuda.current_device():
        rc = _repair_kernel(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = _repair_kernel(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_repair kernel launch failed: CUDA error {rc}")
    make_segment_repair.launches += 1
    trace.count("repair.kernel")
    return emit2, cand2, n_seg


def make_two_phase(n8: int, k: int, n_nodes: int, K_seg: int, aug: bool = False):
    """The stream and replica engines' scan: run(tab, C, ck, jl, jr, suu,
    edge, codes, chunk) -> the repaired (B, L) (emit, cand) and n_seg,
    valid only when n_seg <= K_seg (else the caller re-runs larger). The
    chain runs over k-1-overlapped chunks (chunk_reads) when k <= chunk
    < L, with the same output; suu is None unless aug."""
    chain = make_chain_opt(n8, k, n_nodes, aug=aug)
    repair = make_segment_repair(n8, k, n_nodes, K_seg, aug=aug)

    def run(tab, C, ck, jl, jr, suu, edge, codes, chunk):
        B, L = codes.shape
        if k <= chunk < L:
            emit, cand, untrusted = (unchunk_grid(g, B, L, k, chunk)
                                     for g in chain(tab, C, edge, chunk_reads(codes, k, chunk)))
        else:
            emit, cand, untrusted = chain(tab, C, edge, codes)
        return repair(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted)

    return run


def make_chain_stream_ranks(n8: int, k: int, n_nodes: int, K: int, chunk: int | None = None):
    """The two-phase rank pipeline: run(tab, C, contract_k, jl, jr, edge,
    codes) -> ((B, W) int32 ranks, n_seg), make_two_phase's emit at the
    window closes, valid only when n_seg <= K. chunk: None = auto_chunk,
    0 = whole reads."""
    two_phase = make_two_phase(n8, k, n_nodes, K)

    def run(tab, C, contract_k, jl, jr, edge, codes):
        B, L = codes.shape
        emit, _, n_seg = two_phase(tab, C, contract_k, jl, jr, None, edge, codes,
                                   auto_chunk(k, B, L) if chunk is None else chunk)
        return emit[:, k - 1 :], n_seg

    return run

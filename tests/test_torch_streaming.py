"""The port's two-phase streaming rank engine
(finito_tpu_torch/ops/streaming.py) on the CPU against the JAX
package's: the chunking helpers, make_chain_opt (both edge forms, all
three outputs), make_segment_repair (emit, cand and n_seg, also past its
capacity) and make_chain_stream_ranks (unchunked and chunked, also
against kmer_ranks_fixed), on mutation-heavy reads, the JAX tables fed
straight into the port. Every comparison is exact. The CUDA kernels of
the chain (csrc/chain_opt.cu) and of the repair (csrc/segment_repair.cu)
are held bit for bit to their plain versions on a card (the `cuda`
marker); here, that a CPU tensor takes the plain version and another
device raises."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finito_tpu.ops import bitvec as jbv
from finito_tpu.ops import rank24 as jr24
from finito_tpu.ops import streaming as jst
from finito_tpu_torch.ops import bitvec as pbv
from finito_tpu_torch.ops import streaming as pst
from finito_tpu_torch.ops.bits import put_i32
from finito_tpu_torch.utils import trace

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import build_index, gen_dspss

torch.set_num_threads(1)

B, L = 16, 40


def _mutated_reads(rng, unitigs, k):
    """Reads from the unitigs with up to 5 point mutations (clustered
    failures, long untrusted runs), pads and invalid codes mid-read, and
    random reads."""
    from finito_tpu.io.seqdb import encode_seq

    reads = np.full((B, L), 255, np.uint8)
    for b in range(B):
        if b % 5 == 4:
            reads[b, : L - b % 3] = rng.integers(0, 4, L - b % 3)
            continue
        u = encode_seq(unitigs[int(rng.integers(len(unitigs)))].encode())
        n = min(u.size, L - (b % 4) * 3)
        reads[b, :n] = u[:n]
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, n))
            reads[b, p] = (reads[b, p] + int(rng.integers(1, 4))) % 4
        if b % 3 == 0:
            reads[b, int(rng.integers(0, n))] = 255
    return reads


@pytest.fixture(scope="module", params=[6, 11])
def fixture(request):
    """(k, n8, n_nodes, reads, numpy tables by name, the JAX index)"""
    k = request.param
    rng = np.random.default_rng(60 + k)
    unitigs = gen_dspss(rng, 12, 14 if k == 6 else 30, 60, k)
    index = build_index(unitigs, k)
    bits = index.sbwt.bit_rows()
    C = index.sbwt.get_C_array()
    ck = jr24.build_contract_k_table(index.LCS, k)
    jl, jr = jr24.build_lcs_jump_tables(index.LCS)
    us = np.asarray(index.Ustart, np.uint8)
    tables = {
        "tab": jr24.build_rank24_tables(bits), "C": np.asarray(C, np.int32), "ck": ck,
        "jl": jl, "jr": jr, "suu": jr24.build_su_ustart_table(index.LCS, us),
        "edge": jr24.build_edge_table(bits, C, ck),
        "edge_aug": jr24.build_edge_aug_table(bits, C, ck, index.LCS, us),
    }
    n_nodes = index.sbwt.number_of_subsets()
    return k, tables["tab"].shape[0] // 4, n_nodes, _mutated_reads(rng, unitigs, k), tables, index


def _j(tables, *names):
    return [jnp.asarray(tables[n]) for n in names]


def _p(tables, *names):
    return [put_i32(tables[n], "cpu") for n in names]


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("C", [6, 9, 17, 40])
def test_chunk_helpers_equal_jax(fixture, C):
    k, _, _, reads, _, _ = fixture
    if C < k:
        C = k
    assert pst.n_chunks(L, k, C) == jst.n_chunks(L, k, C)
    assert pst.auto_chunk(k, B, L) == jst.auto_chunk(k, B, L) == 0
    want = np.asarray(jst.chunk_reads(jnp.asarray(reads), k, C))
    got = pst.chunk_reads(torch.from_numpy(reads), k, C)
    _equal(got, want)
    grid = np.arange(want.size, dtype=np.int32).reshape(want.shape)
    _equal(pst.unchunk_grid(torch.from_numpy(grid), B, L, k, C),
           jst.unchunk_grid(jnp.asarray(grid), B, L, k, C))


def _chains(fixture, aug):
    """(the JAX chain outputs, the port's) on the fixture's reads."""
    k, n8, n_nodes, reads, tables, _ = fixture
    edge = "edge_aug" if aug else "edge"
    want = jax.jit(jst.make_chain_opt(n8, k, n_nodes, aug=aug))(
        *_j(tables, "tab", "C", edge), jnp.asarray(reads))
    got = pst.make_chain_opt(n8, k, n_nodes, aug=aug)(
        *_p(tables, "tab", "C", edge), torch.from_numpy(reads))
    return want, got


@pytest.mark.parametrize("aug", [False, True])
def test_chain_opt_equals_jax(fixture, aug):
    want, got = _chains(fixture, aug)
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.bool]
    for a, b in zip(got, want):
        _equal(a, b)
    assert np.asarray(want[2]).any()  # the reads leave runs to repair


def _wide(tab):
    """The flat rank24 entries (rank << 8 | byte) of an index as the wide
    [rank, byte] rows build_rank24_tables gives past 2^24 nodes: the same
    rows in the other form."""
    t = np.asarray(tab, np.uint32)
    return np.stack([t >> np.uint32(8), t & np.uint32(0xFF)], axis=1)


def _chain_tables(fixture, aug, form, device):
    _, _, _, _, tables, _ = fixture
    tab = tables["tab"] if form == "flat" else _wide(tables["tab"])
    return [put_i32(a, device) for a in (tab, tables["C"], tables["edge_aug" if aug else "edge"])]


def _edge_rows(reads, k):
    """The fixture's reads plus rows that reach the chain's edges: N codes
    (4) mid-read, a row whose valid part is shorter than k, an all-pad
    row, a row of one code."""
    extra = np.full((4, reads.shape[1]), 255, np.uint8)
    extra[0] = reads[0]
    extra[0, 3::7] = 4
    extra[1, : k - 1] = reads[1, : k - 1]
    extra[3] = 2
    return np.concatenate([reads, extra])


def _text_rows(index, B, L, seed):
    """(B, L) rows of 32-base stretches of the index's unitig text, 0.5%
    substituted, with N codes and pad tails: long mature runs, window
    failures at every stretch's seam and at every mutation."""
    rng = np.random.default_rng(seed)
    text = np.asarray(index.unitigs.concat, np.uint8)
    starts = rng.integers(0, max(1, text.size - 32), size=(B, -(-L // 32)))
    idx = np.minimum(starts[:, :, None] + np.arange(32), text.size - 1)
    rows = text[idx].reshape(B, -1)[:, :L].copy()
    hit = rng.random((B, L)) < 0.005
    rows[hit] = (rows[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    rows[rng.random((B, L)) < 0.002] = 4
    cut = rng.integers(L // 2, L + 1, B)
    rows[np.arange(L)[None, :] >= cut[:, None]] = 255
    return rows


@pytest.mark.parametrize("aug", [False, True])
def test_chain_opt_cpu_takes_plain_version(fixture, aug):
    """A CPU tensor runs the plain version: equal outputs, no launch."""
    k, n8, n_nodes, reads, _, _ = fixture
    tabs = _chain_tables(fixture, aug, "flat", "cpu")
    codes = torch.from_numpy(_edge_rows(reads, k))
    launches, counted = pst.make_chain_opt.launches, trace.counts.get("chain.kernel", 0)
    got = pst.make_chain_opt(n8, k, n_nodes, aug=aug)(*tabs, codes)
    assert pst.make_chain_opt.launches == launches == 0
    assert trace.counts.get("chain.kernel", 0) == counted
    for a, b in zip(got, pst.make_chain_opt_ref(n8, k, n_nodes, aug=aug)(*tabs, codes)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("aug", [False, True])
def test_chain_opt_wide_table_equals_flat(fixture, aug):
    """The plain version reads both rank24 forms alike: the wide rows the
    kernel is held to on the card are the same index."""
    k, n8, n_nodes, reads, _, _ = fixture
    codes = torch.from_numpy(_edge_rows(reads, k))
    chain = pst.make_chain_opt(n8, k, n_nodes, aug=aug)
    flat = chain(*_chain_tables(fixture, aug, "flat", "cpu"), codes)
    wide_tabs = _chain_tables(fixture, aug, "wide", "cpu")
    assert wide_tabs[0].dim() == 2
    for a, b in zip(chain(*wide_tabs, codes), flat):
        assert torch.equal(a, b)


def test_chain_opt_rejects_other_devices(fixture):
    k, n8, n_nodes, _, _, _ = fixture
    meta = [torch.zeros(4 * n8 + 8, dtype=torch.int32, device="meta")] * 3
    with pytest.raises(ValueError):
        pst.make_chain_opt(n8, k, n_nodes)(*meta, torch.zeros((2, 40), dtype=torch.uint8,
                                                                 device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["reads", "short", "empty", "chunked", "full"])
@pytest.mark.parametrize("form", ["flat", "wide"])
@pytest.mark.parametrize("aug", [False, True])
def test_chain_kernel_matches_plain_on_card(fixture, aug, form, case):
    """The kernel's three grids equal the plain version's bit for bit on
    the card, for both edge forms and both rank24 forms: the fixture's
    mutated reads with N codes, short and all-pad rows ("reads"); rows
    shorter than k ("short"); B = 0 ("empty"); the lanes chunk_reads
    makes ("chunked"); one (8192, 256) batch, a CLI chunk's shape
    ("full")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    k, n8, n_nodes, reads, _, index = fixture
    tabs = _chain_tables(fixture, aug, form, "cuda")
    rows = torch.from_numpy(_edge_rows(reads, k)).cuda()
    batches = {
        "reads": lambda: [rows],
        "short": lambda: [rows[:, : k - 1].contiguous()],
        "empty": lambda: [torch.zeros((0, L), dtype=torch.uint8, device="cuda")],
        "chunked": lambda: [pst.chunk_reads(rows, k, c) for c in (k, k + 3, 17)],
        "full": lambda: [torch.from_numpy(_text_rows(index, 8192, 256, k)).cuda()],
    }[case]()
    chain = pst.make_chain_opt(n8, k, n_nodes, aug=aug)
    plain = pst.make_chain_opt_ref(n8, k, n_nodes, aug=aug)
    for codes in batches:
        launches, counted = pst.make_chain_opt.launches, trace.counts.get("chain.kernel", 0)
        got = chain(*tabs, codes)
        torch.cuda.synchronize()
        n = int(codes.numel() > 0)
        assert pst.make_chain_opt.launches == launches + n
        assert trace.counts.get("chain.kernel", 0) == counted + n
        assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.bool]
        if case == "empty":
            assert all(g.shape == (0, L) for g in got)
            continue
        want = plain(*tabs, codes)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
        if case in ("reads", "full"):
            assert (want[0] >= 0).any() and want[2].any()


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("room", ["enough", "overflow"])
def test_segment_repair_equals_jax(fixture, aug, room):
    """The JAX chain's outputs through both repairs: equal emit, cand and
    n_seg, with room for every segment and with K_seg below n_seg (then
    the first K_seg segments are repaired alike)."""
    k, n8, n_nodes, reads, tables, _ = fixture
    want_chain, _ = _chains(fixture, aug)
    K = B * L if room == "enough" else 5
    names = ("tab", "C", "ck", "jl", "jr", "suu")
    want = jax.jit(jst.make_segment_repair(n8, k, n_nodes, K, aug=aug))(
        *_j(tables, *names), jnp.asarray(reads), *want_chain)
    got = pst.make_segment_repair(n8, k, n_nodes, K, aug=aug)(
        *_p(tables, *names), torch.from_numpy(reads),
        *(torch.from_numpy(np.array(x)) for x in want_chain))
    for a, b in zip(got, want):
        _equal(a, b)
    assert (int(got[2]) > K) == (room == "overflow")


def _repair_tables(fixture, form, device):
    """(tab, C, ck, jl, jr, suu) in the repair's argument order, tab in the
    given rank24 form."""
    _, _, _, _, tables, _ = fixture
    tab = tables["tab"] if form == "flat" else _wide(tables["tab"])
    return [put_i32(a, device) for a in (tab, *(tables[n] for n in ("C", "ck", "jl", "jr", "suu")))]


@pytest.mark.parametrize("aug", [False, True])
def test_segment_repair_cpu_takes_plain_version(fixture, aug):
    """A CPU tensor runs the plain trip loop: outputs equal to
    make_segment_repair_ref's, its trips and straggler reads counted, no
    launch, inputs unchanged."""
    k, n8, n_nodes, reads, _, _ = fixture
    codes = torch.from_numpy(_edge_rows(reads, k))
    grids = pst.make_chain_opt_ref(n8, k, n_nodes, aug=aug)(
        *_chain_tables(fixture, aug, "flat", "cpu"), codes)
    kept = [g.clone() for g in grids]
    tabs = _repair_tables(fixture, "flat", "cpu")
    launches, counted = pst.make_segment_repair.launches, trace.counts.get("repair.kernel", 0)
    stragglers = trace.counts.get("host_reads.straggler", 0)
    got = pst.make_segment_repair(n8, k, n_nodes, B * L, aug=aug)(*tabs, codes, *grids)
    assert pst.make_segment_repair.launches == launches == 0
    assert trace.counts.get("repair.kernel", 0) == counted
    assert trace.counts.get("host_reads.straggler", 0) > stragglers
    for a, b in zip(grids, kept):
        assert torch.equal(a, b)
    want = pst.make_segment_repair_ref(n8, k, n_nodes, B * L, aug=aug)(*tabs, codes, *grids)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("aug", [False, True])
def test_segment_repair_wide_table_equals_flat(fixture, aug):
    """The plain repair reads both rank24 forms alike: the wide rows the
    kernel is held to on the card are the same index."""
    k, n8, n_nodes, reads, _, _ = fixture
    codes = torch.from_numpy(_edge_rows(reads, k))
    grids = pst.make_chain_opt_ref(n8, k, n_nodes, aug=aug)(
        *_chain_tables(fixture, aug, "flat", "cpu"), codes)
    repair = pst.make_segment_repair(n8, k, n_nodes, B * L, aug=aug)
    flat = repair(*_repair_tables(fixture, "flat", "cpu"), codes, *grids)
    wide_tabs = _repair_tables(fixture, "wide", "cpu")
    assert wide_tabs[0].dim() == 2
    for a, b in zip(repair(*wide_tabs, codes, *grids), flat):
        assert torch.equal(a, b)


def test_segment_repair_rejects_other_devices(fixture):
    k, n8, n_nodes, _, _, _ = fixture
    meta = [torch.zeros(4 * n8 + 8, dtype=torch.int32, device="meta")] * 6
    grid = torch.zeros((2, 40), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pst.make_segment_repair(n8, k, n_nodes, 16)(
            *meta, grid.to(torch.uint8), grid, grid, grid.to(torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["reads", "full", "clean", "empty"])
@pytest.mark.parametrize("room", ["enough", "overflow"])
@pytest.mark.parametrize("form", ["flat", "wide"])
@pytest.mark.parametrize("aug", [False, True])
def test_repair_kernel_matches_plain_on_card(fixture, aug, form, room, case):
    """The repair kernel's emit2, cand2 and n_seg equal the plain trip
    loop's (make_segment_repair_ref) bit for bit on the card, for both
    cand forms and both rank24 forms, with room for every segment and
    with K_seg = 5 below n_seg: the chain's grids of the fixture's
    mutated reads with N codes, short and all-pad rows ("reads"); one
    (8192, 256) batch of text rows with substitutions, N codes and
    padding, a CLI chunk's shape ("full"); the reads' grids with no
    untrusted position ("clean"); B = 0 ("empty"). One launch a call
    (none for B = 0), no straggler read, the inputs unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    k, n8, n_nodes, reads, _, index = fixture
    codes = {
        "reads": lambda: torch.from_numpy(_edge_rows(reads, k)),
        "full": lambda: torch.from_numpy(_text_rows(index, 8192, 256, k)),
        "clean": lambda: torch.from_numpy(_edge_rows(reads, k)),
        "empty": lambda: torch.zeros((0, L), dtype=torch.uint8),
    }[case]().cuda()
    grids = list(pst.make_chain_opt(n8, k, n_nodes, aug=aug)(
        *_chain_tables(fixture, aug, form, "cuda"), codes))
    if case == "clean":
        grids[2] = torch.zeros_like(grids[2])
    kept = [g.clone() for g in grids]
    tabs = _repair_tables(fixture, form, "cuda")
    K = max(1, codes.numel()) if room == "enough" else 5
    launches, counted = pst.make_segment_repair.launches, trace.counts.get("repair.kernel", 0)
    stragglers = trace.counts.get("host_reads.straggler", 0)
    got = pst.make_segment_repair(n8, k, n_nodes, K, aug=aug)(*tabs, codes, *grids)
    torch.cuda.synchronize()
    n = int(codes.numel() > 0)
    assert pst.make_segment_repair.launches == launches + n
    assert trace.counts.get("repair.kernel", 0) == counted + n
    assert trace.counts.get("host_reads.straggler", 0) == stragglers
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.int32]
    for a, b in zip(grids, kept):
        assert torch.equal(a, b)
    if case == "empty":
        assert got[0].shape == got[1].shape == (0, L) and int(got[2]) == 0
        return
    want = pst.make_segment_repair_ref(n8, k, n_nodes, K, aug=aug)(*tabs, codes, *grids)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    if case == "clean":
        assert int(got[2]) == 0 and torch.equal(got[0], grids[0])
    else:
        assert (int(got[2]) > K) == (room == "overflow") and not torch.equal(got[0], grids[0])


@pytest.mark.parametrize("chunk", [None, 6, 9, 39])
def test_chain_stream_ranks_equal_jax_and_fixed(fixture, chunk):
    k, n8, n_nodes, reads, tables, index = fixture
    if chunk is not None and chunk < k:
        chunk = k
    K = B * (L - k + 1)
    names = ("tab", "C", "ck", "jl", "jr", "edge")
    want, n_want = jax.jit(jst.make_chain_stream_ranks(n8, k, n_nodes, K, chunk=chunk))(
        *_j(tables, *names), jnp.asarray(reads))
    reads_t = torch.from_numpy(reads)
    before = trace.counts.get("host_reads.straggler", 0)
    got, n_got = pst.make_chain_stream_ranks(n8, k, n_nodes, K, chunk=chunk)(
        *_p(tables, *names), reads_t)
    # at least the read that ends the loop
    assert trace.counts.get("host_reads.straggler", 0) > before
    assert got.dtype == torch.int32 and int(n_got) == int(n_want) <= K
    _equal(got, want)
    fixed = pbv.kmer_ranks_fixed(pbv.DeviceSBWT.from_host(index.sbwt, device="cpu"), reads_t, k)
    _equal(got, fixed)
    _equal(fixed, jbv.kmer_ranks_fixed(jbv.DeviceSBWT.from_host(index.sbwt), jnp.asarray(reads), k))


@pytest.mark.parametrize("lanes", [5, 16])
def test_chain_scan_equals_jax(fixture, lanes):
    """make_chain_scan (the exact hybrid chain without repair) on the
    fixture's real index and mutation-heavy reads, at 2 lane counts."""
    k, n8, n_nodes, reads, tables, _ = fixture
    reads = reads[:lanes]
    names = ("tab", "C", "ck", "edge")
    want = jax.jit(jst.make_chain_scan(n8, k, n_nodes))(*_j(tables, *names), jnp.asarray(reads))
    got = pst.make_chain_scan(n8, k, n_nodes)(*_p(tables, *names), torch.from_numpy(reads))
    assert got.dtype == torch.int32
    _equal(got, want)
    g = got.numpy()[:, k - 1 :]
    assert (g >= 0).any() and (g == -1).any() and (g == pst.UNKNOWN).any()


@pytest.mark.parametrize("k", [4, 31])
@pytest.mark.parametrize("lanes", [64, 256])
def test_chain_scan_on_micro_tables_equals_jax(lanes, k):
    """make_chain_scan on tools.micro's synthetic index (bench_micro's
    random rank rows, trimmed to a valid SBWT, and its dense random edge
    table) over 64 steps, at 2 lane counts. At k = 31, micro's k, a
    random interval empties long before a window closes, so every lane
    stays immature; at k = 4 the lanes close and follow the edges."""
    from finito_tpu_torch.tools.micro import synthetic_sbwt_bits

    rng = np.random.default_rng(lanes)
    n = 1 << 12
    bits = synthetic_sbwt_bits(rng, n)
    assert 1 + int(bits.sum()) <= n
    tables = {"tab": jr24.build_rank24_tables(bits),
              "C": np.cumsum([1, *bits.sum(axis=1)[:3]]).astype(np.int32),
              "ck": np.stack([np.zeros(n, np.int32), np.full(n, n - 1, np.int32)], axis=1),
              "edge": rng.integers(0, n, size=4 * n, dtype=np.int32)}
    codes = rng.integers(0, 4, size=(lanes, 64), dtype=np.uint8)
    codes[rng.integers(0, lanes, 8), rng.integers(0, 64, 8)] = 255
    n8 = tables["tab"].shape[0] // 4
    names = ("tab", "C", "ck", "edge")
    want = jax.jit(jst.make_chain_scan(n8, k, n))(*_j(tables, *names), jnp.asarray(codes))
    got = pst.make_chain_scan(n8, k, n)(*_p(tables, *names), torch.from_numpy(codes))
    _equal(got, want)
    found = (got.numpy()[:, k - 1 :] >= 0).mean()
    assert found > 0.5 if k == 4 else found == 0

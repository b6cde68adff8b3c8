"""The port's two-phase streaming rank engine
(finito_tpu_torch/ops/streaming.py) on the CPU against the JAX
package's: the chunking helpers, make_chain_opt (both edge forms, all
three outputs), make_segment_repair (emit, cand and n_seg, also past its
capacity) and make_chain_stream_ranks (unchunked and chunked, also
against kmer_ranks_fixed), on mutation-heavy reads, the JAX tables fed
straight into the port. Every comparison is exact."""

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

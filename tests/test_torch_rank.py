"""The port's rank tables and rank/extension functions
(finito_tpu_torch/ops/rank24.py, finito_tpu_torch/ops/bitvec.py) on the
CPU against the JAX package's: every numpy table builder gives equal
arrays (the wide rank form forced too), and every device function gives
equal values on the same inputs, the JAX tables fed straight into the
port. Every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finito_tpu.ops import bitvec as jbv
from finito_tpu.ops import rank24 as jr24
from finito_tpu.query import engine as jeng
from finito_tpu_torch.index.index import FinimizerIndex as PortFinimizerIndex
from finito_tpu_torch.ops import bitvec as pbv
from finito_tpu_torch.ops import rank24 as pr24
from finito_tpu_torch.ops.bits import put_i32
from finito_tpu_torch.query import locators as peng

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import build_index, gen_dspss

torch.set_num_threads(1)

SIZES = {4: (6, 6, 14), 6: (14, 10, 50), 11: (12, 30, 70)}  # k -> gen_dspss sizes


@pytest.fixture(scope="module", params=sorted(SIZES))
def fixture(request, tmp_path_factory):
    """(k, the JAX index, the port's index read from its files)"""
    k = request.param
    jindex = build_index(gen_dspss(np.random.default_rng(40 + k), *SIZES[k], k), k)
    prefix = str(tmp_path_factory.mktemp(f"rank{k}") / "idx")
    jindex.serialize(prefix)
    return k, jindex, PortFinimizerIndex.load(prefix)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b)


def _builders(k, index, r24):
    """Every numpy builder of one rank24 module on one index."""
    bits = index.sbwt.bit_rows()
    C = index.sbwt.get_C_array()
    ck = r24.build_contract_k_table(index.LCS, k)
    us = np.asarray(index.Ustart, np.uint8)
    out = {
        "rank24": r24.build_rank24_tables(bits),
        "rank24 one row": r24.build_rank24_tables(us[None, :]),
        "prev_smaller": r24._prev_smaller(np.asarray(index.LCS, np.int64)),
        "next_smaller": r24._next_smaller(np.asarray(index.LCS, np.int64)),
        "lcs_jump": np.stack([a[: index.LCS.size] for a in r24.build_lcs_jump_tables(index.LCS)]),
        "jr pad": r24.build_lcs_jump_tables(index.LCS)[1][-1:],
        "contract_k": ck,
        "su": r24.build_su_table(index.LCS),
        "su_ustart": r24.build_su_ustart_table(index.LCS, us),
        "edge": r24.build_edge_table(bits, C, ck),
        "can_augment": np.array([r24.can_augment_edges(index.sbwt.number_of_subsets(), k),
                                 r24.can_augment_edges(1 << 24, k), r24.can_augment_edges(10, 64)]),
        "constants": np.array([r24._NO_CAND, r24.EDGE_AUG_MIN, r24.EDGE_NODE_MASK,
                               r24.RANK24_MAX_NODES]),
    }
    if r24.can_augment_edges(index.sbwt.number_of_subsets(), k):
        out["edge_aug"] = r24.build_edge_aug_table(bits, C, ck, index.LCS, us)
    return out


@pytest.mark.parametrize("name", ["rank24", "rank24 one row", "prev_smaller", "next_smaller",
                                  "lcs_jump", "jr pad", "contract_k", "su", "su_ustart", "edge",
                                  "edge_aug", "can_augment", "constants"])
def test_builders_equal_jax(fixture, name):
    k, jindex, pindex = fixture
    _equal(pindex.sbwt.bit_rows(), jindex.sbwt.bit_rows())
    want = _builders(k, jindex, jr24)[name]
    got = _builders(k, pindex, pr24)[name]
    assert got.dtype == want.dtype
    _equal(got, want)


def test_wide_rank_form_equals_jax(fixture, monkeypatch):
    """RANK24_MAX_NODES = 1 in both packages forces the wide form: equal
    tables, and rank24 equal to JAX's and to the flat form."""
    k, jindex, pindex = fixture
    bits = jindex.sbwt.bit_rows()
    flat = pr24.build_rank24_tables(bits)
    monkeypatch.setattr(jr24, "RANK24_MAX_NODES", 1)
    monkeypatch.setattr(pr24, "RANK24_MAX_NODES", 1)
    want = jr24.build_rank24_tables(bits)
    got = pr24.build_rank24_tables(pindex.sbwt.bit_rows())
    assert got.ndim == want.ndim == 2 and got.dtype == want.dtype
    _equal(got, want)
    assert not pr24.can_augment_edges(pindex.sbwt.number_of_subsets(), k)
    n = bits.shape[1]
    n8 = flat.shape[0] // 4
    rng = np.random.default_rng(k)
    c = rng.integers(0, 4, 300)
    i = rng.integers(0, n + 1, 300)
    ref = jr24.rank24(jnp.asarray(want), n8, jnp.asarray(c, jnp.int32), jnp.asarray(i, jnp.int32))
    ct, it = torch.from_numpy(c), torch.from_numpy(i)
    _equal(pr24.rank24(put_i32(got, "cpu"), n8, ct, it), ref)
    _equal(pr24.rank24(put_i32(flat, "cpu"), n8, ct, it), ref)


def _intervals(rng, n, size):
    """Random (c, lo, hi): codes 0-3 with pads 4 and 255, intervals
    inside [0, n) with some empty (-1, -1) ones."""
    c = rng.choice(np.array([0, 1, 2, 3, 0, 1, 2, 3, 4, 255]), size)
    a, b = rng.integers(0, n, size), rng.integers(0, n, size)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    empty = rng.random(size) < 0.15
    lo[empty] = -1
    hi[empty] = -1
    return c, lo, hi


def test_rank24_and_update_interval24_equal_jax(fixture):
    k, jindex, pindex = fixture
    tab = jr24.build_rank24_tables(jindex.sbwt.bit_rows())
    n8 = tab.shape[0] // 4
    C = jindex.sbwt.get_C_array()
    n = jindex.sbwt.number_of_subsets()
    rng = np.random.default_rng(7 + k)
    c, lo, hi = _intervals(rng, n, 500)
    jt, pt = jnp.asarray(tab), put_i32(tab, "cpu")
    jC, pC = jnp.asarray(C, jnp.int32), put_i32(pindex.sbwt.get_C_array(), "cpu")
    cs = np.minimum(c, 3)
    i = rng.integers(0, n + 1, 500)
    _equal(pr24.rank24(pt, n8, torch.from_numpy(cs), torch.from_numpy(i)),
           jr24.rank24(jt, n8, jnp.asarray(cs, jnp.int32), jnp.asarray(i, jnp.int32)))
    _equal(pr24.select_C(pC, torch.from_numpy(cs)), jr24.select_C(jC, jnp.asarray(cs, jnp.int32)))
    want = jr24.update_interval24(jt, n8, jC, jnp.asarray(c.astype(np.uint8)),
                                  jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32))
    got = pr24.update_interval24(pt, n8, pC, torch.from_numpy(c.astype(np.uint8)),
                                 torch.from_numpy(lo), torch.from_numpy(hi))
    for a, b in zip(got, want):
        _equal(a, b)


def _device_sbwts(jindex, pindex):
    """(the JAX DeviceSBWT, the port's from_host, the port's from_numpy
    of the JAX leaves)"""
    jd = jbv.DeviceSBWT.from_host(jindex.sbwt)
    pd = pbv.DeviceSBWT.from_host(pindex.sbwt, device="cpu")
    leaves, aux = jd.tree_flatten()
    pn = pbv.DeviceSBWT.from_numpy(*(np.asarray(x) for x in leaves), *aux, device="cpu")
    return jd, pd, pn


def test_device_sbwt_leaves_equal_jax(fixture):
    _, jindex, pindex = fixture
    jd, pd, pn = _device_sbwts(jindex, pindex)
    for d in (pd, pn):
        assert (d.k, d.n_nodes, d.n_words) == (jd.k, jd.n_nodes, jd.n_words)
        _equal(d.words, np.asarray(jd.words).view(np.int32))
        _equal(d.blocks, jd.blocks)
        _equal(d.C, jd.C)


def test_rank_and_update_interval_equal_jax(fixture):
    k, jindex, pindex = fixture
    jd, pd, pn = _device_sbwts(jindex, pindex)
    n = jd.n_nodes
    rng = np.random.default_rng(11 + k)
    cs = rng.integers(0, 4, 400)
    i = rng.integers(0, n + 1, 400)
    want = jbv.rank(jd, jnp.asarray(cs, jnp.int32), jnp.asarray(i, jnp.int32))
    _equal(want, np.stack([pindex.sbwt.rank(int(a), int(b)) for a, b in zip(cs, i)]))
    c, lo, hi = _intervals(rng, n, 400)
    want_u = jbv.update_interval(jd, jnp.asarray(c.astype(np.uint8)), jnp.asarray(lo, jnp.int32),
                                 jnp.asarray(hi, jnp.int32))
    for d in (pd, pn):
        _equal(pbv.rank(d, torch.from_numpy(cs), torch.from_numpy(i)), want)
        got = pbv.update_interval(d, torch.from_numpy(c.astype(np.uint8)), torch.from_numpy(lo),
                                  torch.from_numpy(hi))
        for a, b in zip(got, want_u):
            _equal(a, b)


def _reads(rng, jindex, B, L):
    """Exact substrings of the unitig text with mutations and pads."""
    concat = np.asarray(jindex.unitigs.concat)
    codes = np.full((B, L), 255, np.uint8)
    for b in range(B):
        n = int(rng.integers(1, L + 1))
        s = int(rng.integers(0, max(1, concat.size - n)))
        seg = concat[s : s + n].copy()
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, seg.size))
            seg[p] = (seg[p] + int(rng.integers(1, 4))) % 4
        codes[b, : seg.size] = seg
    codes[rng.integers(0, B, 3), rng.integers(0, L, 3)] = 255
    return codes


def test_kmer_ranks_fixed_equals_jax(fixture):
    k, jindex, pindex = fixture
    jd, pd, _ = _device_sbwts(jindex, pindex)
    codes = _reads(np.random.default_rng(3 + k), jindex, 12, 40)
    want = np.asarray(jbv.kmer_ranks_fixed(jd, jnp.asarray(codes), k))
    got = pbv.kmer_ranks_fixed(pd, torch.from_numpy(codes), k)
    assert got.dtype == torch.int32
    _equal(got, want)
    assert (want >= 0).any() and (want < 0).any()


def test_search_batch_device_equals_jax_and_host(fixture):
    k, jindex, pindex = fixture
    jd, pd, _ = _device_sbwts(jindex, pindex)
    rng = np.random.default_rng(5 + k)
    concat = np.asarray(jindex.unitigs.concat)
    starts = rng.integers(0, concat.size - k + 1, 150)
    kmers = np.concatenate([concat[starts[:, None] + np.arange(k)],
                            rng.integers(0, 4, (150, k)).astype(np.uint8)])
    kmers[rng.integers(0, 300, 4), rng.integers(0, k, 4)] = 255
    want = np.asarray(jbv.search_batch_device(jd, jnp.asarray(kmers)))
    got = pbv.search_batch_device(pd, torch.from_numpy(kmers))
    _equal(got, want)
    _equal(got, pindex.sbwt.search_batch(kmers))


def test_position_and_locate_tables_equal_jax(fixture):
    """build_position_table (in chunks smaller than the text, so the
    sink slot and the chunk seams are crossed) and build_locate_tables
    equal the JAX engine's."""
    k, jindex, pindex = fixture
    jd, pd, _ = _device_sbwts(jindex, pindex)
    u = pindex.unitigs
    want = np.asarray(jeng.build_position_table(jd, jindex.unitigs.concat, jindex.unitigs.ends))
    for chunk in (1 << 20, 37):
        got = peng.build_position_table(pd, u.concat, u.ends, chunk=chunk)
        _equal(got, want)
    ends = jnp.asarray(jindex.unitigs.ends, dtype=jnp.int32)
    want_loc = np.asarray(jeng.build_locate_tables(jnp.asarray(want), ends, k))
    got_loc = peng.build_locate_tables(got, put_i32(u.ends, "cpu"), k)
    assert got_loc.dtype == torch.int32
    _equal(got_loc, want_loc)
    ranks = np.random.default_rng(k).integers(-1, jd.n_nodes, (6, 9)).astype(np.int32)
    for a, b in zip(peng._ranks_to_locations(got_loc, torch.from_numpy(ranks)),
                    jeng._ranks_to_locations(jnp.asarray(want_loc), jnp.asarray(ranks))):
        _equal(a, b)


def test_widen_interval_equals_jax(fixture):
    """Random intervals (some empty, some full) and lengths (some <= 0,
    some past every LCS value) on the fixture's jump tables."""
    k, jindex, pindex = fixture
    n = jindex.sbwt.number_of_subsets()
    jl, jr = jr24.build_lcs_jump_tables(jindex.LCS)
    rng = np.random.default_rng(13 + k)
    _, lo, hi = _intervals(rng, n, 600)
    full = rng.random(600) < 0.1
    lo[full], hi[full] = 0, n - 1
    new_len = rng.integers(-2, k + 2, 600)
    want = jr24.widen_interval(jnp.asarray(jl), jnp.asarray(jr), jnp.asarray(lo, jnp.int32),
                               jnp.asarray(hi, jnp.int32), jnp.asarray(new_len, jnp.int32), n)
    pl, pr = pr24.build_lcs_jump_tables(pindex.LCS)
    got = pr24.widen_interval(put_i32(pl, "cpu"), put_i32(pr, "cpu"), torch.from_numpy(lo),
                              torch.from_numpy(hi), torch.from_numpy(new_len), n)
    for a, b in zip(got, want):
        _equal(a, b)
    moved = (np.asarray(want[0]) != lo) | (np.asarray(want[1]) != hi)
    assert moved[(lo >= 0) & (new_len > 0)].any()


def test_widen_interval_hop_with_top_bit_set():
    """A hand-made jump table whose hop fields reach 2^23 and more, so
    the packed entries have their top bit set: the hops unpack by a
    logical shift, as JAX's uint32 tables do."""
    n = (1 << 23) + 16
    big = (1 << 23) + 7
    jl = np.zeros(n + 1, np.uint32)
    jr = np.zeros(n + 1, np.uint32)
    x = (1 << 23) + 10
    jl[x] = (big << 8) | 9  # x -> 3
    jl[3] = (2 << 8) | 6  # 3 -> 1
    jr[5] = ((big + 1) << 8) | 8  # hi + 1 = 5 -> 2^23 + 13
    assert jl[x] >= 1 << 31 and jr[5] >= 1 << 31
    lo = np.array([x, x, 3, -1, x], np.int64)
    hi = np.array([4, 4, 4, -1, n - 1], np.int64)
    new_len = np.array([5, 8, 7, 5, 0], np.int64)
    want = jr24.widen_interval(jnp.asarray(jl), jnp.asarray(jr), jnp.asarray(lo, jnp.int32),
                               jnp.asarray(hi, jnp.int32), jnp.asarray(new_len, jnp.int32), n)
    got = pr24.widen_interval(put_i32(jl, "cpu"), put_i32(jr, "cpu"), torch.from_numpy(lo),
                              torch.from_numpy(hi), torch.from_numpy(new_len), n)
    for a, b in zip(got, want):
        _equal(a, b)
    _equal(got[0], [1, 3, 3, -1, 0])
    _equal(got[1], [(1 << 23) + 12] * 3 + [-1, n - 1])

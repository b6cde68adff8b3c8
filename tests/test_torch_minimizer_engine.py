"""The port's minimizer tables and locates
(finito_tpu_torch/query/minimizer_{tables,engine}.py, ops/streaming.py)
against the JAX package: host builders table by table, the device index
from the JAX index's leaves, compact_mask, and every output of the v1
and v2 locates and their occurrence-counting forms on the same reads.
The port's tables and locates take the port's own MinimizerIndex,
read by its loader from the file the JAX package writes. Every
comparison is exact."""

from __future__ import annotations

import inspect
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from finito_tpu.index.minimizer import MinimizerIndex, _pack_desc
from finito_tpu.io.seqdb import decode_seq, encode_seq
from finito_tpu.ops.streaming import compact_mask as jax_compact_mask
from finito_tpu.query import minimizer_engine as jme
from finito_tpu_torch.index.minimizer import MinimizerIndex as PortMinimizerIndex
from finito_tpu_torch.ops.streaming import compact_mask
from finito_tpu_torch.query import minimizer_engine as tme
from finito_tpu_torch.query import minimizer_tables as tables

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import build_index, gen_dspss

torch.set_num_threads(1)


def _port(mi):
    """The port's MinimizerIndex of the JAX package's mi, read by the
    port's loader from the file the JAX package writes."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mi")
        mi.serialize(path)
        return PortMinimizerIndex.load(path)


def _permuted_unitigs(unitigs, k):
    """Unitigs in the built FinimizerIndex's order, so (uid, off) answers
    line up with the host oracle (as in test_minimizer_engine)."""
    index = build_index(unitigs, k)
    ends = np.asarray(index.unitigs.ends)
    starts = np.concatenate([[0], ends[:-1]])
    return [decode_seq(index.unitigs.concat[a:b]).decode() for a, b in zip(starts, ends)]


def _mindex(seed, k, m=None, n=10, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    unitigs = gen_dspss(rng, n, lo or k + 6, hi or k + 60, k)
    permuted = _permuted_unitigs(unitigs, k)
    concat = np.concatenate([encode_seq(u.encode()) for u in permuted])
    ends = np.cumsum([len(u) for u in permuted])
    return MinimizerIndex.build(concat, ends, k, m=m), permuted, rng


def _reads(rng, permuted, B, L, mutate=10):
    """Genuine windows, mutations, pad tails, a mid-read N, a random read."""
    reads = np.full((B, L), 255, dtype=np.uint8)
    for b in range(B):
        u = permuted[int(rng.integers(len(permuted)))]
        a = int(rng.integers(0, max(1, len(u) - L)))
        s = encode_seq(u[a : a + L].encode())
        reads[b, : s.size] = s
    for _ in range(mutate):
        b, j = int(rng.integers(B)), int(rng.integers(L))
        if reads[b, j] <= 3:
            reads[b, j] = (reads[b, j] + 1) % 4
    reads[1, L // 2] = 255
    reads[2] = rng.integers(0, 4, size=L)
    return reads


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("k,m", [(9, 4), (31, 16), (40, 16)])
def test_table_builders_equal_jax(k, m):
    mi, _, _ = _mindex(50 + k, k, m)
    pmi = _port(mi)
    for name in ("build_occ_rows", "build_slot_rows"):
        np.testing.assert_array_equal(getattr(tables, name)(pmi), getattr(jme, name)(mi))
    np.testing.assert_array_equal(tables.desc_to_rows(mi.desc), jme.desc_to_rows(mi.desc))
    for pad in (2, 7):
        words = tables.pack_text_words(mi.concat, pad)
        np.testing.assert_array_equal(words, jme.pack_text_words(mi.concat, pad))
        np.testing.assert_array_equal(tables.build_text_rows(words), jme.build_text_rows(words))
        np.testing.assert_array_equal(tables.build_text_rows8(words), jme.build_text_rows8(words))
    assert tables._DESC_LEN_BITS == jme._DESC_LEN_BITS
    assert tables._SLOT_ROWS_MAX_DESC_BYTES == jme._SLOT_ROWS_MAX_DESC_BYTES


def test_capacity_policy_equal_jax():
    for BW in (1, 1000, 802816):
        for v2 in (False, True):
            for div in (None, 8):
                assert tables.initial_capacities(BW, v2, div) == jme.initial_capacities(BW, v2, div)
    for args in [(256, 1024, 10, 0, 4096), (256, 1024, 300, 0, 4096),
                 (256, 1024, 300, 5000, 8192), (1024, 1024, 5000, 0, 2048)]:
        assert tables.grow_capacities(*args) == jme.grow_capacities(*args)
    with pytest.raises(AssertionError):
        tables.grow_capacities(64, 64, 65, 0, 64)


@pytest.mark.parametrize("native", [True, False])
def test_desc_to_rows_uint64_exact(native, monkeypatch):
    """The uint64 descriptor case of test_minimizer_engine: starts past
    2^26 and a saturated stored length."""
    if not native:
        monkeypatch.setenv("FINITO_NO_NATIVE", "1")
    counts = np.zeros(1 << 10, dtype=np.int64)
    counts[0] = 1
    counts[1] = 200
    counts[2] = (1 << 26) + 7
    counts[5] = 3
    counts[-1] = 1 << 30
    desc = _pack_desc(counts)
    assert desc.dtype == np.uint64
    rows = tables.desc_to_rows(desc)
    np.testing.assert_array_equal(rows, jme.desc_to_rows(desc))
    starts = np.concatenate([[0], np.cumsum(counts)])
    np.testing.assert_array_equal(rows[:, 0].astype(np.int64), starts)
    np.testing.assert_array_equal(rows[:-1, 1].astype(np.int64), counts)


@pytest.mark.parametrize("k,m", [(9, 4), (33, 16), (70, 16)])
def test_from_numpy_equals_own_build(k, m):
    """The port's index from the JAX index's leaves equals the port's own
    build from the same MinimizerIndex, and both hold the JAX tables bit
    for bit."""
    mi, _, _ = _mindex(60 + k, k, m, n=6)
    jdmi = jme.DeviceMinimizerIndex(mi)
    leaves, (jk, jm, jn, jh) = jdmi.tree_flatten()
    arrays = {name: None if leaf is None else np.asarray(leaf)
              for name, leaf in zip(tme.LEAVES, leaves)}
    a = tme.DeviceMinimizerIndex.from_numpy(arrays, jk, jm, jn, jh, "cpu")
    b = tme.DeviceMinimizerIndex(_port(mi), "cpu")
    assert (a.k, a.m, a.n_occ, a.h) == (b.k, b.m, b.n_occ, b.h) == (jk, jm, jn, jh)
    for name in tme.LEAVES:
        ta, tb, ref = getattr(a, name), getattr(b, name), arrays[name]
        if ref is None:
            assert ta is None and tb is None, name
            continue
        assert ta.dtype == tb.dtype == torch.int32, name
        assert torch.equal(ta, tb), name
        np.testing.assert_array_equal(ta.numpy(), ref.view(np.int32), name)


def test_device_defaults_to_cuda():
    """The device index targets the card unless the caller asks for the
    CPU, as every test here does."""
    for fn in (tme.DeviceMinimizerIndex.__init__, tme.DeviceMinimizerIndex.from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        mi, _, _ = _mindex(3, 9, 4, n=3)
        with pytest.raises((RuntimeError, AssertionError)):
            tme.DeviceMinimizerIndex(_port(mi))


# ---------------------------------------------------------- compact_mask


@pytest.mark.parametrize("n,density,K", [
    (1000, 0.05, 256), (1000, 0.5, 64), (33, 1.0, 40), (777, 0.0, 16),
])
def test_compact_mask_equals_jax(n, density, K):
    rng = np.random.default_rng(n + K)
    mask = rng.random(n) < density
    idx, cnt = compact_mask(torch.from_numpy(mask), K)
    jidx, jcnt = jax_compact_mask(jnp.asarray(mask), K)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(cnt) == int(jcnt) == int(mask.sum())


def test_compact_mask_empty():
    idx, cnt = compact_mask(torch.zeros(0, dtype=torch.bool), 4)
    assert idx.tolist() == [-1] * 4 and int(cnt) == 0


# --------------------------------------------------------------- locate


def _both_locates(mi, reads, K, narrow=False):
    jdmi = jme.DeviceMinimizerIndex(mi)
    tdmi = tme.DeviceMinimizerIndex(_port(mi), "cpu")
    if narrow:
        jdmi.slot_rows = None
        tdmi.slot_rows = None
    ju, jo, jn = jme.make_minimizer_locate(jdmi, K)(reads)
    tu, to, tn = tme.make_minimizer_locate(tdmi, K)(torch.from_numpy(reads))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tn) == int(jn)
    return tu.numpy(), to.numpy(), int(tn)


@pytest.mark.parametrize("narrow", [False, True])
def test_locate_random_dspss(narrow):
    mi, permuted, rng = _mindex(42, 6, n=12, lo=8, hi=40)
    reads = _reads(rng, permuted, 32, 40)
    _both_locates(mi, reads, 4096, narrow)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("m", [3, 4])
def test_locate_small_m_multi_occurrence(m, narrow):
    mi, permuted, rng = _mindex(11, 8, m=m, n=8, lo=12, hi=50)
    assert int((mi.desc & 7).max()) >= 2, "fixture must exercise slots >= 2"
    reads = _reads(rng, permuted, 32, 40)
    _, _, n_slow = _both_locates(mi, reads, 4096, narrow)
    assert n_slow > 0


@pytest.mark.parametrize("k,narrow", [(33, False), (63, True), (70, False)])
def test_locate_large_k(k, narrow):
    """k=33/63: the 8-word text rows; k=70: the rolling text compare."""
    mi, permuted, rng = _mindex(200 + k, k, n=4)
    reads = _reads(rng, permuted, 8, 2 * k + 20)
    uid, _, _ = _both_locates(mi, reads, 4096, narrow)
    assert (uid >= 0).any()


def test_locate_forced_slow_overflow():
    """K_slow below the slow-window count: n_slow reports the true count
    and the outputs still agree with JAX exactly."""
    mi, permuted, rng = _mindex(12, 8, m=3, n=8, lo=12, hi=50)
    reads = _reads(rng, permuted, 32, 40)
    _, _, n_slow = _both_locates(mi, reads, 2)
    assert n_slow > 2


def _no_occurrence_index(rng):
    """Every unitig shorter than k = 9: no occurrence at all."""
    mi = MinimizerIndex.build(rng.integers(0, 4, 20).astype(np.uint8),
                              np.array([5, 12, 20]), 9, m=4)
    assert mi.occ_key.size == 0
    return mi


@pytest.mark.parametrize("narrow", [False, True])
def test_locate_index_without_occurrences(narrow):
    """The JAX v1 locate cannot trace this (jnp.take from the empty
    occ_rows in _check_candidate); the port answers every window absent,
    as the host oracle does."""
    rng = np.random.default_rng(0)
    mi = _no_occurrence_index(rng)
    dmi = tme.DeviceMinimizerIndex(_port(mi), "cpu")
    if narrow:
        dmi.slot_rows = None
    reads = rng.integers(0, 4, (4, 30)).astype(np.uint8)
    uid, off, n_slow = tme.make_minimizer_locate(dmi, 16)(torch.from_numpy(reads))
    assert mi.lookup_kmer_host(reads[0, :9]) == (-1, -1)
    assert (uid == -1).all() and (off == -1).all() and int(n_slow) == 0


# ------------------------------------------------------------ locate v2


def _v2_both(jdmi, tdmi, reads, K, KH, count=False):
    """JAX and port v2 on the same reads; every output equal."""
    want = jme.make_minimizer_locate_v2(jdmi, K, KH, count_occurrences=count)(reads)
    got = tme.make_minimizer_locate_v2(tdmi, K, KH, count_occurrences=count)(
        torch.from_numpy(reads))
    assert len(got) == len(want) == (5 if count else 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


def _indexes(mi, narrow):
    jdmi = jme.DeviceMinimizerIndex(mi)
    tdmi = tme.DeviceMinimizerIndex(_port(mi), "cpu")
    if narrow:
        jdmi.slot_rows = None
        tdmi.slot_rows = None
    return jdmi, tdmi


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("k,m", [(31, 16), (63, 16), (18, 4), (9, 4), (95, 3)])
def test_locate_v2_equals_jax(k, m, narrow):
    """(31, 16): one bitmap word; (63, 16): R_run = 48, two bitmap words
    with bit 31 set; (18, 4) and (9, 4): multi-occurrence slots, so slow
    runs; (95, 3): spans that reach past the text's pad words. Both index
    branches (v2 reads only the descriptor rows)."""
    mi, permuted, rng = _mindex(400 + k, k, m=m, n=10)
    reads = _reads(rng, permuted, 16, 2 * k + 30)
    uid, _, n_slow, n_heads = _v2_both(*_indexes(mi, narrow), reads, 4096, 4096)
    assert (uid >= 0).any()
    assert 0 < n_heads < reads.shape[0] * (reads.shape[1] - k + 1)
    if m <= 4:
        assert n_slow > 0
    # v2 answers what v1 answers
    v1 = tme.make_minimizer_locate(_indexes(mi, narrow)[1], 4096)(torch.from_numpy(reads))
    np.testing.assert_array_equal(uid, v1[0].numpy())


def test_locate_v2_from_jax_leaves():
    """The port's index made with from_numpy from the JAX index's leaves
    runs v2 to the JAX answer."""
    mi, permuted, rng = _mindex(77, 18, m=4, n=10)
    jdmi = jme.DeviceMinimizerIndex(mi)
    leaves, aux = jdmi.tree_flatten()
    arrays = {name: None if leaf is None else np.asarray(leaf)
              for name, leaf in zip(tme.LEAVES, leaves)}
    tdmi = tme.DeviceMinimizerIndex.from_numpy(arrays, *aux, "cpu")
    _v2_both(jdmi, tdmi, _reads(rng, permuted, 16, 60), 4096, 4096)


def test_locate_v2_forced_overflow():
    """K_heads and K_slow below their counts: every output, the counters
    included, equals JAX's. n_heads is always the true count; n_slow is
    the count among the first K_heads heads, so it is exact whenever the
    heads fit, and overflow shows in one counter or the other."""
    mi, permuted, rng = _mindex(12, 8, m=3, n=8, lo=12, hi=50)
    reads = _reads(rng, permuted, 32, 40)
    jdmi, tdmi = _indexes(mi, False)
    _, _, n_slow, n_heads = _v2_both(jdmi, tdmi, reads, 4096, 4096)
    assert n_slow > 2 and n_heads > 16
    got = _v2_both(jdmi, tdmi, reads, 2, 4096)
    assert (got[2], got[3]) == (n_slow, n_heads)
    for K in (4096, 2):
        got = _v2_both(jdmi, tdmi, reads, K, 16)
        assert got[3] == n_heads and 0 < got[2] <= min(16, n_slow)


# ------------------------------------------------- occurrence counting


def _duplicated_unitig_index(seed, k, m):
    """A DSPSS with one unitig stored twice, so its k-mers occur twice
    (cnt = 2), and with small m so the slots also hold other k-mers."""
    mi, permuted, rng = _mindex(seed, k, m=m, n=8, lo=k + 4, hi=k + 40)
    dup = permuted + [permuted[1]]
    concat = np.concatenate([encode_seq(u.encode()) for u in dup])
    ends = np.cumsum([len(u) for u in dup])
    return MinimizerIndex.build(concat, ends, k, m=m), dup, rng


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("k,m", [(9, 4), (31, 16)])
def test_count_occurrences_equals_jax(k, m, narrow):
    """Both locate forms with count_occurrences against JAX: uid, off and
    the exact count, with cnt >= 2 on the duplicated unitig's k-mers."""
    mi, dup, rng = _duplicated_unitig_index(500 + k, k, m)
    reads = _reads(rng, dup, 16, k + 30)
    reads[0, : k + 4] = encode_seq(dup[1][: k + 4].encode())
    jdmi, tdmi = _indexes(mi, narrow)
    want = jme.make_minimizer_locate(jdmi, 4096, count_occurrences=True)(reads)
    got = tme.make_minimizer_locate(tdmi, 4096, count_occurrences=True)(torch.from_numpy(reads))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cnt = got[3].numpy()
    assert (cnt >= 2).any() and (cnt == 1).any()
    v2 = _v2_both(jdmi, tdmi, reads, 4096, 4096, count=True)
    np.testing.assert_array_equal(v2[4], cnt)
    np.testing.assert_array_equal(v2[0], got[0].numpy())
    # the count is the host's number of occurrences
    for w in range(k + 4 - k + 1):
        assert cnt[0, w] == len(mi.lookup_kmer_host_all(reads[0, w : w + k]))


@pytest.mark.parametrize("narrow", [False, True])
def test_v2_and_counting_without_occurrences(narrow):
    """ROADMAP C4 for v2 and both counting forms: JAX cannot trace them
    on an index with no occurrence; the port answers every window absent
    with count 0, as the host oracle does."""
    rng = np.random.default_rng(1)
    mi = _no_occurrence_index(rng)
    _, tdmi = _indexes(mi, narrow)
    reads = torch.from_numpy(rng.integers(0, 4, (4, 30)).astype(np.uint8))
    u1, o1, s1, c1 = tme.make_minimizer_locate(tdmi, 16, count_occurrences=True)(reads)
    u2, o2, s2, h2, c2 = tme.make_minimizer_locate_v2(tdmi, 16, 256, count_occurrences=True)(reads)
    u3, o3, s3, h3 = tme.make_minimizer_locate_v2(tdmi, 16, 256)(reads)
    assert all(mi.lookup_kmer_host_all(reads[0, w : w + 9].numpy()) == [] for w in range(22))
    for t in (u1, o1, u2, o2, u3, o3):
        assert (t == -1).all()
    assert (c1 == 0).all() and (c2 == 0).all()
    assert int(s1) == int(s2) == int(s3) == 0 and int(h2) == int(h3) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,narrow", [
    (8, 3, False), (8, 4, True), (31, 16, False), (33, 16, True), (63, 16, False), (70, 16, True),
])
def test_locate_on_card_equals_cpu(k, m, narrow):
    """The locate on the card (front-end kernel + plain torch on CUDA
    tensors) equals the same locate on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mi, permuted, rng = _mindex(300 + k, k, m=m, n=8)
    reads = torch.from_numpy(_reads(rng, permuted, 64, 2 * k + 40))
    out = []
    for device in ("cpu", "cuda"):
        dmi = tme.DeviceMinimizerIndex(_port(mi), device)
        if narrow:
            dmi.slot_rows = None
        out.append(tme.make_minimizer_locate(dmi, 4096)(reads.to(device)))
    for a, b in zip(*out):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,narrow", [(9, 4, False), (31, 16, True), (63, 16, False)])
def test_v2_and_counting_on_card_equal_cpu(k, m, narrow):
    """v2 and both counting forms on the card equal the same calls on the
    CPU, on an index with a duplicated unitig."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mi, dup, rng = _duplicated_unitig_index(600 + k, k, m)
    reads = torch.from_numpy(_reads(rng, dup, 64, 2 * k + 40))
    forms = (
        lambda d: tme.make_minimizer_locate_v2(d, 4096, 8192),
        lambda d: tme.make_minimizer_locate_v2(d, 4096, 8192, count_occurrences=True),
        lambda d: tme.make_minimizer_locate(d, 4096, count_occurrences=True),
    )
    for form in forms:
        out = []
        for device in ("cpu", "cuda"):
            dmi = tme.DeviceMinimizerIndex(_port(mi), device)
            if narrow:
                dmi.slot_rows = None
            out.append(form(dmi)(reads.to(device)))
        for a, b in zip(*out):
            assert torch.equal(a, b.cpu())

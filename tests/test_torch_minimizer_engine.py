"""The port's minimizer tables and v1 locate
(finito_tpu_torch/query/minimizer_{tables,engine}.py, ops/streaming.py)
against the JAX package: host builders table by table, the device index
from the JAX index's leaves, compact_mask, and (uid, off, n_slow) of the
locate on the same reads. Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from finito_tpu.index.minimizer import MinimizerIndex, _pack_desc
from finito_tpu.io.seqdb import decode_seq, encode_seq
from finito_tpu.ops.streaming import compact_mask as jax_compact_mask
from finito_tpu.query import minimizer_engine as jme
from finito_tpu_torch.ops.streaming import compact_mask
from finito_tpu_torch.query import minimizer_engine as tme
from finito_tpu_torch.query import minimizer_tables as tables

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import build_index, gen_dspss

torch.set_num_threads(1)


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
    for name in ("build_occ_rows", "build_slot_rows"):
        np.testing.assert_array_equal(getattr(tables, name)(mi), getattr(jme, name)(mi))
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
    b = tme.DeviceMinimizerIndex(mi, "cpu")
    assert (a.k, a.m, a.n_occ, a.h) == (b.k, b.m, b.n_occ, b.h) == (jk, jm, jn, jh)
    for name in tme.LEAVES:
        ta, tb, ref = getattr(a, name), getattr(b, name), arrays[name]
        if ref is None:
            assert ta is None and tb is None, name
            continue
        assert ta.dtype == tb.dtype == torch.int32, name
        assert torch.equal(ta, tb), name
        np.testing.assert_array_equal(ta.numpy(), ref.view(np.int32), name)


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
    tdmi = tme.DeviceMinimizerIndex(mi, "cpu")
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


def test_count_occurrences_not_ported():
    mi, _, _ = _mindex(13, 8, n=3)
    with pytest.raises(NotImplementedError):
        tme.make_minimizer_locate(tme.DeviceMinimizerIndex(mi), 16, count_occurrences=True)


@pytest.mark.parametrize("narrow", [False, True])
def test_locate_index_without_occurrences(narrow):
    """Every unitig shorter than k: no occurrence at all. The JAX v1
    locate cannot trace this (jnp.take from the empty occ_rows in
    _check_candidate); the port answers every window absent, as the
    host oracle does."""
    rng = np.random.default_rng(0)
    k = 9
    mi = MinimizerIndex.build(rng.integers(0, 4, 20).astype(np.uint8),
                              np.array([5, 12, 20]), k, m=4)
    assert mi.occ_key.size == 0
    dmi = tme.DeviceMinimizerIndex(mi, "cpu")
    if narrow:
        dmi.slot_rows = None
    reads = rng.integers(0, 4, (4, 30)).astype(np.uint8)
    uid, off, n_slow = tme.make_minimizer_locate(dmi, 16)(torch.from_numpy(reads))
    assert mi.lookup_kmer_host(reads[0, :k]) == (-1, -1)
    assert (uid == -1).all() and (off == -1).all() and int(n_slow) == 0


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
        dmi = tme.DeviceMinimizerIndex(mi, device)
        if narrow:
            dmi.slot_rows = None
        out.append(tme.make_minimizer_locate(dmi, 4096)(reads.to(device)))
    for a, b in zip(*out):
        assert torch.equal(a, b.cpu())

"""The port's replica engine (finito_tpu_torch/query/replica.py) on the
CPU against the JAX package's make_replica_locate_v2 and the host oracle
FinimizerIndex.search, with augmented and plain forward edges, the chain
scan whole and chunked; and its table builders against JAX's. The port
reads the JAX package's index files with its own loader. Every
comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finito_tpu.io.seqdb import decode_seq, encode_seq
from finito_tpu.ops import rank24 as jr24
from finito_tpu.query import replica as jrep
from finito_tpu_torch.index.index import FinimizerIndex as PortFinimizerIndex
from finito_tpu_torch.ops import rank24 as pr24
from finito_tpu_torch.ops.bits import put_i32
from finito_tpu_torch.query import replica as prep

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import build_index, gen_dspss

torch.set_num_threads(1)

B, L = 16, 40


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(k, the JAX index, the port's index, mutation-heavy reads)"""
    rng = np.random.default_rng(52)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    jindex = build_index(unitigs, k)
    prefix = str(tmp_path_factory.mktemp("replica") / "idx")
    jindex.serialize(prefix)
    reads = np.full((B, L), 255, np.uint8)
    for b in range(B):
        u = encode_seq(unitigs[int(rng.integers(len(unitigs)))].encode())
        n = min(u.size, L)
        reads[b, :n] = u[:n]
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, n))
            reads[b, p] = (reads[b, p] + int(rng.integers(1, 4))) % 4
        if b % 4 == 0:  # invalid chars straddling chunk seams
            reads[b, int(rng.integers(0, L))] = 255
    return k, jindex, PortFinimizerIndex.load(prefix), reads


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b)


def test_tables_equal_jax(fixture):
    _, jindex, pindex, _ = fixture
    ju, pu = jindex.unitigs, pindex.unitigs
    _equal(prep.build_uend_table(pu.ends), jrep.build_uend_table(ju.ends))
    _equal(prep.build_uend_table(np.zeros(0, np.int64)), jrep.build_uend_table(np.zeros(0, np.int64)))
    want = jrep.build_resolution_table(np.asarray(jindex.fmin, np.uint8), jindex.global_offsets,
                                       np.asarray(jindex.Ustart, np.uint8), ju.ends)
    got = prep.build_resolution_table(np.asarray(pindex.fmin, np.uint8), pindex.global_offsets,
                                      np.asarray(pindex.Ustart, np.uint8), pu.ends)
    assert got.dtype == want.dtype
    _equal(got, want)


@pytest.mark.parametrize("wide", [False, True])
def test_rank1_equals_jax(fixture, monkeypatch, wide):
    _, jindex, _, _ = fixture
    if wide:
        monkeypatch.setattr(jr24, "RANK24_MAX_NODES", 1)
        monkeypatch.setattr(pr24, "RANK24_MAX_NODES", 1)
    tab = jrep.build_uend_table(jindex.unitigs.ends)
    assert tab.ndim == (2 if wide else 1)
    _equal(prep.build_uend_table(jindex.unitigs.ends), tab)
    i = np.random.default_rng(1).integers(0, 8 * tab.shape[0], 300)
    _equal(prep.rank1(put_i32(tab, "cpu"), torch.from_numpy(i)),
           jrep.rank1(jnp.asarray(tab), jnp.asarray(i, jnp.int32)))


@pytest.mark.parametrize("edges", ["augmented", "plain"])
@pytest.mark.parametrize("chunk", [0, 6, 40])
def test_locate_v2_equals_jax_and_oracle(fixture, monkeypatch, edges, chunk):
    """make_replica_locate_v2 (uid, off, n_seg) equal to JAX's, and every
    read without an invalid code equal to the host oracle. Plain edges:
    can_augment_edges forced False in both packages."""
    k, jindex, pindex, reads = fixture
    if edges == "plain":
        monkeypatch.setattr(jr24, "can_augment_edges", lambda n, k: False)
        monkeypatch.setattr(prep, "can_augment_edges", lambda n, k: False)
    tables = prep.replica_tables(pindex, device="cpu")
    assert tables["aug"] == (edges == "augmented")
    K = B * L
    want = jrep.make_replica_locate_v2(jindex, K_seg=K, chunk=chunk)(reads)
    got = prep.make_replica_locate_v2(pindex, K_seg=K, chunk=chunk, device="cpu")(reads)
    assert got[0].dtype == got[1].dtype == torch.int32
    for a, b in zip(got, want):
        _equal(a, b)
    assert int(got[2]) <= K
    uid, off = got[0].numpy(), got[1].numpy()
    clean = [b for b in range(B) if not np.any(reads[b] > 3)]
    assert len(clean) >= 4
    for b in clean:
        res = pindex.search(decode_seq(reads[b]))
        assert list(zip(uid[b].tolist(), off[b].tolist())) == res.local_offsets, b


def _twin_inputs(seed):
    """The inputs of tests/test_replica_engine.py's two-phase-vs-twin
    checks: seed 41 (12 reads, every third with an invalid code) and
    seed 52 (16 reads, every fourth); mutations and pad tails. Returns
    (the JAX index, reads)."""
    rng = np.random.default_rng(seed)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    index = build_index(unitigs, k)
    B, L = (12, 40) if seed == 41 else (16, 40)
    reads = np.full((B, L), 255, np.uint8)
    for b in range(B):
        u = encode_seq(unitigs[int(rng.integers(len(unitigs)))].encode())
        n = min(u.size, L)
        reads[b, :n] = u[:n]
        for _ in range(int(rng.integers(0, 4 if seed == 41 else 5))):
            p = int(rng.integers(0, n))
            reads[b, p] = (reads[b, p] + int(rng.integers(1, 4))) % 4
        if seed == 41 and b % 3 == 0:
            reads[b, int(rng.integers(0, n))] = 255
        if seed == 52 and b % 4 == 0:
            reads[b, int(rng.integers(0, L))] = 255
    return index, reads


@pytest.fixture(scope="module", params=[41, 52])
def twin(request, tmp_path_factory):
    """(JAX index, the port's index, reads, JAX's in-scan twin's (uid, off))"""
    jindex, reads = _twin_inputs(request.param)
    prefix = str(tmp_path_factory.mktemp(f"twin{request.param}") / "idx")
    jindex.serialize(prefix)
    want = [np.asarray(a) for a in jrep.make_replica_locate(jindex)(reads)]
    return jindex, PortFinimizerIndex.load(prefix), reads, want


def test_in_scan_twin_equals_jax(twin):
    jindex, pindex, reads, want = twin
    got = prep.make_replica_locate(pindex, device="cpu")(reads)
    assert got[0].dtype == got[1].dtype == torch.int32
    for a, b in zip(got, want):
        _equal(a, b)
    k = pindex.sbwt.get_k()
    uid, off = got[0].numpy(), got[1].numpy()
    for b in range(reads.shape[0]):
        if not np.any(reads[b] > 3):
            res = jindex.search(decode_seq(reads[b]))
            assert list(zip(uid[b].tolist(), off[b].tolist())) == res.local_offsets, b
    assert uid.shape == (reads.shape[0], reads.shape[1] - k + 1)


@pytest.mark.parametrize("chunk", [6, 8, 11, 40])
def test_locate_v2_equals_in_scan_twin(twin, chunk):
    """The two-phase form, at every chunk length of
    tests/test_replica_engine.py, equal to the in-scan twin."""
    _, pindex, reads, want = twin
    K = reads.size
    got = prep.make_replica_locate_v2(pindex, K_seg=K, chunk=chunk, device="cpu")(reads)
    assert int(got[2]) <= K
    for a, b in zip(got[:2], want):
        _equal(a, b)


def test_in_scan_twin_on_repeat_index_equals_oracle():
    from finito_tpu_torch.utils.synth import kmer_location_oracle
    from test_torch_synth import build_repeat_index, sample_reads

    genome, index, _ = build_repeat_index()
    reads = sample_reads(genome, np.random.default_rng(12), B=24, L=80)
    reads[[3, 11], [40, 0]] = 255
    got = prep.make_replica_locate(index, device="cpu")(torch.from_numpy(reads))
    want = kmer_location_oracle(np.asarray(index.unitigs.concat), np.asarray(index.unitigs.ends),
                                reads, index.sbwt.get_k())
    for a, b in zip(got, want):
        _equal(a, b)
    assert (want[0] >= 0).any() and (want[0] < 0).any()


@pytest.mark.cuda
def test_in_scan_twin_on_card_equals_cpu(twin):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, pindex, reads, want = twin
    got = prep.make_replica_locate(pindex, device="cuda")(torch.from_numpy(reads).cuda())
    assert all(t.device.type == "cuda" for t in got)
    for a, b in zip(got, want):
        _equal(a.cpu(), b)

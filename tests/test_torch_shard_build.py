"""The port's mesh index build (finito_tpu_torch/parallel/shard_build.py
and ShardedIndex.build in parallel/mesh.py) against the JAX package's
(finito_tpu/parallel/shard_build.py on its 8 virtual CPU devices) and
the host builders, case for case as tests/test_shard_build.py. The
port's mesh is the CPU repeated 8 times. Integer work: exact equality.

JAX's mesh build is run on the cases where it takes seconds; on the
rest (the larger k, the forced overflow retries) the reference is JAX's host
builder, which tests/test_shard_build.py holds equal to JAX's mesh
build on the same inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from finito_tpu_torch.index.builder import FinimizerIndexBuilder
from finito_tpu_torch.io.seqdb import SeqDB
from finito_tpu_torch.parallel import mesh as pmesh
from finito_tpu_torch.parallel import shard_build as tsb
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import gen_dspss

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the virtual 8-device mesh"
)

CPU8 = ["cpu"] * 8
PAPER = [b"GTAAGTCT", b"AGGAAA", b"ACAGG", b"GTAGG", b"AGGTA"]
INDEX_FILES = (".O.sdsl", ".FBV.sdsl", ".packed_unitigs.sdsl", ".unitig_endpoints.sdsl",
               ".Ustart.sdsl", ".LCS.sdsl", ".sbwt")


def _seqs(k):
    """tests/test_shard_build.py's string set: shared k-mers across
    strings, shared (k-1) overlaps, standalone sources."""
    rng = np.random.default_rng(k)
    seqs = []
    genome = "".join(rng.choice(list("ACGT"), 3000))
    for _ in range(40):
        s = int(rng.integers(0, len(genome) - k - 60))
        seqs.append(genome[s : s + int(rng.integers(k, k + 60))].encode())
    for _ in range(8):
        seqs.append("".join(rng.choice(list("ACGT"), k + 5)).encode())
    return seqs


def _assert_sbwt_equal(got, want):
    np.testing.assert_array_equal(got.bit_rows(), want.bit_rows())
    np.testing.assert_array_equal(got.get_C_array(), want.get_C_array())
    assert got.number_of_kmers() == want.number_of_kmers()
    assert got.number_of_subsets() == want.number_of_subsets()
    assert got.get_k() == want.get_k()


def _assert_keys_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _jax_sbwt(seqs, k, mesh_build, **kw):
    if mesh_build:
        from finito_tpu.parallel.shard_build import sharded_sbwt_build

        return sharded_sbwt_build(seqs, k, n_devices=8, return_keys=True, **kw)
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt as jax_host

    return jax_host(seqs, k, return_keys=True)


@pytest.mark.parametrize("k,jax_mesh", [(5, True), (31, True), (63, False)])
def test_sharded_sbwt_build_equals_jax_and_host(k, jax_mesh):
    seqs = _seqs(k)
    got, got_keys = tsb.sharded_sbwt_build(seqs, k, devices=CPU8, return_keys=True)
    want, want_keys = build_plain_matrix_sbwt(seqs, k, return_keys=True)
    _assert_sbwt_equal(got, want)
    _assert_keys_equal(got_keys, want_keys)
    jgot, jkeys = _jax_sbwt(seqs, k, jax_mesh)
    _assert_sbwt_equal(got, jgot)
    _assert_keys_equal(got_keys, jkeys)


@pytest.mark.parametrize("seqs,k", [([b"ACGTAC", b"TTTT"], 4), (PAPER, 4)])
def test_sharded_sbwt_build_tiny_and_empty_shards(seqs, k):
    """Fewer k-mers than shards: some shards receive nothing."""
    got = tsb.sharded_sbwt_build(seqs, k, devices=CPU8)
    _assert_sbwt_equal(got, build_plain_matrix_sbwt(seqs, k))
    _assert_sbwt_equal(got, _jax_sbwt(seqs, k, True)[0])


def test_sharded_sbwt_build_forced_overflow_retry():
    """slack so small that phases C-E overflow and double their
    capacity; one host read of the overflow count a try."""
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), 90)).encode() for _ in range(20)]
    reads = []
    real = tsb._total

    def counted(parts):
        n = real(parts)
        reads.append(n)
        return n

    tsb._total = counted
    try:
        got = tsb.sharded_sbwt_build(seqs, 11, devices=CPU8, slack=0.02)
    finally:
        tsb._total = real
    assert sum(n > 0 for n in reads) >= 3  # retries happened
    _assert_sbwt_equal(got, build_plain_matrix_sbwt(seqs, 11))
    _assert_sbwt_equal(got, _jax_sbwt(seqs, 11, False)[0])


def _host_builder(spss, k):
    sb = build_plain_matrix_sbwt(spss, k)
    return FinimizerIndexBuilder(sb, lcs_array(sb), SeqDB.from_sequences(spss), device="cpu")


def _assert_index_equal(got, want):
    _assert_sbwt_equal(got.sbwt, want.sbwt)
    for name in ("LCS", "fmin", "global_offsets", "Ustart"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(np.asarray(got.unitigs.concat), np.asarray(want.unitigs.concat))
    np.testing.assert_array_equal(np.asarray(got.unitigs.ends), np.asarray(want.unitigs.ends))
    assert got.offsets_width == want.offsets_width
    assert got.lcs_width == want.lcs_width


def _assert_files_equal(got, want, tmp_path):
    got.serialize(str(tmp_path / "got"))
    want.serialize(str(tmp_path / "want"))
    for suffix in INDEX_FILES:
        assert (tmp_path / ("got" + suffix)).read_bytes() == \
            (tmp_path / ("want" + suffix)).read_bytes(), suffix


def _jax_index(spss, k, mesh_build):
    """JAX's index and its finimizer stats: its mesh build's, or its host
    builder's."""
    if mesh_build:
        from finito_tpu.parallel.shard_build import sharded_index_build

        index = sharded_index_build(spss, k, n_devices=8)
        return index, index.finimizer_stats
    from finito_tpu.index.builder import FinimizerIndexBuilder as JaxBuilder
    from finito_tpu.io.seqdb import SeqDB as JaxSeqDB
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt as jax_host
    from finito_tpu.sbwt.lcs import lcs_array as jax_lcs

    sb = jax_host(spss, k)
    b = JaxBuilder(sb, jax_lcs(sb), JaxSeqDB.from_sequences(spss))
    return b.get_index(), b.finimizer_stats


def _assert_mesh_pos_equal(got, want):
    (gp, gM), (wp, wM) = got.mesh_pos, want.mesh_pos
    assert gM == wM and len(gp) == len(wp)
    for a, b in zip(gp, wp):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("k,n_unitigs,jax_mesh", [(4, 6, True), (11, 25, False), (31, 12, False)])
def test_sharded_index_build_equals_jax_and_host(k, n_unitigs, jax_mesh, tmp_path):
    rng = np.random.default_rng(100 + k)
    spss = [s.encode() for s in gen_dspss(rng, n_unitigs, k, k + 40, k)]
    got = tsb.sharded_index_build(spss, k, devices=CPU8)
    hb = _host_builder(spss, k)
    want = hb.get_index()
    _assert_index_equal(got, want)
    assert got.finimizer_stats == hb.finimizer_stats
    _assert_files_equal(got, want, tmp_path)
    jgot, jstats = _jax_index(spss, k, jax_mesh)
    _assert_index_equal(got, jgot)
    np.testing.assert_array_equal(got.finimizer_stats.packed, jstats.packed)
    if jax_mesh:
        _assert_mesh_pos_equal(got, jgot)
    # query parity on reads straddling unitig seams
    for _ in range(20):
        u = spss[int(rng.integers(0, len(spss)))]
        a = int(rng.integers(0, max(1, len(u) - k)))
        r = u[a : a + k + 10]
        assert got.search(r).local_offsets == want.search(r).local_offsets
    r = b"A" * (k + 3)
    assert got.search(r).n_found == want.search(r).n_found


def test_sharded_index_build_paper_example(tmp_path):
    got = tsb.sharded_index_build(PAPER, 4, devices=CPU8)
    want = _host_builder(PAPER, 4).get_index()
    _assert_index_equal(got, want)
    _assert_files_equal(got, want, tmp_path)
    jgot, _ = _jax_index(PAPER, 4, True)
    _assert_index_equal(got, jgot)
    _assert_mesh_pos_equal(got, jgot)


def test_sharded_finimizer_select_forced_reroute_overflow():
    """slack so small that phase B (the overwrite-rule routing) overflows
    and doubles its capacity; equal to JAX's selection and the host's."""
    from finito_tpu.index.packed_strings import permute_unitigs as jax_permute
    from finito_tpu.io.seqdb import SeqDB as JaxSeqDB
    from finito_tpu.parallel.shard_build import sharded_finimizer_select as jax_select
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt as jax_host
    from finito_tpu.sbwt.lcs import lcs_array as jax_lcs
    from finito_tpu_torch.index.packed_strings import permute_unitigs

    rng = np.random.default_rng(77)
    k = 9
    spss = [s.encode() for s in gen_dspss(rng, 12, k, k + 30, k)]
    sbwt, node_keys = tsb.sharded_sbwt_build(spss, k, devices=CPU8, return_keys=True)
    packed, _ustart, _ = permute_unitigs(sbwt, SeqDB.from_sequences(spss))
    fmin, glob, stats = tsb.sharded_finimizer_select(sbwt, lcs_array(sbwt), packed, node_keys,
                                                     CPU8, slack=0.01)
    want = _host_builder(spss, k)
    np.testing.assert_array_equal(fmin, want.get_index().fmin)
    np.testing.assert_array_equal(glob[fmin == 1].astype(np.uint64),
                                  want.get_index().global_offsets)
    assert stats == want.finimizer_stats
    jsb, jkeys = jax_host(spss, k, return_keys=True)
    jpacked, _, _ = jax_permute(jsb, JaxSeqDB.from_sequences(spss))
    jf, jg, _ = jax_select(jsb, jax_lcs(jsb), jpacked, jkeys, 8, slack=0.01)
    np.testing.assert_array_equal(fmin, jf)
    np.testing.assert_array_equal(glob, jg)


def _jax_fields_equal(got, want):
    for name in ("words", "blocks", "loc_table", "node_start", "C", "ends", "k", "n_nodes",
                 "words_per_shard", "nodes_per_shard"):
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


@pytest.fixture(scope="module")
def mesh_built():
    """tests/test_shard_build.py's ShardedIndex.build input, built by the
    port and by JAX."""
    from finito_tpu.parallel.shard_build import sharded_index_build

    rng = np.random.default_rng(88)
    k = 7
    spss = [s.encode() for s in gen_dspss(rng, 14, k, k + 40, k)]
    return spss, tsb.sharded_index_build(spss, k, devices=CPU8), sharded_index_build(
        spss, k, n_devices=8)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_index_build_feeds_sharded_locate(mesh_built, tp):
    """ShardedIndex.build takes the mesh build's per-shard position
    slices (index.mesh_pos): its arrays equal JAX's ShardedIndex.build
    and the port's from_index; the tp-sharded locate over them answers
    as the host oracle."""
    from finito_tpu.parallel.mesh import ShardedIndex as JaxShardedIndex
    from finito_tpu_torch.io.seqdb import decode_seq, encode_seq
    from finito_tpu_torch.ops.bitvec import DeviceSBWT
    from finito_tpu_torch.query.locators import build_position_table

    spss, index, jindex = mesh_built
    assert index.mesh_pos is not None
    k = index.sbwt.get_k()
    built = pmesh.ShardedIndex.build(index, tp=tp)
    pos = build_position_table(DeviceSBWT.from_host(index.sbwt, "cpu"), index.unitigs.concat,
                               index.unitigs.ends)
    ref = pmesh.ShardedIndex.from_index(index, pos, tp=tp)
    for name in ("words", "blocks", "loc_table", "node_start", "C", "ends"):
        np.testing.assert_array_equal(getattr(built, name), getattr(ref, name), err_msg=name)
    _jax_fields_equal(built, JaxShardedIndex.build(jindex, tp=tp))
    with pytest.raises(ValueError, match="needs a mesh-built index"):
        pmesh.ShardedIndex.build(_host_builder(spss, k).get_index(), tp=tp)

    locate = pmesh.sharded_locate_fn(pmesh.make_mesh(8, tp=tp, devices=CPU8), built)
    B, L = 8, 40
    reads = np.zeros((B, L), np.uint8)
    for b in range(B):
        u = encode_seq(spss[b % len(spss)])
        reads[b, : min(L, u.size)] = u[:L]
        if b % 2:
            reads[b, 5] = (reads[b, 5] + 1) % 4
    uid, off = locate(reads)
    uid, off = np.asarray(uid), np.asarray(off)
    for b in range(B):
        exp = index.search(decode_seq(reads[b])).local_offsets
        assert [(int(uid[b, w]), int(off[b, w])) for w in range(L - k + 1)] == exp


def test_flat_devices_rules():
    """devices as given (a device may repeat), a Mesh's grid flattened;
    with no card a CUDA build raises and never runs on the CPU."""
    assert tsb.flat_devices(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    grid = pmesh.make_mesh(4, tp=2, devices=["cpu"] * 4)
    assert tsb.flat_devices(grid) == [torch.device("cpu")] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is visible"):
            tsb.flat_devices(n_devices=4)
        with pytest.raises(RuntimeError, match="none is visible"):
            tsb.sharded_index_build(PAPER, 4, n_devices=2)


@pytest.mark.cuda
def test_mesh_builds_on_card_equal_host():
    """The sbwt, index and unitig builds with 4 shards on cuda:0 equal
    the host builders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from finito_tpu_torch.dbg import build_unitigs
    from finito_tpu_torch.parallel.shard_dbg import sharded_unitig_build

    cuda4 = ["cuda:0"] * 4
    seqs = _seqs(31)
    got, keys = tsb.sharded_sbwt_build(seqs, 31, devices=cuda4, return_keys=True)
    want, want_keys = build_plain_matrix_sbwt(seqs, 31, return_keys=True)
    _assert_sbwt_equal(got, want)
    _assert_keys_equal(keys, want_keys)
    rng = np.random.default_rng(131)
    spss = [s.encode() for s in gen_dspss(rng, 25, 31, 71, 31)]
    _assert_index_equal(tsb.sharded_index_build(spss, 31, devices=cuda4),
                        _host_builder(spss, 31).get_index())
    rng = np.random.default_rng(31)
    base = rng.integers(0, 4, 4000, dtype=np.uint8)
    pan = [base] + [np.where(rng.random(4000) < 0.01, (base + 1) % 4, base).astype(np.uint8)
                    for _ in range(3)]
    assert [bytes(u) for u in sharded_unitig_build(pan, 31, devices=cuda4)] == \
        [bytes(u) for u in build_unitigs(pan, 31, canonical=True)]

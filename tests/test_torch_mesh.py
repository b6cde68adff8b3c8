"""The port's mesh query layer (finito_tpu_torch/parallel/mesh.py,
ops/lcs_device.py and the engine's mesh mode) against the JAX package's
on an 8-device CPU mesh (tests/conftest.py's virtual JAX devices; the
port's mesh repeats the CPU 8 times): the host-side shard arrays array
for array, the sharded SBWT and minimizer locates against JAX's and
against the single-device engines, the all-k-mers seam cases, the
collision-pressure table, large k, and the device and sharded LCS. The
port takes its own FinimizerIndex, read by its loader from the files
the JAX package writes. Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from finito_tpu.index.minimizer import MinimizerIndex as JaxMinimizerIndex
from finito_tpu.io.seqdb import encode_seq
from finito_tpu.ops.lcs_jax import lcs_array_device as jax_lcs_array_device
from finito_tpu.parallel import mesh as jmesh
from finito_tpu.query.engine import DeviceQueryEngine as JaxEngine
from finito_tpu_torch.index.index import FinimizerIndex as PortFinimizerIndex
from finito_tpu_torch.index.minimizer import MinimizerIndex
from finito_tpu_torch.ops.bitvec import DeviceSBWT
from finito_tpu_torch.ops.lcs_device import lcs_array_device
from finito_tpu_torch.parallel import mesh as pmesh
from finito_tpu_torch.query import minimizer_engine as tme
from finito_tpu_torch.query.engine import DeviceQueryEngine
from finito_tpu_torch.query.locators import build_position_table
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import build_index, gen_dspss

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the virtual 8-device mesh"
)

CPU8 = ["cpu"] * 8


def _port_mesh(tp):
    return pmesh.make_mesh(8, tp=tp, devices=CPU8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(port index, JAX index, JAX dense engine's pos_table, reads, the
    single-device answers): the JAX test_mesh fixture."""
    rng = np.random.default_rng(123)
    k = 6
    unitigs = gen_dspss(rng, 10, 10, 50, k)
    jindex = build_index(unitigs, k)
    prefix = str(tmp_path_factory.mktemp("mesh") / "idx")
    jindex.serialize(prefix)
    index = PortFinimizerIndex.load(prefix)
    jengine = JaxEngine(jindex, mode="dense")
    B, L = 16, 40
    reads = np.full((B, L), 255, dtype=np.uint8)
    for b in range(B):
        if b % 3 == 0:
            u = unitigs[int(rng.integers(len(unitigs)))]
            codes = encode_seq(u.encode())[:L]
        else:
            codes = rng.integers(0, 4, size=int(rng.integers(k, L))).astype(np.uint8)
        reads[b, : codes.size] = codes
    uid1, off1 = jengine.locate_batch(reads)
    # the port's single-device engine gives the same answers
    pu, po = DeviceQueryEngine(index, mode="dense", device="cpu").locate_batch(reads)
    np.testing.assert_array_equal(pu, uid1)
    np.testing.assert_array_equal(po, off1)
    return index, jindex, np.asarray(jengine.pos_table), reads, uid1, off1


def _all_kmer_reads(index):
    """Every k-mer of the indexed text as its own read, batch padded to a
    multiple of 8 (every dp tested divides it)."""
    k = index.sbwt.get_k()
    concat = np.asarray(index.unitigs.concat)
    wins, s = [], 0
    for e in np.asarray(index.unitigs.ends):
        e = int(e)
        wins.extend(concat[p : p + k] for p in range(s, e - k + 1))
        s = e
    reads = np.stack(wins).astype(np.uint8)
    pad = (-reads.shape[0]) % 8
    return np.vstack([reads, np.full((pad, k), 255, np.uint8)])


def _assert_fields_equal(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


SH_FIELDS = ("words", "blocks", "loc_table", "node_start", "C", "ends", "k", "n_nodes",
             "words_per_shard", "nodes_per_shard")
SHM_FIELDS = ("desc", "occ_rows", "n_occ", "text_arr", "k", "m", "h", "V", "uid_base",
              "text_base")


# ------------------------------------------------------------ host arrays


def test_make_mesh_rules():
    m = pmesh.make_mesh(8, tp=2, devices=CPU8)
    assert m.devices.shape == (4, 2) and m.axis_names == ("dp", "tp")
    assert (dict(zip(m.axis_names, m.devices.shape)) == jmesh.make_mesh(8, tp=2).shape
            == {"dp": 4, "tp": 2})
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    # tp falls back to 1 when it does not divide the device count
    assert pmesh.make_mesh(6, tp=4, devices=CPU8).devices.shape == (6, 1)
    with pytest.raises(RuntimeError, match="needs 8 devices, found 3"):
        pmesh.make_mesh(8, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 2 devices, found 0"):
            pmesh.make_mesh(2)


def test_position_table_equals_jax(setup):
    index, _, pos_table, _, _, _ = setup
    got = build_position_table(DeviceSBWT.from_host(index.sbwt, "cpu"),
                               index.unitigs.concat, index.unitigs.ends)
    np.testing.assert_array_equal(got.numpy(), pos_table)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_index_arrays_equal_jax(setup, tp):
    index, jindex, pos_table, _, _, _ = setup
    got = pmesh.ShardedIndex.from_index(index, pos_table, tp=tp)
    _assert_fields_equal(got, jmesh.ShardedIndex.from_index(jindex, pos_table, tp=tp), SH_FIELDS)
    # a tensor position table gives the same shards
    again = pmesh.ShardedIndex.from_index(index, torch.from_numpy(pos_table.copy()), tp=tp)
    _assert_fields_equal(again, got, SH_FIELDS)


@pytest.mark.parametrize("tp,n_unitigs", [(1, 10), (2, 10), (4, 10), (4, 3), (8, 2)])
def test_sharded_minimizer_index_arrays_equal_jax(tp, n_unitigs):
    """tp in {1, 2, 4}, and more shards than unitigs (padded empty
    shards)."""
    rng = np.random.default_rng(40 + tp + n_unitigs)
    k = 7
    unitigs = gen_dspss(rng, n_unitigs, 10, 50, k)
    concat = np.concatenate([encode_seq(u.encode()) for u in unitigs])
    ends = np.cumsum([len(u) for u in unitigs])
    got = pmesh.ShardedMinimizerIndex.build(concat, ends, k, tp)
    want = jmesh.ShardedMinimizerIndex.build(concat, ends, k, tp)
    _assert_fields_equal(got, want, SHM_FIELDS)
    if n_unitigs < tp:
        assert (got.n_occ == 0).sum() >= tp - n_unitigs


def test_from_minimizer_index_equals_jax(setup):
    index, jindex, _, _, _, _ = setup
    got = pmesh.ShardedMinimizerIndex.from_minimizer_index(
        MinimizerIndex.from_finimizer_index(index), tp=4)
    want = jmesh.ShardedMinimizerIndex.from_minimizer_index(
        JaxMinimizerIndex.from_finimizer_index(jindex), tp=4)
    _assert_fields_equal(got, want, SHM_FIELDS)


# ---------------------------------------------------------------- locates


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_locate_equals_jax(setup, tp):
    index, jindex, pos_table, reads, uid1, off1 = setup
    sh = pmesh.ShardedIndex.from_index(index, pos_table, tp=tp)
    uid, off = pmesh.sharded_locate_fn(_port_mesh(tp), sh)(reads)
    assert uid.dtype == off.dtype == torch.int32
    ju, jo = jmesh.sharded_locate_fn(
        jmesh.make_mesh(8, tp=tp), jmesh.ShardedIndex.from_index(jindex, pos_table, tp=tp))(reads)
    np.testing.assert_array_equal(uid.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(off.numpy(), np.asarray(jo))
    W = uid1.shape[1]
    np.testing.assert_array_equal(uid.numpy()[:, :W], uid1)
    np.testing.assert_array_equal(off.numpy()[:, :W], off1)


def _both_minimizer(concat, ends, k, tp, reads, K_slow, slot_factor=32):
    """The port's and JAX's sharded minimizer locates on the same
    reads: every output equal; returns the port's (uid, off, n_slow)."""
    shm = pmesh.ShardedMinimizerIndex.build(concat, ends, k, tp, slot_factor=slot_factor)
    uid, off, n_slow = pmesh.sharded_minimizer_locate_fn(_port_mesh(tp), shm, K_slow)(reads)
    assert uid.dtype == off.dtype == n_slow.dtype == torch.int32
    jshm = jmesh.ShardedMinimizerIndex.build(concat, ends, k, tp, slot_factor=slot_factor)
    ju, jo, jn = jmesh.sharded_minimizer_locate_fn(jmesh.make_mesh(8, tp=tp), jshm, K_slow)(reads)
    np.testing.assert_array_equal(uid.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(off.numpy(), np.asarray(jo))
    assert int(n_slow) == int(np.asarray(jn)) <= K_slow
    return uid.numpy(), off.numpy(), int(n_slow), shm


def _text(index):
    return np.asarray(index.unitigs.concat, np.uint8), np.asarray(index.unitigs.ends, np.int64)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_minimizer_locate_equals_jax(setup, tp):
    index, _, _, reads, uid1, off1 = setup
    concat, ends = _text(index)
    uid, off, _, _ = _both_minimizer(concat, ends, index.sbwt.get_k(), tp, reads, 512)
    W = uid1.shape[1]
    np.testing.assert_array_equal(uid[:, :W], uid1)
    np.testing.assert_array_equal(off[:, :W], off1)
    # the port's single-device minimizer engine answers the same
    got = DeviceQueryEngine(index, device="cpu").locate_batch(reads)
    np.testing.assert_array_equal(got[0], uid1)
    np.testing.assert_array_equal(got[1], off1)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_all_kmers_cover_shard_boundaries(setup, tp):
    """Every k-mer of the indexed set as its own read: every colex rank,
    the shard-boundary ranks of each tp split included, flows through the
    sharded rank/psum path, and every unitig's k-mers through the
    text-sharded combine."""
    index, jindex, pos_table, _, _, _ = setup
    reads = _all_kmer_reads(index)
    uid1, off1 = JaxEngine(jindex, mode="dense").locate_batch(reads)
    n_real = int((reads[:, 0] != 255).sum())
    assert np.all(uid1[:n_real] >= 0)  # every indexed k-mer found
    sh = pmesh.ShardedIndex.from_index(index, pos_table, tp=tp)
    uid, off = pmesh.sharded_locate_fn(_port_mesh(tp), sh)(reads)
    np.testing.assert_array_equal(uid.numpy()[:, :1], uid1)
    np.testing.assert_array_equal(off.numpy()[:, :1], off1)
    concat, ends = _text(index)
    um, om, _, _ = _both_minimizer(concat, ends, index.sbwt.get_k(), tp, reads, 2048)
    np.testing.assert_array_equal(um[:, :1], uid1)
    np.testing.assert_array_equal(om[:, :1], off1)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_minimizer_sharded_collision_pressure(setup, tp):
    """slot_factor=1 saturates every shard's table with collisions, so
    the shard-local slow path and the psum combine both carry weight."""
    index, jindex, _, _, _, _ = setup
    reads = _all_kmer_reads(index)
    uid1, off1 = JaxEngine(jindex, mode="dense").locate_batch(reads)
    concat, ends = _text(index)
    k = index.sbwt.get_k()
    um, om, n_slow, shm = _both_minimizer(concat, ends, k, tp, reads, 4096, slot_factor=1)
    assert n_slow > 0
    assert all(int(shm.desc[s, : shm.V, 1].max()) >= 2
               for s in range(tp) if int(shm.n_occ[s]) >= 4), tp
    # the partition covers every occurrence exactly once
    assert int(shm.n_occ.sum()) == int(MinimizerIndex.build(concat, ends, k, slot_factor=1)
                                       .occ_key.size)
    np.testing.assert_array_equal(um[:, :1], uid1)
    np.testing.assert_array_equal(om[:, :1], off1)


@pytest.mark.parametrize("k", [65, 129])
def test_sharded_minimizer_large_k(k):
    """64 < k <= 255: the rolling packed-word compare on shard-local
    text; equal to JAX's and to the port's single-device v1 locate."""
    rng = np.random.default_rng(k)
    unitigs = gen_dspss(rng, 20, k + 80, k + 200, k)
    concat = np.concatenate([encode_seq(u.encode()) for u in unitigs])
    ends = np.cumsum([len(u) for u in unitigs])
    L, B = k + 40, 16
    reads = np.full((B, L), 255, np.uint8)
    for b, u in enumerate(unitigs[:B]):
        codes = encode_seq(u.encode())
        reads[b, : min(L, codes.size)] = codes[:L]
    mut = rng.integers(0, L, size=B)
    reads[np.arange(B), mut] = (reads[np.arange(B), mut] + 1) % 4
    dmi = tme.DeviceMinimizerIndex(MinimizerIndex.build(concat, ends, k), "cpu")
    uid1, off1, _ = tme.make_minimizer_locate(dmi, 512)(torch.from_numpy(reads))
    assert (uid1 >= 0).any()
    for tp in (2, 8) if k < 128 else (8,):
        um, om, _, _ = _both_minimizer(concat, ends, k, tp, reads, 512)
        np.testing.assert_array_equal(um, uid1.numpy())
        np.testing.assert_array_equal(om, off1.numpy())


# -------------------------------------------------------------------- LCS


@pytest.mark.parametrize("k", [4, 7])
def test_lcs_device_equals_host_and_jax(k):
    rng = np.random.default_rng(8 + k)
    unitigs = [u.encode() for u in gen_dspss(rng, 8, k + 2, 40, k)]
    sbwt = build_plain_matrix_sbwt(unitigs, k)
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt as jax_build

    want = lcs_array(sbwt)
    got = lcs_array_device(sbwt, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_lcs_array_device(jax_build(unitigs, k)))


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_lcs_equals_host_and_jax(setup, tp):
    index, jindex, _, _, _, _ = setup
    want = lcs_array(index.sbwt)
    got = pmesh.sharded_lcs_fn(_port_mesh(tp), index.sbwt)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jmesh.sharded_lcs_fn(jmesh.make_mesh(8, tp=tp), jindex.sbwt))
    # more shards than a shard's worth of nodes: S = 8 over a tiny index
    n = index.sbwt.number_of_subsets()
    np.testing.assert_array_equal(
        pmesh.sharded_lcs_fn(pmesh.make_mesh(min(8, n), tp=1, devices=CPU8), index.sbwt), want)


# ----------------------------------------------------------------- engine


def test_mesh_engine_equals_single_and_jax(setup):
    """DeviceQueryEngine(mesh=(4, 2), device="cpu"): merged_pairs_flat
    equal to the single-device engine's and to the JAX mesh engine's."""
    index, jindex, _, _, _, _ = setup
    rng = np.random.default_rng(5)
    genome = "".join("ACGT"[c] for c in index.unitigs.concat)
    reads = [genome[s : s + 30].encode() for s in rng.integers(0, len(genome) - 30, 13)]
    reads += [b"ACG", b"ACGTNACGTACG"]
    eng = DeviceQueryEngine(index, mesh=(4, 2), device="cpu")
    assert eng.locator.mesh.devices.shape == (4, 2) and eng.device == torch.device("cpu")
    got = eng.merged_pairs_flat(reads)
    for want in (DeviceQueryEngine(index, device="cpu").merged_pairs_flat(reads),
                 JaxEngine(jindex, mode="minimizer", mesh=(4, 2)).merged_pairs_flat(reads)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # explicit devices win; one device per shard of a (2, 2) grid
    eng2 = DeviceQueryEngine(index, mesh=(2, 2), devices=["cpu"] * 4)
    assert eng2.locator.mesh.devices.shape == (2, 2)
    for a, b in zip(eng2.merged_pairs_flat(reads), got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a (1, 1) mesh is the single-device engine
    assert DeviceQueryEngine(index, mesh=(1, 1), device="cpu").mesh_shape is None


@pytest.mark.parametrize("mesh", [(4, 2), (8, 1)])
def test_mesh_engine_batch_not_divisible_by_dp(setup, mesh):
    """A chunk of 1 or 2 reads is B = 2 or 4 rows (both strands), which
    dp = 4 or 8 does not divide: JAX raises "batch N not divisible by
    dp"; the port pads B up to dp with absent rows (ROADMAP C7) and
    answers as the single-device engine and the host oracle do."""
    from finito_tpu_torch.io.fastx import reverse_complement

    index = setup[0]
    k = index.sbwt.get_k()
    eng = DeviceQueryEngine(index, mesh=mesh, device="cpu")
    single = DeviceQueryEngine(index, device="cpu")
    genome = "".join("ACGT"[c] for c in index.unitigs.concat)
    for reads in ([genome[:20].encode()], [genome[5:30].encode(), b"ACGTACGTTTGCA"]):
        got = eng.merged_pairs_flat(reads)
        for a, b in zip(got, single.merged_pairs_flat(reads)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # the host oracle's merged lines (the reference's fwd/RC merge)
        want = []
        for r in reads:
            fwd = index.search(r).local_offsets
            rc = index.search(reverse_complement(r)).local_offsets
            want += [p if p[0] != -1 else rc[len(r) - k - i] for i, p in enumerate(fwd)]
        assert list(zip(got[1].tolist(), got[2].tolist())) == want
        assert got[0].tolist() == [len(r) - k + 1 for r in reads]


def test_mesh_engine_modes_and_devices(setup):
    index = setup[0]
    with pytest.raises(ValueError, match="--mesh requires the minimizer engine"):
        DeviceQueryEngine(index, mode="dense", mesh=(4, 2), device="cpu")
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="--mesh 4,2 needs 8 devices"):
            DeviceQueryEngine(index, mesh=(4, 2), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_mesh_on_card_equals_cpu(setup, dp, tp):
    """The sharded locates, every shard on cuda:0 (the front-end kernel
    and plain torch on CUDA tensors), equal the same meshes on the CPU;
    and the device and sharded LCS on the card equal the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    index, _, pos_table, _, _, _ = setup
    reads = torch.from_numpy(_all_kmer_reads(index))
    concat, ends = _text(index)
    shm = pmesh.ShardedMinimizerIndex.build(concat, ends, index.sbwt.get_k(), tp, slot_factor=1)
    sh = pmesh.ShardedIndex.from_index(index, pos_table, tp=tp)
    out = []
    for device in ("cpu", "cuda:0"):
        mesh = pmesh.make_mesh(dp * tp, tp=tp, devices=[device] * (dp * tp))
        out.append((*pmesh.sharded_minimizer_locate_fn(mesh, shm, 4096)(reads.to(device)),
                    *pmesh.sharded_locate_fn(mesh, sh)(reads.to(device))))
        if device != "cpu":
            want = lcs_array(index.sbwt)
            np.testing.assert_array_equal(lcs_array_device(index.sbwt, device), want)
            np.testing.assert_array_equal(pmesh.sharded_lcs_fn(mesh, index.sbwt), want)
    for a, b in zip(*out):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu())

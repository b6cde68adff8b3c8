"""The port's DeviceQueryEngine (finito_tpu_torch/query/engine.py) on the
CPU against the JAX engine's merged_pairs_flat and the host oracle
FinimizerIndex.search, in both locate forms; the v1/v2 rule, the
forced capacity re-run of every checked mode and the capacity loop
itself (query.locators.Optimistic), the RLE overflow fallback and the minimizer
index cache. The port's engine takes the port's own FinimizerIndex, read
by its loader from the files the JAX package writes. Every comparison is
exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import warnings

from finito_tpu.io.fastx import reverse_complement
from finito_tpu.query import minimizer_engine as jme
from finito_tpu.query.engine import DeviceQueryEngine as JaxEngine
from finito_tpu_torch.index.index import FinimizerIndex as PortFinimizerIndex
from finito_tpu_torch.index.minimizer import MinimizerIndex
from finito_tpu_torch.query import engine as port_engine
from finito_tpu_torch.query import minimizer_engine as port_mini
from finito_tpu_torch.query.engine import DeviceQueryEngine, merge_rle
from finito_tpu_torch.query.locators import Optimistic, minimizer_policy, segment_policy
from finito_tpu_torch.utils import trace

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import _expected_merged_lines, build_index, gen_dspss

torch.set_num_threads(1)


def _reads(rng, unitigs, k):
    """Exact substrings (+1 runs), their RCs (-1 runs via the mirror),
    mutated copies (run breaks), random reads, a long padded read, and
    short, N-containing and empty reads (empty lines)."""
    genome = "".join(unitigs)
    reads = []
    for _ in range(8):
        s = int(rng.integers(0, len(genome) - 30))
        reads.append(genome[s : s + 30].encode())
    reads += [reverse_complement(r) for r in reads[:4]]
    for r in reads[:4]:
        b = bytearray(r)
        j = len(b) // 2
        b[j] = b"ACGT"[(b"ACGT".index(b[j : j + 1]) + 1) % 4]
        reads.append(bytes(b))
    for _ in range(8):
        reads.append("".join(rng.choice(list("ACGT"), int(rng.integers(k, 40)))).encode())
    reads.append(genome[: min(len(genome), 150)].encode())  # L pads to 256
    reads += [b"ACG", b"ACGNNACGTACG", b"", genome[:20].lower().encode()]
    return reads


def _port_index(jindex, prefix):
    """The port's FinimizerIndex of the JAX package's jindex, read by the
    port's loader from the files the JAX package writes at prefix."""
    jindex.serialize(str(prefix))
    return PortFinimizerIndex.load(str(prefix))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(the port's index, its engine on the CPU, reads, k, the JAX index)"""
    rng = np.random.default_rng(17)
    k = 6
    unitigs = gen_dspss(rng, 20, 10, 60, k)
    jindex = build_index(unitigs, k)
    index = _port_index(jindex, tmp_path_factory.mktemp("engine") / "idx")
    return index, DeviceQueryEngine(index, device="cpu"), _reads(rng, unitigs, k), k, jindex


def test_merged_pairs_flat_equals_jax_engine(fixture):
    _index, engine, reads, _k, jindex = fixture
    got = engine.merged_pairs_flat(reads)
    want = JaxEngine(jindex, mode="minimizer").merged_pairs_flat(reads)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    exp_lines, ekf, ekr = _expected_merged_lines(
        jindex, [r for r in reads if len(r) >= jindex.sbwt.get_k() and b"N" not in r]
    )
    assert list(zip(got[1].tolist(), got[2].tolist())) == [p for line in exp_lines for p in line]
    assert (got[3], got[4]) == (ekf, ekr)


def test_process_reads_equals_host_oracle(fixture):
    _index, engine, reads, _k, jindex = fixture
    for read, (f, r) in zip(reads, engine.process_reads(reads)):
        of = jindex.search(read)
        orr = jindex.search(reverse_complement(read))
        assert (f.local_offsets, f.n_found) == (of.local_offsets, of.n_found), read
        assert (r.local_offsets, r.n_found) == (orr.local_offsets, orr.n_found), read


def test_search_fwd_rc_and_locate_batch(fixture):
    _index, engine, reads, k, jindex = fixture
    f, _r = engine.search_fwd_rc(reads[0])
    assert f.local_offsets == jindex.search(reads[0]).local_offsets
    _, _, both = engine._encode_both_strands(reads[:3])
    uid, off = engine.locate_batch(both)
    assert uid.shape == off.shape == (both.shape[0], both.shape[1] - k + 1)
    assert uid.dtype == np.int32


@pytest.mark.parametrize("k0", [None, "1"])
def test_locate_batch_async_and_reads_arrays_equal_jax(fixture, monkeypatch, k0):
    """locate_batch_async returns device tensors whose (B, W) slice equals
    JAX's locate_batch_async and the port's locate_batch, also when a
    forced tiny capacity (FINITO_MIN_K0) makes its check re-run;
    locate_reads_arrays equals JAX's read for read (None for short and
    N-containing reads)."""
    index, _, reads, k, jindex = fixture
    engine, jengine = DeviceQueryEngine(index, device="cpu"), JaxEngine(jindex, mode="minimizer")
    _, _, both = engine._encode_both_strands(reads)
    if k0:
        monkeypatch.setenv("FINITO_MIN_K0", k0)
    uid, off, B, W = engine.locate_batch_async(both)
    assert isinstance(uid, torch.Tensor) and isinstance(off, torch.Tensor)
    juid, joff, jB, jW = jengine.locate_batch_async(both)
    assert (B, W) == (jB, jW) == (both.shape[0], both.shape[1] - k + 1)
    np.testing.assert_array_equal(uid[:B, :W].numpy(), np.asarray(juid)[:B, :W])
    np.testing.assert_array_equal(off[:B, :W].numpy(), np.asarray(joff)[:B, :W])
    lb = engine.locate_batch(both)
    np.testing.assert_array_equal(lb[0], uid[:B, :W].numpy())
    got, want = engine.locate_reads_arrays(reads), jengine.locate_reads_arrays(reads)
    assert len(got) == len(want) == len(reads)
    for g, w, read in zip(got, want, reads):
        assert (g is None) == (w is None) == (len(read) < k or b"N" in read.upper()), read
        if g is not None:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rle_overflow_falls_back_to_host_merge(fixture):
    """Runs past the RLE capacity: _end takes the full-window host merge,
    with the same streams as the RLE path."""
    _, engine, reads, _, _ = fixture
    want = engine.merged_pairs_flat(reads)
    line_lens, rest = engine.merged_pairs_flat_begin(reads)
    batch_codes, lens, uid_d, off_d, _K, _out, verify, lens_d, chunk = rest
    small = merge_rle(uid_d, off_d, lens_d, 2)
    assert int(small[4][0]) > 2
    got = engine.merged_pairs_flat_end(
        (line_lens, (batch_codes, lens, uid_d, off_d, 2, small, verify, lens_d, chunk))
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_v2_switch_constant_equals_jax(fixture):
    """The JAX engine switches to v2 at the slot-row cap's descriptor
    size; the port's rule uses the same number, and the small fixture
    runs v1 unless forced."""
    assert port_mini.V2_MIN_DESC_BYTES == jme._SLOT_ROWS_MAX_DESC_BYTES == 64 << 20
    assert fixture[1].use_v2 is False


def test_forced_v2_equals_jax_and_oracle(fixture, monkeypatch):
    """FINITO_MINIMIZER_V2=1 on both engines: the port's v2 path gives the
    JAX engine's merged_pairs_flat and the host oracle's process_reads."""
    index, _, reads, _k, jindex = fixture
    monkeypatch.setenv("FINITO_MINIMIZER_V2", "1")
    engine = DeviceQueryEngine(index, device="cpu")
    assert engine.use_v2 is True
    got = engine.merged_pairs_flat(reads)
    want = JaxEngine(jindex, mode="minimizer").merged_pairs_flat(reads)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for read, (f, r) in zip(reads, engine.process_reads(reads)):
        assert f.local_offsets == jindex.search(read).local_offsets, read
        assert r.local_offsets == jindex.search(reverse_complement(read)).local_offsets, read


def test_mindex_cache_fresh_reused_stale(fixture, tmp_path, monkeypatch):
    """A fresh cache is written after the build; a matching cache is
    loaded without a rebuild; a cache of another index warns and is
    rebuilt. Every engine answers as the one without a cache."""
    index, engine, reads, k, _ = fixture
    want = engine.merged_pairs_flat(reads)
    cache = str(tmp_path / "mindex")

    def check(e):
        for a, b in zip(e.merged_pairs_flat(reads), want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    check(DeviceQueryEngine(index, device="cpu", mindex_cache=cache))
    fresh = open(cache, "rb").read()
    built = MinimizerIndex.from_finimizer_index

    def no_rebuild(_index):
        raise AssertionError("a matching cache must not be rebuilt")

    monkeypatch.setattr(MinimizerIndex, "from_finimizer_index", staticmethod(no_rebuild))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check(DeviceQueryEngine(index, device="cpu", mindex_cache=cache))
    monkeypatch.setattr(MinimizerIndex, "from_finimizer_index", built)

    other = _port_index(build_index(gen_dspss(np.random.default_rng(5), 6, 10, 40, k), k),
                        tmp_path / "other")
    with pytest.warns(UserWarning, match="does not match"):
        DeviceQueryEngine(other, device="cpu", mindex_cache=cache)
    assert open(cache, "rb").read() != fresh
    with pytest.warns(UserWarning, match="does not match"):
        check(DeviceQueryEngine(index, device="cpu", mindex_cache=cache))
    assert open(cache, "rb").read() == fresh


def test_unported_modes_raise(fixture):
    """Every mode of the JAX engine is ported; an unknown one raises."""
    index = fixture[0]
    assert port_engine.MODES == ("minimizer", "dense", "stream", "replica")
    with pytest.raises(ValueError, match="unknown engine mode"):
        DeviceQueryEngine(index, mode="oracle", device="cpu")


NEW_MODES = ["dense", "stream", "replica"]


@pytest.fixture(scope="module")
def jax_merged(fixture):
    """mode -> the JAX engine's merged_pairs_flat of the fixture's reads"""
    _, _, reads, _, jindex = fixture
    return {mode: JaxEngine(jindex, mode=mode).merged_pairs_flat(reads)
            for mode in ("minimizer", *NEW_MODES)}


def _assert_same_streams(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", NEW_MODES)
def test_new_modes_equal_jax_engine_and_oracle(fixture, jax_merged, mode):
    """dense, stream and replica: merged_pairs_flat equal to the JAX
    engine's, process_reads equal to the host oracle."""
    index, _, reads, _, jindex = fixture
    engine = DeviceQueryEngine(index, mode=mode, device="cpu")
    assert engine.use_v2 is None
    _assert_same_streams(engine.merged_pairs_flat(reads), jax_merged[mode])
    for read, (f, r) in zip(reads, engine.process_reads(reads)):
        of = jindex.search(read)
        orr = jindex.search(reverse_complement(read))
        assert (f.local_offsets, f.n_found) == (of.local_offsets, of.n_found), (mode, read)
        assert (r.local_offsets, r.n_found) == (orr.local_offsets, orr.n_found), (mode, read)
    if mode == "dense":  # no capacity to check: no deferred verify
        _, _, both = engine._encode_both_strands(reads)
        assert engine._locate_batch_deferred(both)[4] is None


@pytest.mark.parametrize("mode", NEW_MODES)
def test_new_modes_default_to_cuda(fixture, mode, monkeypatch):
    """The default device is the card: without one the engine raises
    before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from finito_tpu_torch.ops import rank24 as pr24

    def no_build(*_args):
        raise AssertionError("tables built before the device check")

    monkeypatch.setattr(pr24, "build_rank24_tables", no_build)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceQueryEngine(fixture[0], mode=mode)


@pytest.mark.parametrize("mode", ["stream", "replica"])
def test_new_modes_wide_rank_form(fixture, jax_merged, monkeypatch, mode):
    """RANK24_MAX_NODES = 1 forces the wide rank tables (and plain edges
    in replica mode): the same streams as the JAX engine's."""
    from finito_tpu_torch.ops import rank24 as pr24
    from finito_tpu_torch.query import replica as prep

    index, _, reads, _, _ = fixture
    built = []

    def spy(bit_rows):
        built.append(orig(bit_rows))
        return built[-1]

    orig = pr24.build_rank24_tables
    monkeypatch.setattr(pr24, "RANK24_MAX_NODES", 1)
    monkeypatch.setattr(pr24, "build_rank24_tables", spy)
    monkeypatch.setattr(prep, "build_rank24_tables", spy)
    engine = DeviceQueryEngine(index, mode=mode, device="cpu")
    assert built and all(t.ndim == 2 for t in built)
    _assert_same_streams(engine.merged_pairs_flat(reads), jax_merged[mode])


FORCED = ["v1", "v2", "stream", "replica", "mesh"]


@pytest.mark.parametrize("key", FORCED)
def test_forced_capacity_rerun(fixture, jax_merged, monkeypatch, tmp_path, key):
    """FINITO_MIN_K0=1 makes the first capacity of every dispatch 1, memo
    or not: in each of two calls the deferred verify re-runs
    (capacity_reruns, more than one verify read a call) and the memo
    keeps the grown capacities; the output equals the unforced run's
    and the JAX engine's. The minimizer locate in v1 and v2 (whose
    K_heads starts at 4, below the batch's head count) on the index
    re-addressed to 2^8 slots, whose crowded slots send windows down the
    slow path (m = k here, so no minimizer repeats), stream, replica,
    and v1 over a (1, 2) CPU mesh."""
    index, _, reads, k, _ = fixture
    cache = None
    if key in ("v1", "v2"):
        monkeypatch.setenv("FINITO_MINIMIZER_V2", str(int(key == "v2")))
        cache = str(tmp_path / "mindex")
        MinimizerIndex.from_finimizer_index(index).rebucket(8).serialize(cache)
    engine = DeviceQueryEngine(index, mode=key if key in ("stream", "replica") else "minimizer",
                               device="cpu", mesh=(1, 2) if key == "mesh" else None,
                               mindex_cache=cache)
    want = engine.merged_pairs_flat(reads)
    _assert_same_streams(want, jax_merged[engine.mode])
    trace.reset()
    monkeypatch.setenv("FINITO_MIN_K0", "1")
    got = [engine.merged_pairs_flat(reads) for _ in range(2)]
    monkeypatch.delenv("FINITO_MIN_K0")
    assert trace.counts["capacity_reruns"] == trace.counts["chunks"] == 2
    assert trace.counts["host_reads.verify"] > 2
    ((B, L), caps), = engine.locator.sizes.items()
    assert 4 <= caps[0] <= B * L
    if key == "v2":
        assert 4 < caps[1] <= B * (L - k + 1)
    for g in got:
        _assert_same_streams(g, want)


@pytest.mark.parametrize("need", ["under", "at", "over"])
@pytest.mark.parametrize("policy", ["v1", "v2", "stream", "replica"])
def test_capacity_loop_against_its_ceiling(monkeypatch, policy, need):
    """query.locators' capacity loop over a fake locate whose counters need n
    slow windows (and 20,000 heads in v2): under the ceiling it grows
    (x4; heads doubled or to the count) until they fit, at the ceiling
    it stops there, over it verify raises. The run that stood answers,
    and the memo starts the shape's next dispatch there, with no
    re-run."""
    monkeypatch.delenv("FINITO_MIN_K0", raising=False)
    B, L, k = 64, 1030, 31
    BW = B * (L - k + 1)
    if policy in ("v1", "v2"):
        first, grow = minimizer_policy(B, L, k, policy == "v2")
        ceiling = BW
    else:
        first, grow = segment_policy(B, L, k, stream=policy == "stream")
        ceiling = BW if policy == "stream" else B * L
    n = {"under": 3 * first[0], "at": ceiling, "over": ceiling + 1}[need]
    runs = []

    def run(caps):
        runs.append(caps)
        counters = torch.tensor(n, dtype=torch.int32)
        if policy == "v2":
            counters = (counters, torch.tensor(20_000, dtype=torch.int32))
        return torch.tensor([caps[0]]), torch.tensor([len(runs)]), counters

    sizes = {}
    check = Optimistic(run, first, grow, sizes=sizes, key=(B, L))
    if need == "over":
        with pytest.raises(AssertionError, match="overflow at K =="):
            check.verify()
        assert runs[-1][0] == ceiling
        return
    uid, off = check.verify()
    K = check.caps[0]
    assert n <= K <= ceiling and K // 4 < n and runs[-1] == check.caps == sizes[(B, L)]
    assert (int(uid), int(off)) == (K, len(runs)) and check.counters[0] == n
    assert K == (ceiling if need == "at" else 4 * first[0])
    if policy == "v2":
        assert check.caps[1] == max(2 * first[1], 20_000)
    n_runs = len(runs)
    again = Optimistic(run, first, grow, sizes=sizes, key=(B, L))
    assert again.verify() is None and again.caps == check.caps and len(runs) == n_runs + 1


@pytest.mark.parametrize("mode", ["stream", "replica"])
def test_new_modes_chunked_scan(fixture, jax_merged, mode):
    """chunk=9 splits every read into k-1-overlapped chunks: the same
    streams."""
    index, _, reads, _, _ = fixture
    engine = DeviceQueryEngine(index, mode=mode, device="cpu", chunk=9)
    _assert_same_streams(engine.merged_pairs_flat(reads), jax_merged[mode])


def test_cuda_without_card_raises(fixture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        DeviceQueryEngine(fixture[0], device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("v2", ["0", "1"])
def test_engine_on_card_equals_cpu(fixture, monkeypatch, v2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    index, engine, reads, _, _ = fixture
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    got = DeviceQueryEngine(index, device="cuda").merged_pairs_flat(reads)
    for a, b in zip(got, engine.merged_pairs_flat(reads)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", NEW_MODES)
def test_new_modes_on_card_equal_cpu(fixture, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    index, _, reads, _, _ = fixture
    got = DeviceQueryEngine(index, mode=mode, device="cuda").merged_pairs_flat(reads)
    want = DeviceQueryEngine(index, mode=mode, device="cpu").merged_pairs_flat(reads)
    _assert_same_streams(got, want)

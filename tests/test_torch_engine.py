"""The port's DeviceQueryEngine (finito_tpu_torch/query/engine.py) on the
CPU against the JAX engine's merged_pairs_flat and the host oracle
FinimizerIndex.search, in both locate forms; the v1/v2 rule, the
deferred-verify re-run, the RLE overflow fallback and the minimizer
index cache. Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import warnings

from finito_tpu.index.minimizer import MinimizerIndex
from finito_tpu.io.fastx import reverse_complement
from finito_tpu.query import minimizer_engine as jme
from finito_tpu.query.engine import DeviceQueryEngine as JaxEngine
from finito_tpu_torch.query import engine as port_engine
from finito_tpu_torch.query.engine import DeviceQueryEngine, merge_rle

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


@pytest.fixture(scope="module")
def fixture():
    rng = np.random.default_rng(17)
    k = 6
    unitigs = gen_dspss(rng, 20, 10, 60, k)
    index = build_index(unitigs, k)
    return index, DeviceQueryEngine(index, device="cpu"), _reads(rng, unitigs, k), k


def test_merged_pairs_flat_equals_jax_engine(fixture):
    index, engine, reads, _k = fixture
    got = engine.merged_pairs_flat(reads)
    want = JaxEngine(index, mode="minimizer").merged_pairs_flat(reads)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    exp_lines, ekf, ekr = _expected_merged_lines(
        index, [r for r in reads if len(r) >= index.sbwt.get_k() and b"N" not in r]
    )
    assert list(zip(got[1].tolist(), got[2].tolist())) == [p for line in exp_lines for p in line]
    assert (got[3], got[4]) == (ekf, ekr)


def test_process_reads_equals_host_oracle(fixture):
    index, engine, reads, _k = fixture
    for read, (f, r) in zip(reads, engine.process_reads(reads)):
        of = index.search(read)
        orr = index.search(reverse_complement(read))
        assert (f.local_offsets, f.n_found) == (of.local_offsets, of.n_found), read
        assert (r.local_offsets, r.n_found) == (orr.local_offsets, orr.n_found), read


def test_search_fwd_rc_and_locate_batch(fixture):
    index, engine, reads, k = fixture
    f, _r = engine.search_fwd_rc(reads[0])
    assert f.local_offsets == index.search(reads[0]).local_offsets
    _, _, both = engine._encode_both_strands(reads[:3])
    uid, off = engine.locate_batch(both)
    assert uid.shape == off.shape == (both.shape[0], both.shape[1] - k + 1)
    assert uid.dtype == np.int32


def test_deferred_verify_overflow_rerun(fixture, monkeypatch):
    """A forced tiny slow-path capacity (FINITO_MIN_K0) must be caught by
    the deferred verify in _end and re-run to the exact answer."""
    index, _, _, k = fixture
    engine = DeviceQueryEngine(index, device="cpu")
    rng = np.random.default_rng(31)
    reads = ["".join(rng.choice(list("ACGT"), 30)).encode() for _ in range(12)]
    monkeypatch.setenv("FINITO_MIN_K0", "1")
    h = engine.merged_pairs_flat_begin(reads)
    forced = engine.merged_pairs_flat_end(h)
    monkeypatch.delenv("FINITO_MIN_K0")
    want = JaxEngine(index, mode="minimizer").merged_pairs_flat(reads)
    for a, b in zip(forced, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rle_overflow_falls_back_to_host_merge(fixture):
    """Runs past the RLE capacity: _end takes the full-window host merge,
    with the same streams as the RLE path."""
    _, engine, reads, _ = fixture
    want = engine.merged_pairs_flat(reads)
    line_lens, rest = engine.merged_pairs_flat_begin(reads)
    batch_codes, lens, uid_d, off_d, _K, _out, verify, lens_d = rest
    small = merge_rle(uid_d, off_d, lens_d, 2)
    assert int(small[4][0]) > 2
    got = engine.merged_pairs_flat_end(
        (line_lens, (batch_codes, lens, uid_d, off_d, 2, small, verify, lens_d))
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_v2_switch_constant_equals_jax(fixture):
    """The JAX engine switches to v2 at the slot-row cap's descriptor
    size; the port's rule uses the same number, and the small fixture
    runs v1 unless forced."""
    assert port_engine.V2_MIN_DESC_BYTES == jme._SLOT_ROWS_MAX_DESC_BYTES == 64 << 20
    assert fixture[1].use_v2 is False


def test_forced_v2_equals_jax_and_oracle(fixture, monkeypatch):
    """FINITO_MINIMIZER_V2=1 on both engines: the port's v2 path gives the
    JAX engine's merged_pairs_flat and the host oracle's process_reads."""
    index, _, reads, _k = fixture
    monkeypatch.setenv("FINITO_MINIMIZER_V2", "1")
    engine = DeviceQueryEngine(index, device="cpu")
    assert engine.use_v2 is True
    got = engine.merged_pairs_flat(reads)
    want = JaxEngine(index, mode="minimizer").merged_pairs_flat(reads)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for read, (f, r) in zip(reads, engine.process_reads(reads)):
        assert f.local_offsets == index.search(read).local_offsets, read
        assert r.local_offsets == index.search(reverse_complement(read)).local_offsets, read


def test_forced_v2_head_overflow_rerun(fixture, monkeypatch):
    """FINITO_MIN_K0 under v2 sets K_slow = 1 and K_heads = 4, below the
    batch's head count: the deferred verify grows both and re-runs to
    the exact answer, and the memo keeps the grown (K, KH) per (B, W)."""
    index, _, reads, _ = fixture
    monkeypatch.setenv("FINITO_MINIMIZER_V2", "1")
    engine = DeviceQueryEngine(index, device="cpu")
    monkeypatch.setenv("FINITO_MIN_K0", "1")
    h = engine.merged_pairs_flat_begin(reads)
    rest = h[1]
    assert rest[6]() is not None  # verify re-ran: the first dispatch overflowed
    forced = engine.merged_pairs_flat_end(engine.merged_pairs_flat_begin(reads))
    (B, W), (K, KH) = next(iter(engine._sizes.items()))
    assert KH > 4 and B * W >= KH
    monkeypatch.delenv("FINITO_MIN_K0")
    want = JaxEngine(index, mode="minimizer").merged_pairs_flat(reads)
    for a, b in zip(forced, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mindex_cache_fresh_reused_stale(fixture, tmp_path, monkeypatch):
    """A fresh cache is written after the build; a matching cache is
    loaded without a rebuild; a cache of another index warns and is
    rebuilt. Every engine answers as the one without a cache."""
    index, engine, reads, k = fixture
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

    other = build_index(gen_dspss(np.random.default_rng(5), 6, 10, 40, k), k)
    with pytest.warns(UserWarning, match="does not match"):
        DeviceQueryEngine(other, device="cpu", mindex_cache=cache)
    assert open(cache, "rb").read() != fresh
    with pytest.warns(UserWarning, match="does not match"):
        check(DeviceQueryEngine(index, device="cpu", mindex_cache=cache))
    assert open(cache, "rb").read() == fresh


def test_unported_modes_raise(fixture):
    index = fixture[0]
    with pytest.raises(NotImplementedError):
        DeviceQueryEngine(index, mode="dense", device="cpu")


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
    index, engine, reads, _ = fixture
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    got = DeviceQueryEngine(index, device="cuda").merged_pairs_flat(reads)
    for a, b in zip(got, engine.merged_pairs_flat(reads)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

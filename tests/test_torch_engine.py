"""The port's DeviceQueryEngine (finito_tpu_torch/query/engine.py) on the
CPU against the JAX engine's merged_pairs_flat and the host oracle
FinimizerIndex.search; the deferred-verify re-run and the RLE overflow
fallback. Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from finito_tpu.io.fastx import reverse_complement
from finito_tpu.query.engine import DeviceQueryEngine as JaxEngine
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
def test_engine_on_card_equals_cpu(fixture):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    index, engine, reads, _ = fixture
    got = DeviceQueryEngine(index, device="cuda").merged_pairs_flat(reads)
    for a, b in zip(got, engine.merged_pairs_flat(reads)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

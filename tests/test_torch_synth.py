"""The port's repeat-dense workload (finito_tpu_torch/utils/synth.py) on
the CPU against the JAX package's copy: the same genome array for the
same seed, the same packed windows, the same oracle answers with and
without the native sort. Then the port twins of
tests/test_repeat_workload.py: the workload is repeat-dense, the oracle
equals FinimizerIndex.search, every engine's locate equals the oracle,
the v2 locate takes its slow path, and the canonical dBG holds each
canonical k-mer once. Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import REPEAT_PARAMS
from finito_tpu import native as jax_native
from finito_tpu.utils import synth as jsynth
from finito_tpu_torch import native as port_native
from finito_tpu_torch.dbg import build_unitigs
from finito_tpu_torch.index.builder import FinimizerIndexBuilder
from finito_tpu_torch.io.seqdb import SeqDB, decode_seq
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array
from finito_tpu_torch.utils import synth as psynth

torch.set_num_threads(1)

K = 21


def build_repeat_index(length=120_000, k=K, seed=5):
    """genome -> the port's non-canonical dBG unitigs -> the port's
    FinimizerIndex, as tests/test_repeat_workload.py builds it with the
    JAX package. Returns (genome, index, rng after the genome)."""
    rng = np.random.default_rng(seed)
    genome = psynth.gen_repeat_genome(rng, length)
    seqs = [decode_seq(u) for u in build_unitigs([genome], k, canonical=False)]
    sbwt, node_keys = build_plain_matrix_sbwt(seqs, k, return_keys=True)
    index = FinimizerIndexBuilder(sbwt, lcs_array(sbwt), SeqDB.from_sequences(seqs),
                                  node_keys=node_keys).get_index()
    return genome, index, rng


def sample_reads(genome, rng, B=64, L=96, mutate=0.01):
    """Reads from the genome with point mutations (tests/test_repeat_workload.py)."""
    starts = rng.integers(0, genome.size - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(mutate * reads.size)
    mi = rng.integers(0, B, size=n_mut)
    mj = rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
    return reads


@pytest.fixture(scope="module")
def repeat_index():
    return build_repeat_index()


def _oracle(index, reads, k=K):
    return psynth.kmer_location_oracle(np.asarray(index.unitigs.concat),
                                       np.asarray(index.unitigs.ends), reads, k)


@pytest.mark.parametrize("params", ["default", "REPEAT_PARAMS"])
@pytest.mark.parametrize("seed,length", [(0, 60_000), (7, 130_000), (123, 200_000)])
def test_gen_repeat_genome_equals_jax(seed, length, params):
    kw = {} if params == "default" else REPEAT_PARAMS
    want = jsynth.gen_repeat_genome(np.random.default_rng(seed), length, **kw)
    rng = np.random.default_rng(seed)
    got = psynth.gen_repeat_genome(rng, length, **kw)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    # the rng advanced as far: the next draw agrees too
    jrng = np.random.default_rng(seed)
    jsynth.gen_repeat_genome(jrng, length, **kw)
    assert rng.integers(1 << 62) == jrng.integers(1 << 62)


@pytest.mark.parametrize("k", [1, 21, 32, 500])
def test_pack_all_windows_equals_jax(k):
    codes = np.random.default_rng(k).integers(0, 4, 400).astype(np.uint8)
    want = jsynth._pack_all_windows(codes, k)
    got = psynth._pack_all_windows(codes, k)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("native", ["library", "argsort_u64 None"])
def test_oracle_equals_jax(repeat_index, monkeypatch, native):
    """The oracle on reads with mutations and invalid codes, equal to
    JAX's; the native sort forced off in both packages gives the same."""
    genome, index, _ = repeat_index
    if native != "library":
        monkeypatch.setattr(port_native, "argsort_u64", lambda vals: None)
        monkeypatch.setattr(jax_native, "argsort_u64", lambda vals: None)
    reads = sample_reads(genome, np.random.default_rng(3), B=24, L=70)
    reads[[2, 9, 17], [0, 33, 69]] = 255
    concat, ends = np.asarray(index.unitigs.concat), np.asarray(index.unitigs.ends)
    want = jsynth.kmer_location_oracle(concat, ends, reads, K)
    got = psynth.kmer_location_oracle(concat, ends, reads, K)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert (got[0] >= 0).mean() > 0.3 and (got[0] < 0).any()


def test_oracle_raises_on_duplicate_windows():
    codes = np.random.default_rng(1).integers(0, 4, 60).astype(np.uint8)
    concat = np.concatenate([codes, codes[10:40]])  # unitig 1 repeats unitig 0's windows
    ends = np.array([60, 90], np.int64)
    reads = codes[None, :30].copy()
    with pytest.raises(ValueError, match="not k-mer-disjoint"):
        psynth.kmer_location_oracle(concat, ends, reads, K)


def test_repeat_genome_is_repeat_dense():
    keys = psynth._pack_all_windows(psynth.gen_repeat_genome(np.random.default_rng(0), 100_000), K)
    # uniform random text of this size has ~0 duplicate 21-mers
    assert keys.size - np.unique(keys).size > 0.05 * keys.size


def test_oracle_agrees_with_host_search(repeat_index):
    genome, index, rng = repeat_index
    reads = sample_reads(genome, np.random.default_rng(8), B=8, L=64)
    uid, off = _oracle(index, reads)
    for b in range(reads.shape[0]):
        want = index.search(decode_seq(reads[b])).local_offsets
        assert list(zip(uid[b].tolist(), off[b].tolist())) == want, b


@pytest.mark.parametrize("mode", ["dense", "stream", "minimizer", "replica"])
def test_engines_on_repeat_workload(repeat_index, mode):
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    genome, index, _ = repeat_index
    reads = sample_reads(genome, np.random.default_rng(9), B=48, L=96)
    uid_e, off_e = _oracle(index, reads)
    uid, off = DeviceQueryEngine(index, mode=mode, device="cpu").locate_batch(reads)
    assert np.array_equal(uid, uid_e) and np.array_equal(off, off_e), mode


def test_minimizer_v2_slow_path_taken(repeat_index):
    from finito_tpu_torch.index.minimizer import MinimizerIndex
    from finito_tpu_torch.query.minimizer_engine import (
        DeviceMinimizerIndex,
        make_minimizer_locate_v2,
    )

    genome, index, _ = repeat_index
    reads = sample_reads(genome, np.random.default_rng(10), B=64, L=96)
    dmi = DeviceMinimizerIndex(MinimizerIndex.from_finimizer_index(index), device="cpu")
    BW = reads.shape[0] * (reads.shape[1] - K + 1)
    uid, off, n_slow, _ = make_minimizer_locate_v2(dmi, BW, BW)(torch.from_numpy(reads))
    assert int(n_slow) > 0, "the repeat workload produced no slow-path run"
    uid_e, off_e = _oracle(index, reads)
    assert np.array_equal(uid.numpy(), uid_e) and np.array_equal(off.numpy(), off_e)


def test_dbg_dedup_on_repeat_dense_input():
    """The canonical dBG of a repeat-dense genome holds each canonical
    k-mer of the input exactly once."""
    from finito_tpu_torch.sbwt import keys as kw

    genome = psynth.gen_repeat_genome(np.random.default_rng(11), 300_000)
    unitigs = build_unitigs([genome], K, canonical=True)

    def canonical(codes):
        fwd = kw.pack_windows(codes, K)[0]
        rc = kw.pack_windows((3 - codes)[::-1].copy(), K)[0][::-1]
        return np.minimum(fwd, rc)

    cat = np.sort(np.concatenate([canonical(u) for u in unitigs]), kind="stable")
    assert not np.any(cat[1:] == cat[:-1]), "duplicate canonical k-mer in the DSPSS"
    assert np.array_equal(np.unique(cat), np.unique(canonical(genome)))

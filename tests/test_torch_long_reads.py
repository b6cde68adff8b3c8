"""search-fmin's chunk rule on long reads (cli._run_queries_streaming with
a device engine, on the CPU): chunks close at CHUNK reads or before the
read that would take their padded dispatch past SLOT_BUDGET slots, a read
over the budget goes alone, and the output stays byte-equal to the CLI's
host path and to the benchmark's plain reference, for the v1 and v2
locates, a forced capacity re-run included; the four counters of the rule
(window_slots, windows, chunks_by_budget, host_merge_windows) against the
test's own arithmetic; accurate long reads, whose merge_rle run capacity
comes from their windows, merged on the device and not by the host."""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch

from benchmark import datagen
from benchmark.reference import Reference, line
from finito_tpu_torch import cli
from finito_tpu_torch.index.builder import FinimizerIndexBuilder
from finito_tpu_torch.io.seqdb import SeqDB
from finito_tpu_torch.query import engine as engine_mod
from finito_tpu_torch.query.engine import DeviceQueryEngine
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array
from finito_tpu_torch.utils import trace
from finito_tpu_torch.utils.synth import gen_dspss

K = 31
SEED = 2**31 + 1717
BUDGET = 1 << 16  # 4-8 reads of 2-6 kbp a chunk; a read past 32,768 bases alone
LONG = {"pool": 24, "length": {"lognormal_median": 4000, "sigma": 0.3, "min": 2000, "max": 6000},
        "rc_frac": 0.5, "sub_rate": 0.002, "n_frac": 0.1}
# 512 reads of 1 kbp at 2.5% substitutions: ~23 runs a read, where one chunk's
# merge_rle holds 16 a read (8,192)
NOISY = {"pool": 512, "length": {"fixed": 1000}, "rc_frac": 0.5, "sub_rate": 0.025, "n_frac": 0.0}
# 256 reads of ~4 kbp at 0.5% substitutions: ~40 runs a read, past 16 a read
# but under one per 64 windows
ACCURATE = {"pool": 256, "length": {"lognormal_median": 4000, "sigma": 0.1, "min": 3500, "max": 4500},
            "rc_frac": 0.5, "sub_rate": 0.005, "n_frac": 0.0}
SHORT = {"pool": 4096, "length": {"fixed": 150}, "rc_frac": 0.5, "sub_rate": 0.005, "n_frac": 0.01}


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _ascii(codes, ends) -> list:
    starts = np.concatenate([[0], ends[:-1]])
    return [datagen._ASCII[codes[a:b]].tobytes() for a, b in zip(starts.tolist(), ends.tolist())]


@pytest.fixture(scope="module")
def cell():
    """A k=31 index of a 100 kbp DSPSS, its reference, and the long-read
    set: 24 reads of 2-6 kbp (some with an N), a 20 bp read and a 33 kbp
    read past the budget on its own in the middle."""
    genome, unitigs, cuts = gen_dspss(np.random.default_rng(SEED), 100_000, K, return_cuts=True)
    sbwt, keys = build_plain_matrix_sbwt(unitigs, K, return_keys=True)
    index = FinimizerIndexBuilder(sbwt, lcs_array(sbwt), SeqDB.from_sequences(unitigs),
                                  node_keys=keys).get_index()
    reads = _ascii(*datagen.gen_reads(np.random.default_rng([SEED, 1]), genome, LONG))
    huge = datagen._ASCII[genome[5000:38000]].tobytes()
    reads = reads[:9] + [reads[9][:20], huge] + reads[9:]
    return index, Reference(genome, cuts, K, "cpu"), genome, reads


def _engine(index, v2: str, device: str = "cpu"):
    old = os.environ.get("FINITO_MINIMIZER_V2")
    os.environ["FINITO_MINIMIZER_V2"] = v2
    try:
        return DeviceQueryEngine(index, mode="minimizer", device=device)
    finally:
        if old is None:
            os.environ.pop("FINITO_MINIMIZER_V2", None)
        else:
            os.environ["FINITO_MINIMIZER_V2"] = old


def _serve(index, reads, tmp, engine=None):
    """The CLI's serving loop over reads: (output bytes, stats text,
    counts, reads per chunk, dispatched (B, L) shapes)."""
    per_chunk, shapes = [], []
    if engine is not None:
        begin, dispatch = engine.merged_pairs_flat_begin, engine.locator.dispatch

        def merged_pairs_flat_begin(chunk):
            per_chunk.append(len(chunk))
            return begin(chunk)

        def counted_dispatch(codes):
            shapes.append(tuple(codes.shape))
            return dispatch(codes)

        engine.merged_pairs_flat_begin = merged_pairs_flat_begin
        engine.locator.dispatch = counted_dispatch
    out = io.TextIOWrapper(io.BytesIO(), encoding="ascii")
    stats = os.path.join(tmp, "q.stats")
    if os.path.exists(stats):
        os.remove(stats)
    trace.reset()
    cli._run_queries_streaming(iter([(b"r", r) for r in reads]), out, index, stats, engine)
    out.flush()
    with open(stats) as f:
        return out.buffer.getvalue(), f.read(), dict(trace.counts), per_chunk, shapes


def _reference(ref: Reference, reads) -> tuple:
    """The reference's output bytes and stats text for reads."""
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    codes = [lut[np.frombuffer(r, np.uint8)] for r in reads]
    W, found, _, u, p, first = ref.answer(np.concatenate(codes), np.cumsum([c.size for c in codes]))
    u, p = u.numpy(), p.numpy()
    blob = b"".join(line(u[a : a + w], p[a : a + w]) if w else b"\n"
                    for a, w in zip(first.tolist(), W.tolist()))
    return blob, f"{K},{int(found.sum())},{int(W.sum())}"


def _kept(read: bytes) -> bool:
    return len(read) >= K and set(read) <= set(b"ACGT")


def _expected(reads, budget: int, chunk: int = 4096):
    """The rule by the test's own arithmetic: (reads per chunk, chunks the
    budget closed, dispatched (B, L) shapes, window slots, windows)."""
    def slots(rs):
        return _pow2(2 * len(rs)) * max(128, -(-max(map(len, rs)) // 128) * 128)

    chunks, cur, by_budget = [], [], 0
    for r in reads:
        if cur and slots(cur + [r]) > budget:
            chunks.append(cur)
            cur, by_budget = [], by_budget + 1
        cur.append(r)
        if len(cur) == chunk:
            chunks.append(cur)
            cur = []
    if cur:
        chunks.append(cur)
    shapes, n_slots, n_windows = [], 0, 0
    for c in chunks:
        kept = [r for r in c if _kept(r)]
        if kept:
            B, L = _pow2(2 * len(kept)), max(128, -(-max(map(len, kept)) // 128) * 128)
            shapes.append((B, L))
            n_slots += B * (L - K + 1)
            n_windows += sum(2 * (len(r) - K + 1) for r in kept)
    return [len(c) for c in chunks], by_budget, shapes, n_slots, n_windows


@pytest.fixture(scope="module")
def host_path(cell, tmp_path_factory):
    index, _, _, reads = cell
    return _serve(index, reads, str(tmp_path_factory.mktemp("host")))


@pytest.mark.parametrize("v2", ["0", "1"])
def test_long_reads_equal_host_path_and_reference(cell, host_path, tmp_path, monkeypatch, v2):
    index, ref, _, reads = cell
    monkeypatch.setattr(cli, "SLOT_BUDGET", BUDGET)
    out, stats, counts, per_chunk, _ = _serve(index, reads, str(tmp_path), _engine(index, v2))
    assert out.count(b"\n") == len(reads) and len(per_chunk) > 3
    assert (out, stats) == host_path[:2] == _reference(ref, reads)
    assert counts["chunks_by_budget"] >= 3


def test_slot_cap_closes_chunks_and_serves_a_huge_read_alone(cell, tmp_path, monkeypatch):
    index, _, _, reads = cell
    monkeypatch.setattr(cli, "SLOT_BUDGET", BUDGET)
    _, _, counts, per_chunk, shapes = _serve(index, reads, str(tmp_path), _engine(index, "1"))
    want_chunks, by_budget, want_shapes, _, _ = _expected(reads, BUDGET)
    assert per_chunk == want_chunks and shapes == want_shapes
    assert counts["chunks_by_budget"] == by_budget == len(per_chunk) - 1
    assert all(B * L <= BUDGET for B, L in shapes if B > 2)
    # the 33 kbp read, 2 x 33,024 slots, is a chunk of its own
    at = per_chunk.index(1)
    assert sum(per_chunk[:at]) == 10 and (2, 33024) in shapes


@pytest.mark.parametrize("v2", ["0", "1"])
def test_forced_capacity_rerun_is_exact(cell, tmp_path, monkeypatch, v2):
    index, ref, _, reads = cell
    monkeypatch.setattr(cli, "SLOT_BUDGET", BUDGET)
    engine = _engine(index, v2)
    monkeypatch.setenv("FINITO_MIN_K0", "1")
    out, stats, counts, per_chunk, shapes = _serve(index, reads, str(tmp_path), engine)
    assert (out, stats) == _reference(ref, reads)
    assert counts["capacity_reruns"] == len(shapes) == len(per_chunk)


def test_counters_equal_the_tests_arithmetic(cell, tmp_path, monkeypatch):
    index, _, _, reads = cell
    monkeypatch.setattr(cli, "SLOT_BUDGET", BUDGET)
    _, _, counts, _, _ = _serve(index, reads, str(tmp_path), _engine(index, "1"))
    _, by_budget, _, n_slots, n_windows = _expected(reads, BUDGET)
    assert counts["window_slots"] == n_slots and counts["windows"] == n_windows
    assert counts["chunks_by_budget"] == by_budget
    # a few dozen runs a chunk: merge_rle holds them all
    assert "host_merge_windows" not in counts and "host_merges" not in counts


def test_many_runs_take_the_host_merge_counted_by_windows(cell, tmp_path):
    """512 reads of 1 kbp at 2.5% substitutions in one chunk: more runs
    than merge_rle holds, so the host merge serves every window."""
    index, ref, genome, _ = cell
    reads = _ascii(*datagen.gen_reads(np.random.default_rng([SEED, 2]), genome, NOISY))
    out, stats, counts, per_chunk, shapes = _serve(index, reads, str(tmp_path), _engine(index, "0"))
    assert (out, stats) == _reference(ref, reads)
    _, by_budget, want_shapes, n_slots, n_windows = _expected(reads, cli.SLOT_BUDGET)
    assert per_chunk == [512] and shapes == want_shapes == [(1024, 1024)] and by_budget == 0
    assert counts["host_merges"] == 1
    assert counts["host_merge_windows"] == counts["windows"] == n_windows == 2 * 512 * 970
    assert counts["window_slots"] == n_slots == 1024 * 994


@pytest.fixture(scope="module")
def accurate(cell, tmp_path_factory):
    """The accurate long reads, and their output and stats text by the
    full-window host merge, which the run capacity of 16 a read sends
    them to, equal to the reference's."""
    index, ref, genome, _ = cell
    reads = _ascii(*datagen.gen_reads(np.random.default_rng([SEED, 4]), genome, ACCURATE))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "rle_capacity", lambda rows, Wp, windows: max(4096, 16 * rows))
        out, stats, counts, _, _ = _serve(index, reads, str(tmp_path_factory.mktemp("accurate")),
                                          _engine(index, "0"))
    assert counts["host_merges"] == 1 and (out, stats) == _reference(ref, reads)
    return reads, (out, stats)


@pytest.mark.parametrize("device,v2", [
    ("cpu", "0"), ("cpu", "1"),
    pytest.param("cuda", "0", marks=pytest.mark.cuda),
    pytest.param("cuda", "1", marks=pytest.mark.cuda),
])
def test_accurate_long_reads_merge_on_the_device(cell, accurate, tmp_path, device, v2):
    """256 reads of ~4 kbp at 0.5% substitutions in one chunk under the
    default budget: more runs than 16 a read, so the run capacity comes
    from the windows, and merge_rle serves every window without the host
    merge, byte-equal to the host merge and to the reference."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    reads, host = accurate
    out, stats, counts, per_chunk, shapes = _serve(cell[0], reads, str(tmp_path),
                                                   _engine(cell[0], v2, device))
    assert (out, stats) == host
    rows = shapes[0][0] // 2
    assert per_chunk == [256] and rows == 256
    assert "host_merges" not in counts and "host_merge_windows" not in counts
    assert counts["rle_window_sized"] == len(per_chunk)
    # the old rule's capacity, 16 a read, would have overflowed
    assert counts["runs"] > 16 * rows


def test_short_reads_keep_one_full_dispatch(cell, tmp_path):
    """4,096 reads of 150 bp under the default budget: one chunk, one
    (8192, 256) dispatch, nothing closed by the budget."""
    index, ref, genome, _ = cell
    assert cli.SLOT_BUDGET > 8192 * 256
    reads = _ascii(*datagen.gen_reads(np.random.default_rng([SEED, 3]), genome, SHORT))
    out, stats, counts, per_chunk, shapes = _serve(index, reads, str(tmp_path), _engine(index, "0"))
    assert per_chunk == [4096] and shapes == [(8192, 256)] and "chunks_by_budget" not in counts
    kept = sum(map(_kept, reads))
    assert 4000 < kept < 4096
    assert counts["windows"] == 2 * 120 * kept and counts["window_slots"] == 8192 * 226
    assert "rle_window_sized" not in counts and "host_merges" not in counts
    assert (out, stats) == _reference(ref, reads)


@pytest.mark.parametrize("longest,most", [(150, 4096), (6000, 4), (4096, 8), (33000, 1),
                                          (16384, 512), (25000, 256)])
def test_chunk_reads_at_the_default_budget_and_a_small_one(monkeypatch, longest, most):
    """_chunk_reads: the most reads a chunk with that longest read holds,
    at the budget in force (2^24) for reads of 150 bp, 16,384 bp and
    25,000 bp, and at 2^16 for the long-read set's."""
    if longest in (6000, 4096, 33000):
        monkeypatch.setattr(cli, "SLOT_BUDGET", BUDGET)
    assert cli._chunk_reads(longest) == most

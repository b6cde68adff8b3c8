"""The harness on the CPU at a tiny size: cells made only of data files,
the reference against the port's served output, the control, and each
fault the cells can have, with the timed path broken underneath."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_tiny import ROOT, make_bench  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import datagen, harness  # noqa: E402
from benchmark.reference import Reference, unitig_ids  # noqa: E402

SEED = 2**31 + 777  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    return make_bench(root), os.path.join(root, "benchmark")


def run(bench, cell, seed=SEED, seconds=0.2, trace=False, **kw):
    path, bdir = bench
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", bench_json=path,
                            bench_dir=bdir, **kw)


@pytest.mark.parametrize("cell", ["tiny_minimizer.reads", "tiny_stream.reads"])
def test_new_cell_from_data_files_runs_correct(bench, cell):
    result, checks = run(bench, cell)
    assert result["correct"], checks
    assert result["attempted"] >= 4096 and result["failed"] == 0
    # device_peak_mib finds no card to read on the CPU
    assert set(result["metrics"]) == {"kmer_queries_per_s", "chunk_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"


def test_traced_run_reads_new_metric_file(bench):
    # the span readings come from the chunks before the profiler starts,
    # three quarters of the way through the window
    result, _ = run(bench, "tiny_minimizer.reads", seconds=6.0, trace=True)
    assert result["correct"]
    m = result["metrics"]
    for name in ("engine_init_s", "encode_ms_per_chunk", "readback_ms_per_chunk",
                 "locate_dispatch_ms_per_chunk", "format_ms_per_chunk", "queries_per_chunk"):
        assert m[name]["value"] > 0, name
    # no device in this run: the device-trace metrics find nothing to read;
    # the program keeps no such range or counter: those files read nothing
    for name in ("minimizer_front_roofline", "device_idle_share", "program_encode_ms",
                 "program_encode_calls"):
        assert name not in m, name
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def _program_span_and_counter(engine):
    """What the program would add: a record_function range of its own
    around the encode, and a dict of counters on the engine."""
    from torch.profiler import record_function

    encode = engine._encode_both_strands
    engine.counts = {"encode": 0}

    def encode_both_strands(reads):
        engine.counts["encode"] += 1
        with record_function("program.encode"):
            return encode(reads)

    engine._encode_both_strands = encode_both_strands


def test_new_metric_files_read_the_programs_span_and_counter(bench):
    """A metric file reads a range the program records (not bench.*) and a
    counter the engine keeps, with no edit to the harness; the breakdown
    names an idle gap by the program's range."""
    result, _ = run(bench, "tiny_minimizer.reads", seconds=6.0, trace=True,
                    engine_hook=_program_span_and_counter)
    assert result["correct"]
    m = result["metrics"]
    assert m["program_encode_ms"]["value"] > 0
    # every chunk of the window, whether profiled or not, was counted
    assert m["program_encode_calls"]["value"] == result["counters"]["chunks"]
    gaps = [name for name, _ in result["breakdown"]["idle_gaps"]]
    assert gaps and all(isinstance(g, str) for g in gaps)


@pytest.mark.parametrize("v2", ["0", "1"])
def test_long_reads_take_the_host_merge_and_agree(bench, monkeypatch, v2):
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    result, checks = run(bench, "tiny_minimizer.long")
    assert result["correct"], checks
    assert result["counters"]["host_merge"] >= 1


def test_reference_covers_both_strands_and_n(bench):
    """The pool has reverse-strand reads and N reads, the reference finds
    k-mers on both strands, and N reads give empty lines."""
    path, bdir = bench
    spec = harness.load_cell("tiny_minimizer.reads", path, bdir)
    genome, unitigs = datagen.genome_and_unitigs(SEED, spec.config)
    codes, ends = datagen.gen_reads(np.random.default_rng([SEED, 1]), genome, spec.traffic)
    ref = Reference.of_unitigs(*unitigs, 31, "cpu")
    W, found, nbytes, u, p, first = ref.answer(codes, ends)
    starts = np.concatenate([[0], ends[:-1]])
    has_n = np.array([np.any(codes[a:b] > 3) for a, b in zip(starts, ends)])
    assert has_n.any() and np.all(W[has_n] == 0) and np.all(nbytes[has_n] == 1)
    fwd_only = ref.answer(codes, ends, rc=False)[1]
    assert found.sum() > 1.5 * fwd_only.sum() > 0


def test_unitig_ids_follow_the_ports_index(tmp_path):
    """The reference's own numbering (colex order of first k-mers) is the
    one the port's index stores."""
    from finito_tpu_torch.index.index import FinimizerIndex

    genome, cuts = datagen.gen_dspss(np.random.default_rng(5), 30000, 31)
    codes, ends = datagen.cut_unitigs(genome, cuts, 31)
    harness.build_index(codes, ends, 31, str(tmp_path / "idx"))
    index = FinimizerIndex.load(str(tmp_path / "idx"))
    ids = unitig_ids(codes, ends, 31)
    index_ends = np.asarray(index.unitigs.ends)
    index_starts = np.concatenate([[0], index_ends[:-1]])
    for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        j = ids[i]
        assert np.array_equal(index.unitigs.concat[index_starts[j] : index_ends[j]],
                              genome[a : b + 30])


@pytest.mark.parametrize("variant,fails", [
    ({"rc": False}, ("sample_windows_wrong", "found_diff", "line_bytes_wrong")),
    ({"keep": 0.5}, ("lines_missing", "queries_diff")),
    ({}, ())])
def test_reference_in_the_programs_place(bench, variant, fails):
    """The sound reference served in the program's place is correct; the
    control (no strand merge) and a chunk that drops half its reads fail
    the numbers they should."""
    result, checks = run(bench, "tiny_minimizer.reads", reference_engine=variant)
    assert result["correct"] == (not fails), checks
    assert all(checks[c] > 0 for c in fails), checks


def _wrap_end(engine, change):
    end = engine.merged_pairs_flat_end
    state = {}

    def merged_pairs_flat_end(handle):
        return change(state, *end(handle))

    engine.merged_pairs_flat_end = merged_pairs_flat_end


def _altered(state, line_lens, u, p, kf, kr):
    """An answer altered where it is produced: each line's first found
    window points one base further."""
    p = p.copy()
    heads = np.concatenate([[0], np.cumsum(line_lens)[:-1]])[line_lens > 0]
    heads = heads[u[heads] >= 0]
    p[heads] += 1
    return line_lens, u, p, kf, kr


def _half_dropped(state, line_lens, u, p, kf, kr):
    """Half of the batch left out: the second half of the chunk's windows
    answered absent."""
    u, p = u.copy(), p.copy()
    u[u.size // 2 :] = -1
    p[p.size // 2 :] = -1
    return line_lens, u, p, kf, kr


def _stale(state, line_lens, u, p, kf, kr):
    """A step that returns its state unchanged: each chunk gets the
    previous chunk's answer, the first one the empty state (all absent)."""
    prev = state.get("prev")
    state["prev"] = (line_lens, u, p, kf, kr)
    if prev is not None and len(prev[0]) == len(line_lens):
        return prev
    return line_lens, np.full_like(u, -1), np.full_like(p, -1), 0, 0


@pytest.mark.parametrize("fault", [_altered, _half_dropped, _stale], ids=lambda f: f.__name__)
def test_fault_makes_run_incorrect(bench, fault):
    result, checks = run(bench, "tiny_minimizer.reads", seconds=0.6,
                         engine_hook=lambda e: _wrap_end(e, fault))
    assert not result["correct"], checks


def test_python_formatter_branch_is_caught(bench, monkeypatch):
    """A run whose bytes do not come through format_pairs' branch (the
    CLI's Python formatter writes text) is not correct."""
    from finito_tpu_torch import native

    monkeypatch.setattr(native, "format_pairs", lambda *a: None)
    result, checks = run(bench, "tiny_minimizer.reads")
    assert checks["text_writes"] > 0 and not result["correct"]


def test_same_seed_same_inputs():
    traffic = dict(pool=50, length={"lognormal_median": 400, "sigma": 0.3, "min": 100, "max": 900},
                   rc_frac=0.5, sub_rate=0.01, n_frac=0.1)
    a = datagen.gen_dspss(np.random.default_rng([SEED, 0]), 5000, 31)
    b = datagen.gen_dspss(np.random.default_rng([SEED, 0]), 5000, 31)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    ra = datagen.gen_reads(np.random.default_rng([SEED, 1]), a[0], traffic)
    rb = datagen.gen_reads(np.random.default_rng([SEED, 1]), b[0], traffic)
    assert all(np.array_equal(x, y) for x, y in zip(ra, rb))
    assert datagen.fastq_bytes(*ra) == datagen.fastq_bytes(*rb)
    c = datagen.gen_dspss(np.random.default_rng([SEED + 1, 0]), 5000, 31)
    assert not np.array_equal(a[0], c[0])


def test_gen_dspss_matches_the_programs_generator():
    """The frozen copy draws what utils.synth.gen_dspss draws."""
    from finito_tpu_torch.utils.synth import gen_dspss

    g, cuts = datagen.gen_dspss(np.random.default_rng(3), 8000, 31)
    g2, _, cuts2 = gen_dspss(np.random.default_rng(3), 8000, 31, return_cuts=True)
    assert np.array_equal(g, g2) and np.array_equal(cuts, cuts2)


def test_read_generator_strands_and_errors():
    genome = np.random.default_rng(0).integers(0, 4, 10000, dtype=np.uint8)
    traffic = dict(pool=2000, length={"fixed": 150}, rc_frac=0.5, sub_rate=0.0, n_frac=0.0)
    codes, ends = datagen.gen_reads(np.random.default_rng(1), genome, traffic)
    text = genome.tobytes()
    rc_text = (3 - genome[::-1]).tobytes()
    reads = [codes[e - 150 : e].tobytes() for e in ends]
    fwd = sum(r in text for r in reads)
    rev = sum(r in rc_text for r in reads)
    assert fwd + rev == 2000 and 850 < fwd < 1150

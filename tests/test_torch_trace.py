"""utils.trace on search-fmin's served path (cli._run_queries_streaming
with a device engine, on the CPU): the same bytes with a torch profiler
recording and without one; the tally's spans and counters with no
profiler; the program's ranges, and an untouched tally, under one; the
device-to-host reads a chunk of each engine; host merges counted where
they happen (capacity re-runs: test_torch_engine's
test_forced_capacity_rerun); a fresh tally at each call."""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from finito_tpu_torch import cli
from finito_tpu_torch.index.builder import FinimizerIndexBuilder
from finito_tpu_torch.io.fastx import reverse_complement
from finito_tpu_torch.io.seqdb import SeqDB
from finito_tpu_torch.query.engine import DeviceQueryEngine
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array
from finito_tpu_torch.utils import trace
from finito_tpu_torch.utils.logging import LogLevel, set_log_level
from finito_tpu_torch.utils.synth import gen_dspss

K = 15
CHUNK = 4096  # cli._run_queries_streaming's chunk
# engine key -> (mode, FINITO_MINIMIZER_V2 at construction)
ENGINES = {"v1": ("minimizer", "0"), "v2": ("minimizer", "1"),
           "stream": ("stream", None), "replica": ("replica", None)}
SERVE = {"serve.read", "serve.format", "query.encode", "query.encode_seq", "query.locate",
         "query.merge", "query.verify", "query.readback", "query.expand",
         "host_read.verify", "host_read.stats", "host_read.runs"}
REPAIR = {"chain_opt", "segment_repair.fixed", "segment_repair.straggler",
          "host_read.straggler"}
SPANS = {"v1": SERVE | {"host_read.locate.trips"},
         "v2": SERVE | {"host_read.locate.trips", "v2.front", "v2.runs", "v2.slow",
                        "v2.scatter"},
         "stream": SERVE | REPAIR | {"ranks_to_locations"},
         "replica": SERVE | REPAIR | {"replica_tail"}}


def _reads(genome: bytes, n: int, length: int, sub: float, seed: int, n_every: int = 0):
    """n reads of the genome, every other one reverse-complemented, with
    substitutions at rate sub and, with n_every, an N in every n_every-th;
    as (header, sequence) records."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = int(rng.integers(0, len(genome) - length))
        x = bytearray(genome[s : s + length])
        for p in np.flatnonzero(rng.random(length) < sub):
            x[p] = b"ACGT"[(b"ACGT".index(x[p]) + 1) % 4]
        if n_every and i % n_every == 7:
            x[length // 2] = ord("N")
        x = bytes(x)
        out.append((b"r", reverse_complement(x) if i % 2 else x))
    return out


@pytest.fixture(scope="module")
def cell():
    """A k=15 index of a 20 kbp DSPSS genome, and two chunks of 60 bp
    reads: one full (4,096 reads) and a short last one."""
    genome, unitigs = gen_dspss(np.random.default_rng(15), 20000, K)
    sbwt, keys = build_plain_matrix_sbwt(unitigs, K, return_keys=True)
    index = FinimizerIndexBuilder(sbwt, lcs_array(sbwt), SeqDB.from_sequences(unitigs),
                                  node_keys=keys).get_index()
    text = b"".join(b"ACGT"[c : c + 1] for c in genome.tolist())
    return index, text, _reads(text, CHUNK + 60, 60, 0.01, 16, n_every=50)


def _engine(index, key, device="cpu"):
    mode, v2 = ENGINES[key]
    old = os.environ.get("FINITO_MINIMIZER_V2")
    if v2 is not None:
        os.environ["FINITO_MINIMIZER_V2"] = v2
    try:
        return DeviceQueryEngine(index, mode=mode, device=device)
    finally:
        if old is None:
            os.environ.pop("FINITO_MINIMIZER_V2", None)
        else:
            os.environ["FINITO_MINIMIZER_V2"] = old


def _serve(engine, index, records, tmp):
    """The served path over records: (output bytes, stats text, counts,
    ms), the tally copied at the call's end."""
    out = io.TextIOWrapper(io.BytesIO(), encoding="ascii")
    stats = os.path.join(tmp, "q.stats")
    if os.path.exists(stats):
        os.remove(stats)
    cli._run_queries_streaming(iter(records), out, index, stats, engine)
    out.flush()
    with open(stats) as f:
        return out.buffer.getvalue(), f.read(), dict(trace.counts), dict(trace.ms)


@pytest.fixture(scope="module")
def served(cell, tmp_path_factory):
    """Per engine key, calls on one engine: the first (which settles the
    capacities of both chunk shapes), a second, and, when asked for with
    profiled=True, a third under a torch profiler, with the names of the
    ranges it recorded."""
    index, _, records = cell
    tmp = str(tmp_path_factory.mktemp("served"))
    cache = {}

    def get(key, profiled=False):
        if key not in cache:
            engine = _engine(index, key)
            cache[key] = [engine, _serve(engine, index, records, tmp),
                          _serve(engine, index, records, tmp)]
        if profiled and len(cache[key]) == 3:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                third = _serve(cache[key][0], index, records, tmp)
            cache[key] += [third, {e.name for e in prof.events()}]
        return cache[key][1:] if profiled else cache[key][1:3]

    return get


@pytest.mark.parametrize("key", ["v1", "stream"])
def test_profiler_leaves_output_bytes_unchanged(served, key):
    first, second, profiled, _ = served(key, profiled=True)
    assert first[0] == second[0] == profiled[0] and first[0].count(b"\n") == CHUNK + 60
    assert first[1] == second[1] == profiled[1]


@pytest.mark.parametrize("key", sorted(ENGINES))
def test_tally_holds_each_span_without_profiler(served, key):
    _, (_, _, counts, ms) = served(key)
    assert set(ms) == SPANS[key] and all(t >= 0 for t in ms.values())
    assert counts["chunks"] == counts["chunks_timed"] == 2
    assert counts["reads"] == CHUNK + 60


@pytest.mark.parametrize("key", ["v2", "stream"])
def test_profiler_records_the_programs_ranges_not_the_tally(served, key):
    _, (_, _, counts, _), (_, _, p_counts, p_ms), names = served(key, profiled=True)
    for name in ("query.encode:0", "query.encode:1", "serve.read:0", "serve.read:1",
                 "serve.format:1", "query.locate:1", "query.readback:0", "host_read.stats"):
        assert name in names, name
    assert any(n.startswith("host_read.") for n in names)
    # the profiled chunks add nothing to the host tally, and count the same
    assert p_ms == {} and "chunks_timed" not in p_counts
    assert {n: c for n, c in p_counts.items() if n != "chunks_timed"} == {
        n: c for n, c in counts.items() if n != "chunks_timed"}


@pytest.mark.parametrize("key", sorted(ENGINES))
def test_host_reads_per_chunk(served, key):
    """Minimizer: the slow path's trip count, the verify's counters, the
    merge stats and the runs, one each a chunk. Stream and replica: the
    segment count, the stats and the runs, and one straggler read a
    straggler trip plus the one that ends the loop."""
    _, (_, _, counts, _) = served(key)
    chunks = counts["chunks"]
    reads = {n[len("host_reads."):]: c for n, c in counts.items() if n.startswith("host_reads.")}
    want = {"verify": chunks, "stats": chunks, "runs": chunks}
    if ENGINES[key][0] == "minimizer":
        want["locate.trips"] = chunks
        assert counts["trips.slow"] >= 0
        assert ("slow_runs" in counts and "heads" in counts) == (key == "v2")
    else:
        want["straggler"] = counts.get("trips.straggler", 0) + chunks
        assert counts["trips.repair_fixed"] % chunks == 0 and counts["segments"] > 0
    assert reads == want
    assert "capacity_reruns" not in counts and "host_merges" not in counts
    assert counts["runs"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["stream", "replica"])
def test_card_path_counts_repair_kernel(served, cell, tmp_path, key):
    """On the card the repair is one kernel launch a chunk and capacity
    re-run: `repair.kernel` counts them, under the `segment_repair` span,
    with no repair trip and no straggler read; two calls (the first
    settles the capacities) give the CPU engine's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the repair kernel has no CPU mode)")
    index, _, records = cell
    engine = _engine(index, key, device="cuda")
    (want, want_stats, _, _), _ = served(key)
    for _ in range(2):
        out, stats, counts, ms = _serve(engine, index, records, str(tmp_path))
        assert out == want and stats == want_stats
        # one locate a chunk and re-run, each read back once by verify()
        reads = {n[len("host_reads."):]: c for n, c in counts.items()
                 if n.startswith("host_reads.")}
        assert reads == {"verify": counts["repair.kernel"], "stats": counts["chunks"],
                         "runs": counts["chunks"]}
        assert counts["repair.kernel"] == counts["chain.kernel"] >= (
            counts["chunks"] + counts.get("capacity_reruns", 0))
        assert not any(n.startswith("trips.") for n in counts)
        assert "segment_repair" in ms and not {"segment_repair.fixed",
                                               "segment_repair.straggler"} & set(ms)


def test_host_merges_on_long_noisy_reads(cell, tmp_path):
    """800 bp reads at 7% substitutions: more runs than merge_rle holds,
    so the chunk takes the full-window host merge, counted and timed."""
    index, text, _ = cell
    engine = _engine(index, "v1")
    out, _, counts, ms = _serve(engine, index, _reads(text, 120, 800, 0.07, 17), str(tmp_path))
    assert counts["host_merges"] >= 1 and counts["host_reads.host_merge"] == 2 * counts["host_merges"]
    assert "host_read.runs" not in ms and {"query.host_merge", "host_read.host_merge"} <= set(ms)
    assert out.count(b"\n") == 120


def test_tally_restarts_at_each_call(served):
    """Two calls over the same reads count the same chunks, reads and
    reads back (the first call's capacity re-runs aside)."""
    (_, _, c1, ms1), (_, _, c2, ms2) = served("v2")
    assert c1["chunks"] == c2["chunks"] == 2 and c1["reads"] == c2["reads"] == CHUNK + 60
    for name in ("host_reads.stats", "host_reads.runs", "runs"):
        assert c1[name] == c2[name]
    assert set(ms1) == set(ms2)


def test_span_mode_is_fixed_when_it_opens():
    """A span opened with no profiler times on the host clock though a
    profiler starts before it closes; once one has recorded, the tally's
    clock stays stopped until the next reset."""
    trace.reset()
    s = trace.span("a").open()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.close()
        with trace.span("b", 3):
            pass
        trace.count("c", 2)
    with trace.span("d"):
        pass
    assert set(trace.ms) == {"a"} and trace.counts == {"c": 2}
    assert "b:3" in {e.name for e in prof.events()}
    trace.reset()
    with trace.span("d"):
        pass
    assert set(trace.ms) == {"d"}


def test_cli_logs_the_tally(cell, tmp_path, capsys):
    index, _, records = cell
    engine = _engine(index, "v1")
    set_log_level(LogLevel.MINOR)
    try:
        _serve(engine, index, records[:100], str(tmp_path))
    finally:
        set_log_level(LogLevel.MAJOR)
    line = [x for x in capsys.readouterr().err.splitlines() if "(MINOR) trace: " in x]
    assert len(line) == 1
    assert "chunks 1" in line[0] and "host_reads.stats 1" in line[0]
    assert "ms a timed chunk: " in line[0] and "query.encode " in line[0]


def test_engine_exposes_the_tally(cell):
    index, _, _ = cell
    engine = _engine(index, "v1")
    trace.reset()
    trace.count("x")
    assert engine.trace_counts is trace.counts and engine.trace_counts == {"x": 1}
    assert engine.trace_ms is trace.ms

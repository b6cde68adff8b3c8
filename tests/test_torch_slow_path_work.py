"""The minimizer slow path's work counters (`slow_occ`,
`slow_lane_trips`) on a repeat index against numpy's reading of the
MinimizerIndex, for the v1 and v2 locates, at the host reads and device
operations of the locate without them, and counted once for a forced
capacity re-run; and the benchmark's `slow_path_fill`, which reads them,
on a tiny repeat cell run by the benchmark's own harness on the CPU."""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import datagen, harness
from finito_tpu_torch.index.builder import FinimizerIndexBuilder
from finito_tpu_torch.index.minimizer import MinimizerIndex, mix32, pack_mvals, slot32
from finito_tpu_torch.io.seqdb import SeqDB
from finito_tpu_torch.query import minimizer_engine as me
from finito_tpu_torch.query.engine import DeviceQueryEngine
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array
from finito_tpu_torch.utils import trace
from finito_tpu_torch.utils.synth import REPEAT_PARAMS, gen_repeat_genome

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark", "tests"))
from bench_tiny import make_bench  # noqa: E402

SEED = 2**31 + 2121
K = 31


def test_slow_path_fill_entry_and_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {m["name"]: m for m in bench["per_layer"]}["slow_path_fill"]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"], entry["moves"]) == (
        "%", "higher", "program_counter", "locate", "kmer_queries_per_s")
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    assert entry["workloads"] == ["chr21_minimizer.reads150", "ecoli_minimizer.reads150",
                                  "ecoli_minimizer.hifi"]
    for cell in entry["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "configs", cells[cell] + ".json")) as f:
            assert json.load(f)["engine"] == "minimizer"

    def read(stats):
        return harness.read_metric(harness.BENCH_DIR, "slow_path_fill",
                                   SimpleNamespace(engine_stats=stats))

    # nothing to read where no slow lane ran, as at a tree without the counters
    assert read({}) is None and read({"trace_counts.slow_lane_trips": 0}) is None
    assert read({"trace_counts.slow_occ": 3, "trace_counts.slow_lane_trips": 12}) == 25.0


def test_tiny_repeat_cell_reports_slow_path_fill(tmp_path):
    path = make_bench(str(tmp_path), engines=("minimizer",))
    result, checks = harness.run_cell("tiny_repeat.reads", SEED, 0.3, True, device="cpu",
                                      bench_json=path,
                                      bench_dir=os.path.join(str(tmp_path), "benchmark"))
    assert result["correct"] and result["failed"] == 0, checks
    assert 0 < result["metrics"]["slow_path_fill"]["value"] <= 100


@pytest.fixture(scope="module")
def repeat_index():
    """A k=31 index of a 60 kbp repeat genome's canonical unitigs, its
    MinimizerIndex, and 256 error-free 128 bp reads of the genome: a
    (256, 128) batch, which no bucket pads, so every window is valid."""
    genome = gen_repeat_genome(np.random.default_rng(SEED), 60_000, **REPEAT_PARAMS)
    unitigs = datagen.unitig_bytes(*datagen.dbg_unitigs(genome, K))
    sbwt, keys = build_plain_matrix_sbwt(unitigs, K, return_keys=True)
    index = FinimizerIndexBuilder(sbwt, lcs_array(sbwt), SeqDB.from_sequences(unitigs),
                                  node_keys=keys).get_index()
    rng = np.random.default_rng([SEED, 1])
    starts = rng.integers(0, genome.size - 128, 256)
    codes = np.stack([genome[s : s + 128] for s in starts]).astype(np.uint8)
    return index, MinimizerIndex.from_finimizer_index(index), codes


def _expected_work(mindex: MinimizerIndex, codes: np.ndarray, v2: bool):
    """(slow lanes, sum of their slot lengths, the longest) of a batch of
    valid windows, from the MinimizerIndex: each window's leftmost m-mer
    of least mix32, its slot and the slot's exact length; v1's lanes are
    the windows of slots of 2 or more occurrences, v2's the runs (windows
    sharing one minimizer position) whose first window's slot has them."""
    k, m, h = mindex.k, mindex.m, mindex.h
    start = mindex.desc.astype(np.int64) >> 6
    lanes = []
    for row in codes:
        mv = pack_mvals(row, m)
        o = np.lib.stride_tricks.sliding_window_view(mix32(mv), k - m + 1).argmin(1)
        w = np.arange(o.size)
        slot = slot32(mv[w + o]).astype(np.int64) >> (32 - h)
        ln = start[slot + 1] - start[slot]
        if v2:
            pm = o + w
            ln = ln[np.concatenate([[True], pm[1:] != pm[:-1]])]
        lanes.append(ln[ln >= 2])
    lanes = np.concatenate(lanes)
    return lanes.size, int(lanes.sum()), int(lanes.max(initial=0))


def _engine(index, v2: str):
    old = os.environ.get("FINITO_MINIMIZER_V2")
    os.environ["FINITO_MINIMIZER_V2"] = v2
    try:
        return DeviceQueryEngine(index, mode="minimizer", device="cpu")
    finally:
        if old is None:
            os.environ.pop("FINITO_MINIMIZER_V2", None)
        else:
            os.environ["FINITO_MINIMIZER_V2"] = old


def _counted(engine, codes):
    trace.reset()
    out = engine.locate_batch(codes)
    return out, dict(trace.counts)


@pytest.mark.parametrize("v2", ["0", "1"])
def test_slow_path_work_counters(repeat_index, monkeypatch, v2):
    index, mindex, codes = repeat_index
    engine = _engine(index, v2)
    assert engine.use_v2 == (v2 == "1")
    n_lanes, occ, longest = _expected_work(mindex, codes, engine.use_v2)
    assert n_lanes > 10 and longest > 2  # the repeats fill multi-occurrence slots
    want, counts = _counted(engine, codes)
    assert counts["slow_occ"] == occ and counts["slow_lane_trips"] == n_lanes * longest
    assert counts["trips.slow"] == longest
    # the work rides on the reads the locate made before it was counted
    reads = {n: c for n, c in counts.items() if n.startswith("host_reads.")}
    assert reads == {"host_reads.locate.trips": 1, "host_reads.verify": 1}
    # a forced capacity re-run: one trip read and one verify read a run, the
    # work of the final run alone, the same answers
    monkeypatch.setenv("FINITO_MIN_K0", "1")
    forced, again = _counted(engine, codes)
    assert all(np.array_equal(a, b) for a, b in zip(forced, want))
    runs = again["host_reads.verify"]
    assert runs >= 2 and again["host_reads.locate.trips"] == runs
    assert (again["slow_occ"], again["slow_lane_trips"]) == (occ, n_lanes * longest)


@pytest.mark.parametrize("v2", [False, True])
def test_work_outputs_add_no_device_operation(repeat_index, v2):
    """The locate's work outputs are tensors it already made: the same
    operations with and without them, and the same answers."""
    index, mindex, codes = repeat_index
    dmi = me.DeviceMinimizerIndex(mindex, "cpu")
    reads = torch.from_numpy(codes)
    ops, outs = [], []
    for work in (False, True):
        locate = (me.make_minimizer_locate_v2(dmi, 4096, 8192, work=work) if v2
                  else me.make_minimizer_locate(dmi, 4096, work=work))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outs.append(locate(reads))
        ops.append(sorted(e.name for e in prof.events() if e.name.startswith("aten::")))
    assert ops[0] == ops[1]
    plain, worked = outs
    assert len(worked) == len(plain) + 2
    assert all(torch.equal(a, b) for a, b in zip(plain, worked))
    longest, s_len = worked[len(plain):]
    assert int(longest) == int(s_len.max()) and int(s_len.sum()) == _expected_work(
        mindex, codes, v2)[1]

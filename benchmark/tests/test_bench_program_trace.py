"""The per-layer metrics that read the program's own tracing
(finito_tpu_torch.utils.trace: the engine's trace_ms and trace_counts,
the program's profiler ranges), and a replica cell made only of data
files, on the CPU at a tiny size."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_tiny import ROOT, make_bench  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SEED = 2**31 + 1515
HOST = ("read_ms_per_chunk", "encode_seq_ms_per_chunk", "host_wait_ms_per_chunk",
        "host_reads_per_chunk", "locate_trips_per_chunk")
PROGRAM = ("serve.", "query.", "host_read.", "v2.")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    return make_bench(root, engines=("minimizer", "replica")), os.path.join(root, "benchmark")


def run(bench, cell, seconds, trace, device="cpu"):
    path, bdir = bench
    return harness.run_cell(cell, SEED, seconds, trace, device=device, bench_json=path,
                            bench_dir=bdir)


def test_traced_run_reads_the_programs_tracing(bench):
    """The host-clock readings and counters come from the engine's tally;
    the locate's device time finds no device here. The breakdown's idle
    gap is named by one of the program's ranges, not bench.*."""
    result, checks = run(bench, "tiny_minimizer.reads", 6.0, True)
    assert result["correct"], checks
    m = result["metrics"]
    for name in HOST:
        assert name in m, name
    for name in HOST[:3]:
        assert m[name]["value"] > 0, name
    # the tiny index takes the v1 locate: its trip count, the verify's
    # counter, the merge stats and the runs, each once a chunk at least
    assert m["host_reads_per_chunk"]["value"] >= 4
    assert m["locate_trips_per_chunk"]["value"] >= 0
    assert "locate_device_ms_per_chunk" not in m
    gaps = [name for name, _ in result["breakdown"]["idle_gaps"]]
    assert gaps and any(g.startswith(PROGRAM) for g in gaps), gaps


def test_replica_cell_from_data_files_runs_correct(bench):
    result, checks = run(bench, "tiny_replica.reads", 0.2, False)
    assert result["correct"], checks
    assert result["attempted"] >= 4096 and result["failed"] == 0
    assert set(result["metrics"]) == {"kmer_queries_per_s", "chunk_p95_ms", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_minimizer.reads", "tiny_replica.reads"])
def test_traced_run_on_the_card_reads_all_six(bench, cell):
    """On the card every new metric reads a number, the locate's device
    time among them."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result, checks = run(bench, cell, 1.0, True, device="cuda")
    assert result["correct"], checks
    m = result["metrics"]
    for name in HOST + ("locate_device_ms_per_chunk",):
        assert name in m, name
    assert m["locate_device_ms_per_chunk"]["value"] > 0

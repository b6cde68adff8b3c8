"""The two metric files of the chunk rule, window_slot_ratio and
host_merge_window_share, read on a traced window of the tiny cells on the
CPU: long noisy reads that overflow merge_rle in every chunk, and short
reads that never do."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_tiny import ROOT, make_bench  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SEED = 2**31 + 1717


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    return make_bench(root, engines=("minimizer",)), os.path.join(root, "benchmark")


@pytest.mark.parametrize("cell,share,ratio", [("tiny_minimizer.long", 100.0, (1.0, 1.4)),
                                              ("tiny_minimizer.reads", 0.0, (1.8, 2.0))])
def test_traced_window_reads_both_metrics(bench, monkeypatch, cell, share, ratio):
    """Long reads of 700-900 bp pad to 1,024 columns and take the host
    merge for every window; 150 bp reads pad to 256 columns (226 window
    slots a row for 120 windows, and a few N reads left out) and never do."""
    monkeypatch.setenv("FINITO_MINIMIZER_V2", "0")
    path, bdir = bench
    result, checks = harness.run_cell(cell, SEED, 4.0, True, device="cpu", bench_json=path,
                                      bench_dir=bdir)
    assert result["correct"], checks
    m = result["metrics"]
    assert m["host_merge_window_share"] == {"value": share, "unit": "%"}
    assert ratio[0] < m["window_slot_ratio"]["value"] < ratio[1]
    assert m["window_slot_ratio"]["unit"] == "slots/window"

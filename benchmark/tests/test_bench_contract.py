"""BENCHMARK.json's shape, the files it names, the frozen roofline
arithmetic, the trace reduction, and what a run refuses: a process
without a card, and JAX or the JAX package in its modules."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_tiny import BENCH_DIR, ROOT, make_bench  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.roofline import front_bound_ms, front_bytes_ops  # noqa: E402
from benchmark.trace import Trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"kmer_queries_per_s", "chunk_p95_ms", "device_peak_mib", "setup_s"}
    assert e2e["chunk_p95_ms"]["workloads"] == ["ecoli_minimizer.reads150"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    for c in b["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and os.path.exists(
            os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    for w in b["workloads"]:
        spec = harness.load_cell(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and spec.per_layer
        for m in spec.per_layer:  # each per-layer metric's cells report what it moves
            assert m["moves"] in names, (w["name"], m["name"])


def test_front_bound_at_the_main_shape():
    nbytes, _ = front_bytes_ops(8192, 128, 31, 16)
    ms, what = front_bound_ms(8192, 128, 31, 16)
    assert round(nbytes / 1e6, 2) == 14.70 and round(ms, 5) == 0.00439 and what == "bytes"


def test_trace_reduction():
    ms = 1_000_000
    tr = Trace(window=(0, 100 * ms),
               ranges=[(0, 100 * ms, "bench.window"), (10 * ms, 30 * ms, "bench.locate"),
                       (50 * ms, 90 * ms, "bench.readback")],
               ops=[(20 * ms, 40 * ms, "k1", 12 * ms), (30 * ms, 45 * ms, "k2", 15 * ms),
                    (95 * ms, 110 * ms, "k1", 60 * ms), (5 * ms, 6 * ms, "k3", 5 * ms)])
    assert tr.busy_s() == pytest.approx(0.031)
    assert [op[2] for op, _ in tr.ops_launched_in("bench.locate")] == ["k1", "k2"]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(0.025)]
    assert bd["idle_gaps"][0] == ["bench.readback", pytest.approx(0.05)]
    assert [g[0] for g in bd["idle_gaps"][1:]] == ["bench.locate", "loop_and_reader"]


def test_trace_names_gaps_by_the_programs_ranges():
    """A range the program records (not bench.*) is kept, read like the
    harness's own, and names the idle gaps it holds, innermost first."""
    ms = 1_000_000
    tr = Trace(window=(0, 100 * ms),
               ranges=[(0, 100 * ms, "bench.window"), (0, 100 * ms, "ProfilerStep#4"),
                       (50 * ms, 99 * ms, "bench.readback"),
                       (60 * ms, 95 * ms, "merge_rle")],
               ops=[(20 * ms, 45 * ms, "k1", 12 * ms), (65 * ms, 66 * ms, "k2", 62 * ms)])
    assert [op[2] for op, _ in tr.ops_launched_in("merge_rle")] == ["k2"]
    assert tr.in_ranges("merge_rle") == [(60 * ms, 95 * ms, "merge_rle")]
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0][0] == "merge_rle" and gaps[1][0] == "loop_and_reader"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    fake = type(sys)("x")
    for name in ("finito_tpu_torch.cli", "jaxfoo", "benchmark.harness", "bench_tiny"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "finito_tpu.cli", fake)
    monkeypatch.setitem(sys.modules, "jax", fake)
    assert harness.forbidden_modules() == ["finito_tpu", "jax"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process leaves no JAX, no JAX package
    and no bench module in sys.modules."""
    path = make_bench(str(tmp_path))
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from benchmark import harness\n"
            f"r, c = harness.run_cell('tiny_minimizer.reads', 9, 0.2, True, device='cpu', "
            f"bench_json={path!r}, bench_dir={os.path.join(str(tmp_path), 'benchmark')!r})\n"
            "assert r['correct'], c\n"
            "print('FORBIDDEN', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "ecoli_minimizer.reads150", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=cwd, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_refuses_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_outside_a_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program, no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    """On the card: a tiny cell is correct and its traced run reads the
    device metrics, the roofline share under 105%."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    path = make_bench(str(tmp_path))
    bdir = os.path.join(str(tmp_path), "benchmark")
    result, checks = harness.run_cell("tiny_minimizer.reads", 11, 0.5, True, bench_json=path,
                                      bench_dir=bdir)
    assert result["correct"], checks
    m = result["metrics"]
    assert 0 < m["minimizer_front_roofline"]["value"] < 105
    assert m["locate_ops_per_chunk"]["value"] > 0 and result["device"]["busy_s"] > 0

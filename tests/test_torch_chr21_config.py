"""The chromosome-scale repeat configuration, chr21_k31_minimizer: its
file states the repeat generator's parameters, the t=1 rarest index, the
genome's length and its fixed seed, and BENCHMARK.json runs it in one
cell; a copy of it at 60,000 bp runs correct through the benchmark's own
harness on the CPU, and the control and a chunk that drops half its reads
do not."""

import inspect
import json
import os
import sys

import numpy as np
import pytest

from benchmark import datagen, harness
from finito_tpu_torch.utils.synth import REPEAT_PARAMS, gen_repeat_genome

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark", "tests"))
from bench_tiny import make_bench  # noqa: E402

NAME = "chr21_k31_minimizer"
CELL = "chr21_minimizer.reads150"
SEED = 2**31 + 2121


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs", NAME + ".json")) as f:
        return json.load(f)


def test_configuration_file():
    cfg = _config()
    defaults = {n: p.default for n, p in inspect.signature(gen_repeat_genome).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert cfg["repeat"] == dict(defaults, **REPEAT_PARAMS)
    assert cfg["repeat"]["tandem_frac"] == 0.2
    assert (cfg["name"], cfg["k"], cfg["t"], cfg["finimizer_type"], cfg["engine"],
            cfg["genome"]) == (NAME, 31, 1, "rarest", "minimizer", "repeat")
    assert cfg["genome_len"] == 40_100_000
    assert isinstance(cfg["genome_seed"], int)
    # the benchmark's frozen generator draws what the program's draws
    rng = [np.random.default_rng([cfg["genome_seed"], 0]) for _ in range(2)]
    assert np.array_equal(datagen.gen_repeat_genome(rng[0], 60_000, **cfg["repeat"]),
                          gen_repeat_genome(rng[1], 60_000, **cfg["repeat"]))


def test_configuration_runs_in_one_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {c["name"]: c for c in bench["configs"]}[NAME]
    assert entry["file"] == f"benchmark/configs/{NAME}.json" and entry["reduced"] == []
    assert entry["source"] == _config()["source"] and len(entry["source"]) <= 200
    cells = [w for w in bench["workloads"] if w["config"] == NAME]
    assert [(w["name"], w["traffic"], w["chips"]) for w in cells] == [(CELL, "reads150", 1)]
    # the lists of the metrics that were there before it stay as they were
    lists = {m["name"]: m.get("workloads") for m in bench["end_to_end"] + bench["per_layer"]}
    assert lists["minimizer_front_roofline"] == ["ecoli_minimizer.reads150",
                                                 "ecoli_minimizer.hifi"]
    assert lists["chunk_p95_ms"] == ["ecoli_minimizer.reads150"]
    assert CELL in lists["slow_path_fill"]


@pytest.fixture(scope="module")
def small_copy(tmp_path_factory):
    """The tiny cells of bench_tiny with the configuration beside them, cut
    to 60,000 bp, on the tiny reads."""
    root = str(tmp_path_factory.mktemp("chr21"))
    path = make_bench(root, engines=("minimizer",))
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", NAME + ".json"), "w") as f:
        json.dump(dict(_config(), genome_len=60_000), f)
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": NAME, "source": "test", "file": f"benchmark/configs/{NAME}.json",
                             "reduced": ["genome_len"], "why": "test"})
    bench["workloads"].append({"name": "chr21_small.reads", "config": NAME,
                               "traffic": "tinyreads", "chips": 1, "why": "test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return path, bdir


@pytest.mark.parametrize("variant,fails", [(None, None), ({"rc": False}, "found_diff"),
                                           ({"keep": 0.5}, "lines_missing")],
                         ids=["program", "control", "half"])
def test_small_copy_through_the_harness(small_copy, variant, fails):
    path, bdir = small_copy
    result, checks = harness.run_cell("chr21_small.reads", SEED, 0.2, False, device="cpu",
                                      bench_json=path, bench_dir=bdir, reference_engine=variant)
    if variant is None:
        assert result["correct"] and result["failed"] == 0, checks
    else:
        assert not result["correct"] and checks[fails] > 0, (variant, checks)

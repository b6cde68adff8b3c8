"""Tiny cells for the benchmark's CPU tests, made only of data files: a
copy of the benchmark's metric readers beside new configs/ and traffic/
files and a BENCHMARK.json that names them. Nothing of the harness is
edited to run them."""

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TINY_GENOME = {"name": "tiny", "genome_len": 20000, "k": 31, "t": 1,
               "finimizer_type": "rarest", "mean_unitig": 2000, "engine": "minimizer"}
# a repeat-dense genome decomposed into canonical de Bruijn unitigs: the
# repeat ladder's generator parameters, long enough for segmental duplications
TINY_REPEAT = {"name": "tiny_repeat", "genome_len": 80000, "k": 31, "t": 1,
               "finimizer_type": "rarest", "engine": "minimizer", "genome": "repeat",
               "repeat": {"tandem_frac": 0.2, "seg_frac": 0.35, "snp_rate": 0.004,
                          "div_rate": 0.04}}
TINY_READS = {"pool": 300, "length": {"fixed": 150}, "rc_frac": 0.5, "sub_rate": 0.005,
              "n_frac": 0.05, "warmup_reads": 64, "check_sample": 100,
              "trace": {"from": 0.75, "chunks": 1}}
# long noisy reads: enough runs a chunk to overflow merge_rle's capacity,
# so the host merge fallback serves every chunk
TINY_LONG = {"pool": 40, "length": {"lognormal_median": 800, "sigma": 0.1, "min": 700, "max": 900},
             "rc_frac": 0.5, "sub_rate": 0.025, "n_frac": 0.0, "warmup_reads": 40,
             "check_sample": 40, "trace": {"from": 0.75, "chunks": 1}}
# per-layer metrics that exist only as new files: one of the harness's
# readings, and two of a span and a counter the program would keep
# (tests stand them in by a hook on the engine)
EXTRA_METRICS = {
    "queries_per_chunk": ('''"""k-mer queries answered per chunk of the window."""


def read(run):
    return run.n_queries / run.n_chunks if run.n_chunks else None
''', "host_clock", "queries"),
    "program_encode_ms": ('''"""Mean length of the program's `program.encode` range in the profiled
window, in ms."""


def read(run):
    tr = run.trace
    ranges = tr.in_ranges("program.encode") if tr is not None else []
    return sum(e - s for s, e, _ in ranges) / len(ranges) / 1e6 if ranges else None
''', "program_span", "ms"),
    "program_encode_calls": ('''"""The engine's own count of encode calls, read after the window."""


def read(run):
    return run.engine_stats.get("counts.encode")
''', "program_counter", "calls"),
}


def make_bench(root: str, engines=("minimizer", "stream")) -> str:
    """Write the tiny cells under root; returns the BENCHMARK.json path.
    Cells: tiny_<engine>.reads, tiny_minimizer.long and tiny_repeat.reads."""
    bdir = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(BENCH_DIR, "metrics"), os.path.join(bdir, "metrics"))
    for name, (text, _, _) in EXTRA_METRICS.items():
        with open(os.path.join(bdir, "metrics", name + ".py"), "w") as f:
            f.write(text)
    os.makedirs(os.path.join(bdir, "configs"))
    os.makedirs(os.path.join(bdir, "traffic"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"], bench["workloads"] = [], []
    for engine in engines:
        name = f"tiny_{engine}"
        with open(os.path.join(bdir, "configs", name + ".json"), "w") as f:
            json.dump(dict(TINY_GENOME, name=name, engine=engine), f)
        bench["configs"].append({"name": name, "source": "test", "file": f"benchmark/configs/{name}.json",
                                 "reduced": ["genome_len"], "why": "test"})
        bench["workloads"].append({"name": f"{name}.reads", "config": name, "traffic": "tinyreads",
                                   "chips": 1, "why": "test"})
    bench["workloads"].append({"name": "tiny_minimizer.long", "config": "tiny_minimizer",
                               "traffic": "tinylong", "chips": 1, "why": "test"})
    with open(os.path.join(bdir, "configs", "tiny_repeat.json"), "w") as f:
        json.dump(TINY_REPEAT, f)
    bench["configs"].append({"name": "tiny_repeat", "source": "test",
                             "file": "benchmark/configs/tiny_repeat.json",
                             "reduced": ["genome_len"], "why": "test"})
    bench["workloads"].append({"name": "tiny_repeat.reads", "config": "tiny_repeat",
                               "traffic": "tinyreads", "chips": 1, "why": "test"})
    for name, spec in (("tinyreads", TINY_READS), ("tinylong", TINY_LONG)):
        with open(os.path.join(bdir, "traffic", name + ".json"), "w") as f:
            json.dump(spec, f)
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = cells
    for name, (_, source, unit) in EXTRA_METRICS.items():
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower", "source": source,
                                   "layer": "serving loop and output", "moves": "kmer_queries_per_s"})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path

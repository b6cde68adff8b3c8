"""One run of one cell: set-up, the measured window, the comparison that
decides `correct`, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in BENCHMARK.json: configs/<config>.json,
traffic/<traffic>.json and metrics/<metric>.py (a module with
`read(run) -> number or None`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import numbers
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from benchmark import datagen
from benchmark.reference import Reference, line
from benchmark.serve import Recorder, Sink, instrument, serve

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "finito_tpu", "bench", "bench_micro")
# every number compared is exact: its limit is 0
LIMITS = {"lines_missing": 0, "line_bytes_wrong": 0, "sample_windows_wrong": 0,
          "queries_diff": 0, "found_diff": 0, "text_writes": 0}


def load_cell(name: str, bench_json: str | None = None, bench_dir: str = BENCH_DIR):
    """The cell's entry, configuration, traffic mix and metric entries."""
    with open(bench_json or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    # a configuration's file is configs/<name>.json in the benchmark's folder
    with open(os.path.join(bench_dir, "configs", cell["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return SimpleNamespace(cell=cell, config=config, traffic=traffic, bench_dir=bench_dir,
                           end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def read_metric(bench_dir: str, name: str, run):
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def build_index(codes, ends, k: int, prefix: str) -> None:
    """The port's host index build of a unitig set (flat codes, exclusive
    ends), as `build-fmin` runs it on the .sbwt of the same unitigs,
    serialized under prefix."""
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array

    unitigs = datagen.unitig_bytes(codes, ends)
    sbwt, keys = build_plain_matrix_sbwt(unitigs, k, return_keys=True)
    index = FinimizerIndexBuilder(sbwt, lcs_array(sbwt), SeqDB.from_sequences(unitigs),
                                  node_keys=keys).get_index()
    index.serialize(prefix)


def engine_stats(engine) -> dict:
    """The numbers the engine keeps, read once the window has closed:
    each number attribute, and each dict of numbers as
    `<attribute>.<key>`, so that a metric file can read a counter the
    program adds without an edit here."""
    def num(x):
        return isinstance(x, numbers.Real) and not isinstance(x, bool)

    out = {}
    for name, v in vars(engine).items():
        if num(v):
            out[name] = v
        elif isinstance(v, dict):
            out.update((f"{name}.{key}", x) for key, x in v.items() if num(x))
    return out


def _sync(device: str):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cyclic_sum(x: np.ndarray, n: int) -> int:
    """sum of x[g % len(x)] over g < n."""
    return int((n // x.size) * x.sum() + x[: n % x.size].sum())


def compare(sink, rec, stats_text: str, n_queries: int, ref, sample: np.ndarray):
    """The numbers that decide `correct`, each against LIMITS, for the
    window's whole output: every line's byte length, the CLI's query and
    found-k-mer counts, and every window of the sampled lines."""
    W, found, nbytes, u, p, first = ref
    P = W.size
    n = int(sum(rec.n_reads))
    want_sample = set(sample.tolist())
    got_lines, len_wrong, win_wrong, bad_lines = 0, 0, 0, set()
    for blob in sink.blobs:
        nl = np.flatnonzero(np.frombuffer(blob, np.uint8) == 10)
        if nl.size == 0:
            continue
        starts = np.concatenate([[0], nl[:-1] + 1])
        g = got_lines + np.arange(nl.size)
        wrong = (nl - starts + 1) != nbytes[g % P]
        len_wrong += int(wrong.sum())
        bad_lines.update(g[wrong].tolist())
        for i in np.flatnonzero(np.isin(g, sample)).tolist():
            j = int(g[i] % P)
            a, b = int(first[j]), int(first[j] + W[j])
            want = line(u[a:b].cpu().numpy(), p[a:b].cpu().numpy())
            have = blob[starts[i] : nl[i] + 1]
            if have != want:
                x = re.findall(rb"\((-?\d+),(-?\d+)\)", have)
                y = re.findall(rb"\((-?\d+),(-?\d+)\)", want)
                win_wrong += sum(a_ != b_ for a_, b_ in zip(x, y)) + abs(len(x) - len(y))
                bad_lines.add(int(g[i]))
        got_lines += int(nl.size)
    # sampled lines that never came count as all their windows wrong
    for g in want_sample:
        if g >= got_lines:
            win_wrong += max(1, int(W[g % P]))
    k_, found_cli, q_cli = (int(x) for x in stats_text.strip().split(","))
    checks = {
        "lines_missing": abs(n - got_lines),
        "line_bytes_wrong": len_wrong,
        "sample_windows_wrong": win_wrong,
        "queries_diff": abs(n_queries - _cyclic_sum(W, n)) + abs(q_cli - n_queries),
        "found_diff": abs(found_cli - _cyclic_sum(found, n)),
        "text_writes": sink.text_writes,
    }
    failed = min(n, len(bad_lines) + abs(n - got_lines))
    return checks, n, failed


class _KOnly:
    """What the serving loop reads of an index when the engine is the
    reference's (the control): its k."""

    def __init__(self, k: int):
        self.sbwt = SimpleNamespace(get_k=lambda: k)


class ReferenceEngine:
    """The reference put in the program's place: merged_pairs_flat_begin
    and _end as the CLI calls them, answered by Reference.answer. With
    rc=False it is the control; with keep < 1 it answers only that share
    of each chunk's reads (a planted fault)."""

    def __init__(self, ref: Reference, rc: bool = True, keep: float = 1.0):
        self.ref, self.rc, self.keep = ref, rc, keep
        self.lut = np.full(256, 5, np.uint8)
        for i, c in enumerate(b"ACGT"):
            self.lut[c] = self.lut[c | 32] = i

    def merged_pairs_flat_begin(self, reads):
        reads = reads[: max(1, int(len(reads) * self.keep))]
        codes = [self.lut[np.frombuffer(r, np.uint8)] for r in reads]
        ends = np.cumsum([c.size for c in codes])
        W, found, _, u, p, _ = self.ref.answer(np.concatenate(codes), ends, rc=self.rc)
        return W, u.cpu().numpy(), p.cpu().numpy(), int(found.sum())

    def merged_pairs_flat_end(self, handle):
        W, u, p, found = handle
        return W, u, p, found, 0


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, bench_json: str | None = None,
             bench_dir: str = BENCH_DIR, engine_hook=None, reference_engine: dict | None = None):
    """Set-up, window, comparison. Returns (result dict, checks). A test
    passes engine_hook (engine -> None, may wrap its methods) to break
    the timed path; reference_engine (ReferenceEngine's keywords) serves
    from the reference instead of the program: the control and the
    planted faults of control.py."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(name, bench_json, bench_dir)
    cfg, traffic = spec.config, spec.traffic
    k = int(cfg["k"])
    # the port builds the t=1 rarest index alone: refuse a configuration it would not run
    if (int(cfg["t"]), cfg["finimizer_type"]) != (1, "rarest"):
        raise ValueError(f"configuration {cfg['name']!r}: t={cfg['t']} "
                         f"--type {cfg['finimizer_type']}; the benchmark builds t=1 rarest only")
    work = tempfile.mkdtemp(prefix="finito-bench-")
    try:
        genome, unitigs = datagen.genome_and_unitigs(seed, cfg)
        codes, ends = datagen.gen_reads(np.random.default_rng([seed, 1]), genome, traffic)
        # the warm-up file holds the pool's first reads, one chunk's worth
        warm, pool = os.path.join(work, "warm.fq"), os.path.join(work, "pool.fq")
        warm_n = min(int(traffic["warmup_reads"]), ends.size)
        for path, n in ((warm, warm_n), (pool, ends.size)):
            with open(path, "wb") as f:
                f.write(datagen.fastq_bytes(codes[: ends[n - 1]], ends[:n]))
        t0 = time.perf_counter()
        if reference_engine is not None:
            index = _KOnly(k)
            engine = ReferenceEngine(Reference.of_unitigs(*unitigs, k, device), **reference_engine)
        else:
            from finito_tpu_torch import native
            from finito_tpu_torch.index.index import FinimizerIndex
            from finito_tpu_torch.query.engine import DeviceQueryEngine

            if native.get_lib() is None:
                raise RuntimeError("the program's native library did not load: "
                                   "format_pairs would take the Python formatter")
            build_index(*unitigs, k, os.path.join(work, "idx"))
            t0 = time.perf_counter()
            index = FinimizerIndex.load(os.path.join(work, "idx"))
            engine = DeviceQueryEngine(index, mode=cfg["engine"], device=device)
        _sync(device)
        engine_init_s = time.perf_counter() - t0
        # warm-up: the first chunk of the pool through the same loop
        from finito_tpu_torch import cli
        from finito_tpu_torch.io.fastx import SequenceReader

        with SequenceReader(warm) as reader:
            cli._run_queries_streaming(reader, Sink(Recorder(False)), index,
                                       os.path.join(work, "warm.stats"), engine)
        if engine_hook is not None:
            engine_hook(engine)
        _sync(device)
        tr = traffic["trace"]
        rec = Recorder(trace, float(tr["from"]) * seconds, int(tr["chunks"]))
        instrument(engine, rec)
        stats_path = os.path.join(work, "window.stats")
        sink, clock, n_queries = serve(engine, index, pool, seconds, stats_path, rec)
        _sync(device)
        cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        window_s = clock["t_last"] - clock["t_first"]
        with open(stats_path) as f:
            stats_text = f.read()
        front_m = getattr(getattr(engine, "_dmi", None), "m", None)
        stats = engine_stats(engine)
        del engine, index
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        trace_obj = None
        if rec.kineto is not None:
            from benchmark.trace import from_kineto

            trace_obj = from_kineto(rec.kineto)
            log(f"info: trace {trace_obj.window_s:.3f} s from chunk {rec.first_profiled}, "
                f"{len(trace_obj.ops)} device operations ({trace_obj.unlinked} unlinked), "
                f"{len(trace_obj.in_ranges('bench.locate'))} locate ranges for "
                f"{len(rec.locate_shapes)} locate calls {rec.locate_shapes[:2]}")
        # the per-chunk readings come from the chunks before the profiler started
        lat = [w - b for c, (b, w) in enumerate(zip(rec.t_begin, sink.t_write))
               if rec.unprofiled(c)] if not sink.text_writes else []
        spans = {name: [dt for c, dt in v if rec.unprofiled(c)] for name, v in rec.spans.items()}
        run = SimpleNamespace(
            n_queries=n_queries, window_s=window_s, setup_s=clock["t_first"] - t_start,
            chunk_latency_s=lat, peak_bytes=peak, engine_init_s=engine_init_s,
            spans=spans, n_chunks=len(rec.t_begin), trace=trace_obj, k=k, front_m=front_m,
            locate_shapes=rec.locate_shapes, counters=rec.counters, engine_stats=stats)
        # the comparison, after the window and with the program's state freed
        t_ref = time.perf_counter()
        ref_out = Reference.of_unitigs(*unitigs, k, device).answer(codes, ends)
        n_served = int(sum(rec.n_reads))
        rng = np.random.default_rng([seed, 2])
        n_sample = min(int(traffic["check_sample"]), n_served)
        sample = np.union1d(rng.choice(n_served, size=n_sample, replace=False),
                            [0, max(n_served - 1, 0)]) if n_served else np.zeros(0, np.int64)
        checks, attempted, failed = compare(sink, rec, stats_text, n_queries, ref_out, sample)
        log(f"info: reads {attempted}, chunks {run.n_chunks}, queries {n_queries}, "
            f"window {window_s:.3f} s, reference and comparison "
            f"{time.perf_counter() - t_ref:.3f} s, sampled lines {sample.size}, "
            f"counters {rec.counters}, binary writes {sink.binary_writes}, builds this run "
            f"{_builds()}, files written {_bytes_under(work) / 2**20:.1f} MiB")
        n_un = sum(map(rec.unprofiled, range(run.n_chunks)))
        log(f"info: host ms a chunk over the {n_un} chunks before any profiler: "
            + ", ".join(f"{n} {sum(v) / max(1, n_un) * 1e3:.3f}" for n, v in spans.items())
            + f" ({len(spans.get('gc', []))} collections); chunk period p50 "
            f"{np.median(np.diff(rec.t_begin)) * 1e3 if run.n_chunks > 1 else 0:.3f}, latency p95 "
            f"{np.percentile(lat, 95) * 1e3 if lat else 0:.3f}")
        metrics = {}
        for m in (spec.per_layer if trace else spec.end_to_end):
            v = read_metric(spec.bench_dir, m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}
        if cuda:
            device_info["power_limit"] = _power_limit()
        result = {"correct": all(checks[c] <= LIMITS[c] for c in LIMITS),
                  "attempted": attempted, "failed": failed, "metrics": metrics,
                  "device": device_info}
        if trace_obj is not None:
            device_info["busy_s"] = trace_obj.busy_s()
            device_info["window_s"] = trace_obj.window_s
            result["breakdown"] = trace_obj.breakdown()
        result["counters"] = dict(rec.counters, chunks=run.n_chunks)
        result["checks"] = {c: {"value": checks[c], "limit": LIMITS[c]} for c in LIMITS}
        return result, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)


def log(line: str) -> None:
    sys.stderr.write(line + "\n")


def _builds() -> dict:
    """Seconds of the program's nvcc and g++ builds in this process (none
    when both libraries came from the checkout's build directory)."""
    out = {}
    for mod in ("finito_tpu_torch.ops._build", "finito_tpu_torch.native"):
        info = getattr(sys.modules.get(mod), "build_info", {})
        if "seconds" in info:
            out[mod.split(".")[-1]] = info["seconds"]
    return out


def _bytes_under(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    spec = load_cell(args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"benchmark: needs {chips} CUDA device(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=t_start)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"benchmark: forbidden modules loaded: {', '.join(bad)}\n")
        return 3
    for c in LIMITS:
        sys.stderr.write(f"check {c} = {checks[c]} (limit {LIMITS[c]})\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

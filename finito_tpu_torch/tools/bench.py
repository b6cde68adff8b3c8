"""The headline benchmark's ladder, the port's twin of bench.py: k-mer
localization throughput of the device-resident pipeline on synthetic
DSPSS indexes, one row per genome size and per extra row.

  python -m finito_tpu_torch.tools.build_cache --genome 16000000
  python -m finito_tpu_torch.tools.bench --genome 400000 \\
      --ladder 400000,16000000 --extra-rows replica,stream,repeat,k63

Prints bench.py's one JSON line, with its keys and its row fields:
  {"metric": ..., "value": N, "unit": "kmer_queries/sec",
   "vs_baseline": N, "ladder": [...]}
The headline value is the first rung's. --ladder auto adds every larger
size cached under --cache-dir (build/finito_tpu_torch/bench_cache/ by
default, never the JAX package's .bench_cache/); off measures --genome
only; a comma list pins the sizes. Each rung draws its reads from
np.random.default_rng(0) as bench.py does, so every field but the times
equals JAX's for the same arguments. --device is cuda by default; a card
asked for and missing gives the "device unreachable" line and exit 1.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from finito_tpu_torch.tools import device, sync
from finito_tpu_torch.tools.cache import DEFAULT_CACHE, load_or_build_index

NORTH_STAR_PER_CHIP = 100e6 / 16
METRIC = "kmer_localization_throughput_1chip"
UNIT = "kmer_queries/sec"
EXTRA_ROWS = ("replica", "stream", "repeat", "k63")

_LAST_PROGRESS = [time.monotonic()]


def _log(msg: str) -> None:
    _LAST_PROGRESS[0] = time.monotonic()
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def _emit(ladder, error: str | None = None) -> None:
    """Print the one-line result from the rows measured so far. The
    headline value is always the first rung's."""
    head = ladder[0] if ladder and "qps" in ladder[0] else None
    out = {
        "metric": METRIC,
        "value": head["qps"] if head else 0.0,
        "unit": UNIT,
        "vs_baseline": head["vs_baseline"] if head else 0.0,
        "ladder": ladder,
    }
    if error:
        out["error"] = error
    print(json.dumps(out), flush=True)


def start_stall_watchdog(ladder, stall_s: float, poll_s: float = 20.0) -> threading.Event:
    """A daemon thread that, after stall_s seconds with no _log progress,
    emits the partial ladder with an error and hard-exits with code 3:
    a call that blocks in native code is bounded and still reports the
    rows measured. Set the returned Event to stop it (main does so when
    it returns). poll_s is the thread's polling period; only the test
    sets it."""
    stop = threading.Event()

    def watch():
        while not stop.wait(poll_s):
            idle = time.monotonic() - _LAST_PROGRESS[0]
            if idle > stall_s:
                _log(f"no progress for {idle:.0f}s; emitting {len(ladder)} measured rungs "
                     "and exiting")
                _emit(ladder, error=f"stalled: no progress for {idle:.0f}s")
                os._exit(3)

    threading.Thread(target=watch, daemon=True).start()
    return stop


def _analytic_expected(index, genome, cuts, starts, mi, mj, k: int, B: int, n_win: int):
    """The closed-form DSPSS answer of every window (bench.py's): a k-mer
    occurs once, in the unitig whose cut range holds its genome start;
    the builder's unitig order is recovered from the first k-mers."""
    ends_u = np.asarray(index.unitigs.ends)
    concat_u = np.asarray(index.unitigs.concat)
    ustart = np.concatenate([[0], ends_u[:-1]])
    pw = np.uint64(1) << (np.uint64(2) * np.arange(k, dtype=np.uint64))
    first_perm = concat_u[ustart[:, None] + np.arange(k)].astype(np.uint64) @ pw
    first_orig = genome[cuts[:-1, None] + np.arange(k)].astype(np.uint64) @ pw
    o1, o2 = np.argsort(first_orig), np.argsort(first_perm)
    if not np.array_equal(first_orig[o1], first_perm[o2]):
        raise AssertionError("unitig sets differ")
    perm = np.empty(cuts.size - 1, np.int64)
    perm[o1] = o2
    g = starts[:, None] + np.arange(n_win)
    io = np.searchsorted(cuts, g.reshape(-1), side="right").reshape(g.shape) - 1
    io = np.minimum(io, cuts.size - 2)
    absent = np.zeros((B, n_win), bool)
    rel = mj[:, None] - np.arange(n_win)[None, :]
    np.logical_or.at(absent, mi, (rel >= 0) & (rel < k))
    return np.where(absent, -1, perm[io]), np.where(absent, -1, g - cuts[io])


def run_rung(genome_len: int, args, rng, workload: str = "uniform",
             engine_mode: str | None = None) -> dict:
    """Build or load one index, measure the device-resident pipeline's
    steady-state throughput on args.device, verify its answers (args.verify
    reads against FinimizerIndex.search, every window against the
    analytic or merge-join oracle where one applies) and return the row."""
    from finito_tpu_torch.io.seqdb import decode_seq
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    dev = torch.device(args.device)
    engine_mode = engine_mode or args.engine
    t_start = time.perf_counter()
    genome, index, build_s, cuts = load_or_build_index(
        genome_len, args.k, args.cache_dir, rng, workload=workload)

    t0 = time.perf_counter()
    mcache = None
    if args.cache_dir and engine_mode == "minimizer":
        wtag = "g" if workload == "uniform" else "repg"
        mcache = os.path.join(args.cache_dir, f"midx_{wtag}{genome_len}_k{args.k}.ftmidx")
    engine = DeviceQueryEngine(index, mode=engine_mode, mindex_cache=mcache, chunk=args.chunk,
                               device=dev)
    _log(f"engine init (incl. position table) {time.perf_counter() - t0:.1f}s")

    B, L = args.batch, args.read_len
    starts = rng.integers(0, genome_len - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(args.mutate * reads.size)
    mi = rng.integers(0, B, size=n_mut)
    mj = rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4

    # stream and replica count repair segments, not windows: start small
    frac0 = 0.02 if engine_mode in ("stream", "replica") else 0.10
    pipe = engine.make_device_pipeline(B, L, unknown_frac=frac0)
    reads_dev = torch.from_numpy(reads).to(dev)
    out = pipe(reads_dev)
    n_unknown = int(out[2])
    if engine_mode in ("stream", "minimizer", "replica") and not (pipe.K // 2 <= n_unknown <= pipe.K):
        frac = max(0.005, 1.3 * n_unknown / (B * (L - args.k + 1)))
        _log(f"resizing slow path: {n_unknown} -> frac {frac:.4f}")
        pipe = engine.make_device_pipeline(B, L, unknown_frac=frac)
        out = pipe(reads_dev)
        n_unknown = int(out[2])
    if n_unknown > pipe.K:
        raise AssertionError("pipeline slow-path overflow after resize")
    if len(out) > 3 and pipe.K_heads:
        n_heads = int(out[3])
        if n_heads > pipe.K_heads:
            raise AssertionError(f"run-head capacity overflow: {n_heads} > {pipe.K_heads}")
    uid = out[0].cpu().numpy()
    off_h = out[1].cpu().numpy()
    n_win = uid.shape[1]
    found_frac = float(np.mean(uid >= 0))

    n_verify = max(1, min(args.verify, B))
    t0 = time.perf_counter()
    for b in range(0, B, max(1, B // n_verify))[:n_verify]:
        res = index.search(decode_seq(reads[b])).local_offsets
        got = [(int(uid[b, w]), int(off_h[b, w])) for w in range(n_win)]
        if got != res:
            raise AssertionError(f"mismatch vs oracle at read {b}")
    _log(f"verified {n_verify} reads x {n_win} windows vs host oracle "
         f"in {time.perf_counter() - t0:.1f}s")

    n_analytic = 0
    expected, oracle = None, None
    t0 = time.perf_counter()
    if cuts is not None and args.k <= 32:
        expected = _analytic_expected(index, genome, cuts, starts, mi, mj, args.k, B, n_win)
        oracle = "the analytic DSPSS oracle"
    elif workload == "repeat" and args.k <= 32:
        from finito_tpu_torch.utils.synth import kmer_location_oracle

        expected = kmer_location_oracle(np.asarray(index.unitigs.concat),
                                        np.asarray(index.unitigs.ends), reads, args.k)
        oracle = "the merge-join oracle"
    if expected is not None:
        if not (np.array_equal(uid, expected[0]) and np.array_equal(off_h, expected[1])):
            raise AssertionError(f"device engine disagrees with {oracle}")
        n_analytic = B * n_win
        _log(f"verified ALL {B} reads x {n_win} windows vs {oracle} "
             f"in {time.perf_counter() - t0:.1f}s")

    def chained():
        # every rep's answers feed one device checksum, read once at the end
        s = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(args.reps):
            o = pipe(reads_dev)
            s = s + o[0].sum(dtype=torch.int64) + o[1].sum(dtype=torch.int64)
        return int(s)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=acts) as prof:
            chained()
        trace = os.path.join(args.profile, f"bench_{engine_mode}_{genome_len}_k{args.k}.json")
        prof.export_chrome_trace(trace)
        _log(f"torch.profiler trace written to {trace}")
    sync(dev)
    dt = float("inf")
    for _ in range(args.trials):
        t0 = time.perf_counter()
        chained()
        dt = min(dt, time.perf_counter() - t0)
    qps = args.reps * B * n_win / dt

    _log(f"genome {genome_len}: {B} reads x {n_win} windows x {args.reps} reps "
         f"in {dt:.3f}s; found fraction {found_frac:.3f}; "
         f"rung wall {time.perf_counter() - t_start:.1f}s")
    return {
        "genome": genome_len,
        "k": args.k,
        "qps": round(qps, 1),
        "vs_baseline": round(qps / NORTH_STAR_PER_CHIP, 4),
        "found_frac": round(found_frac, 4),
        "oracle_verified_reads": n_verify,
        "analytic_verified_windows": n_analytic,
        "verified_windows": n_analytic + n_verify * n_win,
        "n_nodes": int(index.sbwt.number_of_subsets()),
        "build_or_load_s": round(build_s, 1),
        "engine": engine_mode,
        "workload": workload,
        "slow_frac": round(n_unknown / (B * n_win), 4),
    }


def _cached_sizes(cache_dir: str | None, k: int) -> list:
    """The genome sizes of the uniform entries cached for k."""
    if not (cache_dir and os.path.isdir(cache_dir)):
        return []
    found = (re.match(rf"idx_g(\d+)_k{k}\.sbwt$", f) for f in os.listdir(cache_dir))
    return [int(m.group(1)) for m in found if m]


def _probe(name: str) -> str | None:
    """One allocation and a synchronize on the device, in a subprocess
    bounded at 600 s; the failure's type name, or None."""
    code = (f"import torch; d = torch.device({name!r}); "
            "torch.ones(1, device=d); torch.cuda.synchronize(d)")
    try:
        subprocess.run([sys.executable, "-c", code], timeout=600, check=True,
                       capture_output=True)
    except (subprocess.SubprocessError, OSError) as e:
        tail = getattr(e, "stderr", b"") or b""
        if tail:
            _log(f"probe stderr tail: ...{tail[-400:].decode(errors='replace')}")
        return type(e).__name__
    return None


def _card_name(name: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, so that
    every number of a run can be written down beside them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (subprocess.SubprocessError, OSError):
        smi = ""
    return smi or f"{torch.cuda.get_device_name(name)} (no nvidia-smi)"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome", type=int, default=400_000, help="synthetic genome length")
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--batch", type=int, default=8192, help="reads per device batch")
    p.add_argument("--read-len", type=int, default=128)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--trials", type=int, default=3, help="the fastest trial is kept")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one timed trial into DIR")
    p.add_argument("--mutate", type=float, default=0.005)
    p.add_argument("--engine", default="minimizer",
                   choices=["minimizer", "stream", "dense", "replica"])
    p.add_argument("--chunk", type=int, default=None,
                   help="stream/replica scan-chunk length (None = auto, 0 = off)")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE,
                   help="cache of genomes and indexes per (genome, k)")
    p.add_argument("--ladder", default="auto",
                   help="'auto': --genome plus any larger cached size; 'off': only "
                   "--genome; or a comma list of sizes")
    p.add_argument("--stall-timeout", type=float, default=1800,
                   help="seconds without progress before the watchdog emits the partial "
                   "ladder and exits 3; 0 disables")
    p.add_argument("--verify", type=int, default=8,
                   help="reads per rung checked against FinimizerIndex.search")
    p.add_argument("--extra-rows", default=",".join(EXTRA_ROWS),
                   help="comma list from {replica, stream, repeat, k63}; '' or 'off' "
                   "disables")
    p.add_argument("--repeat-genome", type=int, default=4_000_000,
                   help="repeat-workload genome length")
    p.add_argument("--device", default="cuda", help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)

    from finito_tpu_torch.utils import tune_host_allocator

    tune_host_allocator()
    if torch.device(args.device).type != "cpu":
        failed = _probe(args.device)
        if failed is None:
            try:
                device(args.device)
            except RuntimeError:
                failed = "RuntimeError"
        if failed:
            _log(f"device probe failed ({failed})")
            print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT,
                              "vs_baseline": 0.0, "error": f"device unreachable: {failed}"}))
            return 1
        _log(f"card: {_card_name(args.device)}")

    sizes = [args.genome]
    if args.ladder == "auto":
        sizes = sorted({args.genome, *(g for g in _cached_sizes(args.cache_dir, args.k)
                                       if g > args.genome)})
    elif args.ladder != "off":
        sizes = sorted({int(x) for x in args.ladder.split(",")})

    t_all = time.perf_counter()
    ladder = []
    stop = None
    if args.stall_timeout > 0:
        _LAST_PROGRESS[0] = time.monotonic()
        stop = start_stall_watchdog(ladder, args.stall_timeout)
    try:
        for g in sizes:
            rng = np.random.default_rng(0)  # each rung's own stream (cache replay)
            try:
                ladder.append(run_rung(g, args, rng))
            except Exception as e:  # a later rung's failure keeps the rows measured
                if g == sizes[0]:
                    raise
                _log(f"rung {g} failed ({type(e).__name__}: {e}); keeping "
                     f"{len(ladder)} measured rungs")
                ladder.append({"genome": g, "error": f"{type(e).__name__}: {e}"})

        wanted = args.extra_rows.split(",")
        extra = [
            ("replica", args.genome, args.k, "uniform", "replica"),
            ("stream", args.genome, args.k, "uniform", "stream"),
            ("repeat", args.repeat_genome, args.k, "repeat", args.engine),
        ]
        if "k63" in wanted and args.k != 63:
            k63 = _cached_sizes(args.cache_dir, 63)
            if k63:
                extra.append(("k63", max(k63), 63, "uniform", args.engine))
            else:
                _log("no cached k63 index; skipping the k63 extra row")
        for label, g, kk, wl, eng in extra:
            if label not in wanted:
                continue
            rng = np.random.default_rng(0)
            a = copy.copy(args)
            a.k = kk
            try:
                ladder.append(run_rung(g, a, rng, workload=wl, engine_mode=eng))
            except Exception as e:
                _log(f"extra row {label} failed ({type(e).__name__}: {e})")
                ladder.append({"genome": g, "k": kk, "engine": eng, "workload": wl,
                               "error": f"{type(e).__name__}: {e}"})
    finally:
        if stop is not None:
            stop.set()
    _log(f"ladder of {len(ladder)} rungs; total wall {time.perf_counter() - t_all:.1f}s")
    _emit(ladder)
    return 0


if __name__ == "__main__":
    sys.exit(main())

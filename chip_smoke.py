#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (finito_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Drives the port's main paths, ``search-fmin --engine minimizer`` and
``kmer-mapper query``, on one device through the port's CLI, at
realistic index sizes, and checks every answer. Phases, one line or
more each:

  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the CUDA kernels from the checkout's sources;
  3. kernel: the front-end kernel against its plain PyTorch version on
     the card, bit for bit, at the main path's shapes and a long-read
     shape; kernel and plain times (CUDA events);
  4. per index (1 Mbp: fused slot rows, v1 locate; 4,641,652 bp, E. coli
     K-12 MG1655's length: narrow descriptor, v2 locate): a random genome
     cut into unitigs with k-1 overlaps (bench.gen_dspss, k=31),
     sbwt-build and build-fmin through the port's CLI, 16,384 mutated
     128 bp reads plus short and N-containing reads;
     a. search-fmin --device cuda, the locate form it ran, every window
        checked against the analytic DSPSS oracle and sampled reads
        against the host oracle FinimizerIndex.search;
     b. the four locate forms (v1, v2 and their occurrence-counting
        forms) on one (8192, 128) CLI chunk: equal answers, cnt equal to
        the found flag (each k-mer of a DSPSS occurs once), ms per batch
        (CUDA events), the slow-path and run-head counts and capacities;
     c. kmer-mapper build and query -r --device cuda on the same reads:
        every window against the analytic oracle (unitig ids in the colex
        order of their first k-mers), short/N and sampled reads against
        query --host-exact, windows/s; then the multi-occurrence error
        (one unitig stored twice) under both locate forms: exit code 1.

Prints the kernels' JSON line, then, last, {"ok": true, "device": ...}.
Any failure raises, and the exit code is then not 0. It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K = 31
GENOMES = (1_000_000, 4_641_652)
READ_LEN = 128
N_READS = 16384  # genome reads per index: 4 CLI chunks of 4096
MUTATE = 0.005
DEVICE = "cuda"
KERNEL_CASES = [(8192, 128, 31, 16), (8192, 128, 21, 12), (8192, 128, 63, 28),
                (8192, 128, 95, 16), (64, 4096, 31, 16)]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call over reps launches, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def padded_codes(rng, B: int, L: int) -> np.ndarray:
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    n_pad = max(25, B * L // 400)
    codes[rng.integers(0, B, n_pad), rng.integers(0, L, n_pad)] = 255
    return codes


def kernel_phase(rng) -> dict:
    """Front-end kernel vs its plain version on the card, bit for bit."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows, minimizer_windows_ref

    max_err = 0
    for B, L, k, m in KERNEL_CASES:
        codes = torch.from_numpy(padded_codes(rng, B, L)).cuda()
        got = minimizer_windows(codes, k, m)
        torch.cuda.synchronize()
        want = minimizer_windows_ref(codes, k, m)
        errs = [int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want)]
        max_err = max(max_err, *errs)
        log(f"kernel (B={B}, L={L}, k={k}, m={m}): max_abs_err {max(errs)} "
            f"({'bit-exact' if max(errs) == 0 else 'MISMATCH'})")
        if max(errs):
            raise AssertionError(f"front-end kernel disagrees with the plain version at {(B, L, k, m)}")
    codes = torch.from_numpy(padded_codes(rng, 8192, 128)).cuda()
    ms = time_cuda(lambda: minimizer_windows(codes, K, 16))
    plain_ms = time_cuda(lambda: minimizer_windows_ref(codes, K, 16))
    log(f"kernel time (8192, 128) k=31 m=16: kernel {ms} ms, plain {plain_ms} ms "
        "(CUDA events, mean of 50 after warm-up)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def build_index(genome_len: int, seed: int, work: str):
    """DSPSS genome -> unitig FASTA -> sbwt-build + build-fmin through the
    port's CLI. Returns (genome, cuts, index prefix)."""
    from bench import gen_dspss

    from finito_tpu_torch import cli

    t0 = time.perf_counter()
    genome, unitigs, cuts = gen_dspss(np.random.default_rng(seed), genome_len, K,
                                      return_cuts=True)
    fna = os.path.join(work, "unitigs.fna")
    with open(fna, "wb") as f:
        for i, u in enumerate(unitigs):
            f.write(b">%d\n%s\n" % (i, u))
    sbwt, prefix = os.path.join(work, "x.sbwt"), os.path.join(work, "idx")
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["sbwt-build", "-i", fna, "-o", sbwt, "-k", str(K)]) != 0:
            raise RuntimeError("sbwt-build failed")
        if cli.main(["build-fmin", "-o", prefix, "-i", sbwt, "-u", fna]) != 0:
            raise RuntimeError("build-fmin failed")
    log(f"index {genome_len} bp: {len(unitigs)} unitigs, host build "
        f"{time.perf_counter() - t0} s (gen_dspss + sbwt-build + build-fmin)")
    return genome, cuts, prefix


def make_queries(rng, genome: np.ndarray, n_reads: int, path: str):
    """Reads sampled from the genome with point mutations (as bench.py),
    then short and N-containing reads. Returns (starts, mutations, extra
    reads as bytes)."""
    from finito_tpu.io.seqdb import decode_seq

    starts = rng.integers(0, genome.size - READ_LEN, size=n_reads)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]].copy()
    n_mut = int(MUTATE * reads.size)
    mi = rng.integers(0, n_reads, size=n_mut)
    mj = rng.integers(0, READ_LEN, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
    extra = []
    for n in (1, 10, K - 1, K, K + 1):  # short reads and the k boundary
        s = int(rng.integers(0, genome.size - n))
        extra.append(decode_seq(genome[s : s + n]))
    for j in (0, 40, 127):  # an N inside an otherwise present read
        s = int(rng.integers(0, genome.size - READ_LEN))
        r = bytearray(decode_seq(genome[s : s + READ_LEN]))
        r[j] = ord("N")
        extra.append(bytes(r))
    with open(path, "wb") as f:
        for i in range(n_reads):
            f.write(b">r%d\n%s\n" % (i, decode_seq(reads[i])))
        for i, r in enumerate(extra):
            f.write(b">x%d\n%s\n" % (i, r))
    return starts, (mi, mj), extra, reads


def parse_output(path: str, n_lines: int):
    """search-fmin output -> list of (n, 2) int64 arrays, one per line."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines[-1] != b"" or len(lines) != n_lines + 1:
        raise AssertionError(f"expected {n_lines} output lines, got {len(lines) - 1}")
    out = []
    for line in lines[:-1]:
        nums = np.array(line.translate(None, b"()").replace(b",", b" ").split(), np.int64)
        out.append(nums.reshape(-1, 2))
    return out


def analytic_expected(concat_u, ends_u, genome, cuts, starts, mutations):
    """Every window of every genome read, closed form (bench.py's DSPSS
    oracle): a k-mer occurs once, in the unitig whose cut range holds its
    genome start; windows covering a mutation are absent (forward, and
    their reverse complement with probability ~1 - n/4^k). The unitig
    ids are those of the index whose unitig text is concat_u/ends_u."""
    B, n_win = starts.size, READ_LEN - K + 1
    ends_u = np.asarray(ends_u)
    concat_u = np.asarray(concat_u)
    ustart = np.concatenate([[0], ends_u[:-1]])
    pw = np.uint64(1) << (np.uint64(2) * np.arange(K, dtype=np.uint64))
    first_perm = concat_u[ustart[:, None] + np.arange(K)].astype(np.uint64) @ pw
    first_orig = genome[cuts[:-1, None] + np.arange(K)].astype(np.uint64) @ pw
    o1, o2 = np.argsort(first_orig), np.argsort(first_perm)
    if not np.array_equal(first_orig[o1], first_perm[o2]):
        raise AssertionError("unitig sets differ")
    perm = np.empty(cuts.size - 1, np.int64)
    perm[o1] = o2
    g = starts[:, None] + np.arange(n_win)
    io_ = np.minimum(np.searchsorted(cuts, g.reshape(-1), side="right").reshape(g.shape) - 1,
                     cuts.size - 2)
    uid, off = perm[io_], g - cuts[io_]
    mi, mj = mutations
    absent = np.zeros((B, n_win), bool)
    rel = mj[:, None] - np.arange(n_win)[None, :]
    np.logical_or.at(absent, mi, (rel >= 0) & (rel < K))
    return np.stack([np.where(absent, -1, uid), np.where(absent, -1, off)], axis=-1)


def oracle_line(index, read: bytes) -> np.ndarray:
    """The merged output line of one read under the host oracle
    (reference merge rule, search_fmin.hh:62-71)."""
    from finito_tpu.io.fastx import reverse_complement

    with contextlib.redirect_stderr(io.StringIO()):  # it reports non-ACGT reads
        fwd = index.search(read).local_offsets
        rc = index.search(reverse_complement(read)).local_offsets
    pairs = [p if p[0] != -1 else rc[len(read) - K - i] for i, p in enumerate(fwd)]
    return np.array(pairs, np.int64).reshape(-1, 2)


@contextlib.contextmanager
def forms_picked(module):
    """Records the locate form (True for v2) that module.pick_v2 returns
    while the block runs."""
    picked, pick = [], module.pick_v2

    def spy(dmi):
        picked.append(pick(dmi))
        return picked[-1]

    module.pick_v2 = spy
    try:
        yield picked
    finally:
        module.pick_v2 = pick


def settle(dmi, codes, v2: bool, count: bool):
    """One locate form at the capacities its caller's rule settles on
    (the engine's; kmer-mapper's slow divisors for the counting forms).
    Returns (locate, outputs, counters)."""
    from finito_tpu_torch.query.minimizer_engine import (
        make_minimizer_locate,
        make_minimizer_locate_v2,
    )
    from finito_tpu_torch.query.minimizer_tables import grow_capacities, initial_capacities

    B, L = codes.shape
    BW = B * (L - K + 1)
    K_slow, K_heads = initial_capacities(BW, v2, ((128 if v2 else 16) if count else None))
    while True:
        locate = (make_minimizer_locate_v2(dmi, K_slow, K_heads, count_occurrences=count) if v2
                  else make_minimizer_locate(dmi, K_slow, count_occurrences=count))
        out = locate(codes)
        n_slow, n_heads = int(out[2]), (int(out[3]) if v2 else 0)
        grown = grow_capacities(K_slow, K_heads, n_slow, n_heads, BW)
        if grown is None:
            return locate, out, {"n_slow": n_slow, "K_slow": K_slow,
                                 **({"n_heads": n_heads, "K_heads": K_heads} if v2 else {})}
        K_slow, K_heads = grown


def locate_forms(index, codes_both: np.ndarray) -> dict:
    """v1, v2 and both counting forms on one (8192, 128) CLI chunk on the
    card: equal answers, ms per batch (CUDA events), counters."""
    import torch

    from finito_tpu_torch.query.engine import DeviceQueryEngine, _pad_codes

    torch.cuda.reset_peak_memory_stats()
    eng = DeviceQueryEngine(index, device=DEVICE)
    codes = eng._to_device(_pad_codes(codes_both))
    B, L = codes.shape
    res = {"windows": B * (L - K + 1), "slot_rows": eng._dmi.slot_rows is not None,
           "engine_form": "v2" if eng.use_v2 else "v1"}
    outs = {}
    for name, v2, count in (("v1", False, False), ("v2", True, False),
                            ("v1-count", False, True), ("v2-count", True, True)):
        locate, out, counters = settle(eng._dmi, codes, v2, count)
        outs[name] = out
        res[name] = {"ms": time_cuda(lambda: locate(codes), reps=20, warmup=3), **counters}
    uid, off = outs["v1"][:2]
    for name in ("v2", "v1-count", "v2-count"):
        if not (torch.equal(outs[name][0], uid) and torch.equal(outs[name][1], off)):
            raise AssertionError(f"locate {name} disagrees with v1 on (uid, off)")
    cnt1, cnt2 = outs["v1-count"][3], outs["v2-count"][4]
    if not torch.equal(cnt1, cnt2):
        raise AssertionError("the counting forms of v1 and v2 disagree on cnt")
    if not torch.equal(cnt1, (uid >= 0).to(torch.int32)):
        raise AssertionError("cnt differs from the found flag on a DSPSS (each k-mer occurs once)")
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return res


def run_counted(main, argv):
    """One CLI call of a main path with the front-end kernel's launch
    count set to 0 just before it and read just after. Returns (exit
    code, stderr text, wall seconds, launches)."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows

    torch.cuda.synchronize()
    minimizer_windows.launches = 0
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    wall = time.perf_counter() - t0
    return rc, err.getvalue(), wall, minimizer_windows.launches


def search_phase(genome_len, prefix, qpath, work, check):
    """search-fmin through the port's CLI, its output held to check.
    Returns (its kernel launches, the loaded FinimizerIndex)."""
    from finito_tpu.index.index import FinimizerIndex

    from finito_tpu_torch import cli
    from finito_tpu_torch.query import engine

    opath = os.path.join(work, "out.txt")
    with forms_picked(engine) as picked:
        rc, logs, wall, launches = run_counted(
            cli.main, ["search-fmin", "-o", opath, "-i", prefix, "-q", qpath, "--device", DEVICE])
    if rc != 0:
        raise RuntimeError(f"search-fmin failed:\n{logs}")
    form = "v2" if picked == [True] else "v1" if picked == [False] else f"? {picked}"
    us_io = re.findall(r"us/query: (\S+) \(excluding I/O etc\)", logs)
    us_e2e = re.findall(r"us/query end-to-end: (\S+)", logs)
    n_q = re.findall(r"total number of queries: (\d+)", logs)
    log(f"search-fmin {genome_len} bp: locate {form}, wall {wall} s, {n_q[-1]} queries, us/query "
        f"{us_io[-1]} (excluding I/O), {us_e2e[-1]} (end to end), "
        f"front-end kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("search-fmin did not launch the front-end kernel")
    if form != ("v2" if genome_len == GENOMES[1] else "v1"):
        raise AssertionError(f"search-fmin ran locate {form} at {genome_len} bp")

    index = FinimizerIndex.load(prefix)
    check(f"search-fmin {genome_len} bp", opath, index.unitigs.concat, index.unitigs.ends,
          lambda reads: [oracle_line(index, r) for r in reads])
    return launches, index


def kmer_mapper_phase(genome_len, fna, qpath, work, check, n_win) -> int:
    """kmer-mapper build and query -r --device cuda through the port's
    CLI, its output held to check; then the multi-occurrence error.
    Returns the query's kernel launches."""
    from finito_tpu.index.minimizer import MinimizerIndex
    from finito_tpu.io.fastx import read_all_records

    from finito_tpu_torch import cli, kmer_mapper

    km, kout = os.path.join(work, "km.idx"), os.path.join(work, "km.txt")
    t0 = time.perf_counter()
    rc, logs, _, _ = run_counted(cli.main, ["kmer-mapper", "build", "-u", fna, "-k", str(K),
                                            "-o", km])
    if rc != 0:
        raise RuntimeError(f"kmer-mapper build failed:\n{logs}")
    log(f"kmer-mapper build {genome_len} bp: {time.perf_counter() - t0} s")
    with forms_picked(kmer_mapper) as picked:
        rc, logs, wall, launches = run_counted(
            cli.main, ["kmer-mapper", "query", "-i", km, "-q", qpath, "-r", "-o", kout,
                       "--device", DEVICE])
    if rc != 0:
        raise RuntimeError(f"kmer-mapper query failed:\n{logs}")
    form = "v2" if picked == [True] else "v1" if picked == [False] else f"? {picked}"
    log(f"kmer-mapper query -r {genome_len} bp: locate {form}, wall {wall} s, {n_win} windows, "
        f"{n_win / wall} windows/s (both strands, incl. index load and output), "
        f"front-end kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("kmer-mapper query did not launch the front-end kernel")

    mindex = MinimizerIndex.load(km)

    def host_exact(reads):
        sub, sub_out = os.path.join(work, "sub.fna"), os.path.join(work, "sub.txt")
        with open(sub, "wb") as f:
            f.write(b"".join(b">s%d\n%s\n" % (i, r) for i, r in enumerate(reads)))
        rc, logs, _, _ = run_counted(cli.main, ["kmer-mapper", "query", "-i", km, "-q", sub,
                                                "-r", "--host-exact", "-o", sub_out])
        if rc != 0:
            raise RuntimeError(f"kmer-mapper query --host-exact failed:\n{logs}")
        return parse_output(sub_out, len(reads))

    check(f"kmer-mapper {genome_len} bp", kout, mindex.concat, mindex.ends, host_exact,
          "kmer-mapper query --host-exact")

    # the error path: one unitig stored twice, a read taken from it
    recs = read_all_records(fna)[:200]
    longest = max(recs, key=lambda rec: len(rec[1]))
    dup_fna, dup_idx = os.path.join(work, "dup.fna"), os.path.join(work, "dup.idx")
    dq = os.path.join(work, "dup_q.fna")
    with open(dup_fna, "wb") as f:
        for i, (_h, seq) in enumerate(recs + [longest]):
            f.write(b">%d\n%s\n" % (i, bytes(seq)))
    with open(dq, "wb") as f:
        f.write(b">d\n%s\n" % bytes(longest[1][:READ_LEN]))
    rc, logs, _, _ = run_counted(cli.main, ["kmer-mapper", "build", "-u", dup_fna,
                                            "-k", str(K), "-o", dup_idx])
    if rc != 0:
        raise RuntimeError(f"kmer-mapper build failed:\n{logs}")
    for forced in ("0", "1"):
        os.environ["FINITO_MINIMIZER_V2"] = forced
        try:
            rc, logs, _, _ = run_counted(cli.main, ["kmer-mapper", "query", "-i", dup_idx, "-q", dq,
                                                    "-r", "--device", DEVICE])
        finally:
            del os.environ["FINITO_MINIMIZER_V2"]
        if rc != 1 or "occurs in 2 unitigs" not in logs:
            raise AssertionError(f"kmer-mapper error path (v2={forced}): exit {rc}, {logs!r}")
    log(f"kmer-mapper error path {genome_len} bp: a duplicated unitig exits 1 with "
        f"'{logs.strip().splitlines()[-1]}' under v1 and v2")
    return launches


def index_phase(genome_len: int, seed: int, n_reads: int, work: str) -> int:
    """One index size end to end; returns the front-end kernel launches
    of its main-path runs (search-fmin and kmer-mapper query)."""
    from finito_tpu.io.seqdb import decode_seq

    genome, cuts, prefix = build_index(genome_len, seed, work)
    rng = np.random.default_rng(seed + 1)
    qpath = os.path.join(work, "q.fna")
    starts, mutations, extra, reads = make_queries(rng, genome, n_reads, qpath)
    sample = rng.choice(n_reads, size=32, replace=False)

    def check(what, opath, concat_u, ends_u, oracle, oracle_name="the host oracle "
              "FinimizerIndex.search"):
        """Every genome-read window against the analytic oracle; the short/N
        reads and 32 sampled reads against oracle (a list of reads -> their
        lines)."""
        lines = parse_output(opath, n_reads + len(extra))
        want = analytic_expected(concat_u, ends_u, genome, cuts, starts, mutations)
        got = np.stack(lines[:n_reads])
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = int((got != want).any(axis=-1).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"{what}: {bad} windows disagree with the analytic DSPSS oracle")
        log(f"check {what}: all {want.shape[0] * want.shape[1]} windows of "
            f"{n_reads} reads equal the analytic DSPSS oracle")
        probe = list(extra) + [decode_seq(reads[i]) for i in sample]
        for r, line, ref in zip(probe, lines[n_reads:] + [lines[i] for i in sample],
                                oracle(probe)):
            if not np.array_equal(line, ref):
                raise AssertionError(f"{what}: read disagrees with {oracle_name}: {r!r}")
        log(f"check {what}: {len(extra)} short/N reads and 32 sampled reads equal {oracle_name}")

    launches, index = search_phase(genome_len, prefix, qpath, work, check)
    launches += kmer_mapper_phase(genome_len, os.path.join(work, "unitigs.fna"), qpath, work,
                                  check, 2 * n_reads * (READ_LEN - K + 1))

    chunk = reads[:4096]  # one CLI chunk: 4096 reads, both strands interleaved
    both = np.empty((2 * len(chunk), READ_LEN), np.uint8)
    both[0::2] = chunk
    both[1::2] = (3 - chunk)[:, ::-1]
    t = locate_forms(index, both)
    log(f"locate forms {genome_len} bp ({'fused slot rows' if t['slot_rows'] else 'narrow descriptor'}, "
        f"engine rule picks {t['engine_form']}), (8192, 128) batch, {t['windows']} windows: "
        "v1 = v2 and v1-count = v2-count on (uid, off), cnt = found")
    for name in ("v1", "v2", "v1-count", "v2-count"):
        f = t[name]
        log(f"  {name}: {f['ms']} ms per batch, {t['windows'] / (f['ms'] / 1e3)} windows/s, "
            + ", ".join(f"{c} {f[c]}" for c in ("n_slow", "K_slow", "n_heads", "K_heads") if c in f))
    log(f"  peak device memory {t['peak_mib']} MiB")
    return launches


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0, help="seed of genomes and reads")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA card")
    card = gpu_name_and_power()
    log(f"device: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible")
    from finito_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0} s (nvcc {_build.build_info.get('seconds', 0.0)} s, "
        f"{_build.build_info['path']})")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    kern = kernel_phase(np.random.default_rng(args.seed))
    launches = 0
    scratch = os.path.join(HERE, "build")
    os.makedirs(scratch, exist_ok=True)
    for genome_len in GENOMES:
        with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke_") as work:
            launches += index_phase(genome_len, args.seed, N_READS, work)

    if any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules):
        raise AssertionError("the port imported jax")
    log(json.dumps({"kernels": [{
        "name": "minimizer_windows", "route": "cuda",
        "source": "finito_tpu_torch/csrc/minimizer_front.cu",
        "replaces": "finito_tpu/ops/pallas_min.py:124",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

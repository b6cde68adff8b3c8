#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (finito_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Drives the port's main paths, ``search-fmin`` (every --engine, and the
minimizer engine on (dp, tp) meshes), ``kmer-mapper query``, the mesh
builds (``sharded_index_build``, ``unitigs --mesh``), the
device-resident pipeline of every engine and the tooling
(finito_tpu_torch.tools, finito_tpu_torch.entry), through the port's
CLI and entry points, at realistic sizes, and checks every answer.
Phases, one line or more each:

  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the CUDA kernels (nvcc) and the host library (g++)
     from the checkout's sources;
  3. kernel: the front-end kernel against its plain PyTorch version on
     the card, bit for bit, at the main path's chunk shape, a long-read
     shape, edge shapes and one shape with B * L near 2^30; at the main
     path's chunk shape its device time (torch.profiler), the wrapper's
     time and the plain version's (CUDA events), and the bound;
  4. per index (1 Mbp: fused slot rows, v1 locate; 4,641,652 bp, E. coli
     K-12 MG1655's length: narrow descriptor, v2 locate): a random genome
     cut into unitigs with k-1 overlaps (utils.synth.gen_dspss, k=31),
     sbwt-build and build-fmin through the port's CLI, 16,384 mutated
     128 bp reads plus short and N-containing reads;
     a. search-fmin --device cuda, the locate form it ran, every window
        checked against the analytic DSPSS oracle and sampled reads
        against the host oracle FinimizerIndex.search; every input the
        run gave the front-end kernel is recorded, and the kernel is held
        bit for bit to its plain version on each (so also in c.);
     b. the four locate forms (v1, v2 and their occurrence-counting
        forms) on one (8192, 128) CLI chunk: equal answers, cnt equal to
        the found flag (each k-mer of a DSPSS occurs once), ms per batch
        (CUDA events), the slow-path and run-head counts and capacities;
     c. kmer-mapper build and query -r --device cuda on the same reads:
        every window against the analytic oracle (unitig ids in the colex
        order of their first k-mers), short/N and sampled reads against
        query --host-exact, windows/s; then the multi-occurrence error
        (one unitig stored twice) under both locate forms: exit code 1;
     d. at 4,641,652 bp only: search-fmin --engine dense, stream and
        replica --device cuda (plain PyTorch but for the chain and repair
        kernels of stream and replica, csrc/chain_opt.cu and
        csrc/segment_repair.cu, one launch each a chunk and re-run): every
        window against the analytic oracle, sampled reads against the host
        oracle, the output byte-identical to c.'s minimizer run; the
        engine's table build time, wall, µs/query, peak memory, chain and
        repair kernel launches against the chunks, no repair trip and no
        straggler read; on one (8192, 128) chunk the locate's ms (CUDA
        events), device time and operations (torch.profiler), host reads,
        n_seg against K, and each phase's share (one JSON line per
        engine); for stream and replica, each kernel against its plain
        version on the card, bit for bit, at (8192, 128) and (8192, 256)
        (the served path's bucket of 150 bp reads), with the kernel's
        device time (torch.profiler), its wrapper's time (CUDA events),
        its launches and the plain version's time, and one lane's device
        time (chain) or one step's and the latency bound (repair);
     e. at 4,641,652 bp only, the mesh: for (dp, tp) in (1, 2), (2, 2),
        (1, 4) a DeviceQueryEngine(mesh=(dp, tp)) whose dp * tp devices
        are all cuda:0 (one card), driven by search-fmin's own serving
        loop over the query file: every window against the analytic
        oracle, probe reads against the host oracle, the output
        byte-identical to a.'s, the kernel bit for bit on every input the
        run gave it (dp * tp launches a chunk); one JSON line per mesh
        (ShardedMinimizerIndex build, wall, µs/query, peak memory, and on
        one (8192, 128) chunk ms, device time and operations, host reads,
        n_slow against K). search-fmin --mesh dp,tp --device cuda through
        the CLI only where dp * tp cards are visible;
     f. the LCS array on the host, on the card (lcs_array_device) and over
        4 shards on cuda:0 (sharded_lcs_fn): all equal, seconds of each;
     g. the mesh index build: sharded_index_build over 4 shards, every
        one on cuda:0, from the unitigs of 4.: every array equal to the
        index build-fmin wrote and its files byte-identical;
        ShardedIndex.build(tp=4) equal to from_index, and its
        sharded_locate_fn equal to FinimizerIndex.search on probe reads;
     h. the mesh unitig build: unitigs --mesh 4 through the port's CLI on
        a pangenome (a 4,641,652 bp base and 4 variants at SNP rate
        0.002, k=31), with --device cuda:0 (4 shards on the card) and
        --device cuda (a shard a visible card): each file byte-identical
        to the host unitigs' on the same input. One JSON line a build
        (g., h.): seconds per phase, overflow retries, node and k-mer
        counts, peak device memory, host peak RSS, the host build's time;
     i. run_distributed_queries in 2 processes on cuda:0 joined by gloo:
        the merged file byte-identical to the single run and to a.'s;
     i'. the mesh across processes: 2 workers (--xproc-worker), 2 shards
        each on cuda:0, one global 4-shard mesh over a gloo group (and
        over nccl, a card a rank, where two cards are visible): the
        cross-process sharded_index_build (files byte-identical to
        build-fmin's, each rank packing only its shards), the sharded
        minimizer locate on (1, 4) and (2, 2) over b.'s (8192, 128) batch
        (every window against kmer_location_oracle and the one-process
        (1, 4) mesh; every front-end launch of each rank bit for bit
        against the plain version) and sharded_lcs_fn (equal to the host
        LCS); per rank one JSON line: wall per step, collectives, staged
        bytes, host reads, peak device memory;
     j. the device-resident pipeline (DeviceQueryEngine.make_device_pipeline)
        on one batch of 8192 forward reads put on the card once, by
        bench.py run_rung's protocol (pipeline_cell): at 1 Mbp the
        minimizer engine's v1 and v2 forced (the pipeline's size
        threshold set to 0), then the builder's device
        fallback (FinimizerIndexBuilder without node keys on the card:
        files byte-identical to build-fmin's); at 4,641,652 bp the
        minimizer (v2), dense, stream and replica engines (the last
        three those d. built), then the in-scan replica twin
        (make_replica_locate) on 1,024 of the reads. Every window against
        the analytic oracle, windows/s, slow_frac, capacities, host syncs
        per call, the device-busy share; one JSON line a pipeline;
  5. the repeat-dense cell: gen_repeat_genome(4,000,000, REPEAT_PARAMS),
     its non-canonical dBG unitigs and index, then j.'s four pipelines
     and the twin, checked against the index-free kmer_location_oracle;
  6. the tooling (tools_phase), every tool on cuda:0 through its own
     entry point, one JSON line each: tools.micro at n = 2^22 and 2^26;
     entry()'s locate step against the same step on the CPU;
     dryrun_multichip on 8 x cuda:0; tools.genome_scale_verify at
     100 Mbp, k=63, tp=8 and tools.pangenome_verify --mesh-build at its
     default shape (2 Mbp base, 20 variants, k=63, tp=8), each ok;
     tools.build_cache at 4,641,652 bp, then tools.h_sweep on it (h 23
     and 25, v1 and v2); tools.lane_sweep at 400 kbp, B 8192, chunks 0
     and auto; tools.bench (bench.py's ladder: the 400 kbp head, the
     cached 4,641,652 bp rung, stream, replica and a 1 Mbp repeat row,
     every window of each against its oracle). The front-end kernel is held bit for bit to its plain
     version on every input these runs gave it (k=63 included).

Prints the kernels' JSON line (launches in total and per main-path run;
the chain and repair kernels' checks),
the script's wall, then, last, {"ok": true, "device": ...}. --kernel-only
stops after phase 3; --sweep times the kernel across its shapes instead
(one JSON line a row).
Any failure raises, and the exit code is then not 0. It imports nothing
of JAX, of the JAX package finito_tpu or of bench.py, and fails if any
of them was imported.
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
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K = 31
GENOMES = (1_000_000, 4_641_652)
# the other search-fmin engines, run at the 4,641,652 bp index only
ENGINE_MODES = ("dense", "stream", "replica")
ENGINES_AT = GENOMES[1]
READ_LEN = 128
N_READS = 16384  # genome reads per index: 4 CLI chunks of 4096
MUTATE = 0.005
DEVICE = "cuda"
KERNEL_CASES = [
    (8192, 128, 31, 16), (8192, 128, 21, 12), (8192, 128, 63, 28), (8192, 128, 95, 16),
    (64, 4096, 31, 16),
    # edges: m = k, m = 1, k at the q-word boundaries, L = k (W = 1), B = 1
    (8192, 128, 31, 31), (8192, 128, 31, 1), (8192, 128, 16, 8), (8192, 128, 17, 9),
    (8192, 128, 32, 16), (8192, 128, 33, 17), (4096, 31, 31, 16), (1, 128, 31, 16),
    (1, 31, 31, 31),
]
# B * L near 2^30, the flat window index's range; checked in row chunks
LARGE_KERNEL_CASE = (4_190_000, 256, 31, 16)
MAIN_SHAPE = (8192, 128, 31, 16)  # one CLI chunk: 4096 reads, both strands
# top-level modules the port must never import
FOREIGN = ("finito_tpu", "bench", "jax", "jaxlib")
# (dp, tp) meshes of the 4,641,652 bp index, every device cuda:0; dp <= 4
# because the CLI's last chunk holds 2 reads (B = 4, ROADMAP C7)
MESHES = ((1, 2), (2, 2), (1, 4))
LCS_SHARDS = 4  # sharded_lcs_fn's mesh, every device cuda:0
# the mesh across processes: 2 workers of XPROC_SHARDS shards each, one
# global 4-shard mesh; (1, 4) puts tp across the processes, (2, 2) dp
XPROC_SHARDS = 2
XPROC_MESHES = ((1, 4), (2, 2))
XPROC_STEPS = 5  # timed locate calls a mesh and rank
XPROC_TIMEOUT = 300  # seconds of a worker, and of its group's collectives
# the mesh build: shards of sharded_index_build and unitigs --mesh, every
# one on cuda:0
MESH_BUILD_SHARDS = 4
# the pangenome of unitigs --mesh: (base bp, variants, SNP rate, k), the
# shape of scripts/pangenome_verify.py
PANGENOME = (4_641_652, 4, 0.002, 31)
# the files FinimizerIndex.serialize writes under a prefix
INDEX_FILES = (".O.sdsl", ".FBV.sdsl", ".packed_unitigs.sdsl", ".unitig_endpoints.sdsl",
               ".Ustart.sdsl", ".LCS.sdsl", ".sbwt")
# the device-resident pipeline (DeviceQueryEngine.make_device_pipeline),
# bench.py run_rung's protocol: PIPE_BATCH forward reads of READ_LEN with
# MUTATE point mutations, put on the card once
PIPE_BATCH = 8192
PIPE_VERIFY = 8  # reads per pipeline also held to FinimizerIndex.search
PIPE_TIMED_S = 2.0  # aimed seconds of a pipeline's timed calls, trials together
PIPE_TRIALS = 3
TWIN_READS = 1024  # reads of the in-scan replica twin (make_replica_locate)
# the repeat-dense cell: utils.synth.gen_repeat_genome with
# utils.synth.REPEAT_PARAMS, non-canonical dBG unitigs at k = K
REPEAT_LEN = 4_000_000
# phase 6, the tooling: every tool on one card (a mesh's shards all on it)
TOOLS_DEVICE = "cuda:0"
TOOLS_MICRO_N_LOG2 = (22, 26)  # a 16 MiB table in the 50 MB L2, and 256 MiB past it
TOOLS_GENOME_SCALE = 100_000_000  # k=63, tp=8; 1 Gbp runs through genome_scale_verify alone
TOOLS_CACHE_GENOME = GENOMES[1]  # build_cache, then h_sweep on its entry
TOOLS_HS = "23,25"
TOOLS_PANGENOME_ARGS = ["--mesh-build"]  # at its default shape: 2 Mbp base, 20 variants, k=63, tp=8
TOOLS_LANE_GENOME = 400_000
TOOLS_LANE_BATCH = 8192
TOOLS_BENCH_GENOME = 400_000  # the ladder's head; auto adds the cached TOOLS_CACHE_GENOME
TOOLS_BENCH_EXTRA = ("stream", "replica", "repeat")
TOOLS_BENCH_REPEAT = 1_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT_OPS_PER_S = 67e12  # the float32 rate outside the tensor cores, same sheet
# the chain kernel's check shapes: a CLI chunk of 128 bp reads, and the
# served path's (8192, 256) bucket of 150 bp reads
CHAIN_SHAPES = ((8192, 128), (8192, 256))
CHAIN_CHECKS = []  # one entry a (engine, shape) check, for the kernels' line
REPAIR_CHECKS = []  # the same for the repair kernel


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


def device_ms(fn, kernel_name: str, reps: int = 50) -> tuple:
    """Mean device time in milliseconds of the kernels whose name holds
    kernel_name, per launch, from torch.profiler's device events over
    reps calls of fn after a warm-up (host time between launches is not
    counted). Returns (ms, the launches the profiler saw, their names).
    The mean is over the events seen, so an event the profiler drops at
    the edge of its window changes no result; seeing none fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel_name in e.key]
    n = sum(e.count for e in hits)
    us = sum(getattr(e, "device_time_total", 0) or e.cuda_time_total for e in hits)
    if n < 1 or us <= 0:
        raise AssertionError(f"profiler saw {n} launches of {kernel_name} ({us} us) for {reps} calls")
    return us / n / 1e3, n, sorted({e.key for e in hits})


def front_bound_ms(B: int, L: int, k: int, m: int) -> tuple:
    """(bound in ms, what binds) of the front end at one shape: each code
    read once and each output written once (best_v, best_o 4 bytes,
    bad 1, NW q-words 4 each per window) at the card's memory rate,
    against the integer work (6 per m-mer: roll and hash; 3 per
    candidate of the minimum; 3 per q-word; 2 for bad) at its peak rate."""
    W, NW = L - k + 1, (2 * k + 31) // 32
    t_bytes = (B * L + B * W * (9 + 4 * NW)) / HBM_BYTES_PER_S
    ops = B * (L - m + 1) * 6 + B * W * (3 * (k - m) + 3 * NW + 2)
    t_ops = ops / INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare_front(codes, k: int, m: int, chunk_rows: int) -> int:
    """Largest absolute difference between the kernel's four outputs and
    the plain version's, the plain version run on row chunks."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows, minimizer_windows_ref

    got = minimizer_windows(codes, k, m)
    torch.cuda.synchronize()
    err = 0
    for r0 in range(0, codes.shape[0], chunk_rows):
        r1 = r0 + chunk_rows
        want = minimizer_windows_ref(codes[r0:r1], k, m)
        mine = (got[0][r0:r1], got[1][r0:r1], got[2][r0:r1], got[3][:, r0:r1])
        for a, b in zip(mine, want):
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def kernel_phase(rng) -> dict:
    """Front-end kernel vs its plain version on the card, bit for bit, at
    every case; at the main path's shape its device time (profiler), the
    wrapper's time (CUDA events), the plain version's and the bound."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows, minimizer_windows_ref

    max_err = 0
    for B, L, k, m in KERNEL_CASES + [LARGE_KERNEL_CASE]:
        if (B, L, k, m) == LARGE_KERNEL_CASE:
            g = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 31)))
            codes = torch.randint(0, 4, (B, L), dtype=torch.uint8, device="cuda", generator=g)
            n_pad = 100_000
            codes[torch.from_numpy(rng.integers(0, B, n_pad)).cuda(),
                  torch.from_numpy(rng.integers(0, L, n_pad)).cuda()] = 255
            err = compare_front(codes, k, m, 1 << 16)
            del codes
            torch.cuda.empty_cache()
        else:
            err = compare_front(torch.from_numpy(padded_codes(rng, B, L)).cuda(), k, m, B)
        max_err = max(max_err, err)
        log(f"kernel (B={B}, L={L}, k={k}, m={m}): max_abs_err {err} "
            f"({'bit-exact' if err == 0 else 'MISMATCH'})")
        if err:
            raise AssertionError(f"front-end kernel disagrees with the plain version at {(B, L, k, m)}")
    B, L, k, m = MAIN_SHAPE
    codes = torch.from_numpy(padded_codes(rng, B, L)).cuda()
    ms = time_cuda(lambda: minimizer_windows(codes, k, m))
    dev_ms, n_seen, _ = device_ms(lambda: minimizer_windows(codes, k, m), "minimizer_front")
    plain_ms = time_cuda(lambda: minimizer_windows_ref(codes, k, m))
    ms2 = time_cuda(lambda: minimizer_windows(codes, k, m))
    bound_ms, bound_by = front_bound_ms(B, L, k, m)
    log(f"kernel time {MAIN_SHAPE}: device {dev_ms} ms per launch (torch.profiler, "
        f"{n_seen} of 50 launches seen); "
        f"wrapper {ms} ms, {ms2} ms per call (CUDA events, mean of 50 calls after warm-up, "
        f"before and after the plain version); plain {plain_ms} ms; bound {bound_ms} ms "
        f"({bound_by}); device time is {bound_ms / dev_ms:.3f} of the bound")
    return {"max_abs_err": max_err, "ms": ms, "ms_after": ms2, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / dev_ms}


def front_shifted(codes, k: int, m: int, shift: int):
    """The kernel's four outputs, from one buffer whose start lies shift
    bytes past a 16-byte boundary; the library is called directly (not
    counted). The kernel stores groups of G windows only where every
    plane is on the 4G-byte grid, so shift 8 makes it take groups of 2
    where 4 divides W: the two group sizes at one shape."""
    import torch

    from finito_tpu_torch.ops import _build
    from finito_tpu_torch.ops.minimizer_front import n_words

    assert shift % 4 == 0, "the 4-byte planes stay aligned"
    B, L = codes.shape
    W, nw = L - k + 1, n_words(k)
    BW = B * W
    size = BW * (4 * (2 + nw) + 1)
    raw = torch.empty(size + 32, dtype=torch.uint8, device=codes.device)
    off = (-raw.data_ptr()) % 16 + shift
    buf = raw[off : off + size]
    words = buf[: 4 * BW * (2 + nw)].view(torch.int32)
    out = (words[:BW].view(B, W), words[BW : 2 * BW].view(B, W),
           buf[4 * BW * (2 + nw) :].view(torch.bool).view(B, W), words[2 * BW :].view(nw, B, W))
    rc = _build.library().fin_minimizer_windows(
        codes.data_ptr(), B, L, k, m, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"minimizer_front kernel launch failed: CUDA error {rc}")
    return out


def sweep_phase(rng, card: str) -> None:
    """Device time of the front-end kernel across what moves it: the row
    width (which sets the group size), the group size at one width, the
    minimum's length R = k - m + 1 and the batch. Every row is bit-exact
    against the plain version first; one JSON line a row."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows, minimizer_windows_ref

    def row(what, B=8192, L=128, k=31, m=16, shift=None):
        codes = torch.from_numpy(padded_codes(rng, B, L)).cuda()
        fn = ((lambda: minimizer_windows(codes, k, m)) if shift is None
              else (lambda: front_shifted(codes, k, m, shift)))
        if not all(torch.equal(a, b) for a, b in zip(fn(), minimizer_windows_ref(codes, k, m))):
            raise AssertionError(f"front-end kernel disagrees with the plain version: {what}")
        ms, n, names = device_ms(fn, "minimizer_front")
        bound, _ = front_bound_ms(B, L, k, m)
        groups = sorted({int(x) for name in names for x in re.findall(r"kernel<(\d+)>", name)})
        log(json.dumps({"row": what, "B": B, "L": L, "W": L - k + 1, "k": k, "m": m,
                        "group": groups, "device_ms": ms, "events": n, "bound_ms": bound,
                        "share_of_bound": bound / ms, "card": card}))

    for L in (130, 128, 127):
        row(f"width W={L - 30}", L=L)
    # W = 108, 100: groups of 4, then of 2 with the planes shifted off the
    # 16-byte grid; W = 98: groups of 2 both ways, the shift's own cost
    for L, k, m in ((128, 21, 12), (130, 31, 16), (128, 31, 16)):
        row("group at one width", L=L, k=k, m=m)
        row("group at one width, planes off the 16-byte grid", L=L, k=k, m=m, shift=8)
    for m in (31, 16, 1):
        row(f"minimum over R={32 - m}", m=m)
    for B in (2048, 8192, 32768):
        row("batch", B=B)


def build_index(genome_len: int, seed: int, work: str):
    """DSPSS genome -> unitig FASTA -> sbwt-build + build-fmin through the
    port's CLI. Returns (genome, cuts, index prefix, build seconds)."""
    from finito_tpu_torch import cli
    from finito_tpu_torch.utils.synth import gen_dspss

    t0 = time.perf_counter()
    genome, unitigs, cuts = gen_dspss(np.random.default_rng(seed), genome_len, K, return_cuts=True)
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
    build_s = time.perf_counter() - t0
    log(f"index {genome_len} bp: {len(unitigs)} unitigs, host build "
        f"{build_s} s (gen_dspss + sbwt-build + build-fmin)")
    return genome, cuts, prefix, build_s


def sample_reads(rng, genome: np.ndarray, B: int):
    """B reads of READ_LEN sampled from the genome with MUTATE point
    mutations (bench.py:237-243). Returns (starts, reads, mutations)."""
    L = READ_LEN
    starts = rng.integers(0, genome.size - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(MUTATE * reads.size)
    mi = rng.integers(0, B, size=n_mut)
    mj = rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
    return starts, reads, (mi, mj)


def make_queries(rng, genome: np.ndarray, n_reads: int, path: str):
    """Reads sampled from the genome with point mutations,
    then short and N-containing reads. Returns (starts, mutations, extra
    reads as bytes)."""
    from finito_tpu_torch.io.seqdb import decode_seq

    starts, reads, (mi, mj) = sample_reads(rng, genome, n_reads)
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


def analytic_expected(concat_u, ends_u, genome, cuts, starts, mutations, k=K, read_len=READ_LEN):
    """Every window of every genome read, closed form (the DSPSS oracle):
    a k-mer occurs once, in the unitig whose cut range holds its
    genome start; windows covering a mutation are absent (forward, and
    their reverse complement with probability ~1 - n/4^k). The unitig
    ids are those of the index whose unitig text is concat_u/ends_u: the
    two unitig orders are matched on the multiword keys of their first k
    bases (sbwt.keys, any k; one uint64 holds only 32 bases)."""
    from finito_tpu_torch.sbwt import keys as kw

    B, n_win = starts.size, read_len - k + 1
    ends_u = np.asarray(ends_u)
    concat_u = np.asarray(concat_u)
    ustart = np.concatenate([[0], ends_u[:-1]])
    first_perm = kw.pack_rows(concat_u[ustart[:, None] + np.arange(k)] + 1)
    first_orig = kw.pack_rows(genome[cuts[:-1, None] + np.arange(k)] + 1)
    o1, o2 = kw.sort_order(first_orig), kw.sort_order(first_perm)
    if not all(np.array_equal(a[o1], b[o2]) for a, b in zip(first_orig, first_perm)):
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
    np.logical_or.at(absent, mi, (rel >= 0) & (rel < k))
    return np.stack([np.where(absent, -1, uid), np.where(absent, -1, off)], axis=-1)


def oracle_line(index, read: bytes) -> np.ndarray:
    """The merged output line of one read under the host oracle
    (reference merge rule, search_fmin.hh:62-71)."""
    from finito_tpu_torch.io.fastx import reverse_complement

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
    with mock.patch.object(module, "pick_v2", lambda dmi: picked.append(pick(dmi)) or picked[-1]):
        yield picked


def locate_forms(index, codes_both: np.ndarray) -> dict:
    """v1, v2 and both counting forms on one (8192, 128) CLI chunk on the
    card: equal answers, ms per batch (CUDA events), counters, each at
    the capacities query.locators' minimizer policy settles on (the
    engine's; kmer-mapper's slow divisors for the counting forms)."""
    import torch

    from finito_tpu_torch.query.engine import DeviceQueryEngine, _pad_codes
    from finito_tpu_torch.query.locators import Optimistic, minimizer_policy
    from finito_tpu_torch.query.minimizer_engine import make_minimizer_locate_form

    torch.cuda.reset_peak_memory_stats()
    eng = DeviceQueryEngine(index, device=DEVICE)
    codes = torch.from_numpy(_pad_codes(codes_both)).to(eng.device)
    B, L = codes.shape
    res = {"windows": B * (L - K + 1), "slot_rows": eng._dmi.slot_rows is not None,
           "engine_form": "v2" if eng.use_v2 else "v1"}
    outs = {}
    for name, v2, count in (("v1", False, False), ("v2", True, False),
                            ("v1-count", False, True), ("v2-count", True, True)):
        check = Optimistic(
            lambda caps: make_minimizer_locate_form(eng._dmi, v2, *caps, count_occurrences=count)(
                codes), *minimizer_policy(B, L, K, v2, (128 if v2 else 16) if count else None))
        check.verify()
        locate = make_minimizer_locate_form(eng._dmi, v2, *check.caps, count_occurrences=count)
        outs[name] = check.out
        res[name] = {"ms": time_cuda(lambda: locate(codes), reps=20, warmup=3),
                     **dict(zip(("n_slow", "n_heads")[: 1 + v2], check.counters)),
                     **dict(zip(("K_slow", "K_heads")[: 1 + v2], check.caps))}
    uid, off = outs["v1"][:2]
    for name in ("v2", "v1-count", "v2-count"):
        if not (torch.equal(outs[name][0], uid) and torch.equal(outs[name][1], off)):
            raise AssertionError(f"locate {name} disagrees with v1 on (uid, off)")
    cnt1, cnt2 = outs["v1-count"][3], outs["v2-count"][3]
    if not torch.equal(cnt1, cnt2):
        raise AssertionError("the counting forms of v1 and v2 disagree on cnt")
    if not torch.equal(cnt1, (uid >= 0).to(torch.int32)):
        raise AssertionError("cnt differs from the found flag on a DSPSS (each k-mer occurs once)")
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return res


@contextlib.contextmanager
def engines_built(module):
    """Records (engine, seconds of its construction, seconds of it in
    build_lcs_jump_tables) of every module.DeviceQueryEngine built while
    the block runs: the table build and upload, synchronised, and the
    share of the LCS jump tables' two Python stack loops."""
    import torch

    from finito_tpu_torch.query import replica

    built, init, jumps = [], module.DeviceQueryEngine.__init__, replica.build_lcs_jump_tables
    in_jumps = []

    def timed_jumps(LCS):
        t0 = time.perf_counter()
        out = jumps(LCS)
        in_jumps.append(time.perf_counter() - t0)
        return out

    def spy(self, *args, **kwargs):
        in_jumps.clear()
        t0 = time.perf_counter()
        init(self, *args, **kwargs)
        torch.cuda.synchronize()
        built.append((self, time.perf_counter() - t0, sum(in_jumps)))

    with mock.patch.object(module.DeviceQueryEngine, "__init__", spy), \
            mock.patch.object(replica, "build_lcs_jump_tables", timed_jumps):
        yield built


def phase_profile(fn, phases) -> dict:
    """One call of fn under torch.profiler (after a warm-up call): for
    the whole call and for each record_function range named in phases,
    the device time of the operations launched inside it (kernels and
    copies), their count, and the range's host time (summed over the
    range's occurrences). An operation is tied to its launch by the
    correlation id of its runtime call (cudaLaunchKernel and kin), so a
    kernel launched through ctypes, with no ATen op around it, counts
    too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, runtime, ranges = [], {}, {name: [] for name in phases}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.correlation_id(), e.duration_ns()))
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
        elif e.is_user_annotation() and e.name() in ranges:
            ranges[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    out = {"all": {"device_ms": sum(d for _, d in ops) / 1e6, "launches": len(ops)}}
    for name, spans in ranges.items():
        inside = [d for c, d in ops
                  if c in runtime and any(a <= runtime[c] <= b for a, b in spans)]
        out[name] = {"device_ms": sum(inside) / 1e6, "launches": len(inside),
                     "host_ms": sum(b - a for a, b in spans) / 1e6}
    return out


# where each plain-torch phase of the new engines lives, and the record_function
# range that names it
PHASES = {
    "dense": [("kmer_ranks_fixed", "finito_tpu_torch/ops/bitvec.py:kmer_ranks_fixed"),
              ("ranks_to_locations", "finito_tpu_torch/query/locators.py:_ranks_to_locations")],
    "stream": [("chain_opt", "finito_tpu_torch/ops/streaming.py:make_chain_opt"),
               ("segment_repair", "finito_tpu_torch/ops/streaming.py:make_segment_repair"),
               ("ranks_to_locations", "finito_tpu_torch/query/locators.py:_ranks_to_locations")],
    "replica": [("chain_opt", "finito_tpu_torch/ops/streaming.py:make_chain_opt"),
                ("segment_repair", "finito_tpu_torch/ops/streaming.py:make_segment_repair"),
                ("replica_tail", "finito_tpu_torch/query/replica.py:resolve_windows")],
}


def chain_kernel_check(mode: str, tables, codes, n8: int, k: int, n_nodes: int,
                       aug: bool) -> list:
    """The chain kernel (make_chain_opt on a CUDA tensor) against its
    plain version (make_chain_opt_ref) on the card, bit for bit, at
    CHAIN_SHAPES: the (8192, 128) chunk's codes, and at (8192, 256) each
    row two of its reads back to back, every other row cut to 150 codes
    and padded. At each: the kernel's device time (torch.profiler), its
    wrapper's time (CUDA events), its launches, the plain version's time
    (CUDA events), one lane's device time (row 0 alone: L dependent
    steps, the latency floor) and the bytes' time at the card's rate.
    Returns one dict a shape, also kept in CHAIN_CHECKS."""
    import torch

    from finito_tpu_torch.ops import streaming

    if tuple(codes.shape) != CHAIN_SHAPES[0]:
        raise AssertionError(f"chain kernel check: a {tuple(codes.shape)} chunk, not {CHAIN_SHAPES[0]}")
    chain = streaming.make_chain_opt(n8, k, n_nodes, aug=aug)
    plain = streaming.make_chain_opt_ref(n8, k, n_nodes, aug=aug)
    wide = codes.new_full((codes.shape[0], 256), 255)
    wide[:, :128] = codes
    wide[:, 128:] = codes.roll(1, 0)
    wide[1::2, 150:] = 255
    out = []
    for B, L in CHAIN_SHAPES:
        c = {128: codes, 256: wide}[L][:B].contiguous()
        n0 = streaming.make_chain_opt.launches
        got = chain(*tables, c)
        want = plain(*tables, c)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want))
        if err or any(a.shape != b.shape for a, b in zip(got, want)):
            raise AssertionError(f"chain kernel ({mode}, aug={aug}, {tuple(c.shape)}) disagrees "
                                 f"with the plain version: max_abs_err {err}")
        dev_ms, n_seen, names = device_ms(lambda: chain(*tables, c), "chain_opt_kernel", reps=20)
        ms = time_cuda(lambda: chain(*tables, c), 20, 2)
        plain_ms = time_cuda(lambda: plain(*tables, c), 2, 1)
        lane_ms, _, _ = device_ms(lambda: chain(*tables, c[:1]), "chain_opt_kernel", reps=20)
        row = {"engine": mode, "aug": aug, "wide_rank24": tables[0].dim() == 2, "B": B, "L": L,
               "max_abs_err": err, "device_ms": dev_ms, "profiled_launches": n_seen,
               "kernels": names, "ms": ms, "plain_ms": plain_ms, "lane_device_ms": lane_ms,
               "lane_step_us": lane_ms / L * 1e3,
               "bytes_ms": B * L * 10 / HBM_BYTES_PER_S * 1e3,
               "launches": streaming.make_chain_opt.launches - n0}
        log(f"chain kernel ({mode}, {B}, {L}): bit-exact; device {dev_ms} ms a launch "
            f"(torch.profiler, {n_seen} seen), wrapper {ms} ms (CUDA events), plain {plain_ms} ms, "
            f"one lane {lane_ms} ms ({row['lane_step_us']} us a step), bytes at 3.35 TB/s "
            f"{row['bytes_ms']} ms; {row['launches']} launches")
        out.append(row)
    CHAIN_CHECKS.extend(out)
    return out


def repair_kernel_check(mode: str, chain_tables, tables, codes, n8: int, k: int,
                        n_nodes: int, aug: bool) -> list:
    """The repair kernel (make_segment_repair on a CUDA tensor) against
    its plain trip loop (make_segment_repair_ref) on the card, bit for
    bit in emit2, cand2 and n_seg, on the chain kernel's grids at
    CHAIN_SHAPES (the rows chain_kernel_check builds), at the K the
    engine would settle on (its first K, times 4 while n_seg exceeds
    it). At each: the kernel's device time (torch.profiler), its
    wrapper's time (CUDA events, the split compaction and the two grid
    copies included), its launches, the plain loop's time (CUDA events)
    and its trips (fixed and straggler: the longest lane's steps plus
    one), one step's latency (the device time of one all-untrusted row,
    whose lanes each walk k-1+Q steps) and the latency bound, the longest
    lane's steps times that. Returns one dict a shape, also kept in
    REPAIR_CHECKS."""
    import torch

    from finito_tpu_torch.ops import streaming
    from finito_tpu_torch.query.locators import Optimistic, segment_policy
    from finito_tpu_torch.utils import trace

    chain = streaming.make_chain_opt(n8, k, n_nodes, aug=aug)
    wide = codes.new_full((codes.shape[0], 256), 255)
    wide[:, :128] = codes
    wide[:, 128:] = codes.roll(1, 0)
    wide[1::2, 150:] = 255
    Q = k + 1
    out = []
    for B, L in CHAIN_SHAPES:
        c = {128: codes, 256: wide}[L][:B].contiguous()
        grids = chain(*chain_tables, c)
        # the engine's K: its policy's, grown by the loop over this n_seg
        counted = streaming._split_segments(grids[2], Q, 1)[2]
        check = Optimistic(lambda caps: (None, None, counted),
                           *segment_policy(B, L, k, stream=mode == "stream"))
        check.verify()
        (K,), (n_seg,) = check.caps, check.counters
        repair = streaming.make_segment_repair(n8, k, n_nodes, K, aug=aug)
        plain = streaming.make_segment_repair_ref(n8, k, n_nodes, K, aug=aug)
        n0 = streaming.make_segment_repair.launches
        got = repair(*tables, c, *grids)
        t0 = dict(trace.counts)
        want = plain(*tables, c, *grids)
        torch.cuda.synchronize()
        trips = sum(trace.counts.get(n, 0) - t0.get(n, 0)
                    for n in ("trips.repair_fixed", "trips.straggler"))
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want))
        if err or any(a.shape != b.shape for a, b in zip(got, want)):
            raise AssertionError(f"repair kernel ({mode}, aug={aug}, {tuple(c.shape)}) disagrees "
                                 f"with the plain loop: max_abs_err {err}")
        dev_ms, n_seen, names = device_ms(lambda: repair(*tables, c, *grids),
                                          "segment_repair_kernel", reps=20)
        ms = time_cuda(lambda: repair(*tables, c, *grids), 20, 2)
        plain_ms = time_cuda(lambda: plain(*tables, c, *grids), 2, 1)
        one = [g[:1].contiguous() for g in grids[:2]] + [torch.ones_like(grids[2][:1])]
        row_ms, _, _ = device_ms(lambda: repair(*tables, c[:1], *one), "segment_repair_kernel",
                                 reps=20)
        step_us = row_ms / (k - 1 + Q) * 1e3
        row = {"engine": mode, "aug": aug, "wide_rank24": tables[0].dim() == 2, "B": B, "L": L,
               "K": K, "n_seg": n_seg, "max_abs_err": err, "device_ms": dev_ms,
               "profiled_launches": n_seen, "kernels": names, "ms": ms, "plain_ms": plain_ms,
               "plain_trips": trips, "step_us": step_us,
               "latency_bound_ms": (trips - 1) * step_us / 1e3,
               "launches": streaming.make_segment_repair.launches - n0}
        log(f"repair kernel ({mode}, {B}, {L}): bit-exact, n_seg {n_seg} of K {K}; device "
            f"{dev_ms} ms a launch (torch.profiler, {n_seen} seen), wrapper {ms} ms (CUDA events), "
            f"plain {plain_ms} ms ({trips} trips); one step {step_us} us, latency bound "
            f"{row['latency_bound_ms']} ms; {row['launches']} launches")
        out.append(row)
    REPAIR_CHECKS.extend(out)
    return out


def engine_batch(eng, codes_both: np.ndarray) -> dict:
    """One (8192, 128) CLI chunk through a built dense/stream/replica
    engine on the card: the locate with its deferred verify (ms by CUDA
    events, device time and operations by torch.profiler, host reads,
    n_seg against K), and each phase alone by CUDA events beside its
    profiled share of the locate."""
    import torch

    from finito_tpu_torch.ops import streaming
    from finito_tpu_torch.ops.bitvec import kmer_ranks_fixed
    from finito_tpu_torch.query.engine import _pad_codes
    from finito_tpu_torch.query.locators import _ranks_to_locations
    from finito_tpu_torch.query.replica import resolve_windows

    codes = torch.from_numpy(_pad_codes(codes_both)).to(eng.device)
    B, L = codes.shape
    loc = eng.locator

    def locate():
        uid, off, verify = loc.dispatch(codes)
        if verify is None:
            return uid, off
        if verify() is not None:
            raise AssertionError("the segment capacity overflowed at the memo's K")
        return uid, off

    verify = loc.dispatch(codes)[2]
    if verify is not None:
        verify()  # settles K for this shape (the CLI run's chunks already did)
    r0, s0 = host_reads(), host_reads("straggler")
    locate()
    torch.cuda.synchronize()
    res = {"B": B, "L": L, "host_reads": host_reads() - r0,
           "straggler_reads": host_reads("straggler") - s0}
    if eng.mode != "dense":
        caps = loc.sizes[(B, L)]
        res.update(K=caps[0], n_seg=int(loc.locate_at(caps)(codes)[2]))
    res["ms"] = [time_cuda(locate, reps=5, warmup=1) for _ in range(2)]
    prof = phase_profile(locate, [name for name, _ in PHASES[eng.mode]])
    res["device_ms"], res["launches"] = prof["all"]["device_ms"], prof["all"]["launches"]

    # each phase alone on the same inputs, CUDA events
    k = eng.k
    alone = {}
    if eng.mode == "dense":
        ranks = kmer_ranks_fixed(loc.dsbwt, codes, k)
        alone["kmer_ranks_fixed"] = time_cuda(lambda: kmer_ranks_fixed(loc.dsbwt, codes, k), 5, 1)
    else:
        P = loc.tables
        tab, C, ck, jl, jr, edge = (P[n] for n in ("tab", "C", "ck", "jl", "jr", "edge"))
        suu, n8, n_nodes, aug = P.get("suu"), P["n8"], P["n_nodes"], P["aug"]
        res["chain_kernel"] = chain_kernel_check(eng.mode, (tab, C, edge), codes, n8, k, n_nodes,
                                                 aug)
        res["repair_kernel"] = repair_kernel_check(eng.mode, (tab, C, edge),
                                                   (tab, C, ck, jl, jr, suu), codes, n8, k,
                                                   n_nodes, aug)
        chain = streaming.make_chain_opt(n8, k, n_nodes, aug=aug)
        repair = streaming.make_segment_repair(n8, k, n_nodes, res["K"], aug=aug)
        grids = chain(tab, C, edge, codes)
        alone["chain_opt"] = time_cuda(lambda: chain(tab, C, edge, codes), 5, 1)
        alone["segment_repair"] = time_cuda(
            lambda: repair(tab, C, ck, jl, jr, suu, codes, *grids), 5, 1)
        emit, cand, _ = repair(tab, C, ck, jl, jr, suu, codes, *grids)
        ranks = emit[:, k - 1 :]
        if eng.mode == "replica":
            alone["replica_tail"] = time_cuda(lambda: resolve_windows(P, emit, cand, 0), 5, 1)
    if eng.mode != "replica":
        alone["ranks_to_locations"] = time_cuda(lambda: _ranks_to_locations(loc.loc_table, ranks),
                                                5, 1)
    res["phases"] = []
    for name, where in PHASES[eng.mode]:
        p = prof[name]
        res["phases"].append({
            "phase": name, "where": where, "launches": p["launches"], "device_ms": p["device_ms"],
            "host_ms": p["host_ms"],
            "events_ms": alone.get(name.split(".")[0]),
        })
    if res["straggler_reads"]:
        raise AssertionError(f"{eng.mode}: {res['straggler_reads']} straggler reads in a locate "
                             "on the card (the repair kernel takes none)")
    return res


def engine_phase(mode, genome_len, prefix, qpath, work, check, index, both):
    """search-fmin --engine mode --device cuda through the port's CLI:
    every window against the analytic oracle and sampled reads against
    the host oracle (check), the output byte-identical to the minimizer
    run's (out.txt), the engine's table build, wall, µs/query, peak
    memory; then one CLI chunk's locate and phases (engine_batch).
    Returns (the engine the CLI built, its table seconds)."""
    import torch

    from finito_tpu_torch import cli
    from finito_tpu_torch.ops import streaming
    from finito_tpu_torch.query import engine
    from finito_tpu_torch.utils import trace

    opath = os.path.join(work, f"out_{mode}.txt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chain0, repair0 = streaming.make_chain_opt.launches, streaming.make_segment_repair.launches
    with engines_built(engine) as built:
        rc, logs, wall, launches = run_counted(
            cli.main, ["search-fmin", "-o", opath, "-i", prefix, "-q", qpath, "--engine", mode,
                       "--device", DEVICE])
    if rc != 0:
        raise RuntimeError(f"search-fmin --engine {mode} failed:\n{logs}")
    # the CLI's tally covers its run: one chain launch a chunk and re-run
    chain_n, chunks = streaming.make_chain_opt.launches - chain0, trace.counts.get("chunks", 0)
    if chain_n != trace.counts.get("chain.kernel", 0) or (
            chain_n < chunks if mode != "dense" else chain_n):
        raise AssertionError(f"search-fmin --engine {mode}: {chain_n} chain kernel launches, "
                             f"{trace.counts.get('chain.kernel', 0)} counted, {chunks} chunks")
    # and one repair launch with each chain launch, no trip, no straggler read
    repair_n = streaming.make_segment_repair.launches - repair0
    if (repair_n != trace.counts.get("repair.kernel", 0) or repair_n != chain_n
            or any(n.startswith(("trips.", "host_reads.straggler")) for n in trace.counts)):
        raise AssertionError(f"search-fmin --engine {mode}: {repair_n} repair kernel launches, "
                             f"{trace.counts.get('repair.kernel', 0)} counted, {chain_n} chain "
                             f"launches, counters {sorted(trace.counts)}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    (eng, build_s, jumps_s), = built
    us_io = float(re.findall(r"us/query: (\S+) \(excluding I/O etc\)", logs)[-1])
    us_e2e = float(re.findall(r"us/query end-to-end: (\S+)", logs)[-1])
    what = f"search-fmin --engine {mode} {genome_len} bp"
    log(f"{what}: engine tables {build_s} s (of which build_lcs_jump_tables {jumps_s} s), "
        f"wall {wall} s, us/query {us_io} (excluding I/O), "
        f"{us_e2e} (end to end), peak device memory {peak} MiB, front-end kernel launches "
        f"{launches}, chain and repair kernel launches {chain_n}, {repair_n} ({chunks} chunks, "
        f"{trace.counts.get('capacity_reruns', 0)} re-run)")
    check(what, opath, index.unitigs.concat, index.unitigs.ends,
          lambda reads: [oracle_line(index, r) for r in reads])
    with open(opath, "rb") as f, open(os.path.join(work, "out.txt"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{what}: output differs from the minimizer engine's")
    log(f"check {what}: output byte-identical to --engine minimizer's")
    batch = engine_batch(eng, both)
    row = {"engine": mode, "index_bp": genome_len, "tables_s": build_s,
           "lcs_jump_tables_s": jumps_s, "wall_s": wall,
           "us_query_excl_io": us_io, "us_query_e2e": us_e2e, "peak_mib": peak,
           "chain_kernel_launches": chain_n, "repair_kernel_launches": repair_n, "batch": batch}
    log(json.dumps(row))
    return eng, build_s


def host_reads(site: str = "") -> int:
    """utils.trace's count of device-to-host reads so far, at one site or
    at all of them."""
    from finito_tpu_torch.utils import trace

    return sum(n for name, n in trace.counts.items() if name.startswith("host_reads." + site))


def host_syncs(fn) -> int:
    """The synchronizing CUDA operations (device-to-host reads and
    blocking copies) of one call of fn, as torch.cuda.set_sync_debug_mode
    reports them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def device_busy(fn) -> dict:
    """One call of fn under torch.profiler, after a warm-up call: the
    device time of the operations it launched (kernels and copies), their
    count, the call's wall on the host clock (synchronised) and the
    device-busy share, their ratio (the profiler slows the host side, so
    the share is a lower bound)."""
    import torch

    box = {}

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        box["wall_ms"] = (time.perf_counter() - t0) * 1e3

    prof = phase_profile(timed, [])["all"]
    return {"device_ms": prof["device_ms"], "launches": prof["launches"],
            "wall_ms": box["wall_ms"], "busy": prof["device_ms"] / box["wall_ms"]}


@contextlib.contextmanager
def front_recorded():
    """The front-end kernel's launch count set to 0, and every input the
    minimizer locates give it on the card recorded while the block runs
    (by reference: a pipeline's input is not written meanwhile); yields
    the list of (codes, k, m)."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows
    from finito_tpu_torch.query import minimizer_engine

    seen = []

    def recorded(codes, k, m):
        if codes.is_cuda:
            seen.append((codes, k, m))
        return minimizer_windows(codes, k, m)

    torch.cuda.synchronize()
    minimizer_windows.launches = 0
    minimizer_engine.minimizer_windows = recorded
    try:
        yield seen
    finally:
        minimizer_engine.minimizer_windows = minimizer_windows


def pipeline_cell(eng, info: dict, reads: np.ndarray, reads_dev, expected, index,
                  forced: bool = False) -> tuple:
    """bench.py run_rung's protocol (bench.py:236-368) on the port's
    device-resident step, eng.make_device_pipeline, for one built
    engine: unknown_frac 0.02 (stream, replica) or 0.10; one call, then
    one re-size to frac = max(0.005, 1.3 n / (B W)) unless K/2 <= n <= K;
    fail if n > K or n_heads > K_heads after it; every window against
    expected ((uid, off): the analytic DSPSS oracle or the index-free
    oracle) and PIPE_VERIFY reads against FinimizerIndex.search; the
    synchronizing operations of one call (whose wall sizes reps);
    PIPE_TRIALS trials of reps
    calls chained through an on-device checksum read once at the end
    (the minimum kept); one call under torch.profiler. The front-end
    kernel's launches are counted from 0 over the whole protocol and held
    bit for bit to the plain version on every input. One JSON line.
    forced: the minimizer pipeline in the v2 form, its size threshold
    V2_MIN_DESC_BYTES at 0 (the pipeline, as JAX's, takes no variable).
    Returns (the launches, the checked call's (uid, off) on the card)."""
    import torch

    from finito_tpu_torch.io.seqdb import decode_seq
    from finito_tpu_torch.ops.minimizer_front import minimizer_windows
    from finito_tpu_torch.query import minimizer_engine

    mode = eng.mode
    B, L = reads_dev.shape
    W = L - K + 1
    form = (("v2" if forced or minimizer_engine.v2_by_size(eng._dmi) else "v1")
            if mode == "minimizer" else None)
    what = (f"pipeline {mode}{' ' + form if form else ''}{' (forced)' if forced else ''} "
            f"{info['cell']}")
    frac0 = frac = 0.02 if mode in ("stream", "replica") else 0.10
    with front_recorded() as seen, (mock.patch.object(minimizer_engine, "V2_MIN_DESC_BYTES", 0)
                                    if forced else contextlib.nullcontext()):
        pipe = eng.make_device_pipeline(B, L, unknown_frac=frac)
        out = pipe(reads_dev)
        n, K0 = int(out[2]), pipe.K
        if mode != "dense" and not (pipe.K // 2 <= n <= pipe.K):
            frac = max(0.005, 1.3 * n / (B * W))
            pipe = eng.make_device_pipeline(B, L, unknown_frac=frac)
            out = pipe(reads_dev)
            n = int(out[2])
        if n > pipe.K:
            raise AssertionError(f"{what}: {n} unknowns over K = {pipe.K} after the re-size")
        n_heads = int(out[3]) if pipe.K_heads else None
        if n_heads is not None and n_heads > pipe.K_heads:
            raise AssertionError(f"{what}: {n_heads} run heads over K_heads = {pipe.K_heads}")
        uid, off = out[0].cpu().numpy(), out[1].cpu().numpy()
        bad = int(((uid != expected[0]) | (off != expected[1])).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} windows disagree with {info['oracle']}")
        for b in range(0, B, B // PIPE_VERIFY):
            want = index.search(decode_seq(reads[b])).local_offsets
            if list(zip(uid[b].tolist(), off[b].tolist())) != want:
                raise AssertionError(f"{what}: read {b} disagrees with FinimizerIndex.search")
        r0 = host_reads("straggler")
        t0 = time.perf_counter()
        syncs = host_syncs(lambda: pipe(reads_dev))
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
        stragglers = host_reads("straggler") - r0
        if stragglers:
            raise AssertionError(f"{what}: {stragglers} straggler reads a call on the card")

        def chained(reps):
            s = torch.zeros((), dtype=torch.int64, device=reads_dev.device)
            for _ in range(reps):
                o = pipe(reads_dev)
                s = s + o[0].sum(dtype=torch.int64) + o[1].sum(dtype=torch.int64)
            return int(s)

        reps = max(1, min(50, int(PIPE_TIMED_S / PIPE_TRIALS / t_call)))
        dt = float("inf")
        for _ in range(PIPE_TRIALS):
            t0 = time.perf_counter()
            chained(reps)
            dt = min(dt, time.perf_counter() - t0)
        busy = device_busy(lambda: pipe(reads_dev))
        launches = minimizer_windows.launches
    log(f"check {what}: all {B * W} windows of {B} reads equal {info['oracle']}, "
        f"{PIPE_VERIFY} reads equal FinimizerIndex.search")
    if mode == "minimizer":
        if launches <= 0:
            raise AssertionError(f"{what}: the front-end kernel was not launched")
        check_inputs(what, seen, launches)
    elif launches:
        raise AssertionError(f"{what}: {launches} front-end launches on a path without it")
    ms = dt / reps * 1e3
    log(json.dumps({
        "pipeline": mode, "form": form, "forced_v2": forced, **info, "B": B, "L": L, "W": W,
        "unknown_frac": [frac0, frac], "K_first": K0, "K": pipe.K, "n_unknown": n,
        "slow_frac": n / (B * W), "K_heads": pipe.K_heads, "n_heads": n_heads,
        "found_frac": float((uid >= 0).mean()), "reps": reps, "trials": PIPE_TRIALS,
        "dt_s": dt, "ms_per_call": ms, "windows_per_s": reps * B * W / dt,
        "host_syncs_per_call": syncs, "straggler_reads_per_call": stragglers,
        "device_ms_per_call": busy["device_ms"], "operations_per_call": busy["launches"],
        "device_busy_profiled": busy["busy"], "device_busy": busy["device_ms"] / ms,
        "front_end_launches": launches}))
    return launches, out[:2]


def twin_phase(index, info: dict, reads_dev, rep_out, expected) -> None:
    """The in-scan replica twin (make_replica_locate) on the first
    TWIN_READS reads of the pipeline batch on the card: equal to the
    replica pipeline's rows (rep_out) and to the oracle (expected); the
    seconds of its tables and of its locate (with the sync counter on)
    and its synchronizing operations. One JSON line."""
    import torch

    from finito_tpu_torch.query.replica import make_replica_locate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    locate = make_replica_locate(index, DEVICE)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    codes = reads_dev[:TWIN_READS]
    box = {}
    t0 = time.perf_counter()
    syncs = host_syncs(lambda: box.update(out=locate(codes)))
    torch.cuda.synchronize()
    locate_s = time.perf_counter() - t0
    uid, off = box["out"]
    what = f"in-scan replica twin {info['cell']}"
    if not (torch.equal(uid, rep_out[0][:TWIN_READS]) and torch.equal(off, rep_out[1][:TWIN_READS])):
        raise AssertionError(f"{what}: differs from the replica pipeline's rows")
    if not (np.array_equal(uid.cpu().numpy(), expected[0][:TWIN_READS])
            and np.array_equal(off.cpu().numpy(), expected[1][:TWIN_READS])):
        raise AssertionError(f"{what}: differs from {info['oracle']}")
    log(f"check {what}: {TWIN_READS} reads equal the replica pipeline's rows and {info['oracle']}")
    log(json.dumps({"twin": "make_replica_locate", **info, "reads": TWIN_READS, "L": READ_LEN,
                    "tables_s": tables_s, "locate_s": locate_s, "host_syncs": syncs,
                    "windows_per_s": TWIN_READS * (READ_LEN - K + 1) / locate_s}))


def builder_fallback_phase(index, prefix: str, fna: str, work: str) -> None:
    """FinimizerIndexBuilder without node keys on the card (the windows
    ranked by search_batch_device in chunks of 2^20): its 7 files
    byte-identical to build-fmin's (prefix); the build's seconds, and the
    rank step alone over the same windows on the card and on the host
    (sbwt.search_batch), with equal ranks. One JSON line."""
    import torch

    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB
    from finito_tpu_torch.ops.bitvec import DeviceSBWT, search_batch_device

    sb = index.sbwt
    db = SeqDB.from_file(fna)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = FinimizerIndexBuilder(sb, index.LCS, db, node_keys=None, device=DEVICE).get_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fprefix = os.path.join(work, "fallback_idx")
    built.serialize(fprefix)
    for suffix in INDEX_FILES:
        with open(fprefix + suffix, "rb") as f, open(prefix + suffix, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"builder fallback on {DEVICE}: {suffix} differs from "
                                     "build-fmin's")
    concat = np.asarray(index.unitigs.concat)
    ends = np.asarray(index.unitigs.ends, np.int64)
    pos = np.arange(concat.size - K + 1)
    vpos = pos[pos + K <= ends[np.searchsorted(ends, pos, side="right")]]
    windows = np.lib.stride_tricks.sliding_window_view(concat, K)[vpos]
    CH = 1 << 20
    dsbwt = DeviceSBWT.from_host(sb, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = np.concatenate([
        search_batch_device(dsbwt, torch.from_numpy(np.ascontiguousarray(windows[s : s + CH]))
                            .to(DEVICE)).cpu().numpy() for s in range(0, vpos.size, CH)])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = np.concatenate([sb.search_batch(np.ascontiguousarray(windows[s : s + CH]))
                           for s in range(0, vpos.size, CH)])
    host_s = time.perf_counter() - t0
    if not np.array_equal(card, host) or (card < 0).any():
        raise AssertionError("search_batch_device and sbwt.search_batch disagree")
    log(f"check builder fallback {concat.size} bp: FinimizerIndexBuilder(node_keys=None, "
        f"device={DEVICE!r}) writes build-fmin's {len(INDEX_FILES)} files byte for byte")
    log(json.dumps({"builder_fallback": int(concat.size), "device": DEVICE, "build_s": build_s,
                    "windows": int(vpos.size), "rank_card_s": card_s, "rank_host_s": host_s}))


def repeat_phase(seed: int) -> dict:
    """The repeat-dense cell: gen_repeat_genome(REPEAT_LEN,
    **REPEAT_PARAMS), its non-canonical dBG unitigs, the index by
    build_plain_matrix_sbwt(return_keys=True) + lcs_array +
    FinimizerIndexBuilder(node_keys=...); then the pipeline of every
    engine mode on one batch (pipeline_cell, checked against
    kmer_location_oracle) and the in-scan twin (twin_phase). Returns the
    front-end launches of each pipeline."""
    import torch

    from finito_tpu_torch.dbg import build_unitigs
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB, decode_seq
    from finito_tpu_torch.query.engine import DeviceQueryEngine
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array
    from finito_tpu_torch.utils.synth import REPEAT_PARAMS, gen_repeat_genome, kmer_location_oracle

    t0 = time.perf_counter()
    genome = gen_repeat_genome(np.random.default_rng(seed + 11), REPEAT_LEN, **REPEAT_PARAMS)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    unitigs = [decode_seq(u) for u in build_unitigs([genome], K, canonical=False)]
    dbg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sb, keys = build_plain_matrix_sbwt(unitigs, K, return_keys=True)
    index = FinimizerIndexBuilder(sb, lcs_array(sb), SeqDB.from_sequences(unitigs),
                                  node_keys=keys).get_index()
    build_s = time.perf_counter() - t0
    del keys
    info = {"cell": f"repeat {REPEAT_LEN} bp", "index_bp": REPEAT_LEN,
            "nodes": sb.number_of_subsets(), "index_build_s": build_s,
            "oracle": "kmer_location_oracle"}
    log(f"index {info['cell']} ({REPEAT_PARAMS}): gen_repeat_genome {gen_s} s, "
        f"{len(unitigs)} unitigs by build_unitigs (non-canonical) {dbg_s} s, "
        f"{info['nodes']} nodes, index build {build_s} s")
    _, reads, _ = sample_reads(np.random.default_rng(seed + 12), genome, PIPE_BATCH)
    t0 = time.perf_counter()
    expected = kmer_location_oracle(index.unitigs.concat, index.unitigs.ends, reads, K)
    log(f"kmer_location_oracle {info['cell']}: {reads.shape[0]} reads in "
        f"{time.perf_counter() - t0} s")
    reads_dev = torch.from_numpy(reads).to(DEVICE)
    launches = {}
    for mode in ("minimizer", "dense", "stream", "replica"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = DeviceQueryEngine(index, mode=mode, device=DEVICE)
        torch.cuda.synchronize()
        n, out = pipeline_cell(eng, {**info, "engine_s": time.perf_counter() - t0}, reads,
                               reads_dev, expected, index)
        launches[f"pipeline {mode} {info['cell']}"] = n
        if mode == "replica":
            twin_phase(index, info, reads_dev, out, expected)
        del eng, out
        torch.cuda.empty_cache()
    return launches


def run_counted(main, argv, seen=None):
    """One CLI call of a main path with the front-end kernel's launch
    count set to 0 just before it and read just after. When seen is a
    list, a copy of every input (codes, k, m) the run gives the front end
    on the card is appended to it. Returns (exit code, stderr text, wall
    seconds, launches)."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows
    from finito_tpu_torch.parallel import mesh
    from finito_tpu_torch.query import minimizer_engine

    def recorded(codes, k, m):
        if codes.is_cuda:
            seen.append((codes.clone(), k, m))
        return minimizer_windows(codes, k, m)

    torch.cuda.synchronize()
    minimizer_windows.launches = 0
    if seen is not None:
        # the callers of the front end: the single-device locates and the
        # mesh's shards
        minimizer_engine.minimizer_windows = mesh.minimizer_windows = recorded
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = main(argv)
    except SystemExit as e:
        rc = e.code
    finally:
        minimizer_engine.minimizer_windows = mesh.minimizer_windows = minimizer_windows
    wall = time.perf_counter() - t0
    return rc, err.getvalue(), wall, minimizer_windows.launches


def check_inputs(what: str, seen: list, launches: int) -> int:
    """The front-end kernel against its plain version, bit for bit, on
    every input a main-path run gave it; returns the largest error."""
    if len(seen) != launches:
        raise AssertionError(f"{what}: {launches} kernel launches but {len(seen)} recorded inputs")
    err, shapes = 0, {}
    for codes, k, m in seen:
        e = compare_front(codes, k, m, codes.shape[0])
        if e:
            raise AssertionError(f"{what}: front-end kernel disagrees with the plain version at "
                                 f"{(*codes.shape, k, m)}")
        shape = (*codes.shape, k, m)
        shapes[shape] = shapes.get(shape, 0) + 1
        err = max(err, e)
    log(f"kernel at {what}'s own inputs: bit-exact at every launch, (B, L, k, m): "
        + ", ".join(f"{s} x{n}" for s, n in shapes.items()))
    return err


def search_phase(genome_len, prefix, qpath, work, check):
    """search-fmin through the port's CLI, its output held to check and
    the kernel held to its plain version on the run's own inputs.
    Returns (its kernel launches, the loaded FinimizerIndex)."""
    from finito_tpu_torch import cli
    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.query import locators

    opath = os.path.join(work, "out.txt")
    seen = []
    with forms_picked(locators) as picked:
        rc, logs, wall, launches = run_counted(
            cli.main, ["search-fmin", "-o", opath, "-i", prefix, "-q", qpath, "--device", DEVICE],
            seen)
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
    check_inputs(f"search-fmin {genome_len} bp", seen, launches)

    index = FinimizerIndex.load(prefix)
    check(f"search-fmin {genome_len} bp", opath, index.unitigs.concat, index.unitigs.ends,
          lambda reads: [oracle_line(index, r) for r in reads])
    return launches, index


def kmer_mapper_phase(genome_len, fna, qpath, work, check, n_win) -> int:
    """kmer-mapper build and query -r --device cuda through the port's
    CLI, its output held to check and the kernel held to its plain
    version on the query's own inputs; then the multi-occurrence error.
    Returns the query's kernel launches."""
    from finito_tpu_torch import cli, kmer_mapper
    from finito_tpu_torch.index.minimizer import MinimizerIndex
    from finito_tpu_torch.io.fastx import read_all_records

    km, kout = os.path.join(work, "km.idx"), os.path.join(work, "km.txt")
    t0 = time.perf_counter()
    rc, logs, _, _ = run_counted(cli.main, ["kmer-mapper", "build", "-u", fna, "-k", str(K),
                                            "-o", km])
    if rc != 0:
        raise RuntimeError(f"kmer-mapper build failed:\n{logs}")
    log(f"kmer-mapper build {genome_len} bp: {time.perf_counter() - t0} s")
    seen = []
    with forms_picked(kmer_mapper) as picked:
        rc, logs, wall, launches = run_counted(
            cli.main, ["kmer-mapper", "query", "-i", km, "-q", qpath, "-r", "-o", kout,
                       "--device", DEVICE], seen)
    if rc != 0:
        raise RuntimeError(f"kmer-mapper query failed:\n{logs}")
    form = "v2" if picked == [True] else "v1" if picked == [False] else f"? {picked}"
    log(f"kmer-mapper query -r {genome_len} bp: locate {form}, wall {wall} s, {n_win} windows, "
        f"{n_win / wall} windows/s (both strands, incl. index load and output), "
        f"front-end kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("kmer-mapper query did not launch the front-end kernel")
    check_inputs(f"kmer-mapper query -r {genome_len} bp", seen, launches)

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


@contextlib.contextmanager
def sharded_builds(mesh):
    """Records the seconds of every ShardedMinimizerIndex.build while the
    block runs."""
    times, build = [], mesh.ShardedMinimizerIndex.build

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = build(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    mesh.ShardedMinimizerIndex.build = staticmethod(timed)
    try:
        yield times
    finally:
        mesh.ShardedMinimizerIndex.build = staticmethod(build)


def mesh_batch(eng, codes_both: np.ndarray) -> dict:
    """One (8192, 128) CLI chunk through a mesh engine's locate with its
    deferred verify: ms by CUDA events, device time and operations by
    torch.profiler (whole and per record_function range), the front-end
    launches and host reads of one locate, n_slow against the K its
    capacity loop settled on."""
    import torch

    from finito_tpu_torch.ops.minimizer_front import minimizer_windows
    from finito_tpu_torch.query.engine import _pad_codes

    codes = torch.from_numpy(_pad_codes(codes_both)).to(eng.device)
    B, L = codes.shape
    loc = eng.locator
    reruns = []

    def locate():
        uid, off, verify = loc.dispatch(codes)
        reruns.append(verify() is not None)
        return uid, off

    locate()
    torch.cuda.synchronize()
    r0, l0 = host_reads(), minimizer_windows.launches
    locate()
    torch.cuda.synchronize()
    # the shards' trip-count reads, and the verify's one read of n_slow
    res = {"B": B, "L": L, "host_reads": host_reads() - r0,
           "front_end_launches": minimizer_windows.launches - l0,
           "K": loc.sizes[(B, L)][0], "n_slow": int(loc.locate_at(loc.sizes[(B, L)])(codes)[2])}
    res["ms"] = [time_cuda(locate, reps=5, warmup=1) for _ in range(2)]
    prof = phase_profile(locate, ["mesh_shards", "mesh_combine"])
    res["device_ms"], res["launches"] = prof["all"]["device_ms"], prof["all"]["launches"]
    res["phases"] = {name: prof[name] for name in ("mesh_shards", "mesh_combine")}
    res["reruns"] = sum(reruns)
    return res


def mesh_phase(genome_len, prefix, qpath, work, check, index, both) -> dict:
    """search-fmin's own serving loop (cli._run_queries_streaming) over a
    DeviceQueryEngine on each (dp, tp) mesh of MESHES, every device of
    the mesh cuda:0: every window against the analytic oracle and probe
    reads against the host oracle (check), the output byte-identical to
    the single-device minimizer run's (out.txt), the kernel bit for bit
    on every input the run gave it; the sharded index's build time,
    wall, µs/query, peak memory and one chunk's locate (mesh_batch), one
    JSON line per mesh. Where dp * tp cards are visible also search-fmin
    --mesh dp,tp --device cuda through the CLI. Returns the front-end
    launches of each mesh's run."""
    import torch

    from finito_tpu_torch import cli
    from finito_tpu_torch.io.fastx import SequenceReader
    from finito_tpu_torch.parallel import mesh
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    with open(os.path.join(work, "out.txt"), "rb") as f:
        single = f.read()
    launches = {}
    for dp, tp in MESHES:
        n, cfg = dp * tp, f"{dp},{tp}"
        what = f"search-fmin --mesh {cfg} {genome_len} bp"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with sharded_builds(mesh) as builds:
            eng = DeviceQueryEngine(index, mode="minimizer", mesh=(dp, tp),
                                    devices=[DEVICE + ":0"] * n)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        opath = os.path.join(work, f"out_mesh_{dp}_{tp}.txt")
        served = []

        def serve(_argv):
            with SequenceReader(qpath) as reader, open(opath, "w") as out:
                served.append(cli._run_queries_streaming(
                    reader, out, index, os.path.join(work, f"mesh_{dp}_{tp}.stats"), eng))
            return 0

        seen = []
        rc, logs, wall, n_launch = run_counted(serve, [], seen)
        if rc != 0:
            raise RuntimeError(f"{what} failed:\n{logs}")
        us_io = float(re.findall(r"us/query: (\S+) \(excluding I/O etc\)", logs)[-1])
        log(f"{what} ({n} shards, all on {DEVICE}:0): ShardedMinimizerIndex.build {builds[0]} s "
            f"(h={eng.locator.sharded.h}), engine {engine_s} s, serving loop wall {wall} s, "
            f"{served[0]} queries, us/query {us_io} (excluding I/O), front-end kernel launches "
            f"{n_launch}")
        if n_launch <= 0 or n_launch % n:
            raise AssertionError(f"{what}: {n_launch} front-end launches, not a multiple of {n} shards")
        check_inputs(what, seen, n_launch)
        check(what, opath, index.unitigs.concat, index.unitigs.ends,
              lambda reads: [oracle_line(index, r) for r in reads])
        with open(opath, "rb") as f:
            if f.read() != single:
                raise AssertionError(f"{what}: output differs from the single-device run's")
        log(f"check {what}: output byte-identical to the single-device minimizer run's")
        launches[cfg] = n_launch
        if torch.cuda.device_count() >= n:
            cpath = os.path.join(work, f"out_cli_mesh_{dp}_{tp}.txt")
            rc, logs, cwall, cl = run_counted(
                cli.main, ["search-fmin", "-o", cpath, "-i", prefix, "-q", qpath,
                           "--mesh", cfg, "--device", DEVICE])
            with open(cpath, "rb") as f:
                if rc != 0 or f.read() != single:
                    raise AssertionError(f"search-fmin --mesh {cfg} --device {DEVICE}: exit {rc} "
                                         f"or output differs:\n{logs}")
            cli_form = (f"search-fmin --mesh {cfg} --device {DEVICE} on {n} cards: bytes equal, "
                        f"wall {cwall} s, {cl} front-end launches")
        else:
            cli_form = (f"not run: {torch.cuda.device_count()} card(s) visible, search-fmin "
                        f"--mesh {cfg} --device {DEVICE} needs {n}")
        log(f"{what}: the CLI form: {cli_form}")
        batch = mesh_batch(eng, both)
        log(json.dumps({
            "mesh": cfg, "shards": n, "devices": f"{DEVICE}:0 x{n}", "index_bp": genome_len,
            "sharded_build_s": builds[0], "engine_s": engine_s, "h": eng.locator.sharded.h,
            "desc_mib_per_shard": eng.locator.sharded.desc[0].nbytes / 2**20,
            "serving_wall_s": wall, "queries": served[0], "us_query_wall": wall / served[0] * 1e6,
            "us_query_excl_io": us_io, "front_end_launches": n_launch, "cli_form": cli_form,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "batch": batch}))
        del eng
        torch.cuda.empty_cache()
    return launches


def lcs_phase(genome_len: int, index) -> None:
    """The LCS array of the index on the host (sbwt.lcs_array), on the
    card (ops.lcs_device) and sharded over a mesh of LCS_SHARDS x cuda:0
    (parallel.mesh.sharded_lcs_fn): all equal to the index's own LCS;
    seconds of each, twice for the device forms."""
    import torch

    from finito_tpu_torch.ops.lcs_device import lcs_array_device
    from finito_tpu_torch.parallel.mesh import make_mesh, sharded_lcs_fn
    from finito_tpu_torch.sbwt.lcs import lcs_array

    sbwt = index.sbwt
    t0 = time.perf_counter()
    host = lcs_array(sbwt)
    row = {"lcs": genome_len, "nodes": sbwt.number_of_subsets(), "k": sbwt.get_k(),
           "host_s": time.perf_counter() - t0, "device_s": [], "sharded_s": [],
           "shards": LCS_SHARDS}
    if not np.array_equal(host, np.asarray(index.LCS)):
        raise AssertionError("lcs_array differs from the index's LCS file")
    mesh = make_mesh(LCS_SHARDS, tp=1, devices=[DEVICE + ":0"] * LCS_SHARDS)
    for name, fn in (("device_s", lambda: lcs_array_device(sbwt, DEVICE)),
                     ("sharded_s", lambda: sharded_lcs_fn(mesh, sbwt))):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()  # host int64: the readback synchronises
            row[name].append(time.perf_counter() - t0)
            if not np.array_equal(got, host):
                raise AssertionError(f"LCS {name[:-2]} differs from the host lcs_array")
    log(f"check LCS {genome_len} bp: lcs_array_device and sharded_lcs_fn ({LCS_SHARDS} shards) "
        f"equal the host lcs_array over {row['nodes']} nodes")
    log(json.dumps(row))


@contextlib.contextmanager
def timed_calls(targets):
    """Seconds of every call, synchronised before and after, of each
    (module, name) in targets while the block runs, summed by name; the
    mesh builds' sorts, all_to_all transposes and scatters likewise,
    under "op sort", "op all_to_all" and "op scatter" (inside the
    phases, so not to be added to them); and the overflow retries: the
    nonzero results of the mesh builds' _total (every retry loop reads
    its summed overflow count through it)."""
    import torch

    from finito_tpu_torch.ops import keys
    from finito_tpu_torch.parallel import shard_build, shard_dbg

    seconds, retries, saved = {}, [0], []
    ops = [(keys, "argsort_rows", "op sort"), (shard_build, "_all_to_all", "op all_to_all"),
           (shard_build, "_scatter_rows", "op scatter")]

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    def total(parts):
        n = shard_build_total(parts)
        retries[0] += n > 0
        return n

    shard_build_total = shard_build._total
    for module, name, label in [(m, n, n) for m, n in targets] + ops:
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, wrap(label, getattr(module, name)))
    for module in (shard_build, shard_dbg):
        saved.append((module, "_total", module._total))
        module._total = total
    try:
        yield seconds, retries
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def probe_codes(reads):
    """Reads as one (B, L) code batch, 255 past each read's end."""
    from finito_tpu_torch.io.seqdb import encode_seq

    codes = np.full((len(reads), max(len(r) for r in reads)), 255, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = encode_seq(r)
    return codes


def mesh_index_build_phase(genome_len: int, prefix: str, fna: str, work: str, index, probe) -> int:
    """sharded_index_build on a flat mesh of MESH_BUILD_SHARDS shards,
    every one on cuda:0, from the DSPSS unitigs: every array equal to the
    index build-fmin wrote (prefix, loaded as index) and its files byte-
    identical; ShardedIndex.build(tp=MESH_BUILD_SHARDS) equal to
    from_index on the card's position table, and its sharded_locate_fn
    equal to FinimizerIndex.search on the probe reads. One JSON line:
    seconds per phase, overflow retries, counts, peak device memory,
    host peak RSS, and the same build on the host. Returns the front-end
    kernel's launches during the build (the build path runs none)."""
    import torch

    from finito_tpu_torch.index import packed_strings
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.fastx import read_all_records
    from finito_tpu_torch.io.seqdb import SeqDB
    from finito_tpu_torch.ops.bitvec import DeviceSBWT
    from finito_tpu_torch.ops.minimizer_front import minimizer_windows
    from finito_tpu_torch.parallel import mesh, shard_build
    from finito_tpu_torch.query.locators import build_position_table
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array
    from finito_tpu_torch.tools import HOST_RSS_SOURCE, host_peak

    n_sh = MESH_BUILD_SHARDS
    seqs = [bytes(seq) for _h, seq in read_all_records(fna)]
    what = f"sharded_index_build {genome_len} bp"
    # the same build on the host: build-fmin's path, in process
    t0 = time.perf_counter()
    with host_peak() as host_rss:
        sb, keys = build_plain_matrix_sbwt(seqs, K, return_keys=True)
        builder = FinimizerIndexBuilder(sb, lcs_array(sb), SeqDB.from_sequences(seqs),
                                        node_keys=keys)
        builder.get_index()
    host_s = time.perf_counter() - t0
    del sb, keys, builder

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    targets = [(shard_build, "sharded_sbwt_build"), (mesh, "sharded_lcs_fn"),
               (packed_strings, "permute_unitigs"), (shard_build, "sharded_finimizer_select")]
    minimizer_windows.launches = 0
    t0 = time.perf_counter()
    with host_peak() as rss, timed_calls(targets) as (phases, retries):
        got = shard_build.sharded_index_build(seqs, K, devices=[DEVICE + ":0"] * n_sh)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = minimizer_windows.launches
    peak = torch.cuda.max_memory_allocated() / 2**20

    # every array and the files against the host-built index
    for name in ("LCS", "fmin", "global_offsets", "Ustart"):
        if not np.array_equal(getattr(got, name), getattr(index, name)):
            raise AssertionError(f"{what}: {name} differs from the host-built index")
    for a, b in ((got.sbwt.bit_rows(), index.sbwt.bit_rows()),
                 (got.sbwt.get_C_array(), index.sbwt.get_C_array()),
                 (got.unitigs.concat, index.unitigs.concat), (got.unitigs.ends, index.unitigs.ends)):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"{what}: the SBWT or the unitig text differs from the host's")
    mprefix = os.path.join(work, "mesh_idx")
    got.serialize(mprefix)
    for suffix in INDEX_FILES:
        with open(mprefix + suffix, "rb") as f, open(prefix + suffix, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{what}: {suffix} is not byte-identical to build-fmin's")
    log(f"check {what} ({n_sh} shards on {DEVICE}:0): every array equals the host-built index, "
        f"the {len(INDEX_FILES)} index files are byte-identical to build-fmin's")

    # the tp-sharded SBWT locate tables from mesh_pos, and their locate
    t1 = time.perf_counter()
    built = mesh.ShardedIndex.build(got, tp=n_sh)
    tables_s = time.perf_counter() - t1
    pos = build_position_table(DeviceSBWT.from_host(index.sbwt, DEVICE), index.unitigs.concat,
                               index.unitigs.ends)
    ref = mesh.ShardedIndex.from_index(index, pos, tp=n_sh)
    for name in ("words", "blocks", "loc_table", "node_start", "C", "ends"):
        if not np.array_equal(getattr(built, name), getattr(ref, name)):
            raise AssertionError(f"ShardedIndex.build: {name} differs from from_index")
    grid = mesh.make_mesh(n_sh, tp=n_sh, devices=[DEVICE + ":0"] * n_sh)
    uid, off = mesh.sharded_locate_fn(grid, built)(probe_codes(probe))
    uid, off = uid.cpu().numpy(), off.cpu().numpy()
    for i, r in enumerate(probe):
        want = index.search(r).local_offsets
        if list(zip(uid[i, : len(want)].tolist(), off[i, : len(want)].tolist())) != want:
            raise AssertionError(f"sharded_locate_fn on ShardedIndex.build disagrees with "
                                 f"FinimizerIndex.search: {r!r}")
    log(f"check ShardedIndex.build(tp={n_sh}) {genome_len} bp: equal to from_index on the "
        f"card's position table; its sharded_locate_fn equals FinimizerIndex.search on "
        f"{len(probe)} probe reads")
    log(json.dumps({
        "build": "sharded_index_build", "index_bp": genome_len, "k": K, "shards": n_sh,
        "devices": f"{DEVICE}:0 x{n_sh}", "wall_s": wall, "phases_s": phases,
        "overflow_retries": retries[0], "front_end_launches": launches,
        "nodes": got.sbwt.number_of_subsets(),
        "kmers": got.sbwt.number_of_kmers(), "unitigs": int(np.asarray(got.unitigs.ends).size),
        "peak_device_mib": peak, "host_peak_rss_mib": rss["mib"],
        "sharded_index_tables_s": tables_s, "host_build_s": host_s,
        "host_rss_at_start_mib": rss["mib_at_start"],
        "host_build_peak_rss_mib": host_rss["mib"], "host_rss_source": HOST_RSS_SOURCE}))
    del got, built, ref, pos
    torch.cuda.empty_cache()
    return launches


def gen_pangenome(rng, base_len: int, n_var: int, snp: float) -> list:
    """A random base genome and n_var copies with snp * base_len point
    substitutions each (the shape of scripts/pangenome_verify.py)."""
    base = rng.integers(0, 4, size=base_len, dtype=np.uint8)
    out = [base]
    for _ in range(n_var):
        v = base.copy()
        pos = rng.choice(base_len, size=max(1, int(snp * base_len)), replace=False)
        v[pos] = (v[pos] + rng.integers(1, 4, size=pos.size)) % 4
        out.append(v)
    return out


def mesh_unitig_phase(seed: int, work: str) -> int:
    """unitigs --mesh MESH_BUILD_SHARDS through the port's CLI on a
    pangenome (PANGENOME), with --device cuda:0 (every shard on the
    one card) and --device cuda (one shard a visible card): each file
    byte-identical to the port's host unitigs on the same input. One
    JSON line: seconds per phase, overflow retries, counts, peak device
    memory, host peak RSS, and the host build's seconds and RSS. Returns
    the front-end kernel's launches in the mesh runs (the build path runs
    none)."""
    import torch

    from finito_tpu_torch import cli, dbg
    from finito_tpu_torch.io.seqdb import decode_seq
    from finito_tpu_torch.parallel import shard_dbg
    from finito_tpu_torch.tools import HOST_RSS_SOURCE, host_peak

    base_len, n_var, snp, k = PANGENOME
    n_sh = MESH_BUILD_SHARDS
    seqs = gen_pangenome(np.random.default_rng(seed + 7), base_len, n_var, snp)
    fna = os.path.join(work, "pangenome.fna")
    with open(fna, "wb") as f:
        for i, v in enumerate(seqs):
            f.write(b">v%d\n%s\n" % (i, decode_seq(v)))
    what = f"unitigs --mesh {n_sh} {base_len} bp x{n_var + 1}"

    host_out = os.path.join(work, "pan_host.fna")
    with host_peak() as host_rss:
        rc, logs, host_s, _ = run_counted(cli.main, ["unitigs", "-k", str(k), "-i", fna,
                                                     "-o", host_out])
    if rc != 0:
        raise RuntimeError(f"unitigs (host) failed:\n{logs}")
    with open(host_out, "rb") as f:
        want = f.read()

    rows, launches = {}, 0
    for device in (DEVICE + ":0", DEVICE):
        out = os.path.join(work, f"pan_mesh_{device.replace(':', '')}.fna")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        targets = [(shard_dbg, "_pack_shards"), (shard_dbg, "_distinct"),
                   (dbg, "links_to_unitigs")]
        with host_peak() as rss, timed_calls(targets) as (phases, retries):
            rc, logs, wall, n = run_counted(cli.main, ["unitigs", "-k", str(k), "-i", fna, "-o", out,
                                                        "--mesh", str(n_sh), "--device", device])
        launches += n
        if rc != 0:
            raise RuntimeError(f"{what} --device {device} failed:\n{logs}")
        with open(out, "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{what} --device {device}: not byte-identical to the host build")
        shards = n_sh if device != DEVICE else min(n_sh, torch.cuda.device_count())
        counts = re.findall(r"(\d+) unitigs, (\d+) distinct canonical k-mers", logs)[-1]
        log(f"check {what} --device {device} ({shards} shard(s)): the file is byte-identical to "
            f"the host unitigs' ({counts[0]} unitigs, {counts[1]} canonical k-mers)")
        rows[device] = {"shards": shards, "wall_s": wall, "phases_s": phases,
                        "overflow_retries": retries[0], "front_end_launches": n,
                        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
                        "host_peak_rss_mib": rss["mib"],
                        "host_rss_at_start_mib": rss["mib_at_start"]}
    log(json.dumps({
        "build": "unitigs --mesh", "base_bp": base_len, "variants": n_var, "snp": snp, "k": k,
        "input_bp": base_len * (n_var + 1), "unitigs": int(counts[0]), "kmers": int(counts[1]),
        "runs": rows, "host_build_s": host_s, "host_build_peak_rss_mib": host_rss["mib"],
        "host_rss_source": HOST_RSS_SOURCE}))
    return launches


def dist_worker(argv) -> int:
    """One rank of dist_phase: join the gloo group, run this rank's read
    slice on cuda:0, write its part; rank 0 merges after the barrier."""
    import torch.distributed as tdist

    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    pid, nproc, port, prefix, qpath, out = argv
    pid, nproc = int(pid), int(nproc)
    t0 = time.perf_counter()
    if dist.init_distributed(f"localhost:{port}", nproc, pid) != (pid, nproc):
        raise AssertionError("the process group has another rank or size")
    engine = DeviceQueryEngine(FinimizerIndex.load(prefix), device=DEVICE + ":0")
    reads = read_reads(qpath)
    t1 = time.perf_counter()
    dist.run_distributed_queries(engine, reads, out, pid, nproc, barrier=True)
    if not os.path.exists(out):
        raise AssertionError("the merged file is missing after the barrier")
    log(json.dumps({"rank": pid, "world": nproc, "backend": tdist.get_backend(),
                    "reads": len(dist.split_for_process(reads, pid, nproc)),
                    "setup_s": t1 - t0, "queries_s": time.perf_counter() - t1}))
    tdist.destroy_process_group()
    return 0


def read_reads(path: str) -> list:
    from finito_tpu_torch.io.fastx import SequenceReader

    with SequenceReader(path) as reader:
        return [bytes(seq) for _h, seq in reader]


def dist_phase(genome_len: int, prefix: str, qpath: str, work: str, index) -> None:
    """run_distributed_queries in 2 processes (this script with
    --dist-worker), each on cuda:0, joined by a gloo group on localhost:
    the merged file byte-identical to the single-process run and to the
    CLI's output (out.txt)."""
    import socket

    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_multi = os.path.join(work, "dist.txt")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker", str(pid),
                               "2", str(port), prefix, qpath, out_multi],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"dist worker exit {p.returncode}:\n{se.decode()[-3000:]}")
    ranks = [json.loads(so.decode().strip().splitlines()[-1]) for so, _ in outs]
    single = os.path.join(work, "dist_single.txt")
    t0 = time.perf_counter()
    dist.run_distributed_queries(DeviceQueryEngine(index, device=DEVICE), read_reads(qpath),
                                 single, 0, 1)
    single_s = time.perf_counter() - t0
    with open(out_multi, "rb") as f, open(single, "rb") as g, \
            open(os.path.join(work, "out.txt"), "rb") as h:
        multi = f.read()
        if multi != g.read() or multi != h.read():
            raise AssertionError("the 2-process run differs from the single run or the CLI's output")
    log(f"check run_distributed_queries {genome_len} bp, 2 processes on {DEVICE}:0 (gloo): merged "
        "file byte-identical to the single-process run and to search-fmin's output")
    log(json.dumps({"distributed": genome_len, "processes": 2, "wall_s": wall,
                    "single_s": single_s, "ranks": ranks}))


def xproc_worker(argv) -> int:
    """One rank of xproc_phase: join the group (gloo: both ranks on
    cuda:0; nccl: cuda:<rank>), hold XPROC_SHARDS shards of a global
    4-shard mesh on its card, and run the cross-process
    sharded_index_build (its files against build-fmin's at PREFIX), the
    sharded minimizer locate on each mesh of XPROC_MESHES over the batch
    in WORK/xproc_both.npy (the front-end kernel held bit for bit to its
    plain version at every launch of the main-path call; answers to
    WORK for the parent) and the LCS (against the index's). Logs one
    JSON line: wall per step, collectives, staged bytes, host reads and
    peak device memory."""
    import torch
    import torch.distributed as tdist

    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.io.fastx import read_all_records
    from finito_tpu_torch.ops.minimizer_front import minimizer_windows
    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.parallel import mesh, shard_build
    from finito_tpu_torch.query.locators import Optimistic, minimizer_policy

    pid, nproc, port, backend, prefix, fna, work = argv
    pid, nproc = int(pid), int(nproc)
    card = torch.device(DEVICE, pid if backend == "nccl" else 0)
    torch.cuda.set_device(card)
    t0 = time.perf_counter()
    if dist.init_distributed(f"localhost:{port}", nproc, pid, backend=backend,
                             timeout=XPROC_TIMEOUT) != (pid, nproc):
        raise AssertionError("the process group has another rank or size")
    devs = dist.global_devices([card] * XPROC_SHARDS)
    row = {"xproc_rank": pid, "world": nproc, "backend": backend, "card": str(card),
           "owners": devs.owners, "setup_s": time.perf_counter() - t0}
    what = f"xproc {backend} rank{pid}"

    # the build: each rank packs only its shards, every rank gets the index
    seqs = [bytes(s) for _h, s in read_all_records(fna)]
    calls, put = [], shard_build._put_shard_blocks

    def counted(devs_, block_fn):
        return put(devs_, lambda s: (calls.append(s), block_fn(s))[1])

    torch.cuda.reset_peak_memory_stats(card)
    shard_build._put_shard_blocks = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = shard_build.sharded_index_build(seqs, K, devices=devs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        shard_build._put_shard_blocks = put
    if not set(calls) <= set(devs.local):
        raise AssertionError(f"{what} packed shards {sorted(set(calls))}, holds {devs.local}")
    mprefix = os.path.join(work, f"xproc_{backend}_r{pid}")
    got.serialize(mprefix)
    for suffix in INDEX_FILES:
        with open(mprefix + suffix, "rb") as f, open(prefix + suffix, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{what}: {suffix} is not byte-identical to build-fmin's")
    log(f"check {what}: sharded_index_build over {len(devs)} shards in {nproc} processes: the "
        f"{len(INDEX_FILES)} index files byte-identical to build-fmin's; packed shard blocks "
        f"{sorted(set(calls))} of its shards {devs.local}")
    row["build"] = {"wall_s": build_s, "collectives": devs.stats["collectives"],
                    "staged_bytes": devs.stats["staged_bytes"],
                    "peak_mib": torch.cuda.max_memory_allocated(card) / 2**20,
                    "nodes": got.sbwt.number_of_subsets()}
    del got
    torch.cuda.empty_cache()

    # the locates: the main-path call counted, then timed steps
    index = FinimizerIndex.load(prefix)
    concat = np.asarray(index.unitigs.concat, np.uint8)
    ends = np.asarray(index.unitigs.ends, np.int64)
    codes = torch.from_numpy(np.load(os.path.join(work, "xproc_both.npy")))
    B, L = codes.shape
    row["meshes"] = {}
    for dp, tp in XPROC_MESHES:
        torch.cuda.reset_peak_memory_stats(card)
        grid = mesh.make_mesh(len(devs), tp=tp, devices=devs)
        t0 = time.perf_counter()
        sh = mesh.ShardedMinimizerIndex.build(concat, ends, K, tp=tp)
        tables = mesh.place_minimizer_shards(grid, sh)
        sh_s = time.perf_counter() - t0

        def fn_for(K_slow):
            return mesh.sharded_minimizer_locate_fn(grid, sh, K_slow, tables=tables)

        seen = []

        def recorded(c, k, m):
            seen.append((c.clone(), k, m))
            return minimizer_windows(c, k, m)

        torch.cuda.synchronize()
        minimizer_windows.launches = 0
        mesh.minimizer_windows = recorded
        try:
            # the engine's capacity loop (n_slow is the same on every rank)
            check = Optimistic(lambda caps: fn_for(caps[0])(codes),
                               *minimizer_policy(B, L, K, False))
            check.verify()
            (uid, off, _), (n_slow,), K_used = check.out, check.counters, check.caps[0]
            torch.cuda.synchronize()
        finally:
            mesh.minimizer_windows = minimizer_windows
        launches = minimizer_windows.launches
        err = check_inputs(f"{what} ({dp},{tp})", seen, launches)
        np.savez(os.path.join(work, f"xproc_{backend}_{dp}x{tp}_r{pid}.npz"),
                 uid=uid.cpu().numpy(), off=off.cpu().numpy())
        fn = fn_for(K_used)
        c0, b0, r0 = grid.flat.stats["collectives"], grid.flat.stats["staged_bytes"], host_reads()
        walls = []
        for _ in range(XPROC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(codes)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        row["meshes"][f"{dp},{tp}"] = {
            "B": B, "L": L, "shards_here": int((grid.owners == pid).sum()),
            "sharded_index_s": sh_s, "front_end_launches": launches, "max_abs_err": err,
            "n_slow": n_slow, "K_slow": K_used, "step_ms": [w * 1e3 for w in walls],
            "collectives_per_step": (grid.flat.stats["collectives"] - c0) / XPROC_STEPS,
            "staged_bytes_per_step": (grid.flat.stats["staged_bytes"] - b0) / XPROC_STEPS,
            "host_reads_per_step": (host_reads() - r0) / XPROC_STEPS,
            "peak_mib": torch.cuda.max_memory_allocated(card) / 2**20}
        del grid, sh, tables, seen
        torch.cuda.empty_cache()

    # the LCS
    c0, b0 = devs.stats["collectives"], devs.stats["staged_bytes"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lcs = mesh.sharded_lcs_fn(devs, index.sbwt)
    lcs_s = time.perf_counter() - t0
    if not np.array_equal(lcs, np.asarray(index.LCS)):
        raise AssertionError(f"{what}: sharded_lcs_fn differs from the index's LCS")
    log(f"check {what}: sharded_lcs_fn over {len(devs)} shards in {nproc} processes equals the "
        f"host LCS over {lcs.size} nodes")
    row["lcs"] = {"s": lcs_s, "collectives": devs.stats["collectives"] - c0,
                  "staged_bytes": devs.stats["staged_bytes"] - b0}
    log(json.dumps(row))
    tdist.destroy_process_group()
    return 0


def xproc_phase(genome_len: int, prefix: str, work: str, index, both: np.ndarray) -> dict:
    """The mesh across processes: 2 workers (this script with
    --xproc-worker), XPROC_SHARDS shards each, joined by gloo on cuda:0,
    and by nccl a card a rank where two cards are visible. Their
    locates' windows against kmer_location_oracle and the one-process
    (1, 4) mesh on the same batch. A worker that fails or outlives
    XPROC_TIMEOUT fails the script. Returns the front-end launches of
    each worker's main-path locate calls."""
    import socket

    import torch

    from finito_tpu_torch.parallel import mesh
    from finito_tpu_torch.query.locators import Optimistic, minimizer_policy
    from finito_tpu_torch.utils.synth import kmer_location_oracle

    concat = np.asarray(index.unitigs.concat, np.uint8)
    ends = np.asarray(index.unitigs.ends, np.int64)
    want = kmer_location_oracle(concat, ends, both, K)
    B, L = both.shape
    one = mesh.make_mesh(4, tp=4, devices=[DEVICE + ":0"] * 4)
    sh = mesh.ShardedMinimizerIndex.build(concat, ends, K, tp=4)
    check = Optimistic(lambda caps: mesh.sharded_minimizer_locate_fn(one, sh, caps[0])(both),
                       *minimizer_policy(B, L, K, False))
    check.verify()
    ou, oo = (t.cpu().numpy() for t in check.out[:2])
    if not (np.array_equal(ou, want[0]) and np.array_equal(oo, want[1])):
        raise AssertionError("the one-process (1,4) mesh differs from kmer_location_oracle")
    del one, sh
    torch.cuda.empty_cache()
    np.save(os.path.join(work, "xproc_both.npy"), both)
    launches = {}
    for backend in ("gloo", "nccl"):
        if backend == "nccl" and torch.cuda.device_count() < 2:
            log(f"xproc nccl: not run: {torch.cuda.device_count()} card visible, and nccl needs a "
                "card a rank (two ranks on one card raise in global_devices)")
            continue
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--xproc-worker",
                                   str(pid), "2", str(port), backend, prefix,
                                   os.path.join(work, "unitigs.fna"), work],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for pid in range(2)]
        try:
            outs = [p.communicate(timeout=XPROC_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"xproc {backend} rank{pid} exit {p.returncode}:\n"
                                   f"{so.decode()[-2000:]}\n{se.decode()[-3000:]}")
        ranks = []
        for so, _ in outs:
            lines = so.decode().strip().splitlines()
            for line in lines[:-1]:
                log(line)
            ranks.append(json.loads(lines[-1]))
        for dp, tp in XPROC_MESHES:
            for pid in range(2):
                got = np.load(os.path.join(work, f"xproc_{backend}_{dp}x{tp}_r{pid}.npz"))
                for name, a, o, w in (("uid", got["uid"], ou, want[0]),
                                      ("off", got["off"], oo, want[1])):
                    if not (np.array_equal(a, w) and np.array_equal(a, o)):
                        raise AssertionError(f"xproc {backend} ({dp},{tp}) rank{pid}: {name} "
                                             "differs from the oracle or the one-process mesh")
                launches[f"xproc {backend} ({dp},{tp}) rank{pid}"] = \
                    ranks[pid]["meshes"][f"{dp},{tp}"]["front_end_launches"]
            log(f"check xproc {backend} ({dp},{tp}) {genome_len} bp: every rank's {B * (L - K + 1)} "
                "windows equal kmer_location_oracle and the one-process (1,4) mesh")
        log(json.dumps({"xproc": genome_len, "backend": backend, "processes": 2,
                        "shards_per_process": XPROC_SHARDS, "wall_s": wall, "ranks": ranks}))
    return launches


def index_phase(genome_len: int, seed: int, n_reads: int, work: str) -> tuple:
    """One index size end to end; returns the front-end kernel launches
    of each of its main-path runs (search-fmin, kmer-mapper query, the
    device-resident pipelines), and of each mesh's search-fmin run."""
    import torch

    from finito_tpu_torch.io.seqdb import decode_seq
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    genome, cuts, prefix, build_s = build_index(genome_len, seed, work)
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

    launches = {}
    launches[f"search-fmin {genome_len} bp"], index = search_phase(
        genome_len, prefix, qpath, work, check)
    launches[f"kmer-mapper query -r {genome_len} bp"] = kmer_mapper_phase(
        genome_len, os.path.join(work, "unitigs.fna"), qpath, work, check,
        2 * n_reads * (READ_LEN - K + 1))

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

    # the device-resident pipelines on one batch put on the card once
    p_starts, p_reads, p_mut = sample_reads(np.random.default_rng(seed + 3), genome, PIPE_BATCH)
    p_want = analytic_expected(index.unitigs.concat, index.unitigs.ends, genome, cuts, p_starts,
                               p_mut)
    p_want = (p_want[..., 0], p_want[..., 1])
    p_dev = torch.from_numpy(p_reads).to(DEVICE)
    info = {"cell": f"DSPSS {genome_len} bp", "index_bp": genome_len,
            "nodes": index.sbwt.number_of_subsets(), "index_build_s": build_s,
            "oracle": "the analytic DSPSS oracle"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = DeviceQueryEngine(index, device=DEVICE)
    torch.cuda.synchronize()
    pinfo = {**info, "engine_s": time.perf_counter() - t0}
    n, _ = pipeline_cell(eng, pinfo, p_reads, p_dev, p_want, index)
    launches[f"pipeline minimizer {'v2' if eng.use_v2 else 'v1'} {genome_len} bp"] = n
    if not eng.use_v2:  # the 1 Mbp cell: v2 forced on the same engine
        n, _ = pipeline_cell(eng, pinfo, p_reads, p_dev, p_want, index, forced=True)
        launches[f"pipeline minimizer v2 (forced) {genome_len} bp"] = n
        builder_fallback_phase(index, prefix, os.path.join(work, "unitigs.fna"), work)
    del eng
    torch.cuda.empty_cache()

    mesh_launches = {}
    if genome_len == ENGINES_AT:
        for mode in ENGINE_MODES:
            eng, tables_s = engine_phase(mode, genome_len, prefix, qpath, work, check, index, both)
            n, out = pipeline_cell(eng, {**info, "engine_s": tables_s}, p_reads, p_dev, p_want,
                                   index)
            launches[f"pipeline {mode} {genome_len} bp"] = n
            if mode == "replica":
                twin_phase(index, info, p_dev, out, p_want)
            del eng, out
            torch.cuda.empty_cache()
        mesh_launches = mesh_phase(genome_len, prefix, qpath, work, check, index, both)
        launches["search-fmin --mesh"] = sum(mesh_launches.values())
        lcs_phase(genome_len, index)
        probe = [r for r in extra if len(r) >= K and b"N" not in r] + [
            decode_seq(reads[i]) for i in sample]
        # the build paths run no kernel: their counts stand in the line as 0
        launches[f"sharded_index_build {genome_len} bp"] = mesh_index_build_phase(
            genome_len, prefix, os.path.join(work, "unitigs.fna"), work, index, probe)
        launches[f"unitigs --mesh {PANGENOME[0]} bp"] = mesh_unitig_phase(seed, work)
        dist_phase(genome_len, prefix, qpath, work, index)
        xproc = xproc_phase(genome_len, prefix, work, index, both)
        mesh_launches.update(xproc)
        launches["cross-process mesh locates"] = sum(xproc.values())
    return launches, mesh_launches


def tool_run(what: str, fn):
    """fn() (an entry point) under run_counted: the front end's count set
    to 0 just before it and read just after, its standard output
    captured, and the kernel held bit for bit to its plain version on
    every input the run gave it. Returns (fn's result, its standard
    output, wall seconds, launches)."""
    import torch

    seen, out, box = [], io.StringIO(), {}

    def main(_argv):
        with contextlib.redirect_stdout(out):
            box["result"] = fn()
        return 0

    _, _, wall, launches = run_counted(main, [], seen)
    if launches or seen:
        check_inputs(what, seen, launches)
    del seen
    torch.cuda.empty_cache()
    return box["result"], out.getvalue(), wall, launches


def tool_main(name: str, module, argv):
    """A tool's main(argv) under tool_run, which must return 0. Returns
    (the last line of its standard output as JSON, None when it printed
    none; the output; wall seconds; launches)."""
    rc, out, wall, launches = tool_run(name, lambda: module.main(argv))
    if rc != 0:
        raise AssertionError(f"{name} {' '.join(argv)} returned {rc}: {out[-3000:]}")
    lines = out.strip().splitlines()
    return (json.loads(lines[-1]) if lines else None), out, wall, launches


def bench_args(cache: str) -> list:
    """tools.bench's arguments in phase 6: the 400 kbp head, --ladder auto
    over the cache build_cache filled (so the cached TOOLS_CACHE_GENOME
    rung runs too), the stream, replica and repeat extra rows, no
    watchdog (main runs in this process) and no --profile (a process
    that has profiled before drops device events)."""
    return ["--device", TOOLS_DEVICE, "--genome", str(TOOLS_BENCH_GENOME), "--ladder", "auto",
            "--cache-dir", cache, "--extra-rows", ",".join(TOOLS_BENCH_EXTRA),
            "--repeat-genome", str(TOOLS_BENCH_REPEAT), "--reps", "5", "--trials", "1",
            "--stall-timeout", "0"]


def check_ladder(res: dict, sizes: list) -> None:
    """tools.bench's line: no error, one row a rung and extra row, and
    every window of each k <= 32 row against its oracle."""
    if res is None or "error" in res:
        raise AssertionError(f"tools.bench: {res}")
    rows = res["ladder"]
    want = [(g, "uniform") for g in sizes] + [
        (TOOLS_BENCH_REPEAT if e == "repeat" else TOOLS_BENCH_GENOME,
         "repeat" if e == "repeat" else "uniform") for e in sorted(TOOLS_BENCH_EXTRA)]
    got = [(r.get("genome"), r.get("workload")) for r in rows]
    if sorted(got) != sorted(want) or any("error" in r for r in rows):
        raise AssertionError(f"tools.bench rows {got} (want {want}): {rows}")
    for r in rows:
        if r["k"] <= 32 and r["analytic_verified_windows"] != PIPE_BATCH * (READ_LEN - r["k"] + 1):
            raise AssertionError(f"tools.bench: not every window verified in {r}")


def tools_phase(work: str) -> dict:
    """Phase 6: the port's tooling and entry points on cuda:0, each
    through its own entry point under tool_run, one JSON line each:
    micro at its default sizes and at n = 2^26; entry()'s step against
    the plain path (the same step on the CPU); dryrun_multichip on 8 x
    cuda:0; genome_scale_verify and pangenome_verify --mesh-build (ok
    required); build_cache, then h_sweep on its entry; lane_sweep; the
    ladder (tools.bench) with that entry as its second rung.
    Returns the front-end launches of each."""
    import torch

    from finito_tpu_torch.entry import dryrun_multichip, entry
    from finito_tpu_torch.tools import (
        bench,
        build_cache,
        genome_scale_verify,
        h_sweep,
        lane_sweep,
        micro,
        pangenome_verify,
    )

    t_phase = time.perf_counter()
    launches = {}
    for n_log2 in TOOLS_MICRO_N_LOG2:
        _, out, wall, n = tool_main(f"micro n=2^{n_log2}", micro,
                                    ["--device", TOOLS_DEVICE, "--n-log2", str(n_log2)])
        log(json.dumps({"tool": "micro", "n_log2": n_log2, "wall_s": wall, "launches": n,
                        "rows": [json.loads(line) for line in out.strip().splitlines()]}))
        launches["micro"] = launches.get("micro", 0) + n

    fn, args = entry(TOOLS_DEVICE)
    got, _, wall, n = tool_run("entry() step", lambda: fn(*args))
    pfn, pargs = entry("cpu")
    err = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, pfn(*pargs)))
    if err:
        raise AssertionError("entry()'s step on the card disagrees with the plain path on the CPU")
    launches["entry"] = n
    log(json.dumps({"tool": "entry", "launches": n, "max_abs_err": err, "step_wall_s": wall,
                    "windows": int(got[0].numel()), "found": int((got[0] >= 0).sum())}))

    summary, _, wall, n = tool_run("dryrun_multichip(8)", lambda: dryrun_multichip(
        8, devices=[TOOLS_DEVICE] * 8))
    launches["dryrun_multichip"] = n
    log(json.dumps({"tool": "dryrun_multichip", "devices": f"{TOOLS_DEVICE} x8", "wall_s": wall,
                    "launches": n, "summary": summary}))

    for name, module, argv in (
            ("genome_scale_verify", genome_scale_verify,
             ["--genome", str(TOOLS_GENOME_SCALE), "--k", "63", "--tp", "8"]),
            ("pangenome_verify", pangenome_verify, TOOLS_PANGENOME_ARGS)):
        res, _, wall, n = tool_main(name, module, argv + ["--device", TOOLS_DEVICE])
        if not res["ok"]:
            raise AssertionError(f"{name}: not ok: {res}")
        launches[name] = n
        log(json.dumps({"tool": name, "argv": argv, "launches": n, "tool_wall_s": wall, **res}))

    cache = os.path.join(work, "cache")
    _, _, wall_c, launches["build_cache"] = tool_main(
        "build_cache", build_cache, ["--genome", str(TOOLS_CACHE_GENOME), "--cache-dir", cache])
    rows, _, wall, launches["h_sweep"] = tool_main(
        "h_sweep", h_sweep, ["--genome", str(TOOLS_CACHE_GENOME), "--hs", TOOLS_HS,
                             "--engines", "v1,v2", "--trials", "1", "--cache-dir", cache,
                             "--device", TOOLS_DEVICE])
    log(json.dumps({"tool": "h_sweep", "genome": TOOLS_CACHE_GENOME, "build_cache_s": wall_c,
                    "wall_s": wall, "launches": launches["h_sweep"], "rows": rows}))
    art, _, wall, launches["lane_sweep"] = tool_main(
        "lane_sweep", lane_sweep, ["--genome", str(TOOLS_LANE_GENOME), "--batches", str(TOOLS_LANE_BATCH),
                                   "--chunks", "0,auto", "--reps", "3", "--trials", "1",
                                   "--cache-dir", cache, "--out", os.path.join(work, "lanes.json"),
                                   "--device", TOOLS_DEVICE])
    log(json.dumps({"tool": "lane_sweep", "wall_s": wall, "launches": launches["lane_sweep"],
                    **art}))
    res, _, wall, launches["bench"] = tool_main("tools.bench", bench, bench_args(cache))
    check_ladder(res, [TOOLS_BENCH_GENOME, TOOLS_CACHE_GENOME])
    log(json.dumps({"tool": "bench", "wall_s": wall, "launches": launches["bench"], **res}))
    log(f"tools phase wall: {time.perf_counter() - t_phase} s")
    return launches


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0, help="seed of genomes and reads")
    p.add_argument("--kernel-only", action="store_true",
                   help="stop after the kernel phase (its check and times); prints no ok line")
    p.add_argument("--sweep", action="store_true",
                   help="time the kernel across widths, group sizes, R and batch; no ok line")
    p.add_argument("--dist-worker", nargs=6, help=argparse.SUPPRESS,
                   metavar=("PID", "NPROC", "PORT", "PREFIX", "QUERIES", "OUT"))
    p.add_argument("--xproc-worker", nargs=7, help=argparse.SUPPRESS,
                   metavar=("PID", "NPROC", "PORT", "BACKEND", "PREFIX", "UNITIGS", "WORK"))
    args = p.parse_args()

    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "finito_tpu_torch")):
        # the script alone, outside a checkout, has no program to drive
        raise SystemExit(f"chip_smoke: no finito_tpu_torch/ beside {os.path.abspath(__file__)}; "
                         "run it from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA card")
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.xproc_worker:
        return xproc_worker(args.xproc_worker)
    card = gpu_name_and_power()
    log(f"device: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible")
    from finito_tpu_torch import native
    from finito_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0} s (nvcc {_build.build_info.get('seconds', 0.0)} s, "
        f"{_build.build_info['path']})")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the host library (g++, finito_tpu_torch/native) did not build or load")
    gxx = native.build_info.get("seconds")
    log(f"build: host library {time.perf_counter() - t0} s "
        f"({'g++ ' + str(gxx) + ' s' if gxx is not None else 'cached'}, {native.build_info['path']})")

    if args.sweep:
        sweep_phase(np.random.default_rng(args.seed), card)
        return 0
    kern = kernel_phase(np.random.default_rng(args.seed))
    if args.kernel_only:
        log(json.dumps({"kernel_only": kern, "card": card}))
        return 0
    launches, mesh_launches = {}, {}
    scratch = os.path.join(HERE, "build")
    os.makedirs(scratch, exist_ok=True)
    for genome_len in GENOMES:
        with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke_") as work:
            by_path, by_mesh = index_phase(genome_len, args.seed, N_READS, work)
            launches.update(by_path)
            mesh_launches.update(by_mesh)
    launches.update(repeat_phase(args.seed))
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke_tools_") as work:
        tools_launches = tools_phase(work)
    launches.update({f"tools {name}": n for name, n in tools_launches.items()})

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    if foreign:
        raise AssertionError(f"the run imported {foreign[:5]}: the port must import none of {FOREIGN}")
    from finito_tpu_torch.ops import streaming

    if len(CHAIN_CHECKS) != 2 * len(CHAIN_SHAPES) or len(REPAIR_CHECKS) != 2 * len(CHAIN_SHAPES):
        raise AssertionError(f"{len(CHAIN_CHECKS)} chain and {len(REPAIR_CHECKS)} repair kernel "
                             "checks (stream and replica expected)")
    log(json.dumps({"kernels": [{
        "name": "minimizer_windows", "route": "cuda",
        "source": "finito_tpu_torch/csrc/minimizer_front.cu",
        "replaces": "finito_tpu/ops/pallas_min.py:124",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "launches_by_mesh": mesh_launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "device_ms": kern["device_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "share_of_bound": kern["share_of_bound"], "library_ms": None,
    }, {
        "name": "make_chain_opt", "route": "cuda", "source": "finito_tpu_torch/csrc/chain_opt.cu",
        "replaces": None, "launches": streaming.make_chain_opt.launches,
        "checks": CHAIN_CHECKS, "library_ms": None,
    }, {
        "name": "make_segment_repair", "route": "cuda",
        "source": "finito_tpu_torch/csrc/segment_repair.cu", "replaces": None,
        "launches": streaming.make_segment_repair.launches, "checks": REPAIR_CHECKS,
        "library_ms": None,
    }]}))
    log(f"chip_smoke wall: {time.perf_counter() - t_start} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

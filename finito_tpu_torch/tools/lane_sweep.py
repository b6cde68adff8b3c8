"""Lane-saturation sweep of the stream and replica pipelines: the port's
twin of scripts/lane_sweep.py.

Measures the device-resident pipeline (DeviceQueryEngine.
make_device_pipeline) of each engine over batch size B x chain-scan
chunk policy ("auto" is ops.streaming.auto_chunk, a number an explicit
chunk length, 0 whole reads), the measurement that sets the chunk
policy. Writes one JSON artifact with a row per (engine, B, chunk), by
default build/finito_tpu_torch/SWEEP_lanes.json; the repository root's
SWEEP_lanes.json is the JAX package's record and is never written.

  python -m finito_tpu_torch.tools.lane_sweep [--genome 400000]
      [--batches 8192,16384,32768] [--chunks 0,auto] [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from finito_tpu_torch.tools import (
    HOST_RSS_SOURCE,
    device,
    host_peak,
    log,
    peak_device_mib,
    reset_peak,
    sync,
)
from finito_tpu_torch.tools.cache import DEFAULT_CACHE, ROOT, load_or_build_index

DEFAULT_OUT = os.path.join(ROOT, "build", "finito_tpu_torch", "SWEEP_lanes.json")
JAX_RECORD = os.path.join(ROOT, "SWEEP_lanes.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome", type=int, default=400_000)
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--read-len", type=int, default=128)
    p.add_argument("--batches", default="8192,16384,32768")
    p.add_argument("--chunks", default="0,auto")
    p.add_argument("--engines", default="stream,replica")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--mutate", type=float, default=0.005)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--cache-dir", default=DEFAULT_CACHE)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if os.path.abspath(args.out) == JAX_RECORD:
        raise ValueError(f"{args.out} is the JAX package's sweep record; write elsewhere")
    dev = device(args.device)

    from finito_tpu_torch.query.engine import DeviceQueryEngine

    rng = np.random.default_rng(0)
    genome, index, _, _ = load_or_build_index(args.genome, args.k, args.cache_dir, rng)
    L = args.read_len
    W = L - args.k + 1
    rows = []
    with host_peak() as rss:
        for eng_mode in args.engines.split(","):
            for B in (int(x) for x in args.batches.split(",")):
                starts = rng.integers(0, args.genome - L, size=B)
                reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
                n_mut = int(args.mutate * reads.size)
                mi = rng.integers(0, B, size=n_mut)
                mj = rng.integers(0, L, size=n_mut)
                reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
                reads_dev = torch.from_numpy(reads).to(dev)
                for ch in args.chunks.split(","):
                    chunk = None if ch == "auto" else int(ch)
                    reset_peak([dev])
                    engine = DeviceQueryEngine(index, mode=eng_mode, device=dev, chunk=chunk)
                    pipe = engine.make_device_pipeline(B, L, unknown_frac=0.02)
                    n_unknown = int(pipe(reads_dev)[2])
                    if not (pipe.K // 2 <= n_unknown <= pipe.K):
                        frac = max(0.002, 1.3 * n_unknown / (B * W))
                        pipe = engine.make_device_pipeline(B, L, unknown_frac=frac)
                        n_unknown = int(pipe(reads_dev)[2])
                    if n_unknown > pipe.K:
                        raise AssertionError(f"{eng_mode} B={B} chunk={ch}: {n_unknown} segments "
                                             f"past the re-sized capacity {pipe.K}")
                    dt = float("inf")
                    for _ in range(args.trials):
                        sync(dev)
                        t0 = time.perf_counter()
                        for _ in range(args.reps):
                            pipe(reads_dev)
                        sync(dev)
                        dt = min(dt, time.perf_counter() - t0)
                    row = {"engine": eng_mode, "B": B, "chunk": ch,
                           "qps": args.reps * B * W / dt, "total_lanes": B if chunk == 0 else None,
                           "n_unknown": n_unknown, "K": pipe.K,
                           "peak_device_mib": peak_device_mib([dev])}
                    rows.append(row)
                    log("sweep", str(row))
                    del engine, pipe
    artifact = {
        "date": time.strftime("%Y-%m-%d"),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "genome": args.genome, "k": args.k, "read_len": L,
        "reps": args.reps, "trials": args.trials, "rows": rows,
        "host_peak_rss_mib": rss["mib"], "host_rss_source": HOST_RSS_SOURCE,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sweep the minimizer slot-table size (h): the port's twin of
scripts/h_sweep.py.

The slot table costs 8 bytes a slot as [start, exact_len] rows; the
build's policy h = ceil(log2(slot_factor * n_occ)), slot_factor = 32,
comes from a sweep on another chip. A smaller h raises the load factor
(more multi-occupant slots, more slow-path windows) and shrinks the
descriptor the gathers touch. For each h this re-addresses the cached
minimizer index (MinimizerIndex.rebucket), uploads it
(DeviceMinimizerIndex), settles the v1 and/or v2 locate's capacities
(query.locators' Optimistic and minimizer_policy) and times it. Every h
must give the first h's answers, or the sweep raises.

  python -m finito_tpu_torch.tools.build_cache --genome 16000000
  python -m finito_tpu_torch.tools.h_sweep [--genome 16000000] [--hs 22,23,24,25,26]

Prints one JSON list of rows; each row's qps is windows a second, the
fastest of --trials trials of --reps calls between two synchronize
calls.
"""

from __future__ import annotations

import argparse
import json
import gc
import os
import sys
import time

import numpy as np
import torch

from finito_tpu_torch.tools import device, host_peak, log, peak_device_mib, reset_peak, sync
from finito_tpu_torch.tools.cache import DEFAULT_CACHE, cache_tag


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome", type=int, default=16_000_000)
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--hs", default="22,23,24,25")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--read-len", type=int, default=128)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--slow-frac", type=float, default=0.08,
                   help="initial slow-path capacity as a fraction of B*W")
    p.add_argument("--engines", default="v2", help="comma list of v1,v2 to measure at each h")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = device(args.device)

    from finito_tpu_torch.index.minimizer import MinimizerIndex
    from finito_tpu_torch.query.locators import Optimistic, minimizer_policy
    from finito_tpu_torch.query.minimizer_engine import (
        DeviceMinimizerIndex,
        make_minimizer_locate_form,
    )

    tag = cache_tag(args.genome, args.k)
    genome = np.load(os.path.join(args.cache_dir, f"genome_{tag}.npy"))
    t0 = time.perf_counter()
    mindex = MinimizerIndex.load(os.path.join(args.cache_dir, f"midx_{tag}.ftmidx"))
    log("sweep", f"midx loaded in {time.perf_counter() - t0:.1f}s; "
        f"n_occ={mindex.occ_key.size} h={mindex.h}")

    B, L, k = args.batch, args.read_len, args.k
    W = L - k + 1
    rng = np.random.default_rng(0)
    starts = rng.integers(0, args.genome - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(0.005 * reads.size)
    mi = rng.integers(0, B, size=n_mut)
    mj = rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
    reads_dev = torch.from_numpy(reads).to(dev)

    results, first = [], None
    with host_peak() as rss:
        for h in sorted(int(x) for x in args.hs.split(",")):
            t0 = time.perf_counter()
            mindex.rebucket(h)
            log("sweep", f"rebucket h={h} in {time.perf_counter() - t0:.1f}s")
            reset_peak([dev])
            sync(dev)
            t0 = time.perf_counter()
            dmi = DeviceMinimizerIndex(mindex, dev)
            sync(dev)
            init_s = time.perf_counter() - t0
            desc_mb = (dmi.desc.numel() * 4) >> 20
            slot_mb = (dmi.slot_rows.numel() * 4) >> 20 if dmi.slot_rows is not None else 0
            for eng in args.engines.split(","):
                use_v2 = eng == "v2"
                (K, KH), grow = minimizer_policy(B, L, k, use_v2)
                check = Optimistic(
                    lambda caps: make_minimizer_locate_form(dmi, use_v2, *caps)(reads_dev),
                    (max(K, int(args.slow_frac * B * W)), KH), grow)
                check.verify()
                (K, KH), n_slow, out = check.caps, check.counters[0], check.out
                del check  # the first run's outputs, when it was re-run
                f = make_minimizer_locate_form(dmi, use_v2, K, KH)
                answer = (out[0].cpu().numpy(), out[1].cpu().numpy())
                if first is None:
                    first = (h, eng, answer)
                elif not (np.array_equal(answer[0], first[2][0])
                          and np.array_equal(answer[1], first[2][1])):
                    raise AssertionError(
                        f"h={h} {eng} answers differ from h={first[0]} {first[1]}'s")
                dt = float("inf")
                for _ in range(args.trials):
                    sync(dev)
                    t0 = time.perf_counter()
                    for _ in range(args.reps):
                        out = f(reads_dev)
                    sync(dev)
                    dt = min(dt, time.perf_counter() - t0)
                row = {"h": h, "engine": eng, "qps": args.reps * B * W / dt,
                       "slow_frac": n_slow / (B * W), "K": K, "KH": KH,
                       "desc_mb": desc_mb, "slot_rows_mb": slot_mb, "device_init_s": init_s,
                       "peak_device_mib": peak_device_mib([dev]),
                       "host_peak_rss_mib": rss["mib"]}
                log("sweep", str(row))
                results.append(row)
                del f, out
            # free this h's tables before the next upload, so the peak does
            # not grow with each h
            del dmi
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

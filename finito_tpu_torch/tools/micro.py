"""Speed-of-light microbenchmarks of the primitives under every engine,
the port's twin of bench_micro.py: batched gather rates (scalar and
4-word rows), the SBWT interval extension (rank24, 2 gathers), and the
chain-scan step latency (ops.streaming.make_chain_scan) at 8k, 32k and
128k lanes.

  python -m finito_tpu_torch.tools.micro [--device cuda] [--n-log2 22]

Prints one JSON line a metric, bench_micro's names and units, with the
device, its table sizes and the timing protocol. Each time is the
fastest of 3 trials of 10 calls (5 for the chain scan), each trial
between two torch.cuda.synchronize calls; on the card the gathers also
carry their device time a call (torch.profiler) and their kernels. The tables have n = 2^n_log2 entries: at
the default 22 the scalar table (16 MiB) fits the H100's 50 MB L2, and
--n-log2 26 (256 MiB) does not.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from finito_tpu_torch.tools import device, sync


def timed(dev, f, args_list, reps: int, trials: int) -> float:
    """Seconds per call of f: the fastest of `trials` trials, each `reps`
    calls cycling over args_list, after one warm-up call."""
    f(*args_list[0])
    best = float("inf")
    for _ in range(trials):
        sync(dev)
        t0 = time.perf_counter()
        for i in range(reps):
            f(*args_list[i % len(args_list)])
        sync(dev)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def device_us(dev, f, args_list) -> tuple:
    """(device microseconds a call, the device kernels' names) of f over
    args_list, one call each, by torch.profiler's device events after a
    warm-up call: the time the card spent, apart from the host's time
    between launches. Each kernel's time is its mean over the launches
    the profiler saw, summed over the kernels (each launched once a
    call), so an event the profiler drops changes no result; (None, [])
    off the card, or when it saw no device event."""
    if dev.type != "cuda":
        return None, []
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    f(*args_list[0])
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in args_list:
            f(*args)
        sync(dev)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count > 0 and e.device_time_total > 0]
    if not events:
        return None, []
    return sum(e.device_time_total / e.count for e in events), sorted(e.key for e in events)


def synthetic_sbwt_bits(rng, n: int) -> np.ndarray:
    """bench_micro's (4, n) random out-edge rows (a bit set with
    probability 0.25), trimmed to a valid SBWT: 1 + the edge count must
    not pass n, or an interval extension ranks past the table's end (the
    JAX gather fills such reads silently; torch raises, and on the card
    the context is lost). The draw's excess, O(sqrt n) bits, is cleared
    from the end of the last row."""
    bits = (rng.random((4, n)) < 0.25).astype(np.uint8)
    excess = int(bits.sum(dtype=np.int64)) - (n - 1)
    if excess > 0:
        set3 = np.flatnonzero(bits[3])
        bits[3, set3[set3.size - excess:]] = 0
    return bits


def run(dev, n_log2: int = 22, b_log2: int = 21, lanes_log2=(13, 15, 17), steps: int = 64,
        reps: int = 10, trials: int = 3) -> list:
    """The metric rows (dicts), bench_micro's draws from one rng in its
    order: 2^b_log2 lookups a call, chain scans of `steps` positions at
    2^lanes_log2 lanes, k=31."""
    from finito_tpu_torch.ops.bits import put_i32
    from finito_tpu_torch.ops.rank24 import build_rank24_tables, update_interval24
    from finito_tpu_torch.ops.streaming import make_chain_scan

    rng = np.random.default_rng(0)
    n, B = 1 << n_log2, 1 << b_log2
    rows = []

    def row(name, value, unit, **extra):
        rows.append({"metric": name, "value": value, "unit": unit, "n_log2": n_log2,
                     "batch": B, "reps": reps, "trials": trials, **extra})

    tab = torch.from_numpy(rng.integers(0, 2**31, size=n, dtype=np.int32)).to(dev)
    tab4 = torch.from_numpy(rng.integers(0, 2**31, size=(n, 4), dtype=np.int32)).to(dev)
    idxs = [torch.from_numpy(rng.integers(0, n, size=B, dtype=np.int32)).to(dev).long()
            for _ in range(5)]
    args = [(i,) for i in idxs]
    dt = timed(dev, lambda i: tab[i], args, reps, trials)
    us, kernels = device_us(dev, lambda i: tab[i], args)
    row("hbm_gather_scalar", B / dt / 1e6, "Mlookups/sec", table_bytes=tab.numel() * 4,
        device_us=us, kernels=kernels)
    dt = timed(dev, lambda i: tab4[i].sum(dim=1), args, reps, trials)
    # the row gather alone, without the row sum bench_micro adds, by
    # advanced indexing (the engines' form) and by index_select, each
    # also by the card's own time (host clock against device time)
    dt_g = timed(dev, lambda i: tab4[i], args, reps, trials)
    dt_s = timed(dev, lambda i: tab4.index_select(0, i), args, reps, trials)
    us_g, kernels_g = device_us(dev, lambda i: tab4[i], args)
    us_s, kernels_s = device_us(dev, lambda i: tab4.index_select(0, i), args)
    row("hbm_gather_row4", B / dt / 1e6, "Mlookups/sec", table_bytes=tab4.numel() * 4,
        gather_only=B / dt_g / 1e6, index_select=B / dt_s / 1e6,
        gather_only_device_us=us_g, gather_only_kernels=kernels_g,
        index_select_device_us=us_s, index_select_kernels=kernels_s)
    del tab, tab4, idxs

    # SBWT interval extension on a synthetic n-node index
    bits = synthetic_sbwt_bits(rng, n)
    rtab = build_rank24_tables(bits)
    n8 = rtab.shape[0] // 4
    rtab_d = put_i32(rtab, dev)
    C = torch.tensor(np.cumsum([1, *bits.sum(axis=1)[:3]]), dtype=torch.int32, device=dev)
    nn = bits.shape[1]
    del bits, rtab
    los = [torch.from_numpy(rng.integers(0, nn - 1, size=B, dtype=np.int32)).to(dev).long()
           for _ in range(5)]
    cs = torch.from_numpy(rng.integers(0, 4, size=B, dtype=np.int32)).to(dev)
    dt = timed(dev, lambda lo: update_interval24(rtab_d, n8, C, cs, lo, lo)[0],
               [(lo,) for lo in los], reps, trials)
    row("sbwt_interval_extension", B / dt / 1e6, "Mext/sec",
        table_bytes=rtab_d.numel() * 4)
    del los, cs

    # chain-scan step latency: the floor under the stream and replica
    # engines' chain, at several lane counts (latency floor and the
    # throughput knee)
    ck_tab = torch.stack([torch.zeros(nn, dtype=torch.int32),
                          torch.full((nn,), nn - 1, dtype=torch.int32)], dim=1).to(dev)
    # a synthetic dense edge table (every transition present): the
    # gather pattern of a mature chain
    edge_tab = torch.from_numpy(rng.integers(0, nn, size=4 * nn, dtype=np.int32)).to(dev)
    chain = make_chain_scan(n8, 31, nn)
    for lp in lanes_log2:
        lanes = 1 << lp
        codes_l = [torch.from_numpy(rng.integers(0, 4, size=(lanes, steps), dtype=np.uint8)).to(dev)
                   for _ in range(3)]
        dt = timed(dev, lambda c: chain(rtab_d, C, ck_tab, edge_tab, c),
                   [(c,) for c in codes_l], max(1, reps // 2), trials)
        row(f"chain_scan_us_per_step_{lanes >> 10}k_lanes", dt / steps * 1e6, "us/step",
            lanes=lanes, steps=steps)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-log2", type=int, default=22, help="table entries and SBWT nodes: 2^n")
    args = p.parse_args(argv)
    dev = device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for r in run(dev, args.n_log2):
        print(json.dumps({**r, "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

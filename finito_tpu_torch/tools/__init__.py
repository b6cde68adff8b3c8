"""The port's tooling: twins of the JAX package's scripts, bench_micro.py
and bench.py's ladder and data helpers, each run as ``python -m
finito_tpu_torch.tools.<name>`` and each importing nothing of the JAX
package.

  cache                the DSPSS / repeat index cache (load_or_build_index)
  build_cache          builds a cache entry: index, genome, .ftmidx
  micro                gather, interval-extension and chain-scan rates
  bench                bench.py's ladder: the pipeline's qps per rung, verified
  h_sweep              the minimizer slot-table size (h) against qps
  lane_sweep           the stream and replica pipelines over B x chunk
  genome_scale_verify  a shard-local k=63 index of a genome-scale DSPSS
                       against the closed-form oracle
  pangenome_verify     base + variants -> unitigs -> index -> sharded
                       locate, against FinimizerIndex.search

Every tool takes --device, "cuda" by default. Nothing falls back to the
host: a card asked for and missing raises. A mesh's shard devices come
from parallel.shard_build.shard_devices. The helpers here resolve one
device, synchronise timers and sample the host's peak resident set.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

HOST_RSS_SOURCE = "statm sampled every 10 ms"  # how host_peak measures


def log(tag: str, msg: str) -> None:
    sys.stderr.write(f"[{tag}] {msg}\n")
    sys.stderr.flush()


def device(name: str = "cuda") -> torch.device:
    """A torch device from --device; a CUDA device without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    return dev


def sync(dev) -> None:
    """Wait for the device's queued work (a timer's edge)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def peak_device_mib(devs) -> float | None:
    """Peak allocated memory over the distinct CUDA devices, MiB (None
    when none is a card)."""
    cards = sorted({d.index or 0 for d in map(torch.device, devs) if d.type == "cuda"})
    if not cards:
        return None
    return max(torch.cuda.max_memory_allocated(i) for i in cards) / 2**20


def reset_peak(devs) -> None:
    """Restart the peak-memory count of the CUDA devices (before the
    first CUDA call the count starts at zero anyway, and the reset
    would raise)."""
    if not torch.cuda.is_initialized():
        return
    for i in sorted({d.index or 0 for d in map(torch.device, devs) if d.type == "cuda"}):
        torch.cuda.reset_peak_memory_stats(i)


@contextlib.contextmanager
def host_peak():
    """The peak resident set of this process while the block runs, MiB,
    in the yielded dict's "mib": a thread samples /proc/self/statm every
    10 ms (VmHWM cannot be reset, and some kernels do not report it);
    "mib_at_start" is the resident set when it begins."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")

    def rss() -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page / 2**20

    box = {"mib": 0.0, "mib_at_start": rss()}
    stop = threading.Event()

    def sample() -> None:
        while True:
            box["mib"] = max(box["mib"], rss())
            if stop.wait(0.01):
                return

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield box
    finally:
        stop.set()
        thread.join()
        box["mib"] = max(box["mib"], rss())

"""Spans and counters of the served path (search-fmin's chunk loop, the
engine's host shell and its locates), kept in one process-wide tally.

A span is a `torch.profiler.record_function` range while a profiler
records, so that it lies on the clock of the device operations it
launches; otherwise it adds its host-clock duration, in ms, to
`ms[name]`. Never both, and the choice is made when the span opens. The
tally's host clock also stops at the first span that finds a profiler
recording, until the next reset: what a profiler's start, window and
teardown cost the host stays out of `ms`. A span issues no device
operation and no synchronize.

`count(name, n)` adds to `counts[name]`. Every blocking device-to-host
read of the served path goes through `host_read(site, read)`: span
`host_read.<site>` and counter `host_reads.<site>`. A counter only
counts values the host already holds.

The tally is process-wide, like the profiler: `reset()` clears it in
place, so a DeviceQueryEngine's `trace_ms` and `trace_counts`, which
are these two dicts, follow it.
"""

from __future__ import annotations

from time import perf_counter_ns

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

ms: dict = {}  # span name -> host ms, over the spans opened with no profiler recording
counts: dict = {}  # counter name -> count
_clock_on = True  # whether spans still time on the host clock (until a profiler is seen)


def reset() -> None:
    """Start a fresh tally (cli._run_queries_streaming, at each call)."""
    global _clock_on
    ms.clear()
    counts.clear()
    _clock_on = True


def recording() -> bool:
    """Whether a torch profiler is recording now."""
    return _profiler._is_profiler_enabled


def timing() -> bool:
    """Whether a span opened now adds to `ms`: no profiler recording, and
    none seen since the tally was reset."""
    global _clock_on
    if _profiler._is_profiler_enabled:
        _clock_on = False
    return _clock_on


def count(name: str, n: int = 1) -> None:
    counts[name] = counts.get(name, 0) + n


class span:
    """`with span(name):`, or `s = span(name).open()` ... `s.close()`
    where the two ends lie in different blocks. `chunk` (the chunk's
    ordinal within a call) is appended to the profiler range's name as
    `:<chunk>`; the tally keys by `name` alone."""

    __slots__ = ("name", "chunk", "_rf", "_t0")

    def __init__(self, name: str, chunk: int | None = None):
        self.name, self.chunk = name, chunk
        self._rf = self._t0 = None

    def open(self) -> "span":
        if timing():
            self._t0 = perf_counter_ns()
        elif recording():
            self._rf = record_function(
                self.name if self.chunk is None else f"{self.name}:{self.chunk}")
            self._rf.__enter__()
        return self

    def close(self) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        elif self._t0 is not None:
            ms[self.name] = ms.get(self.name, 0.0) + (perf_counter_ns() - self._t0) / 1e6
            self._t0 = None

    __enter__ = open

    def __exit__(self, *exc) -> None:
        self.close()


def host_read(site: str, read):
    """read() -- a blocking device-to-host read -- inside span
    `host_read.<site>`, counted in `host_reads.<site>`."""
    count("host_reads." + site)
    with span("host_read." + site):
        return read()


def new_chunk(n_reads: int) -> int:
    """Count one chunk of n_reads reads handed to the engine (and whether
    the tally times it); returns its ordinal within the tally."""
    c = counts.get("chunks", 0)
    count("chunks")
    count("reads", n_reads)
    if timing():
        count("chunks_timed")
    return c


def dispatching() -> int:
    """The ordinal of the chunk whose dispatch runs now (the last one
    new_chunk counted)."""
    return counts.get("chunks", 0) - 1


def summary() -> str:
    """The counters, then each span's mean over the timed chunks, in ms."""
    timed = counts.get("chunks_timed", 0)
    out = ", ".join(f"{name} {n}" for name, n in sorted(counts.items()))
    if timed:
        out += "; ms a timed chunk: " + ", ".join(
            f"{name} {t / timed:.3f}" for name, t in sorted(ms.items()))
    return out

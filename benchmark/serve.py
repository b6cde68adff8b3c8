"""The measured window: `search-fmin`'s serving loop,
`finito_tpu_torch.cli._run_queries_streaming`, driven over a FASTQ read
pool as the CLI drives it, with the benchmark's own wrappers around the
calls into each layer.

The wrappers are instance attributes set on the engine the CLI is given;
they time a call and hand it on, and change no argument and no result.
The sink stands in for the output file: `format_pairs`' bytes reach it
through `.buffer.write`, the branch the CLI takes for a real file, and a
text write (the CLI's Python formatter) is counted so that a run can show
it never happened.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager


class Recorder:
    """Chunk times, host spans and the interpreter's collection pauses of
    one window, and, when tracing, one profiler window of `chunks` chunks.

    The spans are taken in every run, by the same wrappers, so a traced
    run's chunks before its profiler starts run the code of an untraced
    run. The profiler starts at the first chunk that begins `start_s`
    seconds after the window's first record, and the span readings come
    from the chunks before it: its start, its window and what it leaves
    behind slow the host, the stream engine's ~60,000 launches a chunk
    most. One profile a process, since a second one drops device events.
    A traced run's reader runs on past the window's end until the profile
    has closed."""

    def __init__(self, trace: bool, start_s: float = 0.0, chunks: int = 0):
        self.trace = trace and chunks > 0
        self.t_begin, self.n_reads = [], []
        self.spans = {}  # name -> [(chunk, seconds)]
        self.counters = {"host_merge": 0, "capacity_reruns": 0}
        self.start_s, self.chunks = start_s, chunks
        self.profiling = False
        self.locate_shapes = []  # (B, W) of each locate's output while profiling
        self.kineto = None  # the profiler's events once its window has closed
        self.first_profiled = None  # the chunk at which the profiler started
        self._prof = self._window = None
        self._open = []  # (name, chunk, start, profiler range) of the open spans
        self._done = False
        self._gc_t0 = None
        self.t_first = None  # the window's first record

    # ---- the profiler window
    def _start_profile(self, chunk: int):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # one warm-up step: this chunk, and the previous one's readback,
        # which the profiler's start delays; then `chunks` recorded ones
        self._prof = profile(activities=acts, on_trace_ready=self._ready,
                             schedule=schedule(wait=0, warmup=1, active=self.chunks, repeat=1))
        self._prof.start()
        self.first_profiled = chunk

    def _ready(self, prof):
        self.kineto = prof.profiler.kineto_results

    def _close_window(self):
        if self.profiling:
            self.profiling = False
            self._window.__exit__(None, None, None)

    def holding(self) -> bool:
        """Whether the reader has to run on past the window's end: a
        traced run whose profile has not closed yet."""
        return self.trace and not self._done

    def unprofiled(self, chunk: int) -> bool:
        """Whether a chunk, its readback and its bytes all came before
        the profiler started."""
        return self.first_profiled is None or chunk < self.first_profiled - 1

    def stop_profile(self):
        self._close_window()
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
        self._done = True

    # ---- chunks, spans and collection pauses
    def chunk_begin(self, n_reads: int):
        c = len(self.t_begin)
        if self.trace and not self._done:
            if self._prof is None and time.perf_counter() - self.t_first >= self.start_s:
                self._start_profile(c)
            elif self._prof is not None:
                step = c - self.first_profiled  # the step this chunk starts
                if step == 1 + self.chunks:
                    self.stop_profile()
                else:
                    self._prof.step()
                    if step == 1:
                        from torch.profiler import record_function

                        self._window = record_function("bench.window")
                        self._window.__enter__()
                        self.profiling = True
        self.t_begin.append(time.perf_counter())
        self.n_reads.append(n_reads)

    @contextmanager
    def span(self, name: str):
        self.open_span(name)
        try:
            yield
        finally:
            self.close_span()

    def open_span(self, name: str):
        """Start span `name`, also a bench.<name> range while profiling;
        close_span ends the innermost open one."""
        rf = None
        if self.profiling:
            from torch.profiler import record_function

            rf = record_function("bench." + name)
            rf.__enter__()
        self._open.append((name, len(self.t_begin) - 1, time.perf_counter(), rf))

    def close_span(self):
        if self._open:
            name, chunk, t0, rf = self._open.pop()
            self.spans.setdefault(name, []).append((chunk, time.perf_counter() - t0))
            if rf is not None:
                rf.__exit__(None, None, None)

    def gc_pause(self, phase: str, info: dict):
        """gc.callbacks hook: each collection's pause, as span `gc`."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.spans.setdefault("gc", []).append(
                (len(self.t_begin) - 1, time.perf_counter() - self._gc_t0))
            self._gc_t0 = None


class _Buffer:
    def __init__(self, sink):
        self._sink = sink

    def write(self, blob: bytes):
        self._sink._put(blob, binary=True)
        return len(blob)


class Sink:
    """search-fmin's output file, in memory: each chunk's bytes and the
    time they arrived."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.blobs, self.t_write = [], []
        self.binary_writes = self.text_writes = 0
        self.buffer = _Buffer(self)

    def _put(self, blob: bytes, binary: bool):
        self.rec.close_span()
        self.blobs.append(blob)
        self.t_write.append(time.perf_counter())
        if binary:
            self.binary_writes += 1
        else:
            self.text_writes += 1

    def write(self, text: str):
        self._put(text.encode(), binary=False)
        return len(text)

    def flush(self):
        pass


def instrument(engine, rec: Recorder):
    """Wrap the engine's layer entries for one window (see module doc)."""
    begin, end = engine.merged_pairs_flat_begin, engine.merged_pairs_flat_end

    def merged_pairs_flat_begin(reads):
        rec.chunk_begin(len(reads))
        with rec.span("begin"):
            return begin(reads)

    def merged_pairs_flat_end(handle):
        with rec.span("readback"):
            out = end(handle)
        rec.open_span("format")  # closed when the chunk's bytes arrive
        return out

    engine.merged_pairs_flat_begin = merged_pairs_flat_begin
    engine.merged_pairs_flat_end = merged_pairs_flat_end
    host = getattr(engine, "_merged_pairs_host", None)
    if host is not None:
        def merged_pairs_host(*a):
            rec.counters["host_merge"] += 1
            return host(*a)

        engine._merged_pairs_host = merged_pairs_host
    encode = getattr(engine, "_encode_both_strands", None)
    if encode is not None:
        def encode_both_strands(reads):
            with rec.span("encode"):
                return encode(reads)

        engine._encode_both_strands = encode_both_strands
    locate = getattr(engine, "_locate_batch_deferred", None)
    if locate is not None:
        def locate_batch_deferred(codes):
            profiling = rec.profiling
            with rec.span("locate"):
                uid, off, B, W, verify = locate(codes)
            if profiling:
                rec.locate_shapes.append((int(uid.shape[0]), int(uid.shape[1])))
            if verify is None:
                return uid, off, B, W, verify

            def verify_counted():
                fixed = verify()
                rec.counters["capacity_reruns"] += fixed is not None
                return fixed

            return uid, off, B, W, verify_counted

        engine._locate_batch_deferred = locate_batch_deferred


def pool_records(path: str, seconds: float, rec: Recorder):
    """Records of the pool file, reopened from its start until `seconds`
    have passed since the first one (and, in a traced run, until its
    profile has closed); rec.t_first is set at the first."""
    from finito_tpu_torch.io.fastx import SequenceReader

    deadline = None
    while True:
        with SequenceReader(path) as reader:
            for record in reader:
                now = time.perf_counter()
                if deadline is None:
                    rec.t_first, deadline = now, now + seconds
                elif now >= deadline and not rec.holding():
                    return
                yield record


def serve(engine, index, pool_path: str, seconds: float, stats_path: str, rec: Recorder):
    """One window through the CLI's serving loop. Returns (sink, clock,
    number of queries the CLI counted)."""
    from finito_tpu_torch import cli

    sink = Sink(rec)
    gc.callbacks.append(rec.gc_pause)
    try:
        n_queries = cli._run_queries_streaming(pool_records(pool_path, seconds, rec),
                                               sink, index, stats_path, engine)
    finally:
        gc.callbacks.remove(rec.gc_pause)
        rec.stop_profile()
    clock = {"t_first": rec.t_first,
             "t_last": sink.t_write[-1] if sink.t_write else time.perf_counter()}
    return sink, clock, n_queries

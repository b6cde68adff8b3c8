"""Host ms a chunk spent in the program's blocking device-to-host reads:
the sum of its `host_read.<site>` spans (utils.trace) over the chunks
timed before any profiler, per such chunk."""


def read(run):
    s = run.engine_stats
    timed = s.get("trace_counts.chunks_timed")
    if not timed:
        return None
    return sum(v for k, v in s.items() if k.startswith("trace_ms.host_read.")) / timed

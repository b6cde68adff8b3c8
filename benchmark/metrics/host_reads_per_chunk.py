"""Blocking device-to-host reads a chunk: the sum of the program's
`host_reads.<site>` counters (utils.trace) over the window, per chunk."""


def read(run):
    s = run.engine_stats
    chunks = s.get("trace_counts.chunks")
    if not chunks:
        return None
    return sum(v for k, v in s.items() if k.startswith("trace_counts.host_reads.")) / chunks

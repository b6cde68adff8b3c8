"""The program's `serve.read` span (utils.trace: the CLI's FASTQ parsing
and bytes() copies, from a chunk's hand-off until the next is gathered),
host ms summed over the chunks before any profiler, per such chunk."""


def read(run):
    s = run.engine_stats
    timed = s.get("trace_counts.chunks_timed")
    t = s.get("trace_ms.serve.read")
    return t / timed if timed and t is not None else None

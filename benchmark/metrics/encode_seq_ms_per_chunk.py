"""The program's `query.encode_seq` span (utils.trace: the per-read
encode_seq and filter loop of _encode_both_strands, without the padding
and strand stacking), host ms per chunk timed before any profiler."""


def read(run):
    s = run.engine_stats
    timed = s.get("trace_counts.chunks_timed")
    t = s.get("trace_ms.query.encode_seq")
    return t / timed if timed and t is not None else None

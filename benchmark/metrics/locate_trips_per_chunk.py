"""Host-driven loop trips of the locate a chunk: the sum of the program's
`trips.<loop>` counters (utils.trace: the minimizer slow path's trips,
the segment repair's fixed and straggler trips) over the window, per
chunk; 0 when the engine took none."""


def read(run):
    s = run.engine_stats
    chunks = s.get("trace_counts.chunks")
    if not chunks:
        return None
    return sum(v for k, v in s.items() if k.startswith("trace_counts.trips.")) / chunks

"""Share of the window's windows (both strands) that the full-window host
merge served, in %: the program's `host_merge_windows` counter
(utils.trace, _merged_pairs_host: the chunks whose runs overflowed
merge_rle's capacity) over its `windows`; 0 when no chunk overflowed."""


def read(run):
    s = run.engine_stats
    windows = s.get("trace_counts.windows")
    return 100.0 * s.get("trace_counts.host_merge_windows", 0) / windows if windows else None

"""Window slots of the padded locate dispatches over the windows of their
reads, both strands: the program's `window_slots` and `windows`
counters (utils.trace, merged_pairs_flat_begin) summed over the window.
What the shape bucket and the chunk rule cost the locate."""


def read(run):
    s = run.engine_stats
    windows = s.get("trace_counts.windows")
    slots = s.get("trace_counts.window_slots")
    return slots / windows if windows and slots is not None else None

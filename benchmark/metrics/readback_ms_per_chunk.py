"""Mean host-clock span per chunk of a traced run's window, over the
chunks before its profiler started, in ms: merged_pairs_flat_end (deferred verify, run readback,
re-expansion or the host merge)."""


def read(run):
    spans = run.spans.get("readback")
    return sum(spans) / len(spans) * 1e3 if spans else None

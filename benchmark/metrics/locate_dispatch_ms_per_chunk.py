"""Mean host-clock span per chunk of a traced run's window, over the
chunks before its profiler started, in ms: _locate_batch_deferred (bucketing, upload, the
engine's locate enqueued)."""


def read(run):
    spans = run.spans.get("locate")
    return sum(spans) / len(spans) * 1e3 if spans else None

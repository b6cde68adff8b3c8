"""Mean host-clock span per chunk of a traced run's window, over the
chunks before its profiler started, in ms: the serving loop's counting and native.format_pairs,
from _end's return to the bytes written."""


def read(run):
    spans = run.spans.get("format")
    return sum(spans) / len(spans) * 1e3 if spans else None

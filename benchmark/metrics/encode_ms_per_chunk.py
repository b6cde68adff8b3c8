"""Mean host-clock span per chunk of a traced run's window, over the
chunks before its profiler started, in ms: _encode_both_strands (encode, filter, pad, stack both
strands)."""


def read(run):
    spans = run.spans.get("encode")
    return sum(spans) / len(spans) * 1e3 if spans else None

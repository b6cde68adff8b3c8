"""Device operations (kernels, copies, sets) launched inside the locate
span, per locate call of the profiled window."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    calls = len(tr.in_ranges("bench.locate"))
    ops = tr.ops_launched_in("bench.locate")
    return len(ops) / calls if calls and ops else None

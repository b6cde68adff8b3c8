"""Device ms of the operations launched inside the program's
`query.locate` ranges (utils.trace: padding, upload and the engine's
locate), per such range, in the profiled window."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    calls = len(tr.in_ranges("query.locate"))
    ops = tr.ops_launched_in("query.locate")
    return sum(op[1] - op[0] for op, _ in ops) / calls / 1e6 if calls and ops else None

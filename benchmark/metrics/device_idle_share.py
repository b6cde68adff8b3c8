"""Share of the profiled window in which no operation ran on the device:
1 - union of device intervals / window, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0

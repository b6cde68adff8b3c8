"""The front-end kernel (csrc/minimizer_front.cu, launched by the
minimizer locate) against its roofline: the bound of each launch from its
own (B, L, k, m) over its device time, summed over the profiled window,
in %."""

from benchmark.roofline import front_bound_ms

KERNEL = "minimizer_front_kernel"


def read(run):
    tr = run.trace
    if tr is None or run.front_m is None:
        return None
    launches = [(op, r) for op, r in tr.ops_launched_in("bench.locate") if KERNEL in op[2]]
    if not launches or len(tr.in_ranges("bench.locate")) != len(run.locate_shapes):
        return None
    order = [r[0] for r in tr.in_ranges("bench.locate")]
    bound_ms = dev_ms = 0.0
    for op, _ in launches:
        i = max(j for j, s in enumerate(order) if s <= op[3])
        B, W = run.locate_shapes[i]
        bound_ms += front_bound_ms(B, W + run.k - 1, run.k, run.front_m)[0]
        dev_ms += (op[1] - op[0]) / 1e6
    return bound_ms / dev_ms * 100.0 if dev_ms > 0 else None

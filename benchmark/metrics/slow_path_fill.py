"""How full the minimizer slow path's host-driven trip loop runs, in %:
the slot lengths its lanes cover (the program's `slow_occ` counter,
utils.trace: the slot lengths of each locate's slow runs in v2, which
scans them whole, or slow windows in v1, where a lane that stops at its
first hit scans less) over the lanes it carries times its trips
(`slow_lane_trips`), both summed over the window and counted for the
final capacity run of each chunk alone; None where the engine took no
slow lane. The rest is the loop's padding."""


def read(run):
    s = run.engine_stats
    lane_trips = s.get("trace_counts.slow_lane_trips")
    return 100.0 * s.get("trace_counts.slow_occ", 0) / lane_trips if lane_trips else None

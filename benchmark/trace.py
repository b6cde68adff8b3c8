"""Reduction of one torch.profiler window to what the per-layer metrics
and the result line's `breakdown` read.

The harness opens `bench.window` at the profiler's first recorded chunk
and closes it right before it stops, and one `bench.<layer>` range around
each call into a layer. Every other user range the profiler records (a
`record_function` of the program's own) is kept beside them, so that a
metric file can read a span the program adds. A device operation belongs
to the range that holds the host event that launched it (kineto's
correlation ids).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass


# ranges that hold whole chunks, not a layer: the window and the profiler's steps
OUTER = ("bench.window", "ProfilerStep#")


@dataclass
class Trace:
    window: tuple  # (start_ns, end_ns) of bench.window
    ranges: list  # (start_ns, end_ns, name) of every user range: bench.* and the program's
    ops: list  # (start_ns, end_ns, name, launch_ns) device operations
    unlinked: int = 0  # device operations whose launch was not found

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def clipped_ops(self):
        a, b = self.window
        for s, e, name, launch in self.ops:
            s, e = max(s, a), min(e, b)
            if e > s:
                yield s, e, name, launch

    def busy_intervals(self) -> list:
        """Union of the device operations' intervals inside the window."""
        out = []
        for s, e, _, _ in sorted(self.clipped_ops()):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def in_ranges(self, prefix: str) -> list:
        return sorted((s, e, n) for s, e, n in self.ranges if n.startswith(prefix))

    def ops_launched_in(self, prefix: str) -> list:
        """Device operations whose launch lies inside a range whose name
        starts with prefix, each with that range's name."""
        rs = self.in_ranges(prefix)
        starts = [r[0] for r in rs]
        out = []
        for op in self.ops:
            i = bisect.bisect_right(starts, op[3]) - 1
            if i >= 0 and op[3] <= rs[i][1]:
                out.append((op, rs[i][2]))
        return out

    def host_label(self, t: int) -> str:
        """The innermost user range open at time t (the harness's bench.*
        or the program's own, not an OUTER one), else the serving loop's own code (reading
        records, gathering the chunk)."""
        best = None
        for s, e, n in self.ranges:
            if s <= t <= e and not n.startswith(OUTER) and (best is None or s >= best[0]):
                best = (s, n)
        return best[1].split(":")[0] if best else "loop_and_reader"

    def breakdown(self, top: int = 10) -> dict:
        tot = {}
        for s, e, name, _ in self.clipped_ops():
            tot[name[:120]] = tot.get(name[:120], 0.0) + (e - s) / 1e9
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[self.host_label((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:top]]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}


def from_kineto(results) -> Trace:
    """Trace from the kineto results of a profiler window holding CPU and
    CUDA activities, one bench.window range and any other user ranges. A device operation's
    launch is the runtime call of the same correlation id (cudaLaunchKernel
    and kin); failing that, the host op its linked id names, the innermost
    one open when it was launched; failing both (counted in `unlinked`),
    its own start on the device."""
    from torch.autograd import DeviceType

    ranges, ops, runtime, frontend = [], [], {}, {}
    for e in results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith("bench.")):
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                            e.correlation_id(), e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            if name.startswith("cu"):  # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...
                runtime[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:
                frontend[e.correlation_id()] = e.start_ns()
            if e.is_user_annotation():
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    window = [r for r in ranges if r[2] == "bench.window"]
    if len(window) != 1:
        raise RuntimeError(f"profiler window: {len(window)} bench.window ranges")
    linked, unlinked = [], 0
    for s, e, name, corr, link in ops:
        t = runtime.get(corr) if corr else None
        if t is None and link:
            t = frontend.get(link)
        unlinked += t is None
        linked.append((s, e, name, s if t is None else t))
    return Trace(window=window[0][:2], ranges=ranges, ops=linked, unlinked=unlinked)

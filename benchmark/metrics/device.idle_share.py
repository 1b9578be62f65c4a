"""% of the traced sessions' wall in which no kernel or copy ran on the
card: 1 - (union of device intervals) / wall. The profiler slows the host,
so this overstates the idle share of an untraced run."""

from harness import trace


def read(rec):
    s = trace.kept(rec["sessions"])
    wall = sum(x.wall_s for x in s)
    return 100.0 * (1 - sum(x.busy_s for x in s) / wall) if wall else None

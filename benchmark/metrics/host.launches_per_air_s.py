"""Kernel launches per second of air in the traced sessions: the host
records whose name holds "LaunchKernel" (cudaLaunchKernel, cuLaunchKernel
and their Ex forms), an exact count."""

from harness import trace


def read(rec):
    s = trace.kept(rec["sessions"])
    air = sum(x.air_s for x in s)
    return sum(x.launches for x in s) / air if air else None

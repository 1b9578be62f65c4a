"""The program's own spans (`satdump_tpu_torch.core.trace`), as the
per-layer metrics of single blocks and CADUs read them.

A torch profiler turns the program's tracing on while it records, so after
a traced run `trace.totals()` holds exactly the spans and counters of the
profiled calls and pushes, every try of them. Each metric is a ratio of
spans or counters recorded together, so the number of tries does not move
it. `ratio` gives None where the program has no `core.trace` (a checkout
from before it) or where the denominator is 0.
"""

from __future__ import annotations

FIELDS = ("calls", "ns", "self_ns")


def totals():
    """The program's span totals, or None where it has none."""
    try:
        from satdump_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.totals()


def ratio(prefix: str, kind: str, field: str, per: str, scale: float):
    """scale x the sum of `field` over the spans named `prefix`* of `kind`,
    over `per`: the calls of the span of that name, or the counter of that
    name."""
    got = totals()
    if got is None:
        return None
    spans, counters = got["spans"], got["counters"]
    den = spans[per]["calls"] if per in spans else counters.get(per, 0)
    if not den:
        return None
    num = sum(s[field] for name, s in spans.items()
              if name.startswith(prefix) and s["kind"] == kind)
    return scale * num / den

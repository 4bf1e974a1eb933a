"""Host milliseconds a campaign resolving the sweep's knobs (span
``dse.plan.knobs``: ``dse._resolve_knobs`` and its autotune cache)."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "dse.plan.knobs")

"""Host milliseconds a campaign copying reduced parts to the host (span
``reduce.to_host``: ``pareto._as_numpy`` on tensors, with the wait for
the reduction to finish)."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "reduce.to_host")

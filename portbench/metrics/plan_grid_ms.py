"""Host milliseconds a campaign planning the buckets' grids: the self time
of span ``dse.plan.grid`` (``plan_grid``, the hardware grid repeated per
lane and the lane operands put on the card), without the tables."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "dse.plan.grid", "self_s")

"""Host milliseconds a campaign building the buckets' device tables (span
``dse.plan.tables``: ``dse.sweep_tables``)."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "dse.plan.tables")

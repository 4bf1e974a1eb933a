"""Host milliseconds a campaign remapping and merging reduced parts (span
``reduce.merge``)."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "reduce.merge")

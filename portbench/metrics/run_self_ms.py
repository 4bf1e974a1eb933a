"""Host milliseconds a campaign in a plan's ``fn()`` outside the chunk loop
and the reducer's spans: the self time of span ``dse.run`` (lane set-up,
result fields, the scatter, the bank check)."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "dse.run", "self_s")

"""Host milliseconds a campaign in the program's span ``dse.plan``: all of
``dse.make_bucketed_sweep_fn``, seen from inside (compare ``plan_ms``)."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "dse.plan")

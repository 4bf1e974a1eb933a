"""Device milliseconds a campaign of the device reducer's calls (span
``reduce.device``, timed by CUDA events on the reducer's stream)."""
from portbench.program_spans import span_ms


def read(r):
    return span_ms(r, "reduce.device", "device_s")

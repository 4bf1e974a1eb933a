"""Host waits for the card a campaign (the program's ``host_syncs``): reads
of ``done``, of the bank bound and of results, and copies from host
memory to the card."""
from portbench.program_spans import report


def read(r):
    rep = report()
    n = rep["counts"].get("host_syncs") if rep else None
    if n is None or not r.campaigns:
        return None
    return n / r.campaigns

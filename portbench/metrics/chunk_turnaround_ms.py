"""Host milliseconds a campaign from a read of the lanes' ``done`` flags
that found lanes running to the return of the next launch (the
program's ``sweep.turnaround``)."""
from portbench.program_spans import report


def read(r):
    rep = report()
    entry = rep["seconds"].get("sweep.turnaround") if rep else None
    if not entry or not r.campaigns:
        return None
    return entry["total_s"] / r.campaigns * 1e3

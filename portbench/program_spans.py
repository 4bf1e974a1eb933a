"""The program's own spans and counters (``repro_torch.spans``) in a
traced run.

The program records while ``torch.profiler`` records.  In a traced run
that is the profiler's start-up, which calls no program code, and the
traced campaigns, so the recorder's totals are the traced campaigns'.
The readers of ``metrics/`` divide them by the campaigns, and return
``None`` where the program has no recorder (a checkout older than it)
or the recorder holds nothing under the name they read.
"""
from __future__ import annotations

from typing import Optional


def report() -> Optional[dict]:
    """The program's report, or ``None`` without a recorder."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.report()


def span_ms(r, name: str, key: str = "total_s") -> Optional[float]:
    """Milliseconds a campaign of ``key`` (``total_s``, ``self_s`` or
    ``device_s``) of the program's span ``name``."""
    rep = report()
    entry = rep["spans"].get(name) if rep else None
    if not entry or key not in entry or not r.campaigns:
        return None
    return entry[key] / r.campaigns * 1e3

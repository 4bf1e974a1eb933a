"""Share of the traced window in which every card of the cell runs an
operation at once, in percent: whether one host thread keeps all the
cards running (with one card it is ``100 - idle_share``)."""


def read(r):
    t = r.trace
    return 100.0 * t.all_busy_s / t.window_s if t.busy_s > 0 else None

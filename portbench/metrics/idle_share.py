"""Share of the traced window in which the card runs no operation, in
percent; over several cards, the mean card's."""


def read(r):
    t = r.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.busy_s > 0 else None

"""Sweep kernel launches a campaign (the program's counter
``sweep_engine.launches``): one a chunk of each bucket, each followed by
a host read of the lanes' done flags; over several cards, every card's."""


def read(r):
    return sum(r.launches) / r.campaigns if r.campaigns else None

"""Bytes of a campaign's answer that reach the host, counted from its
arrays."""


def read(r):
    return sum(r.answer_bytes) / r.campaigns if r.campaigns else None

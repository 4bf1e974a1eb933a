"""Peak device memory of the traced window (``max_memory_allocated``
after ``reset_peak_memory_stats``) of the fullest card, in GiB."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes > 0 else None

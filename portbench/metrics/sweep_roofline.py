"""The sweep kernel's share of its roofline, in percent: one card's least
time for the campaigns' work (``peaks.least_seconds``: the cell's cards'
least time times their number) over the kernel's device time in them,
summed over the cards, so the count of work is the same however many
cards do it."""
from portbench.harness import is_sweep_kernel


def read(r):
    s = r.campaign_device_s(is_sweep_kernel)
    return 100.0 * sum(r.least_s) * r.chips / s if s > 0 else None

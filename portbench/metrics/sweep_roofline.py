"""The sweep kernel's share of its roofline, in percent: the least time
of the campaigns' work (``peaks.least_seconds``) over the kernel's
device time in them."""
from portbench.harness import is_sweep_kernel


def read(r):
    s = r.campaign_device_s(is_sweep_kernel)
    return 100.0 * sum(r.least_s) / s if s > 0 else None

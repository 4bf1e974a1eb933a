"""Device milliseconds of the sweep kernel a campaign, from the
profiler's trace, summed over the cell's cards."""
from portbench.harness import is_sweep_kernel


def read(r):
    s = r.campaign_device_s(is_sweep_kernel)
    return s / r.campaigns * 1e3 if s > 0 else None

"""Device milliseconds a campaign of every operation but the sweep
kernel: lane set-up, the result fields, the scatter, the reducer and the
copies, summed over the cell's cards."""
from portbench.harness import is_sweep_kernel


def read(r):
    s = r.campaign_device_s(lambda name: not is_sweep_kernel(name))
    return s / r.campaigns * 1e3 if r.campaigns else None

"""Host milliseconds a campaign spends building its sweep plans
(``dse.make_bucketed_sweep_fn``: knobs, buckets, grid plans, tables)."""


def read(r):
    return sum(r.plan_s) / r.campaigns * 1e3 if r.campaigns else None

"""Executed lane-steps over launched lane-slots, in percent: the program's
``lane_steps`` (each lane's ``steps_executed``) over ``sweep.lane_slots``
(lanes times steps of every chunk launched).  What falls short is chunk
tails: finished lanes in launched slots."""
from portbench.program_spans import report


def read(r):
    rep = report()
    slots = rep["counts"].get("sweep.lane_slots") if rep else None
    if not slots:
        return None
    return 100.0 * rep["lane_steps"] / slots

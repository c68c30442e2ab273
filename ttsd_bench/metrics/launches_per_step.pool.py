"""Kernel launches a decode step: the runtime's launch calls inside the
traced steps (a few steps of one pool segment)."""
from ttsd_bench.readers import launches_per_step


def read(layer, cfg):
    return launches_per_step(layer)

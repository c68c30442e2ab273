"""The host's wait on the device a decode step: the window's
``engine.sync`` (the loop's ``unfinished.any()`` test) and
``engine.readback`` (a segment's tokens, or the final copy) span seconds
over its steps."""
from ttsd_bench.spans import per_step_ms


def read(layer, cfg):
    return per_step_ms(layer, ("engine.sync", "engine.readback"))

"""The host's dispatch of a decode step: the window's ``engine.step``
span seconds (around each ``_step`` call, which makes no sync) over its
steps."""
from ttsd_bench.spans import per_step_ms


def read(layer, cfg):
    return per_step_ms(layer, ("engine.step",))

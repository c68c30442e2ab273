"""Share of the traced window (the first batch's prefill and first decode
steps) in which no kernel, copy or set ran on the device."""
from ttsd_bench.readers import idle_percent


def read(layer, cfg):
    return idle_percent(layer)

"""The routed experts' device time a traced decode step: the ``moss::moe::``
kernels' seconds in the trace (the first batch's first decode steps; the
prefill's experts run the ``moss::moe_grouped::`` kernels, not these) over
its labelled steps, in ms."""
from ttsd_bench.trace import kernel_seconds


def read(layer, cfg):
    trace = layer.get("trace") or {}
    n, seconds = kernel_seconds(trace, lambda k: "moss::moe::" in k)
    return 1e3 * seconds / trace["steps"] if n and trace.get("steps") \
        else None

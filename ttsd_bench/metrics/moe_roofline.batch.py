"""The decode expert kernel's share of its roofline in the traced decode
steps: the work of one call (the architecture's ``moe_work`` over the
program's counters ``moe_pairs_held_traced`` and
``moe_experts_read_traced`` per ``moe_calls_traced``, the expert calls of
the steps the profiler traced) over the kernels' device time a call in
the same steps (``moss::moe::`` kernels, one ``gate_up_kernel`` a call;
the prefill's ``moss::moe_grouped::`` kernels are not these). None
without the counters, the kernels or an architecture that counts them."""
from ttsd_bench import arch
from ttsd_bench.counts import roofline_percent
from ttsd_bench.spans import store
from ttsd_bench.trace import kernel_seconds


def read(layer, cfg):
    m, work = store(), getattr(arch.of(cfg), "moe_work", None)
    trace = layer.get("trace") or {}
    if m is None or work is None:
        return None
    calls = m.get("moe_calls_traced")
    n, _ = kernel_seconds(trace, lambda k: "moe::gate_up_kernel" in k)
    _, seconds = kernel_seconds(trace, lambda k: "moss::moe::" in k)
    if not calls or not n or seconds <= 0:
        return None
    w = work(cfg, m.get("moe_pairs_held_traced") / calls,
             m.get("moe_experts_read_traced") / calls)
    return roofline_percent(w["flops"], w["bytes"], seconds / n)

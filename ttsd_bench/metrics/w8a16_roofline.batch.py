"""The w8a16 decode product's share of its roofline in the traced decode
steps: the int8 weight bytes one step reads (the architecture's
``lm_params``, backbone and heads, one byte a weight, and 4 bytes of fp32
scale a row: the seven projections of ``lora_targets`` in every layer and
the heads' table rows) over the decode kernel's (``moss::w8a16::
product_kernel``) device seconds a traced step; the prefill's many rows
run ``moss::w8a16_gemm::gemm_kernel``, which the name does not match.
Counted a step, not a call, so the reading does not depend on how many
launches the work is cut into. None for a configuration without
int8 weights, for one with ``restricted_text_head`` (its steps read the
text table's window and, every so many steps, the whole table for an
audit: the configuration does not say how often), or for a trace without
the kernels."""
from ttsd_bench import arch
from ttsd_bench.counts import roofline_percent
from ttsd_bench.trace import kernel_seconds


def read(layer, cfg):
    if cfg.get("quant") != "int8" or cfg.get("restricted_text_head"):
        return None
    a = arch.of(cfg)
    params = getattr(a, "lm_params", None)
    trace = layer.get("trace") or {}
    n, seconds = kernel_seconds(
        trace, lambda k: "moss::w8a16::product_kernel" in k)
    if params is None or not n or seconds <= 0 or not trace.get("steps"):
        return None
    p = params(cfg)
    rows = (cfg["num_hidden_layers"]
            * sum(out for _, out in a.lora_targets(cfg).values())
            + p["heads"] // cfg["hidden_size"])
    nbytes = p["backbone"] + p["heads"] + 4 * rows
    return roofline_percent(0.0, nbytes, seconds / trace["steps"])

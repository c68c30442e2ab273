"""The decode steps' share of the chip's bf16 peak: the model FLOPs the
window's decode steps need (the architecture's ``decode_flops``: two a
weight and a row, and attention over each row's keys) over the engine's
decode seconds and 989 TFLOP/s."""
from ttsd_bench.counts import PEAK_BF16_FLOPS


def read(layer, cfg):
    b = layer.get("batches") or []
    t = sum(x["decode_s"] for x in b)
    return 100.0 * sum(x["flops"] for x in b) / t / PEAK_BF16_FLOPS if t else None

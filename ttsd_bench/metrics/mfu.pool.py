"""The pool steps' share of the chip's bf16 peak: the model FLOPs of the
rows that advance (the architecture's ``decode_flops``) over the
segments' wall time (``ContinuousBatcher.run``) and 989 TFLOP/s."""
from ttsd_bench.counts import PEAK_BF16_FLOPS


def read(layer, cfg):
    runs = layer.get("runs") or []
    t = sum(x[0] for x in runs)
    return 100.0 * sum(x[2] for x in runs) / t / PEAK_BF16_FLOPS if t else None

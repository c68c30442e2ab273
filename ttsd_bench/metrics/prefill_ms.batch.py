"""Mean prefill time of the window's batches, the engine's own
``last_stats["prefill_s"]`` (ends in a sync)."""
from ttsd_bench.readers import mean_ms


def read(layer, cfg):
    return mean_ms([b["prefill_s"] for b in layer.get("batches") or []])

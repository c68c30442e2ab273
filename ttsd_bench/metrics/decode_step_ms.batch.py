"""Decode time a step over the window's batches: the engine's
``last_stats`` decode seconds over its steps."""


def read(layer, cfg):
    b = layer.get("batches") or []
    steps = sum(x["steps"] for x in b)
    return 1e3 * sum(x["decode_s"] for x in b) / steps if steps else None

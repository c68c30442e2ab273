"""Wall time of ``ContinuousBatcher.run`` over the pool steps it ran, every
segment of the window, host clock (a run ends in its last step's loop
test; the last step's device tail lands in the segment's readback)."""


def read(layer, cfg):
    runs = layer.get("runs") or []
    steps = sum(n for _, n, _ in runs)
    return 1e3 * sum(t for t, _, _ in runs) / steps if steps else None

"""The overlap's vocode dispatched between decode segments: the window's
``pipeline.vocode_feed`` span seconds (each ``inc.feed``, with the codes
it reads) over the audio seconds made; 0 when no batch of the window
crossed a codec window."""
from ttsd_bench.spans import seconds, window


def read(layer, cfg):
    roots = window(layer)
    audio = sum(x["audio_s"] for x in layer.get("batches") or [])
    if roots is None or not audio:
        return None
    return 1e3 * seconds(roots, "pipeline.vocode_feed") / audio

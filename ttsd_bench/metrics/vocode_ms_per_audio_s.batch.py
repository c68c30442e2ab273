"""Vocode time a second of audio over the window's batches: the
pipeline's ``timings.vocode_s`` (the codec time not hidden under the
decode) over the audio seconds made."""


def read(layer, cfg):
    b = layer.get("batches") or []
    audio = sum(x["audio_s"] for x in b)
    return 1e3 * sum(x["vocode_s"] for x in b) / audio if audio else None

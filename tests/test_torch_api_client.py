"""The port's API client helpers against the JAX package's copy:
``wav_bytes_to_array`` on 8/16/24/32-bit and stereo wavs,
``build_references`` on the examples' items, and ``process_jsonl``'s
fan-out with a stub client (per-item isolation, the summary file)."""
import io
import json
import pathlib
import wave

import numpy as np
import pytest

from moss_ttsd_tpu.serve import api_client as japi
from moss_ttsd_torch.serve import api_client as api

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _wav_bytes(width, channels, n=257, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, n * width * channels, dtype=np.uint8)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(22050)
        w.writeframes(raw.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bytes_to_array_matches_jax(width, channels):
    data = _wav_bytes(width, channels, seed=width * 10 + channels)
    ours, sr = api.wav_bytes_to_array(data)
    theirs, jsr = japi.wav_bytes_to_array(data)
    assert sr == jsr == 22050
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (257,) and np.abs(ours).max() <= 1.0


def test_24_bit_values():
    """A 24-bit sample 0x400000 is half scale, 0x800000 minus one."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(24000)
        w.writeframes(bytes([0, 0, 0x40, 0, 0, 0x80]))
    arr, _ = api.wav_bytes_to_array(buf.getvalue())
    np.testing.assert_array_equal(arr, [0.5, -1.0])


def test_build_references_matches_jax():
    items = [json.loads(l) for n in ("examples.jsonl",
                                     "examples_single_reference.jsonl")
             for l in (ROOT / "examples" / n).read_text().splitlines()
             if l.strip()]
    items = [{**it, "base_path": str(ROOT / it["base_path"])}
             for it in items]
    items.append({"text": "[S1]no voice"})
    for item in items:
        assert api.build_references(item) == japi.build_references(item)
    assert [len(api.build_references(it)) for it in items] == [2, 1, 0]


def test_process_jsonl_isolates_items(tmp_path):
    """Two items through a stub client, one failing: one wav, one summary
    line, the count of items written."""
    jsonl = tmp_path / "in.jsonl"
    jsonl.write_text("\n".join(json.dumps({"text": t}) for t in
                               ("[S1]good", "[S1]bad")) + "\n")

    class Stub:
        def generate_speech(self, text, refs, voice=None):
            if "bad" in text:
                raise RuntimeError("server said no")
            return b"RIFF" + text.encode()

    summary = tmp_path / "summary.jsonl"
    n = api.process_jsonl(str(jsonl), str(tmp_path / "out"), Stub(),
                          max_workers=2, summary_file=str(summary))
    assert n == 1
    assert (tmp_path / "out" / "output_0.wav").read_bytes() == b"RIFF[S1]good"
    assert not (tmp_path / "out" / "output_1.wav").exists()
    lines = [json.loads(l) for l in summary.read_text().splitlines()]
    assert lines == [{"index": 0, "text": "[S1]good",
                      "output": str(tmp_path / "out" / "output_0.wav")}]

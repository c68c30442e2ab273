"""The port's host audio path against the JAX package's (CPU): the numpy
resampler, the native runtime (the port's own copy, built with make) and
the prompt-audio loading of two-speaker dicts, (wav, sr) tuples and stereo
files at another rate."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_tpu.ops.dsp import resample as j_resample  # noqa: E402
from moss_ttsd_tpu.pipeline.jsonl import load_audio_data as j_load  # noqa: E402
from moss_ttsd_torch.ops.dsp import resample  # noqa: E402
from moss_ttsd_torch.pipeline.jsonl import load_audio_data  # noqa: E402
from moss_ttsd_torch.utils import audio_io, native  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("the native audio runtime did not build (no compiler)")
    return native


@pytest.mark.parametrize("sr_in", [24000, 44100, 8000])
def test_resample_to_16k_matches_jax(sr_in):
    rng = np.random.default_rng(sr_in)
    x = rng.standard_normal((2, sr_in + 7)).astype(np.float32)
    ref = j_resample(x, sr_in, 16000)
    got = resample(x, sr_in, 16000)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("sr_in,sr_out", [(24000, 16000), (44100, 16000),
                                          (16000, 24000)])
def test_native_resample_matches_numpy(native_lib, sr_in, sr_out):
    rng = np.random.default_rng(sr_in + sr_out)
    x = rng.standard_normal((3, sr_in // 2 + 1)).astype(np.float32)
    before = native_lib.calls["resample"]
    got = native_lib.resample(x, sr_in, sr_out)
    assert native_lib.calls["resample"] == before + 1
    ref = resample(x, sr_in, sr_out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_native_library_builds_outside_the_package(native_lib):
    assert native_lib.LIB_PATH.exists()
    assert native_lib.LIB_PATH.parent.parts[-3:] == ("build", "moss_ttsd_torch",
                                                     "native")
    assert not list(native_lib.SRC_DIR.rglob("*.so"))


def test_read_wav_native_matches_scipy(native_lib, monkeypatch):
    path = str(EXAMPLES / "voice_s1.wav")
    got, sr = audio_io.read_wav(path)
    monkeypatch.setattr(native, "read_wav", lambda p: None)
    ref, sr_ref = audio_io.read_wav(path)
    assert sr == sr_ref == 16000 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _stereo_24k(tmp_path):
    """voice_s1 as a stereo 24 kHz file (channel 2 at half gain)."""
    from scipy.io import wavfile
    w, sr = audio_io.read_wav(str(EXAMPLES / "voice_s1.wav"))
    w24 = resample(w[0], sr, 24000)
    st = np.stack([w24, 0.5 * w24])
    path = tmp_path / "stereo24k.wav"
    wavfile.write(path, 24000, (np.clip(st, -1, 1) * 32767).astype(np.int16).T)
    return str(path), st


@pytest.mark.parametrize("kind", ["two_speakers", "tuple", "stereo_24k_file",
                                  "stereo_24k_tuple"])
def test_load_audio_data_matches_jax(tmp_path, kind):
    s1, s2 = str(EXAMPLES / "voice_s1.wav"), str(EXAMPLES / "voice_s2.wav")
    if kind == "two_speakers":
        prompt = {"speaker1": s1, "speaker2": s2}
    elif kind == "tuple":
        w, sr = audio_io.read_wav(str(EXAMPLES / "voice_both.wav"))
        prompt = (w[0], sr)
    elif kind == "stereo_24k_file":
        prompt = _stereo_24k(tmp_path)[0]
    else:
        prompt = (_stereo_24k(tmp_path)[1], 24000)
    ref = j_load(prompt)
    got = load_audio_data(prompt)
    assert got.dtype == np.float32 and got.ndim == 1
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)
    if kind == "two_speakers":
        assert got.shape == (96000,)


def test_load_audio_data_refuses_unknown_inputs():
    assert load_audio_data(None) is None
    with pytest.raises(ValueError, match="Unsupported audio input"):
        load_audio_data(3.5)

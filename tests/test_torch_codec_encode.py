"""The port's codec encode against the JAX XYTokenizer on the same weights
(CodecConfig().tiny(), fp32, CPU): the STFT, the mel filterbank and the
log-mel (on a padded batch of the examples' voices), the encoder modules,
the pre-RVQ latents, nearest_codes and XYTokenizer.encode, whose codes
must be identical to JAX's on the examples' wavs, on a batch of two
lengths and on a wav of two 30 s windows."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig  # noqa: E402
from moss_ttsd_tpu.models.codec import transformer as jtr  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizerModule as JModule  # noqa: E402
from moss_ttsd_tpu.models.codec.rvq import nearest_codes as j_nearest  # noqa: E402
from moss_ttsd_tpu.ops import dsp as jdsp  # noqa: E402
from moss_ttsd_tpu.utils.audio_io import read_wav as j_read_wav  # noqa: E402
from moss_ttsd_torch.core.config import CodecConfig  # noqa: E402
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.models.codec.rvq import nearest_codes  # noqa: E402
from moss_ttsd_torch.ops import dsp as pdsp  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import codec_state_from_jax  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
ATOL = 1e-5          # fp32 activations, reassociation across frameworks


def _voice(name):
    return j_read_wav(str(EXAMPLES / name))[0][0]


def _wavs():
    """voice_s1 + voice_s2 (the two-speaker prompt, 6 s), voice_both (4 s),
    and a 35 s wav (two 30 s windows): the voices tiled, plus seeded noise."""
    pair = np.concatenate([_voice("voice_s1.wav"), _voice("voice_s2.wav")])
    both = _voice("voice_both.wav")
    rng = np.random.default_rng(0)
    long = np.tile(np.concatenate([pair, both]), 4)[:35 * 16000]
    long = long + 0.01 * rng.standard_normal(long.shape).astype(np.float32)
    return {"pair": pair, "both": both, "long": long.astype(np.float32)}


@pytest.fixture(scope="module")
def pair():
    jspt = JXY.init_random(JCodecConfig().tiny(), seed=0)
    cfg = CodecConfig().tiny()
    params = jax.tree_util.tree_map(np.asarray, jspt.params)
    spt = XYTokenizer(cfg, codec_state_from_jax(params, cfg), device="cpu")
    return jspt, spt, params["params"]


def _padded_chunk(wavs, n=480000):
    x = np.zeros((len(wavs), n), np.float32)
    for b, w in enumerate(wavs):
        x[b, :len(w)] = w[:n]
    return x, np.array([min(len(w), n) for w in wavs], np.int64)


def test_stft_magsq_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 1000)).astype(np.float32)
    win = jdsp.hann_window(64)
    ref = np.asarray(jdsp.stft_magsq(jnp.asarray(x), 64, 16, jnp.asarray(win)))
    got = pdsp.stft_magsq(torch.from_numpy(x), 64, 16,
                          torch.from_numpy(win)).numpy()
    assert got.shape == ref.shape == (2, 3, 33, 63)
    # |X|^2 reaches ~500 here: fp32 sums in another order, relative 1e-6
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=ATOL)


def test_mel_filter_bank_matches_jax_exactly():
    for args in ((201, 80, 0.0, 8000.0, 16000), (33, 10, 20.0, 4000.0, 8000)):
        np.testing.assert_array_equal(pdsp.mel_filter_bank(*args),
                                      jdsp.mel_filter_bank(*args))


def test_log_mel_padded_batch_matches_jax():
    """B 2 of the examples' voices padded to the 30 s chunk; the per-sample
    max runs over the whole chunk, padding included, as in JAX."""
    w = _wavs()
    x, _ = _padded_chunk([w["pair"], w["both"]])
    ref = np.asarray(jdsp.log_mel_spectrogram(jnp.asarray(x)))
    got = pdsp.log_mel_spectrogram(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 80, 3000)
    # bins within 10^-4 of each sample's peak power (log-mel above max - 1):
    # fp32 reassociation of the DFT, ATOL
    top = ref > ref.max(axis=(1, 2), keepdims=True) - 1.0
    np.testing.assert_allclose(got[top], ref[top], atol=ATOL)
    # weaker bins, down to the max - 8 floor: log10 magnifies the relative
    # error of a low-power bin's DFT sum (measured 5.8e-5 at most)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("name", ["semantic_encoder", "acoustic_encoder"])
def test_audio_encoder_matches_jax(pair, name):
    jspt, spt, p = pair
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 203, 80)).astype(np.float32)
    lens = np.array([203, 120])
    jmod = jtr.AudioEncoder(getattr(jspt.cfg, name))
    ref, ref_len = jmod.apply({"params": p[name]}, jnp.asarray(mel),
                              jnp.asarray(lens))
    got, got_len = getattr(spt.module, name)(torch.from_numpy(mel),
                                             torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got.shape == ref.shape == (2, 102, 32)      # (203 + 2 - 3) // 2 + 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


@pytest.mark.parametrize("T", [96, 99])
def test_gated_downsample_matches_jax(pair, T):
    """T a multiple of the factor 4, and not (the right-pad path)."""
    jspt, spt, p = pair
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 32)).astype(np.float32)
    lens = np.array([T, T - 37])
    jmod = jtr.GatedDownsample(32, 4)
    ref, ref_len = jmod.apply({"params": p["downsample"]}, jnp.asarray(x),
                              jnp.asarray(lens))
    got, got_len = spt.module.downsample(torch.from_numpy(x),
                                         torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got.shape == ref.shape == (2, -(-T // 4), 128)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def test_encode_latents_matches_jax(pair):
    """The pre-RVQ latents of a padded batch of the examples' voices."""
    jspt, spt, _ = pair
    w = _wavs()
    x, lens = _padded_chunk([w["pair"], w["both"]])
    ref, ref_len = jspt.module.apply(
        jspt.params, jnp.asarray(x), jnp.asarray(lens), True,
        method=JModule._encode_latents)
    got, got_len = spt.module._encode_latents(torch.from_numpy(x),
                                              torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got.shape == ref.shape == (2, 375, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_nearest_codes_matches_jax():
    rng = np.random.default_rng(3)
    for shape, K, D in (((2, 50), 64, 16), ((3, 7, 11), 1024, 512)):
        z = rng.standard_normal(shape + (D,)).astype(np.float32)
        cb = rng.standard_normal((K, D)).astype(np.float32)
        ref = np.asarray(j_nearest(jnp.asarray(z), jnp.asarray(cb)))
        got = nearest_codes(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("names", [("pair",), ("both",), ("pair", "both"),
                                   ("long",)])
def test_encode_codes_identical_to_jax(pair, names):
    """Identical codes, each (nq, len // 1280): the two-speaker prompt, the
    single-reference voice, both in one batch (different lengths), and a
    35 s wav over two windows."""
    jspt, spt, _ = pair
    w = _wavs()
    wavs = [w[n] for n in names]
    ref = jspt.encode(wavs)["codes_list"]
    got = spt.encode(wavs)["codes_list"]
    for g, r, wav in zip(got, ref, wavs):
        assert g.dtype == np.int32
        assert g.shape == r.shape == (8, len(wav) // 1280)
        np.testing.assert_array_equal(g, r)


def test_encode_batch_padding_invariance(pair):
    """A row's codes do not depend on the other rows of its batch."""
    _, spt, _ = pair
    w = _wavs()
    batched = spt.encode([w["pair"], w["both"]])["codes_list"]
    for wav, b in zip((w["pair"], w["both"]), batched):
        np.testing.assert_array_equal(spt.encode([wav])["codes_list"][0], b)


def test_encode_bf16_keeps_quantizer_fp32(pair):
    """bf16 serving: the quantizer subtree (input_proj included) stays fp32
    and the codes keep their shapes and range."""
    _, spt, _ = pair
    cfg = CodecConfig().tiny()
    sd = {k: v.clone() for k, v in spt.module.state_dict().items()}
    b16 = XYTokenizer(cfg, sd, dtype="bfloat16", device="cpu")
    assert b16.module.quantizer.input_proj.weight.dtype == torch.float32
    assert b16.module.semantic_encoder.conv1.weight.dtype == torch.bfloat16
    w = _wavs()
    for c, wav in zip(b16.encode([w["pair"], w["both"]])["codes_list"],
                      (w["pair"], w["both"])):
        assert c.shape == (8, len(wav) // 1280)
        assert c.min() >= 0 and c.max() < cfg.quantizer.codebook_size


def test_encode_bf16_matches_jax_bf16(pair):
    """bf16 serving against JAX's bf16 encode (cast_compute_dtype=True) on
    the same weights: the fp32 log-mel cast at the stack boundary, ``down``
    back to fp32 before the fp32 quantizer. Two bf16 stacks round at
    different points, so the pre-RVQ latents are held to twice the bf16
    noise of JAX's own encode (its distance to the fp32 encode), in max and
    in mean; the codes then flip on near ties of the codebook distances, so
    their agreement is held to a floor (measured on the CPU: 0.91 and 0.95
    over all eight stages, 0.96 and 0.98 in the first)."""
    jspt, spt, _ = pair
    jb16 = JXY(jspt.cfg, jspt.params, dtype="bfloat16")
    b16 = XYTokenizer(spt.cfg, {k: v.clone() for k, v in
                                spt.module.state_dict().items()},
                      dtype="bfloat16", device="cpu")
    w = _wavs()
    wavs = [w["pair"], w["both"]]
    x, lens = _padded_chunk(wavs)
    ref, ref_len = jb16.module.apply(
        jb16.infer_params, jnp.asarray(x), jnp.asarray(lens), True,
        method=JModule._encode_latents)
    ref = np.asarray(ref.astype(jnp.float32))
    f32 = np.asarray(jspt.module.apply(
        jspt.params, jnp.asarray(x), jnp.asarray(lens), True,
        method=JModule._encode_latents)[0])
    got, got_len = b16.module._encode_latents(torch.from_numpy(x),
                                              torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    err = np.abs(got.float().numpy() - ref)
    noise = np.abs(ref - f32)
    assert err.max() <= 2 * noise.max(), (err.max(), noise.max())
    assert err.mean() <= 2 * noise.mean(), (err.mean(), noise.mean())

    ref_codes = jb16.encode(wavs)["codes_list"]
    got_codes = b16.encode(wavs)["codes_list"]
    for g, r, wav in zip(got_codes, ref_codes, wavs):
        assert g.shape == r.shape == (8, len(wav) // 1280)
        agree, first = float(np.mean(g == r)), float(np.mean(g[0] == r[0]))
        assert agree >= 0.85 and first >= 0.95, (agree, first)

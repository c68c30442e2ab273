"""The port's codec decode against the JAX XYTokenizer on the same weights
(CodecConfig().tiny(), fp32, CPU): wavs for a multi-window input with and
without length buckets and with rows_per_call, the int16-PCM variant, and
the ISTFT including hop == n_fft."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY  # noqa: E402
from moss_ttsd_tpu.ops import dsp as jdsp  # noqa: E402
from moss_ttsd_torch.core.config import CodecConfig  # noqa: E402
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.ops import dsp as pdsp  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import codec_state_from_jax  # noqa: E402

ATOL = 1e-4          # fp32 wav samples, reassociation across frameworks
LSB = 1.0 / 32768    # one int16 step


@pytest.fixture(scope="module")
def pair():
    jspt = JXY.init_random(JCodecConfig().tiny(), seed=0)
    cfg = CodecConfig().tiny()
    params = jax.tree_util.tree_map(np.asarray, jspt.params)
    spt = XYTokenizer(cfg, codec_state_from_jax(params, cfg), device="cpu")
    return jspt, spt


def _codes(spt, lens, seed):
    rng = np.random.default_rng(seed)
    K = spt.cfg.quantizer.codebook_size
    return [rng.integers(0, K, (spt.nq, n)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kw", [dict(), dict(len_buckets=None),
                                dict(rows_per_call=1)])
def test_decode_multi_window_matches_jax(pair, kw):
    jspt, spt = pair
    codes = _codes(spt, [400, 130], 0)          # 2 windows for row 0
    ref = jspt.decode(codes, **kw)["syn_wav_list"]
    got = spt.decode(codes, **kw)["syn_wav_list"]
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_decode_pcm16_within_one_lsb(pair):
    jspt, spt = pair
    codes = _codes(spt, [90, 57], 1)
    ref = jspt.decode(codes, pcm16=True, rows_per_call=1)["syn_wav_list"]
    got = spt.decode(codes, pcm16=True, rows_per_call=1)["syn_wav_list"]
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=LSB * 1.01)


@pytest.mark.parametrize("n_fft,hop,T", [(960, 240, 13), (16, 4, 9),
                                         (8, 8, 6), (12, 12, 1)])
def test_istft_same_matches_jax(n_fft, hop, T):
    rng = np.random.default_rng(n_fft + hop + T)
    nb = n_fft // 2 + 1
    re = rng.standard_normal((2, nb, T)).astype(np.float32)
    im = rng.standard_normal((2, nb, T)).astype(np.float32)
    ref = np.asarray(jdsp.istft_same(jnp.asarray(re), jnp.asarray(im),
                                     n_fft, hop))
    got = pdsp.istft_same(torch.from_numpy(re), torch.from_numpy(im),
                          n_fft, hop).numpy()
    assert got.shape == ref.shape == (2, T * hop)
    # rtol: at a masked row's last frames the envelope is small and the
    # normalized samples large
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    frames = np.array([T, max(1, T - 2)])
    ref = np.asarray(jdsp.istft_same_masked(
        jnp.asarray(re), jnp.asarray(im), n_fft, hop, jnp.asarray(frames)))
    got = pdsp.istft_same_masked(torch.from_numpy(re), torch.from_numpy(im),
                                 n_fft, hop, torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_bf16_keeps_rvq_fp32_and_stays_close(pair):
    """bf16 mode: the quantizer subtree and the position tables stay fp32,
    every other weight is bf16, and the wav stays near the fp32 one (the
    JAX package's 3% relative-RMS contract, tests/test_codec_bf16.py)."""
    _, spt = pair
    cfg = CodecConfig().tiny()
    sd = {k: v.clone() for k, v in spt.module.state_dict().items()}
    b16 = XYTokenizer(cfg, sd, dtype="bfloat16", device="cpu")
    for name, p in b16.module.named_parameters():
        want = torch.float32 if name.startswith("quantizer.") else torch.bfloat16
        assert p.dtype == want, name
    assert b16.module.post_rvq_adapter.pos.dtype == torch.float32
    codes = _codes(spt, [40, 40], 2)
    for a, b in zip(spt.decode(codes)["syn_wav_list"],
                    b16.decode(codes)["syn_wav_list"]):
        assert b.dtype == np.float32
        rel = np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-9)
        assert rel < 0.03, rel


def test_unported_vocos_variants_raise():
    """Every Vocos variant the JAX package builds is built (their parity:
    tests/test_torch_codec_variants.py); what still raises is what JAX
    refuses, the ISTFT head with padding="center"."""
    import dataclasses
    from moss_ttsd_torch.models.codec.vocos import Vocos
    base = CodecConfig().tiny().vocos
    with pytest.raises(NotImplementedError, match="padding='same'"):
        Vocos(dataclasses.replace(base, padding="center"))
    for kw in (dict(head="imdct_cos"), dict(head="imdct_symexp"),
               dict(backbone="resnet"), dict(adanorm_num_embeddings=2),
               dict(head="imdct_cos", padding="center")):
        Vocos(dataclasses.replace(base, **kw))

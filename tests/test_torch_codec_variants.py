"""The port's Vocos variants against the JAX modules on the same weights
(fp32, CPU): MDCT / IMDCT in both paddings, both IMDCT heads with the clip
flags both ways, AdaLayerNorm, the AdaLN ConvNeXt backbone, the ResNet
backbone, every backbone x head pairing through ``Vocos``, and
``XYTokenizer.decode`` with a ResNet / IMDCT codec. The port counterparts
of the reference-oracle tests in ``tests/test_codec_parity.py``.
Tolerances: 2e-5 on the transforms and norms, 1e-4 on audio (as
``tests/test_torch_codec.py`` holds the codec's wavs)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig  # noqa: E402
from moss_ttsd_tpu.core.config import VocosConfig as JVocosConfig  # noqa: E402
from moss_ttsd_tpu.models.codec import vocos as jvocos  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY  # noqa: E402
from moss_ttsd_tpu.ops import dsp as jdsp  # noqa: E402
from moss_ttsd_torch.core.config import CodecConfig, VocosConfig  # noqa: E402
from moss_ttsd_torch.models.codec import vocos as pvocos  # noqa: E402
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.ops import dsp as pdsp  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import codec_state_from_jax  # noqa: E402

TOL = 2e-5           # transforms and norms, fp32 reassociation
ATOL = 1e-4          # audio, as tests/test_torch_codec.py


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, seed, scale=0.2):
    """Every leaf plus N(0, scale): flax's constant inits (LN, AdaLN tables,
    gammas, biases) become informative."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))
                   ).astype(np.float32), tree)


def _vocos_state(tree, vcfg):
    """The JAX Vocos tree -> the port's ``Vocos`` state dict (through the
    codec converter's own Vocos map)."""
    from moss_ttsd_torch.utils.convert_jax import _vocos
    sd = {}
    _vocos(sd, tree, vcfg)
    return {k[len("vocos."):]: v for k, v in sd.items()}


def _lens(B, T):
    return np.array([T, max(1, T - 4)] + [T] * (B - 2))[:B].astype(np.int32)


@pytest.mark.parametrize("padding", ["same", "center"])
def test_mdct_imdct_match_jax(padding):
    frame_len = 64
    audio = np.random.default_rng(21).standard_normal((2, 640)).astype(
        np.float32)
    ref = np.asarray(jdsp.mdct(jnp.asarray(audio), frame_len, padding))
    got = pdsp.mdct(torch.from_numpy(audio), frame_len, padding).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL)
    ref_y = np.asarray(jdsp.imdct(jnp.asarray(ref), frame_len, padding))
    got_y = pdsp.imdct(torch.from_numpy(np.array(ref)), frame_len,
                       padding).numpy()
    assert got_y.shape == ref_y.shape
    np.testing.assert_allclose(got_y, ref_y, atol=TOL)
    with pytest.raises(ValueError, match="padding"):
        pdsp.mdct(torch.from_numpy(audio), frame_len, "valid")


@pytest.mark.parametrize("kind", ["symexp", "cos"])
@pytest.mark.parametrize("clip_audio,clip_coeffs",
                         [(False, False), (True, False), (True, True)])
def test_imdct_heads_match_jax(kind, clip_audio, clip_coeffs):
    dim, frame_len, sr, B, T = 24, 32, 24000, 2, 10
    x = (np.random.default_rng(31).standard_normal((B, T, dim)) * 0.3
         ).astype(np.float32)
    lens = _lens(B, T)
    if kind == "symexp":
        jhead = jvocos.IMDCTSymExpHead(dim, frame_len, "same", sr,
                                       clip_audio, clip_coeffs)
        phead = pvocos.IMDCTSymExpHead(dim, frame_len, "same", sr,
                                       clip_audio, clip_coeffs)
    else:
        jhead = jvocos.IMDCTCosHead(dim, frame_len, "same", clip_audio,
                                    clip_coeffs)
        phead = pvocos.IMDCTCosHead(dim, frame_len, "same", clip_audio,
                                    clip_coeffs)
    params = _np_tree(jhead.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                 jnp.asarray(lens)))
    ref = np.asarray(jhead.apply(params, jnp.asarray(x), jnp.asarray(lens)))
    out = params["params"]["out"]
    phead.load_state_dict({"out.weight": torch.tensor(out["kernel"].T),
                           "out.bias": torch.tensor(out["bias"])})
    got = phead(torch.from_numpy(x), torch.from_numpy(lens)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if clip_audio:
        assert np.abs(got).max() <= 1.0


def test_mel_scale_init_matches_jax():
    """IMDCTSymExpHead's mel-scale column factors, as the JAX init applies
    them to its lecun-normal kernel."""
    out_dim = 16
    init = jvocos._mel_scale_init(24000, out_dim)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(init(key, (8, out_dim)))
    base = np.asarray(jax.nn.initializers.lecun_normal()(key, (8, out_dim)))
    np.testing.assert_allclose(ref, base * pvocos.mel_scale(24000, out_dim),
                               rtol=1e-6)


def test_adanorm_matches_jax():
    n_emb, dim, B, T = 4, 16, 3, 7
    x = np.random.default_rng(35).standard_normal((B, T, dim)).astype(
        np.float32)
    cond = np.array([0, 2, 3])[:, None]
    jmod = jvocos.AdaLayerNorm(n_emb, dim)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(cond)), 35)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(cond)))
    pmod = pvocos.AdaLayerNorm(n_emb, dim)
    pmod.load_state_dict({k: torch.from_numpy(v)
                          for k, v in params["params"].items()})
    got = pmod(torch.from_numpy(x), torch.from_numpy(cond)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)


def _backbone_case(cfg_kw, seed):
    jcfg = JVocosConfig(input_channels=12, dim=16, intermediate_dim=32,
                        num_layers=2, **cfg_kw)
    B, T = 2, 9
    x = np.random.default_rng(seed).standard_normal(
        (B, T, jcfg.input_channels)).astype(np.float32)
    lens = _lens(B, T)
    mask = (np.arange(T)[None, :] < lens[:, None])[..., None]
    return jcfg, VocosConfig(**dataclasses.asdict(jcfg)), x, lens, mask


@pytest.mark.parametrize("backbone", ["convnext_adanorm", "resnet"])
def test_backbones_match_jax(backbone):
    """The AdaLN ConvNeXt backbone (per-row classes) and the ResNet
    backbone, ragged rows masked as the codec masks them."""
    if backbone == "resnet":
        jcfg, cfg, x, lens, mask = _backbone_case(
            dict(backbone="resnet", num_blocks=2), 39)
        jmod, pmod = (jvocos.VocosResNetBackbone(jcfg),
                      pvocos.VocosResNetBackbone(cfg))
        cond = None
    else:
        jcfg, cfg, x, lens, mask = _backbone_case(
            dict(adanorm_num_embeddings=3), 37)
        jmod, pmod = jvocos.VocosBackbone(jcfg), pvocos.VocosBackbone(cfg)
        cond = np.array([1, 2])[:, None]
    jcond = None if cond is None else jnp.asarray(cond)
    params = _perturb(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                jnp.asarray(mask), jcond), 7, 0.1)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(mask),
                                jcond))
    state = _vocos_state({"backbone": params["params"],
                          "head": {"out": {"kernel": np.zeros((16, 4)),
                                           "bias": np.zeros(4)}}}, cfg)
    pmod.load_state_dict({k[len("backbone."):]: v for k, v in state.items()
                          if k.startswith("backbone.")})
    got = pmod(torch.from_numpy(x), torch.from_numpy(mask),
               None if cond is None else torch.from_numpy(cond)
               ).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("cfg_kw", [
    dict(head="imdct_symexp", head_sample_rate=24000),
    dict(head="imdct_cos", padding="center"),
    dict(backbone="resnet", num_blocks=2),
    dict(backbone="resnet", num_blocks=1, head="imdct_cos", clip_audio=True,
         clip_coeffs=True),
    dict(adanorm_num_embeddings=2, head="imdct_symexp", padding="center"),
], ids=["convnext-symexp", "convnext-cos-center", "resnet-istft",
        "resnet-cos-coeffs", "adanorm-symexp-center"])
def test_vocos_variants_match_jax(cfg_kw):
    """``Vocos`` builds each backbone x head JAX builds, and its wav and
    lengths (the per-head upsampling) match JAX's."""
    jcfg = JVocosConfig(input_channels=12, dim=16, intermediate_dim=32,
                        num_layers=2, n_fft=16, hop_size=4,
                        mdct_frame_len=8, **cfg_kw)
    cfg = VocosConfig(**dataclasses.asdict(jcfg))
    B, T = 2, 11
    x = np.random.default_rng(43).standard_normal(
        (B, T, jcfg.input_channels)).astype(np.float32)
    lens = _lens(B, T)
    cond = (None if jcfg.adanorm_num_embeddings is None
            else np.array([0, 1])[:, None])
    jcond = None if cond is None else jnp.asarray(cond)
    jmod = jvocos.Vocos(jcfg)
    params = _perturb(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                jnp.asarray(lens), jcond), 11, 0.1)
    ref_wav, ref_len = jmod.apply(params, jnp.asarray(x), jnp.asarray(lens),
                                  jcond)
    pmod = pvocos.Vocos(cfg)
    pmod.load_state_dict(_vocos_state(params["params"], cfg))
    wav, wav_len = pmod(torch.from_numpy(x), torch.from_numpy(lens),
                        None if cond is None else torch.from_numpy(cond))
    np.testing.assert_array_equal(wav_len.numpy(), np.asarray(ref_len))
    assert wav.shape == np.asarray(ref_wav).shape
    np.testing.assert_allclose(wav.detach().numpy(), np.asarray(ref_wav),
                               atol=ATOL)


def test_istft_center_padding_raises_as_jax():
    base = VocosConfig(input_channels=12, dim=16, intermediate_dim=32,
                       num_layers=2)
    with pytest.raises(NotImplementedError, match="same"):
        pvocos.Vocos(dataclasses.replace(base, padding="center"))
    with pytest.raises(ValueError, match="unknown"):
        pvocos.Vocos(dataclasses.replace(base, head="wavenet"))


def _variant_codec(jcfg_kw):
    jcfg = JCodecConfig().tiny()
    jcfg = dataclasses.replace(jcfg, vocos=dataclasses.replace(
        jcfg.vocos, **jcfg_kw))
    cfg = CodecConfig().tiny()
    return jcfg, dataclasses.replace(cfg, vocos=dataclasses.replace(
        cfg.vocos, **jcfg_kw))


@pytest.mark.parametrize("vocos_kw", [
    dict(backbone="resnet", num_blocks=2, head="imdct_symexp",
         head_sample_rate=24000),
    dict(head="imdct_cos")], ids=["resnet-symexp", "convnext-cos"])
def test_xytokenizer_decode_variant_matches_jax(vocos_kw):
    """The whole codec decode (30 s windows, a partial bucket) with a
    variant Vocos; the frame's 240 samples keep the 1920 a code."""
    jcfg, cfg = _variant_codec(vocos_kw)
    jspt = JXY.init_random(jcfg, seed=0)
    spt = XYTokenizer(cfg, codec_state_from_jax(_np_tree(jspt.params), cfg),
                      device="cpu")
    rng = np.random.default_rng(5)
    codes = [rng.integers(0, cfg.quantizer.codebook_size,
                          (spt.nq, n)).astype(np.int32) for n in (400, 77)]
    ref = jspt.decode(codes)["syn_wav_list"]
    got = spt.decode(codes)["syn_wav_list"]
    for a, b, c in zip(got, ref, codes):
        assert a.shape == b.shape == (c.shape[-1] * 1920,)
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_random_init_of_variants():
    """``init_random`` builds every variant with the JAX init's constants:
    layer-scale gammas, AdaLN tables of ones and zeros, the mel-scaled
    IMDCT-symexp output layer (its last column zero)."""
    _, cfg = _variant_codec(dict(backbone="resnet", num_blocks=2,
                                 head="imdct_symexp",
                                 head_sample_rate=24000))
    spt = XYTokenizer.init_random(cfg, seed=0, device="cpu")
    bb = spt.module.vocos.backbone
    assert torch.all(bb.resnet[1].gamma[2] == 1.0 / 2 / 3)
    w = spt.module.vocos.head.out.weight
    assert torch.all(w[-1] == 0) and torch.all(w[0] != 0)
    _, cfg = _variant_codec(dict(adanorm_num_embeddings=3))
    spt = XYTokenizer.init_random(cfg, seed=0, device="cpu")
    norm = spt.module.vocos.backbone.blocks[0].norm
    assert torch.all(norm.scale == 1) and torch.all(norm.shift == 0)
    assert torch.all(spt.module.vocos.backbone.blocks[1].gamma == 0.5)

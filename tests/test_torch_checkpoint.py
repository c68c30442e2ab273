"""Real-checkpoint loading in the port against the JAX package (tiny
models, fp32, CPU):

  * the HF-format LM directory both ways: JAX writes and the port reads
    (safetensors and ``pytorch_model.bin``, with and without
    ``attention_bias``), the port writes and JAX reads (plain and
    LoRA-merged; ``safetensors.numpy`` reads the port's files); bf16 and
    sharded files; logits within 1e-5 of JAX's, greedy tokens identical;
  * ``config.json`` and the codec yaml (nested ``generator_params``) read
    as JAX reads them, and the port's YAML reader equal to
    ``yaml.safe_load`` on them;
  * the reference codec ``.ckpt`` (weight-norm folding, the deconv flip)
    through both converters: the same JAX tree, identical codes, wavs
    within 1e-4; a native ``.npz``, per-layer or stacked;
  * every entry point with the real-checkpoint flags on a tiny directory,
    against JAX's CLI or function on the same files: the inference CLI
    (fp32, ``--quant int8``, ``--restricted_text_head``, a LoRA voice),
    the server's ``main`` (one request), ``codec_roundtrip``,
    ``finetune`` (its first loss) and the workflow (the processed data);
  * ``load_tokenizer`` without ``transformers`` names it.

``load_tokenizer`` (and JAX's ``AutoTokenizer``) are replaced by the mock
tokenizer: the directories hold no tokenizer files."""
import dataclasses
import json
import os
import pathlib
import sys
import threading
import types
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

import torch_ref_codec  # noqa: E402
from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig  # noqa: E402
from moss_ttsd_tpu.core.config import LMConfig as JLMConfig  # noqa: E402
from moss_ttsd_tpu.decode import engine as jeng  # noqa: E402
from moss_ttsd_tpu.models import lm as jlm  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY  # noqa: E402
from moss_ttsd_tpu.pipeline.batch import TTSPipeline as JPipeline  # noqa: E402
from moss_ttsd_tpu.pipeline.prompt import left_pad_batch  # noqa: E402
from moss_ttsd_tpu.utils import convert_codec as jcc  # noqa: E402
from moss_ttsd_tpu.utils import convert_lm as jconv  # noqa: E402
from moss_ttsd_tpu.utils.mock_tokenizer import MockTokenizer as JTok  # noqa: E402
from moss_ttsd_torch.core.config import CodecConfig, LMConfig  # noqa: E402
from moss_ttsd_torch.decode.engine import GenerationEngine  # noqa: E402
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.models.lm import AsteroidLM  # noqa: E402
from moss_ttsd_torch.pipeline import batch as pbatch  # noqa: E402
from moss_ttsd_torch.utils import config_yaml  # noqa: E402
from moss_ttsd_torch.utils import convert_codec as pcc  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import (  # noqa: E402
    codec_state_from_jax, lm_state_from_jax)
from moss_ttsd_torch.utils.convert_lm import (  # noqa: E402
    export_asteroid_state_dict, load_asteroid_checkpoint,
    save_asteroid_checkpoint)
from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer  # noqa: E402
from tests.test_codec_full_parity import tiny_generator_params  # noqa: E402
from tests.test_decode import make_prompt  # noqa: E402
from tests.test_torch_engine import JAX_S, TORCH_S, greedy  # noqa: E402
from tests.test_torch_lm import jax_tiny, rand_ids  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGITS_TOL = 1e-5    # fp32 logits, reassociation across frameworks
ATOL = 1e-4          # fp32 wav samples, as tests/test_torch_codec.py
LSB = 1.0 / 32768    # one int16 step of a written wav
# the tiny pipeline geometry of tests/test_torch_pipeline.py
PIPE_LM = dict(vocab_size=300, speech_vocab_size=65, speech_pad_token=64,
               speech_token_range=(0, 290), eos_token_id=290, pad_token_id=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_logits(jcfg, params, ids, mask):
    t, s = jlm.AsteroidLM(jcfg).apply(params, jnp.asarray(ids),
                                      jnp.asarray(mask))
    return np.asarray(t), np.asarray(s)


def _port_logits(cfg, state, ids, mask):
    model = AsteroidLM(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        t, s = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    return t.numpy(), s.numpy()


def _ids(cfg, seed=1):
    ids = rand_ids(cfg, np.random.default_rng(seed), 2, 11)
    mask = np.ones((2, 11), np.int64)
    mask[1, :3] = 0
    return ids, mask


def _write_generation_config(path, channels=8):
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"do_samples": [False] * channels,
                   "layers": [{} for _ in range(channels)]}, f)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny HF-format LM directory written by JAX (greedy
    generation_config.json) and the reference codec's yaml + .ckpt."""
    d = tmp_path_factory.mktemp("ckpt")
    jcfg, params = jax_tiny(0, **PIPE_LM)
    lm_dir = str(d / "lm")
    jconv.save_asteroid_checkpoint(params, jcfg, lm_dir)
    _write_generation_config(lm_dir)
    spt_yaml, spt_ckpt = torch_ref_codec.write_reference_codec(
        str(d / "codec"), CodecConfig().tiny(), seed=0)
    return {"lm": lm_dir, "yaml": spt_yaml, "ckpt": spt_ckpt, "jcfg": jcfg,
            "params": params, "root": d}


@pytest.fixture
def mock_tokenizers(monkeypatch):
    """The port's load_tokenizer and JAX's AutoTokenizer give the mock."""
    import transformers
    monkeypatch.setattr(pbatch, "load_tokenizer", lambda path: MockTokenizer())
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: JTok())


# -- the LM directory --------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("layout", ["safetensors", "bin"])
def test_jax_checkpoint_loads_in_port(tmp_path, layout, bias):
    """JAX's exporter writes; ``load_asteroid_checkpoint`` reads: logits
    within 1e-5 of JAX's on the JAX params, greedy tokens identical."""
    jcfg, params = jax_tiny(3, attention_bias=bias)
    if layout == "safetensors":
        jconv.save_asteroid_checkpoint(params, jcfg, str(tmp_path))
    else:
        sd = jconv.export_asteroid_state_dict(params, jcfg)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   tmp_path / "pytorch_model.bin")
        (tmp_path / "config.json").write_text(json.dumps(jcfg.to_dict()))
    cfg = LMConfig.from_hf_config_json(str(tmp_path / "config.json"))
    state = load_asteroid_checkpoint(str(tmp_path), cfg)
    assert all(v.dtype == torch.float32 for v in state.values())
    ids, mask = _ids(cfg)
    for got, ref in zip(_port_logits(cfg, state, ids, mask),
                        _jax_logits(jcfg, params, ids, mask)):
        np.testing.assert_allclose(got, ref, atol=LOGITS_TOL)

    rng = np.random.default_rng(4)
    batch, bmask = left_pad_batch(
        [make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 9, 2)],
        jcfg.pad_token_id, jcfg.speech_pad_token)
    r_j = jeng.GenerationEngine(jcfg, params, greedy(JAX_S), bucket=32,
                                cache_dtype=jnp.float32
                                ).generate(batch, bmask, 16)
    r_t = GenerationEngine(cfg, state, greedy(TORCH_S), bucket=32,
                           device="cpu").generate(batch, bmask, 16)
    assert r_t.steps == r_j.steps
    np.testing.assert_array_equal(r_t.tokens, r_j.tokens)


def _port_lora(jlora):
    """JAX merge-based factors {"layers/block/<t>/kernel": {"a": (L, in, r),
    "b": (L, r, out)}} -> the port's {"layers.<l>.<t>.weight": {...}}."""
    out = {}
    for key, fac in jlora.items():
        target = key.split("/")[-2]
        for l in range(np.shape(fac["a"])[0]):
            out[f"layers.{l}.{target}.weight"] = {
                ab: torch.from_numpy(np.array(fac[ab][l])) for ab in "ab"}
    return out


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_port_checkpoint_loads_in_jax(tmp_path, lora):
    """``save_asteroid_checkpoint`` writes; JAX's loader reads: the JAX
    forward gives the logits of the weights saved (LoRA factors merged as
    JAX's merge_lora merges them), and ``safetensors.numpy`` reads every
    tensor of the port's export bit for bit."""
    from safetensors.numpy import load_file
    from moss_ttsd_tpu.train.lora import init_lora, merge_lora
    jcfg, params = jax_tiny(5, attention_bias=True)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    state = lm_state_from_jax(params, cfg)
    kw, want = {}, params
    if lora:
        jl = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.01,
            init_lora(params, jax.random.PRNGKey(6), rank=4))
        kw = dict(lora=_port_lora(jl), lora_rank=4, lora_alpha=8.0)
        want = merge_lora(params, jl, rank=4, alpha=8.0)
    path = save_asteroid_checkpoint(state, cfg, str(tmp_path), **kw)
    assert path == str(tmp_path / "model.safetensors")
    jsonable = json.loads(json.dumps(jcfg.to_dict()))      # tuples as lists
    assert json.loads(json.dumps(JLMConfig.from_hf_config_json(
        str(tmp_path / "config.json")).to_dict())) == jsonable
    loaded = jconv.load_asteroid_checkpoint(str(tmp_path), jcfg)
    ids, mask = _ids(cfg, 7)
    for got, ref in zip(_jax_logits(jcfg, loaded, ids, mask),
                        _jax_logits(jcfg, want, ids, mask)):
        np.testing.assert_allclose(got, ref, atol=LOGITS_TOL)
    if not lora:
        on_disk = load_file(path)
        ours = export_asteroid_state_dict(state, cfg)
        assert sorted(on_disk) == sorted(ours)
        for k, v in ours.items():
            np.testing.assert_array_equal(on_disk[k], v.numpy(), err_msg=k)


def test_bf16_sharded_checkpoint_reads_back(tmp_path):
    """bf16 over two shards: ``safetensors.torch`` reads the port's BF16
    bytes as the bf16 cast of every tensor, the index maps each name to
    its shard, and the port's loader reads both shards back (in bf16 or
    widened to fp32)."""
    from safetensors.torch import load_file
    jcfg, params = jax_tiny(8)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    state = lm_state_from_jax(params, cfg)
    index = save_asteroid_checkpoint(state, cfg, str(tmp_path),
                                     dtype=torch.bfloat16, shards=2)
    shards = sorted(p.name for p in tmp_path.glob("*.safetensors"))
    assert shards == ["model-00001-of-00002.safetensors",
                      "model-00002-of-00002.safetensors"]
    weight_map = json.load(open(index))["weight_map"]
    ours = export_asteroid_state_dict(state, cfg)
    assert sorted(weight_map) == sorted(ours)
    for name in shards:
        for k, v in load_file(str(tmp_path / name)).items():
            assert weight_map[k] == name
            assert v.dtype == torch.bfloat16
            assert torch.equal(v, ours[k].bfloat16()), k
    b16 = load_asteroid_checkpoint(str(tmp_path), cfg, dtype=torch.bfloat16)
    f32 = load_asteroid_checkpoint(str(tmp_path), cfg)
    assert b16.keys() == state.keys() == f32.keys()
    for k, v in state.items():
        assert b16[k].dtype == torch.bfloat16 and f32[k].dtype == torch.float32
        assert torch.equal(b16[k], v.bfloat16()), k
        assert torch.equal(f32[k], v.bfloat16().float()), k


def test_missing_checkpoint_files_raise(tmp_path):
    cfg = LMConfig().tiny()
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        load_asteroid_checkpoint(str(tmp_path), cfg)
    with pytest.raises(FileNotFoundError, match="config.json"):
        pbatch.TTSPipeline.load(str(tmp_path), "c.yaml", "c.ckpt",
                                device="cpu")
    # a mesh is taken (tests/test_torch_tp_serve.py): the directory is
    # what is missing
    with pytest.raises(FileNotFoundError, match="config.json"):
        pbatch.TTSPipeline.load(str(tmp_path), "c.yaml", "c.ckpt",
                                mesh="2x1", device="cpu")


def test_lm_config_json_matches_jax():
    path = str(ROOT / "configs" / "lm_moss_ttsd_v0.5.json")
    assert (LMConfig.from_hf_config_json(path).to_dict()
            == JLMConfig.from_hf_config_json(path).to_dict())


# -- the codec yaml and checkpoint ---------------------------------------------

VARIANTS = {
    "default": {},
    "resnet-symexp": dict(backbone="resnet", num_blocks=2,
                          head="imdct_symexp", head_sample_rate=24000),
    "adanorm-cos": dict(adanorm_num_embeddings=3, head="imdct_cos",
                        padding="center"),
}


def _codec_cfgs(variant):
    kw = VARIANTS[variant]
    jcfg, cfg = JCodecConfig().tiny(), CodecConfig().tiny()
    return (dataclasses.replace(jcfg, vocos=dataclasses.replace(jcfg.vocos,
                                                                **kw)),
            dataclasses.replace(cfg, vocos=dataclasses.replace(cfg.vocos,
                                                               **kw)))


@pytest.mark.parametrize("writer", ["safe_dump", "ref_codec"])
def test_codec_yaml_matches_jax(tmp_path, writer):
    """``CodecConfig.from_yaml`` equals JAX's, field by field, on the
    reference layout (``tiny_generator_params`` dumped by pyyaml) and on
    the shared reference-codec writer (the full geometry with a variant Vocos); the
    port's reader equals ``yaml.safe_load`` on both."""
    if writer == "safe_dump":
        text = yaml.safe_dump(
            {"generator_params": tiny_generator_params(JCodecConfig().tiny())})
    else:
        cfg = CodecConfig()
        cfg = dataclasses.replace(cfg, vocos=dataclasses.replace(
            cfg.vocos, **VARIANTS["resnet-symexp"]))
        text = torch_ref_codec.yaml_text(
            {"generator_params": torch_ref_codec.codec_generator_params(cfg)})
    assert config_yaml.loads(text) == yaml.safe_load(text)
    path = tmp_path / "codec.yaml"
    path.write_text(text)
    ours = dataclasses.asdict(CodecConfig.from_yaml(str(path)))
    assert ours == dataclasses.asdict(JCodecConfig.from_yaml(str(path)))
    if writer == "ref_codec":
        assert ours == dataclasses.asdict(cfg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_codec_converter_tree_matches_jax(variant):
    """The port's numpy converter gives JAX's tree, leaf for leaf, from the
    reference state dict (legacy and parametrized weight norms folded,
    ConvTranspose kernels flipped), for each Vocos backbone and head."""
    jcfg, cfg = _codec_cfgs(variant)
    sd = torch_ref_codec.reference_codec_state_dict(cfg, seed=2)
    ref = jcc.convert_codec_state_dict(sd, jcfg)
    got = pcc.convert_codec_state_dict(sd, cfg)
    ref_flat = dict(jax.tree_util.tree_leaves_with_path(ref))
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(jax.tree_util.keystr, got_flat)) == sorted(
        map(jax.tree_util.keystr, ref_flat))
    by_key = {jax.tree_util.keystr(k): v for k, v in got_flat.items()}
    for k, v in ref_flat.items():
        np.testing.assert_array_equal(by_key[jax.tree_util.keystr(k)],
                                      np.asarray(v))
    # the tree fills the port's module, every name and shape (strict), and
    # has JAX's init's structure (an AdaLN codec cannot run JAX's init: its
    # decode passes no class id)
    XYTokenizer(cfg, codec_state_from_jax(got, cfg), device="cpu")
    if cfg.vocos.adanorm_num_embeddings is None:
        init = JXY.init_random(jcfg, seed=0).params
        assert jax.tree_util.tree_structure(init) == \
            jax.tree_util.tree_structure(_np_tree(ref))


def _wav(seconds=1.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def _codec_pair_matches(jspt, spt, seed=0):
    wavs = [_wav(1.5, seed), _wav(0.9, seed + 1)]
    ref = jspt.encode(wavs)["codes_list"]
    got = spt.encode(wavs)["codes_list"]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    ref_w = jspt.decode(ref)["syn_wav_list"]
    got_w = spt.decode(got)["syn_wav_list"]
    for a, b in zip(got_w, ref_w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)
    return got


@pytest.mark.parametrize("variant", ["default", "resnet-symexp"])
def test_codec_ckpt_loads_like_jax(tmp_path, variant):
    """The reference yaml + ``{"generator": state dict}`` .ckpt through both
    packages' ``load_from_checkpoint``: identical codes, wavs within
    1e-4. (An AdaLN Vocos needs a class id at decode, which the codec's
    decode does not pass, in either package.)"""
    _, cfg = _codec_cfgs(variant)
    yaml_path, ckpt = torch_ref_codec.write_reference_codec(str(tmp_path),
                                                            cfg, seed=3)
    jspt = JXY.load_from_checkpoint(yaml_path, ckpt)
    spt = XYTokenizer.load_from_checkpoint(yaml_path, ckpt, device="cpu")
    assert spt.cfg == CodecConfig.from_yaml(yaml_path)
    assert spt.device.type == "cpu" and spt.cfg.dtype == "float32"
    codes = _codec_pair_matches(jspt, spt)
    assert len({tuple(c[0]) for c in codes}) > 1 or codes[0].std() > 0
    b16 = XYTokenizer.load_from_checkpoint(yaml_path, ckpt, dtype="bfloat16",
                                           device="cpu")
    assert b16.module.vocos.head.out.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ["stacked", "legacy"])
def test_native_npz_codec_loads_like_jax(files, tmp_path, layout):
    """A native ``.npz`` (the JAX tree), stacked or per-layer (pre-scan,
    restacked on load), through both packages' ``load_from_checkpoint``."""
    from moss_ttsd_torch.core.checkpoint import save_pytree
    jspt = JXY.load_from_checkpoint(files["yaml"], files["ckpt"])
    tree = _np_tree(jspt.params)
    if layout == "legacy":
        def unstack(t):
            if not isinstance(t, dict):
                return t
            out = {k: unstack(v) for k, v in t.items()}
            for group, inner, prefix in (("layers", "layer", "layer_"),
                                         ("blocks", "block", "block_")):
                sub = out.get(group)
                if isinstance(sub, dict) and set(sub) == {inner}:
                    n = jax.tree_util.tree_leaves(sub[inner])[0].shape[0]
                    del out[group]
                    for i in range(n):
                        out[f"{prefix}{i}"] = jax.tree_util.tree_map(
                            lambda x: x[i], sub[inner])
            return out
        tree = unstack(tree)
        assert pcc.restack_legacy_pytree(tree).keys() == _np_tree(
            jspt.params).keys()
    npz = str(tmp_path / "codec.npz")
    save_pytree(npz, tree)
    spt = XYTokenizer.load_from_checkpoint(files["yaml"], npz, device="cpu")
    _codec_pair_matches(JXY.load_from_checkpoint(files["yaml"], npz), spt, 4)


# -- the entry points ----------------------------------------------------------

def _items(name="examples_only_text.jsonl"):
    return [json.loads(l) for l in (ROOT / "examples" / name).read_text()
            .splitlines() if l.strip()]


def _spy_generate(monkeypatch, cls):
    """Record every GenerateResult of ``cls.generate``."""
    seen = []
    orig = cls.generate

    def generate(self, *a, **kw):
        seen.append(orig(self, *a, **kw))
        return seen[-1]

    monkeypatch.setattr(cls, "generate", generate)
    return seen


def _read_wav(path):
    from moss_ttsd_torch.utils.audio_io import read_wav
    wav, sr = read_wav(str(path))
    return np.asarray(wav, np.float32).reshape(-1), sr


def _lora_npz(files, path):
    """A finetune-CLI lora_factors.npz for the files' LM (JAX layout)."""
    from moss_ttsd_torch.core.checkpoint import save_pytree
    jcfg = files["jcfg"]
    rng = np.random.default_rng(9)
    L, H, r = jcfg.num_hidden_layers, jcfg.hidden_size, 4
    block = {t: {"lora_a": rng.standard_normal((L, H, r)).astype(np.float32)
                 * 0.3,
                 "lora_b": rng.standard_normal((L, r, H)).astype(np.float32)
                 * 0.3}
             for t in ("q_proj", "o_proj")}
    save_pytree(path, {"params": {"layers": {"block": block}}})
    return path


@pytest.mark.parametrize("extra", [
    [], ["--quant", "int8"], ["--quant", "int8", "--restricted_text_head"],
    ["--lora_adapter", "LORA"]], ids=["fp32", "int8", "int8-restricted",
                                      "lora-voice"])
def test_inference_cli_loads_checkpoint_like_jax(files, tmp_path,
                                                 monkeypatch, mock_tokenizers,
                                                 extra):
    """The inference CLI with --model_path / --spt_config / --spt_ckpt (fp32
    codec) against JAX's ``TTSPipeline.load`` on the same files: greedy
    tokens identical, every wav within 1e-4 + one int16 step."""
    from moss_ttsd_tpu.utils.convert_lora import parse_adapter_specs
    from moss_ttsd_torch.cli.inference import main
    items = _items()
    jsonl = tmp_path / "items.jsonl"
    if "LORA" in extra:
        npz = _lora_npz(files, str(tmp_path / "lora_factors.npz"))
        extra = ["--lora_adapter", f"voice1={npz}"]
        items[0]["voice"] = "voice1"
    jsonl.write_text("".join(json.dumps(it) + "\n" for it in items))
    seen = _spy_generate(monkeypatch, GenerationEngine)
    out = tmp_path / "out"
    assert main(["--jsonl", str(jsonl), "--model_path", files["lm"],
                 "--spt_config", files["yaml"], "--spt_ckpt", files["ckpt"],
                 "--dtype", "fp32", "--platform", "cpu", "--max_new_tokens",
                 "20", "--output_dir", str(out), *extra]) == 0

    jpipe = JPipeline.load(files["lm"], files["yaml"], files["ckpt"],
                           quant="int8" if "int8" in extra else None,
                           codec_dtype=None,
                           restricted_text_head=(
                               "--restricted_text_head" in extra) or None)
    jpipe.engine.cache_dtype = jnp.float32
    adapter = None
    if "voice" in items[0]:
        for name, (tree, alpha, rslora) in parse_adapter_specs(
                extra[1:2], 32.0).items():
            jpipe.engine.register_adapter(name, tree, alpha=alpha,
                                          use_rslora=rslora)
        adapter = [it.get("voice") for it in items]
    js = []
    orig = jpipe.engine.generate
    jpipe.engine.generate = lambda *a, **k: js.append(orig(*a, **k)) or js[-1]
    _, audio = jpipe.process_batch(items, max_new_tokens=20, adapter=adapter)
    assert seen[-1].steps == js[-1].steps
    np.testing.assert_array_equal(seen[-1].tokens, np.asarray(js[-1].tokens))
    for i, res in enumerate(audio):
        assert res is not None
        wav, sr = _read_wav(out / f"output_{i}.wav")
        ref = np.clip(np.asarray(res["audio_data"]).reshape(-1), -1, 1)
        assert sr == res["sample_rate"] and wav.shape == ref.shape
        np.testing.assert_allclose(wav, ref, atol=ATOL + LSB)


@pytest.mark.parametrize("scheduler", [
    [], ["--scheduler", "continuous", "--pool_base", "192",
         "--pool_max_steps", "32"]], ids=["window", "continuous"])
def test_server_main_serves_a_loaded_checkpoint(files, monkeypatch,
                                                mock_tokenizers, scheduler):
    """``serve/server.py main`` with --model_path, on either scheduler,
    answers one request with the wav of JAX's ``TTSPipeline.load`` +
    ``process_batch`` on the same files (the server's codec in bf16, as
    JAX's default)."""
    from moss_ttsd_torch.serve import server as srv
    from moss_ttsd_torch.serve.api_client import wav_bytes_to_array
    started, replies = [], []
    orig_start = srv.SpeechServer.start

    def start(self):
        orig_start(self)
        started.append(self)

    test_thread = threading.get_ident()

    class OneRequest(threading.Event):
        """main's wait (in this thread): one request, then a ^C; every
        other thread's events as they are."""
        def wait(self, timeout=None):
            if threading.get_ident() != test_thread:
                return super().wait(timeout)
            url = f"http://127.0.0.1:{started[0].port}/v1/audio/speech"
            body = json.dumps({"input": "[S1]hello there[S2]hi", "seed": 0,
                               "max_tokens": 16}).encode()
            req = urllib.request.Request(
                url, body, {"Content-Type": "application/json"})
            replies.append(urllib.request.urlopen(req, timeout=300).read())
            raise KeyboardInterrupt

    monkeypatch.setattr(srv.SpeechServer, "start", start)
    monkeypatch.setattr(srv, "threading", types.SimpleNamespace(
        **{**vars(threading), "Event": OneRequest}))
    assert srv.main(["--model_path", files["lm"], "--spt_config",
                     files["yaml"], "--spt_ckpt", files["ckpt"], "--platform",
                     "cpu", "--host", "127.0.0.1", "--port", "0",
                     *scheduler]) == 0
    assert started[0].worker.pipeline.device.type == "cpu"
    wav, sr = wav_bytes_to_array(replies[0])

    jpipe = JPipeline.load(files["lm"], files["yaml"], files["ckpt"])
    jpipe.engine.cache_dtype = jnp.float32
    _, audio = jpipe.process_batch([{"text": "[S1]hello there[S2]hi"}],
                                   max_new_tokens=16, seed=0)
    ref = np.clip(np.asarray(audio[0]["audio_data"]).reshape(-1), -1, 1)
    assert sr == audio[0]["sample_rate"] and wav.shape == ref.shape
    # bf16 codecs in two frameworks: the codec's bf16 contract (3 %
    # relative RMS, tests/test_codec_bf16.py) rather than fp32's 1e-4
    rel = np.linalg.norm(wav - ref) / (np.linalg.norm(ref) + 1e-9)
    assert rel < 0.03, rel


def test_codec_roundtrip_cli_loads_checkpoint_like_jax(files, tmp_path):
    """``codec_roundtrip --config --checkpoint`` (fp32) writes the
    reconstructions JAX's CLI writes from the same files, within 1e-4 +
    one int16 step."""
    from moss_ttsd_tpu.cli.codec_roundtrip import main as jmain
    from moss_ttsd_torch.cli.codec_roundtrip import main
    inp = tmp_path / "in"
    inp.mkdir()
    (inp / "voice_s1.wav").write_bytes(
        (ROOT / "examples" / "voice_s1.wav").read_bytes())
    args = ["--input_dir", str(inp), "--config", files["yaml"],
            "--checkpoint", files["ckpt"], "--platform", "cpu"]
    assert main([*args, "--output_dir", str(tmp_path / "ours")]) == 0
    assert jmain([*args, "--output_dir", str(tmp_path / "jax")]) == 0
    got, sr = _read_wav(tmp_path / "ours" / "voice_s1_recon.wav")
    ref, jsr = _read_wav(tmp_path / "jax" / "voice_s1_recon.wav")
    assert sr == jsr == 24000 and got.shape == ref.shape and got.size
    np.testing.assert_allclose(got, ref, atol=ATOL + LSB)


def _records(path, n=2, T=20):
    """``n`` records of one length in process_data's layout, for the tiny
    pipeline LM (speech pad 64, channel-0 ids in its vocab)."""
    rng = np.random.default_rng(12)
    flat = {}
    for i in range(n):
        ids = rng.integers(0, 64, (T, 8))
        ids[:, 0] = rng.integers(1, 290, T)
        labels = ids.copy()
        labels[: T // 2] = -100
        flat[f"input_ids_{i}"], flat[f"labels_{i}"] = ids, labels
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "processed_data_00000.npz"), **flat)
    return str(path)


def test_finetune_cli_loads_checkpoint_like_jax(files, tmp_path,
                                                mock_tokenizers):
    """``finetune --model_path`` (2 steps, fp32, the whole dataset in one
    batch) logs as its first loss JAX's train step's loss on the JAX
    loader's params and the same batch (rel 1e-5)."""
    from moss_ttsd_tpu.train import data as jdata
    from moss_ttsd_tpu.train import step as jstep
    from moss_ttsd_torch.cli.finetune import main
    data = _records(tmp_path / "data")
    tc = tmp_path / "tc.yaml"
    tc.write_text("per_device_train_batch_size: 2\nlogging_steps: 1\n"
                  "bf16: false\nreport_to: none\nmax_length: 64\n"
                  "dataloader_num_workers: 0\n")
    out = tmp_path / "out"
    assert main(["--model_path", files["lm"], "--data_dir", data,
                 "--output_dir", str(out), "--training_config", str(tc),
                 "--platform", "cpu", "--max_steps", "2"]) == 0
    log = [json.loads(l) for l in (out / "train_log.jsonl").read_text()
           .splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    assert os.path.isfile(out / "model.npz")

    jcfg = JLMConfig.from_hf_config_json(os.path.join(files["lm"],
                                                      "config.json"))
    params = jconv.load_asteroid_checkpoint(files["lm"], jcfg)
    ds = jdata.TrainingDataset(data, jcfg.channels, 0, jcfg.speech_pad_token)
    batch = jdata.collate([ds[i] for i in range(len(ds))], 0, max_length=64,
                          pad_token=jcfg.speech_pad_token, pad_to_multiple=64)
    opt = jstep.make_optimizer(learning_rate=1e-4, total_steps=2)
    state = jstep.init_train_state(jcfg, opt, params=params)
    _, m = jstep.make_train_step(jcfg, opt)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(log[0]["loss"], float(m["loss"]), rtol=1e-5)


def test_finetune_workflow_real_flags_match_jax_process_data(
        files, tmp_path, mock_tokenizers):
    """The workflow with ``model_path`` / ``spt_config`` /
    ``spt_checkpoint``: the records it writes (speech offset 151665, the
    fp32 codec loaded from the .ckpt) equal JAX's ``process_data`` on the
    same files, and one LoRA step trains on them (a tiny LM with the
    reference's token space)."""
    from moss_ttsd_tpu.train.data import process_data as jprocess
    from moss_ttsd_torch.cli.finetune_workflow import main
    from tests.test_torch_train_data import voice_training_jsonl
    jcfg, params = jax_tiny(11, pad_token_id=0, vocab_size=152704,
                            speech_vocab_size=1025, speech_pad_token=1024,
                            speech_token_range=(151665, 152689),
                            eos_token_id=152694)
    lm_dir = str(tmp_path / "lm_big_vocab")
    jconv.save_asteroid_checkpoint(params, jcfg, lm_dir)
    jsonl = voice_training_jsonl(tmp_path / "train.jsonl")
    wf = tmp_path / "wf.yaml"
    wf.write_text(f"""data_preprocess:
  jsonl: {jsonl}
  model_path: {lm_dir}
  spt_config: {files['yaml']}
  spt_checkpoint: {files['ckpt']}
  output_dir: {tmp_path / 'processed'}
  use_normalize: true
finetune:
  model_path: {lm_dir}
  output_dir: {tmp_path / 'ft_out'}
  lora: true
  max_steps: 1
""")
    assert main(["--config", str(wf), "--platform", "cpu"]) == 0
    assert os.path.isfile(tmp_path / "ft_out" / "lora_factors.npz")
    jprocess(jsonl, JTok(), JXY.load_from_checkpoint(files["yaml"],
                                                     files["ckpt"]),
             str(tmp_path / "jax_processed"), use_normalize=True,
             speech_offset=151665)
    ours = np.load(tmp_path / "processed" / "processed_data_00000.npz")
    ref = np.load(tmp_path / "jax_processed" / "processed_data_00000.npz")
    assert sorted(ours.files) == sorted(ref.files) and ours.files
    for k in ref.files:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert int(ours["input_ids_0"][:, 0].max()) >= 151665


def test_load_tokenizer_names_missing_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        pbatch.load_tokenizer("some/dir")


def test_transformers_only_inside_load_tokenizer():
    """Nothing of the port imports ``transformers`` at module level; the
    one import is in ``load_tokenizer``."""
    hits = []
    for path in (ROOT / "moss_ttsd_torch").rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "import" in line and "transformers" in line:
                hits.append((path.relative_to(ROOT).as_posix(), i))
    assert [h[0] for h in hits] == ["moss_ttsd_torch/pipeline/batch.py"]
    text = (ROOT / "moss_ttsd_torch/pipeline/batch.py").read_text()
    body = text.split("def load_tokenizer")[1].split("\ndef ")[0]
    assert "from transformers import AutoTokenizer" in body

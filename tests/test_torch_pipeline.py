"""The port's TTSPipeline against the JAX TTSPipeline on the same weights
(tiny LM + codec, fp32, greedy, CPU): over examples/examples_only_text.jsonl
and over a voice-cloning batch (examples.jsonl, examples_single_reference
.jsonl and a text-only item), identical prompt ids and codes, wavs within
one int16 step; the prompt-encode LRU; an item whose prompt wav is missing
becomes an error entry and the rest of the batch still generates; both
CLIs on the CPU."""
import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY  # noqa: E402
from moss_ttsd_tpu.pipeline.batch import TTSPipeline as JPipeline  # noqa: E402
from moss_ttsd_tpu.utils.mock_tokenizer import MockTokenizer as JTok  # noqa: E402
from moss_ttsd_torch.core.config import CodecConfig  # noqa: E402
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.pipeline.batch import TTSPipeline  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import codec_state_from_jax  # noqa: E402
from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer  # noqa: E402
from tests.test_torch_engine import JAX_S, TORCH_S, greedy  # noqa: E402
from tests.test_torch_lm import jax_tiny, port_model  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LSB = 1.0 / 32768


def _spy(engine, inputs=None):
    """Record every GenerateResult of ``engine.generate`` (and, into
    ``inputs``, its prompt ids)."""
    seen = []
    orig = engine.generate

    def generate(*a, **kw):
        if inputs is not None:
            inputs.append(np.asarray(a[0]))
        seen.append(orig(*a, **kw))
        return seen[-1]

    engine.generate = generate
    return seen


def _items(*names):
    return [json.loads(l) for n in names
            for l in (ROOT / "examples" / n).read_text().splitlines()
            if l.strip()]


@pytest.fixture(scope="module")
def pipes():
    jcfg, params = jax_tiny(
        0, vocab_size=300, speech_vocab_size=65, speech_pad_token=64,
        speech_token_range=(0, 290), eos_token_id=290, pad_token_id=0)
    jspt = JXY.init_random(JCodecConfig().tiny(), seed=0)
    jpipe = JPipeline(JTok(), jcfg, params, jspt, greedy(JAX_S), bucket=32)
    jpipe.engine.cache_dtype = jnp.float32
    cfg, model = port_model(jcfg, params)
    ccfg = CodecConfig().tiny()
    spt = XYTokenizer(ccfg, codec_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jspt.params), ccfg), device="cpu")
    pipe = TTSPipeline(MockTokenizer(), cfg, model, spt, greedy(TORCH_S),
                       bucket=32, device="cpu")
    return jpipe, pipe


def test_process_batch_matches_jax(pipes):
    jpipe, pipe = pipes
    items = [json.loads(l) for l in
             (ROOT / "examples" / "examples_only_text.jsonl").read_text()
             .splitlines() if l.strip()]
    js, ps = _spy(jpipe.engine), _spy(pipe.engine)
    jt, ja = jpipe.process_batch(items, max_new_tokens=20)
    pt, pa = pipe.process_batch(items, max_new_tokens=20, use_normalize=False)
    np.testing.assert_array_equal(ps[-1].tokens, js[-1].tokens)
    assert ps[-1].steps == js[-1].steps
    for a, b in zip(pipe.extract_codes(ps[-1]), jpipe.extract_codes(js[-1])):
        np.testing.assert_array_equal(a, b)
    assert [t["final_text"] for t in pt] == [t["final_text"] for t in jt]
    assert sum(r is not None for r in pa) == 2
    for a, b in zip(pa, ja):
        assert a["sample_rate"] == b["sample_rate"] and a["index"] == b["index"]
        assert a["audio_data"].shape == b["audio_data"].shape
        np.testing.assert_allclose(a["audio_data"], b["audio_data"],
                                   atol=LSB * 1.01)


def test_voice_clone_batch_matches_jax(pipes):
    """Both voice formats and a text-only item in one batch: one batched
    codec encode of the two prompt voices, then greedy decode."""
    jpipe, pipe = pipes
    items = _items("examples.jsonl", "examples_single_reference.jsonl")
    items.append({"text": "[S1]no voice here[S2]none at all"})
    jin, pin = [], []
    js, ps = _spy(jpipe.engine, jin), _spy(pipe.engine, pin)
    jt, ja = jpipe.process_batch(items, max_new_tokens=20)
    pt, pa = pipe.process_batch(items, max_new_tokens=20)
    np.testing.assert_array_equal(pin[-1], jin[-1])
    np.testing.assert_array_equal(ps[-1].tokens, js[-1].tokens)
    assert ps[-1].steps == js[-1].steps
    assert [t["final_text"] for t in pt] == [t["final_text"] for t in jt]
    assert pipe.timings.tokenize_s > 0
    assert all(r is not None for r in pa)
    for a, b in zip(pa, ja):
        assert a["index"] == b["index"]
        assert a["audio_data"].shape == b["audio_data"].shape
        np.testing.assert_allclose(a["audio_data"], b["audio_data"],
                                   atol=LSB * 1.01)


def test_single_voice_batch_uses_the_encode_lru(pipes, monkeypatch):
    """A repeated single-voice batch takes its codes from the LRU: no second
    codec encode, the same prompt ids."""
    _, pipe = pipes
    pipe._encode_cache.clear()
    calls = []
    orig = pipe.spt.encode
    monkeypatch.setattr(pipe.spt, "encode",
                        lambda wavs, *a, **kw: calls.append(len(wavs))
                        or orig(wavs, *a, **kw))
    items = _items("examples_single_reference.jsonl")
    ids = []
    _spy(pipe.engine, ids)
    for _ in range(2):
        pipe.process_batch(items, max_new_tokens=8)
    assert calls == [1]
    np.testing.assert_array_equal(ids[0], ids[1])
    assert len(pipe._encode_cache) == 1
    # the per-request path shares the cache: no encode, the same prompt
    shifted, meta = pipe.prepare_item(items[0])
    assert calls == [1] and "error" not in meta
    np.testing.assert_array_equal(shifted, ids[0][0])


def test_prompt_audio_item_is_isolated(pipes):
    """An item whose prompt wav does not exist becomes an error entry that
    names the path; the other items, voiced or not, still produce audio."""
    _, pipe = pipes
    missing = str(ROOT / "examples" / "no_such_voice.wav")
    items = [{"text": "[S1]good item[S2]fine"},
             {"text": "[S1]cloned", "prompt_audio": missing,
              "prompt_text": "[S1]hi"},
             *_items("examples_single_reference.jsonl"),
             {"text": "[S1]also good[S2]yes"}]
    texts, audio = pipe.process_batch(items, max_new_tokens=8)
    assert "error" in texts[1] and "no_such_voice.wav" in texts[1]["error"]
    assert audio[1] is None
    assert all(audio[i] is not None for i in (0, 2, 3))
    assert [t["index"] for t in texts] == [0, 1, 2, 3]


def test_cli_voice_clone_tiny_cpu_writes_a_wav(tmp_path):
    from moss_ttsd_torch.cli.inference import main
    rc = main(["--jsonl", str(ROOT / "examples" / "examples.jsonl"),
               "--tiny", "--platform", "cpu", "--max_new_tokens", "16",
               "--output_dir", str(tmp_path)])
    assert rc == 0
    assert [p.name for p in tmp_path.glob("*.wav")] == ["output_0.wav"]


def test_cli_codec_roundtrip_tiny_cpu(tmp_path):
    from moss_ttsd_torch.cli.codec_roundtrip import main
    out = tmp_path / "recon"
    rc = main(["--input_dir", str(ROOT / "examples"), "--output_dir",
               str(out), "--tiny", "--platform", "cpu", "--metrics",
               str(tmp_path / "metrics.json")])
    assert rc == 0
    assert sorted(p.name for p in out.glob("*.wav")) == [
        "voice_both_recon.wav", "voice_s1_recon.wav", "voice_s2_recon.wav"]
    summary = json.loads((tmp_path / "metrics.json").read_text())
    assert len(summary["files"]) == 3
    assert all(np.isfinite(m["mel_l1"]) and np.isfinite(m["si_snr_db"])
               for m in summary["files"])


def test_cli_attn_impl_xla_codes_equal_jax_cli(tmp_path, monkeypatch):
    """Both inference CLIs with ``--attn_impl xla --tiny --platform cpu``,
    each package's ``build_tiny_pipeline`` swapped for the ``pipes`` fixture's
    weights under greedy sampling (the two CLIs' own tiny models are
    random draws of two frameworks): the flag reaches both engines, their
    tokens and codes are identical, and both write the same wavs."""
    from moss_ttsd_tpu.cli import inference as jinf
    from moss_ttsd_torch.cli import inference as pinf
    jcfg, params = jax_tiny(
        0, vocab_size=300, speech_vocab_size=65, speech_pad_token=64,
        speech_token_range=(0, 290), eos_token_id=290, pad_token_id=0)
    jspt = JXY.init_random(JCodecConfig().tiny(), seed=0)
    ccfg = CodecConfig().tiny()
    built = {}

    def jbuild(seed=0, mesh=None, restricted_text_head=False,
               attn_impl=None):
        p = JPipeline(JTok(), jcfg, params, jspt, greedy(JAX_S), bucket=32,
                      attn_impl=attn_impl)
        p.engine.cache_dtype = jnp.float32
        built["jax"] = (p, _spy(p.engine))
        return p

    def pbuild(seed=0, device="cuda", quant=None, restricted_text_head=False,
               restricted_audit_every=None, mesh=None, attn_impl=None):
        cfg, model = port_model(jcfg, params)
        spt = XYTokenizer(ccfg, codec_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jspt.params), ccfg),
            device=device)
        p = TTSPipeline(MockTokenizer(), cfg, model, spt, greedy(TORCH_S),
                        bucket=32, device=device, attn_impl=attn_impl)
        built["torch"] = (p, _spy(p.engine))
        return p

    monkeypatch.setattr(jinf, "build_tiny_pipeline", jbuild)
    monkeypatch.setattr(pinf, "build_tiny_pipeline", pbuild)
    # JAX's --platform cpu appends to XLA_FLAGS: restored after the test
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    argv = ["--jsonl", str(ROOT / "examples" / "examples_only_text.jsonl"),
            "--tiny", "--platform", "cpu", "--max_new_tokens", "20",
            "--attn_impl", "xla"]
    jinf.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert pinf.main(argv + ["--output_dir", str(tmp_path / "torch")]) == 0
    (jpipe, js), (pipe, ps) = built["jax"], built["torch"]
    assert jpipe.engine.cfg.attn_impl == pipe.engine.cfg.attn_impl == "xla"
    assert ps[-1].steps == js[-1].steps > 8
    np.testing.assert_array_equal(ps[-1].tokens, np.asarray(js[-1].tokens))
    for a, b in zip(pipe.extract_codes(ps[-1]), jpipe.extract_codes(js[-1])):
        np.testing.assert_array_equal(a, b)
    names = sorted(p.name for p in (tmp_path / "torch").glob("*.wav"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.wav"))
    assert len(names) == 2

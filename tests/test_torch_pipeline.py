"""The port's TTSPipeline against the JAX TTSPipeline on the same weights
(tiny LM + codec, fp32, greedy, CPU) over examples/examples_only_text.jsonl:
identical codes, wavs within one int16 step; a prompt-audio item becomes
an error entry and the rest of the batch still generates."""
import json
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


def _spy(engine):
    seen = []
    orig = engine.generate

    def generate(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    engine.generate = generate
    return seen


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


def test_prompt_audio_item_is_isolated(pipes):
    _, pipe = pipes
    items = [{"text": "[S1]good item[S2]fine"},
             {"text": "[S1]cloned", "prompt_audio": "voice.wav",
              "prompt_text": "[S1]hi"},
             {"text": "[S1]also good[S2]yes"}]
    texts, audio = pipe.process_batch(items, max_new_tokens=8)
    assert "error" in texts[1] and "not yet ported" in texts[1]["error"]
    assert audio[1] is None
    assert audio[0] is not None and audio[2] is not None
    assert [t["index"] for t in texts] == [0, 1, 2]

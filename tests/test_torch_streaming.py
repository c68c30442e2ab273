"""The port's streaming against the JAX package on the same weights (tiny
config, fp32, CPU): ``GenerationEngine.generate_stream`` gives exactly the
tokens of the port's ``generate`` (greedy and sampled, same seed) and, with
greedy sampling at the same boundaries, the JAX ``generate_stream``'s
tokens, steps and finish flags segment by segment; ``GenerateResult`` has
JAX's fields in JAX's order; ``StreamVocoder``'s context guard and
``effective_context`` equal JAX's; ``TTSPipeline.stream_item`` emits the
serial wav's length and, concatenated, JAX ``stream_item``'s PCM within
1e-4 (the codec's stated gap)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.decode import engine as jeng  # noqa: E402
from moss_ttsd_tpu.pipeline.batch import StreamVocoder as JStreamVocoder  # noqa: E402
from moss_ttsd_torch.core.config import (ChannelSamplingConfig,  # noqa: E402
                                         CodecConfig, SamplingConfig)
from moss_ttsd_torch.decode.engine import (GenerateResult,  # noqa: E402
                                           GenerationEngine)
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.pipeline.batch import StreamVocoder  # noqa: E402
from tests.test_torch_engine import JAX_S, SAMPLED, TORCH_S, _batch, greedy  # noqa: E402
from tests.test_torch_lm import jax_tiny, port_model  # noqa: E402
from tests.test_torch_pipeline import pipes  # noqa: E402,F401

PCM_TOL = 1e-4        # the codec's stated fp32 gap (int16 steps are 3.1e-5)
ITEM = {"text": "[S1]hello world[S2]general kenobi"}


@pytest.fixture(scope="module")
def models():
    jcfg, params = jax_tiny(7)
    cfg, model = port_model(jcfg, params)
    return jcfg, params, cfg, model


def _eos_cfgs(jcfg, cfg, speech=(100, 104)):
    """A speech range that excludes most of the vocab: greedy rows hit the
    EOS flush and finish at different steps; (0, vocab) keeps them
    decoding."""
    return (dataclasses.replace(jcfg, speech_token_range=speech),
            dataclasses.replace(cfg, speech_token_range=speech))


def test_generate_result_fields_match_jax():
    assert GenerateResult._fields == jeng.GenerateResult._fields
    vals = (np.zeros((1, 3, 8)), 2, 1, np.array([True]), (4, 1))
    ours, theirs = GenerateResult(*vals), jeng.GenerateResult(*vals)
    for i, name in enumerate(GenerateResult._fields):
        assert ours[i] is theirs[i] is getattr(ours, name)
    assert GenerateResult(*vals[:3]).unfinished is None


@pytest.mark.parametrize("sampled", [False, True])
def test_stream_tokens_equal_generate(models, sampled):
    """One prefill, one decode state and one generator across segments:
    the streamed tokens are generate's, greedy and sampled."""
    _, _, cfg, model = models
    sampling = (SamplingConfig(channels=[ChannelSamplingConfig(**SAMPLED[0])
                                         for _ in range(8)], max_new_tokens=16)
                if sampled else greedy(TORCH_S, 16))
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    batch, mask = _batch(models[0], 3, [(6, 4), (9, 2)])
    full = eng.generate(batch, mask, 16, seed=5)
    results = list(eng.generate_stream(batch, mask, 16, seed=5,
                                       chunk_steps=5))
    assert len(results) >= 2 and full.unfinished is None
    assert [r.steps for r in results[:-1]] == [5 * (i + 1) for i in
                                               range(len(results) - 1)]
    assert results[-1].steps == full.steps
    np.testing.assert_array_equal(results[-1].tokens, full.tokens)
    for r in results:       # every result is a prefix of the whole run
        np.testing.assert_array_equal(r.tokens, full.tokens[:, :r.base
                                                            + r.steps])


@pytest.mark.parametrize("eos", [False, True])
def test_stream_matches_jax_stream_greedy(models, eos):
    """Greedy at the same absolute boundaries (one outside (0, max_steps),
    unsorted): tokens, steps and unfinished equal JAX's per segment; with
    the EOS flush the rows finish apart and the stream stops early."""
    jcfg, params, cfg, model = models
    jcfg, cfg = _eos_cfgs(jcfg, cfg, (100, 104) if eos
                          else (0, jcfg.vocab_size))
    batch, mask = _batch(jcfg, 1, [(5, 3), (7, 2)])
    bounds = [11, 3, 40, 7]
    jres = list(jeng.GenerationEngine(
        jcfg, params, greedy(JAX_S), bucket=32, cache_dtype=jnp.float32
    ).generate_stream(batch, mask, 24, boundaries=bounds))
    model.cfg = cfg
    try:
        pres = list(GenerationEngine(cfg, model, greedy(TORCH_S), bucket=32,
                                     device="cpu").generate_stream(
            batch, mask, 24, boundaries=bounds))
    finally:
        model.cfg = models[2]
    assert len(pres) == len(jres)
    for p, j in zip(pres, jres):
        assert (p.steps, p.base) == (j.steps, j.base)
        np.testing.assert_array_equal(p.unfinished, j.unfinished)
        np.testing.assert_array_equal(p.tokens, j.tokens)
    if eos:
        assert pres[-1].steps < 24 and not pres[-1].unfinished.any()
        assert pres[0].unfinished.all()
    else:
        assert [p.steps for p in pres] == [3, 7, 11, 24]


def test_stream_early_stop_matches_generate(models):
    """All rows finishing inside a segment ends the stream there."""
    _, _, cfg, model = models
    cfg2 = _eos_cfgs(models[0], cfg)[1]
    model.cfg = cfg2
    try:
        eng = GenerationEngine(cfg2, model, greedy(TORCH_S), bucket=32,
                               device="cpu")
        batch, mask = _batch(models[0], 1, [(5, 3)])
        results = list(eng.generate_stream(batch, mask, 64, chunk_steps=8))
        full = eng.generate(batch, mask, 64)
    finally:
        model.cfg = cfg
    assert results[-1].steps == full.steps < 64
    assert not results[-1].unfinished.any()
    assert len(results) == -(-full.steps // 8)
    np.testing.assert_array_equal(results[-1].tokens, full.tokens)


def test_stream_zero_step_budget(models):
    """A prompt already at max_length: one prompt-only result, no row
    unfinished, as JAX yields."""
    jcfg, params, cfg, model = models
    batch, mask = _batch(jcfg, 0, [(6, 4), (9, 2)])
    pres = list(GenerationEngine(cfg, model, greedy(TORCH_S, 20, 5),
                                 bucket=32, device="cpu"
                                 ).generate_stream(batch, mask))
    jres = list(jeng.GenerationEngine(jcfg, params, greedy(JAX_S, 20, 5),
                                      bucket=32, cache_dtype=jnp.float32
                                      ).generate_stream(batch, mask))
    assert len(pres) == len(jres) == 1
    assert pres[0].steps == jres[0].steps == 0
    np.testing.assert_array_equal(pres[0].unfinished, [False, False])
    np.testing.assert_array_equal(pres[0].tokens, jres[0].tokens)


def test_adapter_is_refused(models):
    """With no LoRA adapter registered, a named adapter raises (as the JAX
    engine does) instead of decoding with the base model."""
    _, _, cfg, model = models
    eng = GenerationEngine(cfg, model, greedy(TORCH_S), bucket=32,
                           device="cpu")
    batch, mask = _batch(models[0], 0, [(6, 4)])
    with pytest.raises(ValueError, match="unknown adapter 'narrator'"):
        eng.generate(batch, mask, 4, adapter="narrator")
    with pytest.raises(ValueError, match="none registered"):
        next(eng.generate_stream(batch, mask, 4, adapter=["narrator"]))
    assert eng.generate(batch, mask, 4, adapter=None).steps == 4


def test_stream_vocoder_context_guard():
    """context_frames >= the codec window can never advance the sliding
    window (finish() would loop forever): the constructor refuses."""
    spt = XYTokenizer.init_random(CodecConfig().tiny(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="context_frames"):
        StreamVocoder(spt, context_frames=spt.chunk_codes)
    with pytest.raises(ValueError, match="context_frames"):
        StreamVocoder(spt, context_frames=-1)
    sv = StreamVocoder(spt, context_frames=spt.chunk_codes - 1)
    assert sv.context == spt.chunk_codes - 1


@pytest.mark.parametrize("chunk_seconds", [30, 4])
def test_effective_context_matches_jax(chunk_seconds):
    """Both clamp on the codec's window stride; the stride reads only the
    window, the input rate and the downsample rate."""
    from types import SimpleNamespace
    cc = CodecConfig()
    spt = SimpleNamespace(chunk_seconds=chunk_seconds,
                          input_sample_rate=cc.input_sample_rate,
                          encoder_downsample_rate=cc.encoder_downsample_rate)
    for overlap in range(chunk_seconds):
        for feed in (0, 1, 12, 25, 49, 50, 250, 1000):
            for ctx in (0, 7, 25):
                assert StreamVocoder.effective_context(
                    spt, overlap, feed, ctx) == \
                    JStreamVocoder.effective_context(spt, overlap, feed, ctx)


def test_stream_item_matches_jax_and_serial_length(pipes):
    """Greedy stream_item on the same weights: the concatenated PCM within
    1e-4 of JAX's, chunk by chunk the same lengths, the total equal to the
    serial process_batch wav's length."""
    jpipe, pipe = pipes
    kw = dict(max_new_tokens=14, chunk_steps=4, first_chunk_steps=3)
    ours = [c for c, sr in pipe.stream_item(ITEM, **kw)]
    theirs = [c for c, sr in jpipe.stream_item(ITEM, **kw)]
    assert len(ours) >= 2
    assert [len(c) for c in ours] == [len(c) for c in theirs]
    assert all(c.dtype == np.float32 and np.isfinite(c).all() for c in ours)
    a, b = np.concatenate(ours), np.concatenate(theirs)
    assert float(np.abs(a - b).max()) < PCM_TOL
    _, audio = pipe.process_batch([ITEM], max_new_tokens=14)
    assert len(a) == audio[0]["audio_data"].shape[-1]


def test_stream_item_oversized_chunk_steps(pipes):
    """chunk_steps larger than one codec window: each dispatch caps at one
    window and the rest drains, so the total sample count holds."""
    _, base = pipes
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    spt = XYTokenizer(base.spt.cfg, base.spt.module, chunk_seconds=2,
                      device="cpu")
    pipe = TTSPipeline(base.tokenizer, base.lm_cfg, base.engine.model, spt,
                       base.engine.sampling, bucket=32, device="cpu")
    steps = 2 * spt.chunk_codes + 3
    chunks = [c for c, sr in pipe.stream_item(
        ITEM, max_new_tokens=steps, chunk_steps=10 * spt.chunk_codes,
        first_chunk_steps=10 * spt.chunk_codes)]
    assert chunks, "stream produced no audio"
    _, audio = pipe.process_batch([ITEM], max_new_tokens=steps)
    assert sum(len(c) for c in chunks) == audio[0]["audio_data"].shape[-1]

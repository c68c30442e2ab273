"""The port's GenerationEngine against the JAX engine on the same weights
(tiny config, fp32, CPU): greedy tokens equal exactly; for a sampled
config the pre-draw contract (processed_logits + the TF/pad/EOS masks)
matches, since torch and JAX draw different random bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core.config import (ChannelSamplingConfig as JCh,  # noqa: E402
                                       SamplingConfig as JSampling)
from moss_ttsd_tpu.decode import engine as jeng  # noqa: E402
from moss_ttsd_tpu.ops import sampling as jsam  # noqa: E402
from moss_ttsd_tpu.pipeline.prompt import left_pad_batch  # noqa: E402
from moss_ttsd_torch.core.config import (ChannelSamplingConfig,  # noqa: E402
                                         SamplingConfig)
from moss_ttsd_torch.decode.engine import GenerationEngine, channel_logits  # noqa: E402
from moss_ttsd_torch.ops import sampling as psam  # noqa: E402
from tests.test_decode import make_prompt  # noqa: E402
from tests.test_torch_lm import jax_tiny, port_model  # noqa: E402


def greedy(mod, n=24, max_length=None):
    return mod[1](channels=[mod[0](do_sample=False, temperature=None,
                                   top_k=None, top_p=None)
                            for _ in range(8)],
                  max_new_tokens=n, max_length=max_length)


JAX_S, TORCH_S = (JCh, JSampling), (ChannelSamplingConfig, SamplingConfig)


@pytest.fixture(scope="module")
def models():
    jcfg, params = jax_tiny(7)
    cfg, model = port_model(jcfg, params)
    return jcfg, params, cfg, model


def _batch(jcfg, seed, lens):
    rng = np.random.default_rng(seed)
    prompts = [make_prompt(jcfg, rng, t, a) for t, a in lens]
    return left_pad_batch(prompts, jcfg.pad_token_id, jcfg.speech_pad_token)


@pytest.mark.parametrize("max_new,max_length", [(20, None), (None, 30),
                                                (None, 5)])
def test_greedy_tokens_equal_jax(models, max_new, max_length):
    """Left-padded batch of 2; a max_new_tokens budget, a max_length budget
    and a prompt already past max_length (0 steps)."""
    jcfg, params, cfg, model = models
    batch, mask = _batch(jcfg, 0, [(6, 4), (9, 2)])
    r_j = jeng.GenerationEngine(jcfg, params, greedy(JAX_S, 20, max_length),
                                bucket=32, cache_dtype=jnp.float32
                                ).generate(batch, mask, max_new)
    r_t = GenerationEngine(cfg, model, greedy(TORCH_S, 20, max_length),
                           bucket=32, device="cpu").generate(batch, mask,
                                                             max_new)
    assert (r_t.steps, r_t.base) == (r_j.steps, r_j.base)
    if max_length == 5:
        assert r_t.steps == 0
    np.testing.assert_array_equal(r_t.tokens, r_j.tokens)


def test_greedy_eos_flush_matches_jax(models):
    """A speech range that excludes most of the vocab makes greedy rows hit
    the EOS flush: the staggered pad flush and finished-row fill match."""
    import dataclasses
    jcfg, params, cfg, model = models
    jcfg2 = dataclasses.replace(jcfg, speech_token_range=(100, 104))
    cfg2 = dataclasses.replace(cfg, speech_token_range=(100, 104))
    model.cfg = cfg2
    try:
        batch, mask = _batch(jcfg, 1, [(5, 3), (7, 2)])
        r_j = jeng.GenerationEngine(jcfg2, params, greedy(JAX_S), bucket=32,
                                    cache_dtype=jnp.float32
                                    ).generate(batch, mask, 24)
        r_t = GenerationEngine(cfg2, model, greedy(TORCH_S), bucket=32,
                               device="cpu").generate(batch, mask, 24)
    finally:
        model.cfg = cfg
    assert r_t.steps == r_j.steps < 24
    np.testing.assert_array_equal(r_t.tokens, r_j.tokens)


SAMPLED = [dict(do_sample=True, temperature=0.9, top_k=20, top_p=0.8,
                repetition_penalty=1.3),
           dict(do_sample=True, temperature=0.7, top_k=None, top_p=0.9,
                repetition_penalty=None)]


@pytest.mark.parametrize("ch", SAMPLED)
@pytest.mark.parametrize("exact", [False, True])
def test_processed_logits_match_jax(ch, exact):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 257)).astype(np.float32) * 3
    presence = rng.random((3, 257)) < 0.1
    jp = jsam.ChannelParams.from_config(JCh(**ch), exact_top_p=exact)
    pp_ = psam.ChannelParams.from_config(ChannelSamplingConfig(**ch),
                                         exact_top_p=exact)
    ref = np.asarray(jsam.processed_logits(jnp.asarray(logits),
                                           jnp.asarray(presence), jp, 64))
    got = psam.processed_logits(torch.from_numpy(logits),
                                torch.from_numpy(presence), pp_, 64).numpy()
    np.testing.assert_array_equal(got <= -1e29, ref <= -1e29)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("srow", [0, 3, 6, 7, 12])
def test_tf_pad_eos_masks_match_jax(models, srow):
    """The per-channel logits the draws see (TF-window eos mask, pad mask
    once a channel's delay elapsed, repetition penalty) equal the JAX
    sampler body's, step by step through and past the TF window."""
    jcfg = models[0]
    rng = np.random.default_rng(srow)
    B, C = 2, jcfg.channels
    tl = rng.standard_normal((B, jcfg.vocab_size)).astype(np.float32)
    sl = rng.standard_normal((B, C - 1, jcfg.speech_vocab_size)
                             ).astype(np.float32)
    pt = rng.random((B, jcfg.vocab_size)) < 0.2
    ps = rng.random((B, C - 1, jcfg.speech_vocab_size)) < 0.2
    ch = ChannelSamplingConfig(**SAMPLED[0])
    jps = [jsam.ChannelParams.from_config(JCh(**SAMPLED[0]))] * C
    pps = [psam.ChannelParams.from_config(ch)] * C
    seen = {}

    def draw(i, lg):
        seen[i] = np.asarray(lg)
        return jnp.zeros((B,), jnp.int32)

    jeng._sample_channels_body(draw, jnp.asarray(tl), jnp.asarray(sl),
                               jnp.asarray(pt), jnp.asarray(ps),
                               jnp.int32(srow), jps, jcfg.eos_token_id,
                               jcfg.speech_pad_token, 0)
    got = channel_logits(torch.from_numpy(tl), torch.from_numpy(sl),
                         torch.from_numpy(pt), torch.from_numpy(ps), srow,
                         pps, jcfg.eos_token_id, jcfg.speech_pad_token)
    for i in range(C):
        np.testing.assert_allclose(got[i].numpy(), seen[i], rtol=1e-6)


def test_sampled_generate_holds_tf_window(models):
    """A sampled run re-feeds the shifted prompt tail on channels > s for
    the first C-1 steps and never emits pad on channel i once s >= i."""
    jcfg, params, cfg, model = models
    batch, mask = _batch(jcfg, 3, [(6, 4), (9, 2)])
    sampling = SamplingConfig(channels=[ChannelSamplingConfig(**SAMPLED[0])
                                        for _ in range(8)],
                              max_new_tokens=16)
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    r = eng.generate(batch, mask, 16, seed=1)
    C = cfg.channels
    ids, _, base = eng._bucket_prompt(batch, mask)
    for s in range(min(C - 1, r.steps)):
        np.testing.assert_array_equal(r.tokens[:, base + s, s + 1:],
                                      ids[:, base + s, s + 1:])
    r2 = eng.generate(batch, mask, 16, seed=1)
    np.testing.assert_array_equal(r.tokens, r2.tokens)   # seeded generator


@pytest.mark.parametrize("cfg_fields,kwargs,match", [
    (dict(kv_quant="fp8"), {}, "kv_quant"),
    ({}, dict(kv_quant="int4"), "kv_quant"),
    ({}, dict(quant="int4"), "quant"),
    (dict(attn_impl="flash"), {}, "unknown attn_impl 'flash'"),
    ({}, dict(attn_impl="sdpa"), "unknown attn_impl 'sdpa'"),
])
def test_engine_refuses_unported_config_fields(models, cfg_fields, kwargs,
                                               match):
    """A decode policy neither package implements (an unknown KV-cache,
    weight or attention mode) raises instead of decoding silently with the
    defaults."""
    import dataclasses
    cfg, model = models[2], models[3]
    with pytest.raises(ValueError, match=match):
        GenerationEngine(dataclasses.replace(cfg, **cfg_fields), model,
                         device="cpu", **kwargs)


def test_engine_accepts_tpu_performance_knobs(models):
    """Knobs with no numeric effect are accepted and ignored; int8 serving
    drops a training-time LoRA rank, as the JAX engine does."""
    import dataclasses
    cfg, model = models[2], models[3]
    knobs = dataclasses.replace(cfg, decode_len_bucket=64,
                                decode_extent_kernel=True, decode_block_k=32,
                                pallas_interpret=True, fuse_qk_norm_rope=True,
                                attn_impl="pallas", lora_rank=8)
    eng = GenerationEngine(knobs, model, device="cpu", quant="int8")
    assert eng.cfg.quantized and eng.cfg.lora_rank == 0


def test_tf_pad_eos_masks_match_jax_per_row(models):
    """The pool's form: srow a (B,) tensor, each row masked by its own step
    (inside, at the edge of and past the TF window), equal to the JAX
    sampler body with a per-row srow vector."""
    jcfg = models[0]
    rng = np.random.default_rng(11)
    srow = np.array([0, 3, 6, 7, 12])
    B, C = len(srow), jcfg.channels
    tl = rng.standard_normal((B, jcfg.vocab_size)).astype(np.float32)
    sl = rng.standard_normal((B, C - 1, jcfg.speech_vocab_size)
                             ).astype(np.float32)
    pt = rng.random((B, jcfg.vocab_size)) < 0.2
    ps = rng.random((B, C - 1, jcfg.speech_vocab_size)) < 0.2
    jps = [jsam.ChannelParams.from_config(JCh(**SAMPLED[0]))] * C
    pps = [psam.ChannelParams.from_config(
        ChannelSamplingConfig(**SAMPLED[0]))] * C
    seen = {}

    def draw(i, lg):
        seen[i] = np.asarray(lg)
        return jnp.zeros((B,), jnp.int32)

    jeng._sample_channels_body(draw, jnp.asarray(tl), jnp.asarray(sl),
                               jnp.asarray(pt), jnp.asarray(ps),
                               jnp.asarray(srow, jnp.int32), jps,
                               jcfg.eos_token_id, jcfg.speech_pad_token, 0)
    got = channel_logits(torch.from_numpy(tl), torch.from_numpy(sl),
                         torch.from_numpy(pt), torch.from_numpy(ps),
                         torch.from_numpy(srow), pps, jcfg.eos_token_id,
                         jcfg.speech_pad_token)
    for i in range(C):
        np.testing.assert_allclose(got[i].numpy(), seen[i], rtol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
def test_rowkeys_sampler_draws_each_rows_batch1_noise(exact):
    """sample_channels with a list of one generator per row: row b's tokens
    are those of a batch-1 sample_channels with a generator seeded alike,
    at its own step; B x (sampled channels) per-row draws are counted."""
    from moss_ttsd_torch.decode.engine import sample_channels
    rng = np.random.default_rng(12)
    B, C, V, Vs, eos, pad = 3, 8, 40, 17, 39, 16
    tl = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    sl = torch.from_numpy(rng.standard_normal((B, C - 1, Vs)
                                              ).astype(np.float32))
    pt = torch.from_numpy(rng.random((B, V)) < 0.2)
    ps = torch.from_numpy(rng.random((B, C - 1, Vs)) < 0.2)
    srow = torch.tensor([0, 5, 9])
    chs = [dict(SAMPLED[i % 2], do_sample=i != 3) for i in range(C)]
    params = [psam.ChannelParams.from_config(ChannelSamplingConfig(**c),
                                             exact_top_p=exact) for c in chs]
    seeds = [3, 17, 3]
    before = psam.categorical.row_draws
    got = sample_channels(
        [torch.Generator().manual_seed(s) for s in seeds], tl, sl, pt, ps,
        srow, params, 16, False, eos, pad)
    assert psam.categorical.row_draws - before == B * (C - 1)
    for b in range(B):
        ref = sample_channels(torch.Generator().manual_seed(seeds[b]),
                              tl[b:b + 1], sl[b:b + 1], pt[b:b + 1],
                              ps[b:b + 1], int(srow[b]), params, 16, False,
                              eos, pad)
        assert torch.equal(got[b], ref[0]), b


def _ring_inputs(cfg, rng, B, S):
    from tests.test_torch_lm import rand_ids
    kv = rng.random((B, S)) < 0.6
    slot = 5
    gate = np.array([True, False, True])[:B]
    kv[:, slot] |= gate
    ext = np.where(gate, np.max(np.where(kv, np.arange(S) + 1, 0), axis=1),
                   1).astype(np.int32)
    return (rand_ids(cfg, rng, B, 1), rng.integers(3, 9, (B, 1)), kv, slot,
            gate, ext)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_backbone_ring_write_gate_extent_and_adapters_match_jax(models,
                                                                 kv_quant):
    """One ring-addressed decode step over a cache with random contents and
    valid bits: write_gate keeps gated-off rows' k/v (and int8 scales) as
    they were, read_extent gives each row its own extent, and per-row LoRA
    adapters (ids 1, 0, 2) run in every projection: hidden states and the
    whole cache equal the JAX backbone's (hidden states of the rows that
    advance)."""
    import dataclasses
    from moss_ttsd_tpu.decode.lora_registry import LoraRegistry as JReg
    from moss_ttsd_tpu.models import lm as jlm
    from moss_ttsd_torch.decode.lora_registry import LoraRegistry
    from moss_ttsd_torch.models.lm import init_cache, select_adapters
    from tests.test_torch_continuous import rand_adapter
    jcfg, params, cfg, model = models
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    model.cfg = cfg
    B, S, L = 3, 12, cfg.num_hidden_layers
    rng = np.random.default_rng(21)
    ids, pos, kv, slot, gate, ext = _ring_inputs(cfg, rng, B, S)
    reg, jreg = LoraRegistry(torch.float32, L), JReg(jnp.float32, L)
    for r in (reg, jreg):
        r.register("a", rand_adapter(cfg, 1, rank=3), alpha=8.0)
        r.register("b", rand_adapter(cfg, 2, rank=2), alpha=8.0)
    aids = np.array([1, 0, 2])
    try:
        jc = jlm.init_cache(jcfg, B, S, jnp.float32)
        pc = init_cache(cfg, B, S, torch.float32, device="cpu")
        for name in jc:
            if jc[name].dtype == jnp.int8:
                v = rng.integers(-127, 128, jc[name].shape).astype(np.int8)
            else:
                v = rng.random(jc[name].shape).astype(np.float32)
            jc[name] = jnp.asarray(v)
            pc[name].copy_(torch.from_numpy(v))
        old = {k: v.clone() for k, v in pc.items()}
        jh, jc = jlm.AsteroidLM(jcfg).apply(
            params, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(kv), jc,
            slot, jnp.asarray(gate), method=jlm.AsteroidLM.backbone,
            read_extent=jnp.asarray(ext), adapters=jreg.stacks,
            adapter_ids=jnp.asarray(aids, jnp.int32))
        with torch.no_grad():
            ph, _ = model.backbone(
                torch.from_numpy(ids), torch.from_numpy(pos),
                torch.from_numpy(kv), pc, slot,
                write_gate=torch.from_numpy(gate),
                read_extent=torch.from_numpy(ext),
                adapters=select_adapters(reg.stacks,
                                         torch.from_numpy(aids)))
    finally:
        model.cfg = models[2]
    # rows that advance; a gated-off row reads a 1-slot extent and its
    # output is dropped by the pool (JAX on the CPU reads every slot)
    np.testing.assert_allclose(ph.numpy()[gate], np.asarray(jh)[gate],
                               atol=1e-4)
    for name in pc:
        got, ref = pc[name].numpy(), np.asarray(jc[name])
        if got.dtype == np.int8:
            # a quantized value may sit one step off where the fp32 k/v
            # differ by float reassociation
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        # rows gated off keep their old sliver exactly; no other slot moved
        np.testing.assert_array_equal(got[:, ~gate], old[name].numpy()[
            :, ~gate])
        keep = np.ones(S, bool)
        keep[slot] = False
        np.testing.assert_array_equal(got[:, :, :, keep],
                                      old[name].numpy()[:, :, :, keep])


# -- the dense backend, the bench-only stubs, remat and a LoRA config --------

def _jax_lora_tree(jcfg, params, seed=0):
    """JAX ``graft_lora_params`` on the tiny tree, with ``lora_b`` set
    non-zero (its init is zeros, which would hide the factors)."""
    import jax
    from moss_ttsd_tpu.train.lora import graft_lora_params
    tree = jax.tree_util.tree_map(np.asarray, graft_lora_params(
        params, jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blk = tree["params"]["layers"]["block"]
    for name in jcfg.lora_targets:
        b = blk[name]["lora_b"]
        blk[name]["lora_b"] = (rng.standard_normal(b.shape) * 0.2
                               ).astype(np.float32)
    return tree


ENGINE_VARIANTS = {
    "xla": ({}, dict(attn_impl="xla")),
    "xla_int8": ({}, dict(attn_impl="xla", quant="int8")),
    "xla_kv8": ({}, dict(attn_impl="xla", kv_quant="int8")),
    "xla_int8_kv8": ({}, dict(attn_impl="xla", quant="int8",
                              kv_quant="int8")),
    "ablate_norms": (dict(ablate_norms=True), {}),
    "ablate_rope": (dict(ablate_rope=True), {}),
    "ablate_attention": (dict(ablate_attention=True), {}),
    "ablate_all": (dict(ablate_norms=True, ablate_rope=True,
                        ablate_attention=True), {}),
    "remat_layers": (dict(remat_layers=True), {}),
    "lora_rank": (dict(lora_rank=4, lora_alpha=8.0, lora_rslora=False), {}),
    "lora_rank_rslora": (dict(lora_rank=4, lora_targets=("q_proj", "v_proj",
                                                         "down_proj")), {}),
    "lora_rank_int8": (dict(lora_rank=4), dict(quant="int8")),
}


@pytest.mark.parametrize("variant", list(ENGINE_VARIANTS))
def test_engine_variants_greedy_tokens_equal_jax(models, variant):
    """Greedy tokens of the port's engine equal the JAX engine's (its CPU
    path) under attn_impl="xla" with every weight and KV-cache mode, each
    bench-only stub, remat_layers (no effect at serving) and a lora_rank
    config served layerwise (scale alpha / r, or alpha / sqrt(r) under
    rsLoRA; int8 serving drops the factors in both)."""
    import dataclasses
    from tests.test_torch_lm import port_model
    jcfg0, params = models[0], models[1]
    fields, kw = ENGINE_VARIANTS[variant]
    # most of the vocab counted as speech: the rows decode past the TF
    # window instead of flushing at once
    jcfg = dataclasses.replace(jcfg0, speech_token_range=(0, 150), **fields)
    if jcfg.lora_rank:
        params = _jax_lora_tree(jcfg, params)
    cfg, model = port_model(jcfg, params)
    batch, mask = _batch(jcfg, 4, [(6, 4), (9, 2)])
    r_j = jeng.GenerationEngine(jcfg, params, greedy(JAX_S, 20), bucket=32,
                                cache_dtype=jnp.float32, **kw
                                ).generate(batch, mask, 20)
    eng = GenerationEngine(cfg, model, greedy(TORCH_S, 20), bucket=32,
                           device="cpu", **kw)
    r_t = eng.generate(batch, mask, 20)
    assert eng.cfg.attn_impl == kw.get("attn_impl", "mixed")
    assert eng.cfg.lora_rank == (0 if "quant" in kw else jcfg.lora_rank)
    assert (r_t.steps, r_t.base) == (r_j.steps, r_j.base)
    assert r_t.steps > jcfg.channels
    np.testing.assert_array_equal(r_t.tokens, r_j.tokens)


def test_sampled_xla_run_draws_from_jax_distributions(models, monkeypatch):
    """A sampled attn_impl="xla" run: at each of its first 4 steps the
    distribution every channel's draw sees (processed_logits, after the
    TF/pad/EOS masks and the repetition penalty) equals JAX's, within
    1e-6, with JAX's cached backbone fed the port's drawn tokens."""
    import dataclasses
    from moss_ttsd_tpu.models import lm as jlm
    from moss_ttsd_torch.decode import engine as peng
    jcfg0, params, cfg0, _ = models
    jcfg = dataclasses.replace(jcfg0, attn_impl="xla")
    cfg = dataclasses.replace(cfg0, attn_impl="xla")
    model = models[3]
    ch = SAMPLED[0]
    C, steps, prefilter = cfg.channels, 4, 64
    sampling = SamplingConfig(channels=[ChannelSamplingConfig(**ch)
                                        for _ in range(C)],
                              max_new_tokens=steps, topk_prefilter=prefilter)
    seen, orig = [], peng.sample_from_channel

    def spy(gen, x, p, pre, approx):
        seen.append(psam.processed_logits(x, torch.zeros_like(x, dtype=bool),
                                          p, pre, approx).numpy())
        return orig(gen, x, p, pre, approx)

    monkeypatch.setattr(peng, "sample_from_channel", spy)
    batch, mask = _batch(jcfg, 6, [(6, 4), (9, 2)])
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    res = eng.generate(batch, mask, steps, seed=3)
    assert res.steps == steps and len(seen) == steps * C

    ids, m, base = eng._bucket_prompt(batch, mask)
    B, S = ids.shape[0], base + 32
    jm = jlm.AsteroidLM(jcfg)
    jps = [jsam.ChannelParams.from_config(JCh(**ch))] * C
    kv = np.zeros((B, S), bool)
    kv[:, :base] = m[:, :base] > 0
    pos = np.maximum(np.cumsum(m[:, :base], 1) - 1, 0)
    cache = jlm.init_cache(jcfg, B, S, jnp.float32)
    h, cache = jm.apply(params, jnp.asarray(ids[:, :base]), jnp.asarray(pos),
                        jnp.asarray(kv), cache, 0,
                        method=jlm.AsteroidLM.backbone)
    h, last = h[:, -1:], pos[:, -1]
    pt = np.zeros((B, jcfg.vocab_size), bool)
    ps = np.zeros((B, C - 1, jcfg.speech_vocab_size), bool)
    for b in range(B):
        pt[b, ids[b, :base, 0]] = True
        for i in range(1, C):
            ps[b, i - 1, ids[b, :base, i]] = True
    for s in range(steps):
        tl, sl = jm.apply(params, h, method=jlm.AsteroidLM.logits_all)
        ref = {}

        def draw(i, lg):
            ref[i] = np.asarray(jsam.processed_logits(
                lg, jnp.zeros(lg.shape, bool), jps[i], prefilter))
            return jnp.zeros((B,), jnp.int32)

        jeng._sample_channels_body(draw, tl[:, 0], sl[:, 0],
                                   jnp.asarray(pt), jnp.asarray(ps),
                                   jnp.int32(s), jps, jcfg.eos_token_id,
                                   jcfg.speech_pad_token, 0)
        for i in range(C):
            got = seen[s * C + i]
            np.testing.assert_array_equal(got <= -1e29, ref[i] <= -1e29)
            np.testing.assert_allclose(got, ref[i], rtol=1e-6, atol=1e-6)
        tok = res.tokens[:, base + s]                      # the port's draw
        pt[np.arange(B), tok[:, 0]] = True
        for i in range(1, C):
            ps[np.arange(B), i - 1, tok[:, i]] = True
        kv[:, base + s] = True
        last = last + 1
        h, cache = jm.apply(params, jnp.asarray(tok[:, None]),
                            jnp.asarray(last[:, None]), jnp.asarray(kv),
                            cache, base + s, method=jlm.AsteroidLM.backbone)

"""int8 serving in the port against the JAX package (tiny config, fp32,
CPU): the int8-cache decode attention's plain version vs the Pallas kernel
in interpret mode, the quantized LM (logits, restricted head, prefill plus
one int8-cache decode step), the engine's greedy tokens and audit counters
under quant="int8" / kv_quant="int8" / restricted_text_head, the pipeline's
codes, and the CLI's --quant int8."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.decode import engine as jeng  # noqa: E402
from moss_ttsd_tpu.models import lm as jlm  # noqa: E402
from moss_ttsd_tpu.ops import pallas_attention as jpa  # noqa: E402
from moss_ttsd_tpu.ops.quantize import quantize_lm_params as jquantize  # noqa: E402
from moss_ttsd_tpu.pipeline.prompt import left_pad_batch  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.decode.engine import GenerationEngine  # noqa: E402
from moss_ttsd_torch.models.lm import AsteroidLM, init_cache  # noqa: E402
from moss_ttsd_torch.ops import flash_attention as fa  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from tests.test_restricted_head import make_prompt  # noqa: E402
from tests.test_torch_engine import JAX_S, TORCH_S  # noqa: E402
from tests.test_torch_lm import jax_tiny, port_model, rand_ids  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5      # fp32, float reassociation across frameworks
T_ = torch.from_numpy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def quantized_models(seed, bias=False, **jax_overrides):
    """(JAX cfg, JAX quantized tree, port cfg, port quantized model) on
    the same int8 bytes."""
    jcfg, params = jax_tiny(seed, attention_bias=bias)
    jcfg = dataclasses.replace(jcfg, quantized=True, **jax_overrides)
    qtree = _np_tree(jquantize(params))
    cfg = dataclasses.replace(LMConfig.from_dict(jcfg.to_dict()),
                              attn_impl="mixed", pallas_interpret=False)
    with torch.device("meta"):
        model = AsteroidLM(cfg)
    model.load_state_dict(lm_state_from_jax(qtree, cfg), assign=True)
    return jcfg, qtree, cfg, model.eval()


# ---------------------------------------------------------------------------
# flash_decode_int8_hs: plain version vs the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

def _int8_cache(rng, B, S, H, Hkv, D, L=None):
    lead = (B,) if L is None else (L, B)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal(lead + (Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal(lead + (Hkv, S, D)).astype(np.float32)
    kq, ks = (np.array(a) for a in jpa.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jpa.quantize_kv(jnp.asarray(v)))
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("S,spans,extent,layer", [
    # tests/test_pallas_attention.py:120-145 (no extent)
    (96, [(0, 70), (9, 88)], None, None),
    # :265-288 (scalar and per-row extents)
    (128, [(0, 50), (10, 60)], 60, None),
    (128, [(0, 50), (10, 60)], [50, 60], None),
    # a layered (L, ...) stack, extent 1, and a row with no valid key
    (64, [(0, 1), (0, 1)], 1, 2),
    (64, [(0, 0), (5, 40)], 40, 1),
])
def test_int8_decode_plain_matches_jax_kernel(S, spans, extent, layer):
    rng = np.random.default_rng(S + (layer or 0))
    B, H, Hkv, D = 2, 8, 4, 16
    q, kq, ks, vq, vs = _int8_cache(rng, B, S, H, Hkv, D,
                                    None if layer is None else 3)
    valid = np.zeros((B, S), bool)
    for b, (lo, hi) in enumerate(spans):
        valid[b, lo:hi] = True
    scale = D ** -0.5
    kw = {} if extent is None else {"extent": jnp.asarray(extent, jnp.int32)}
    if layer is not None:
        kw["layer"] = jnp.int32(layer)
    ref = np.asarray(jpa.flash_decode_int8_hs(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(valid), scale, block_k=32,
        interpret=True, **kw))
    ext = (torch.tensor(extent, dtype=torch.int32)
           if isinstance(extent, list) else extent)
    out = fa.flash_decode_int8_hs(T_(q), T_(kq), T_(ks), T_(vq), T_(vs),
                                  T_(valid), scale, extent=ext,
                                  layer=layer).numpy()
    assert np.isfinite(out).all()
    rows = valid.any(axis=1)
    np.testing.assert_allclose(out[rows], ref[rows], atol=2e-5)
    np.testing.assert_array_equal(out[~rows], 0.0)


SPLIT_S = 200        # 4 tiles of 64: chunk boundaries at 64, 128, 192


@pytest.mark.parametrize("n_split", [1, 2, 3, -(-SPLIT_S // 64)])
def test_int8_decode_split_plain_matches_jax_kernel(n_split):
    """The split-K arithmetic of the int8 decode kernel (per-chunk m, l,
    acc with the scales folded around the two products, then the kernel's
    merge) against the Pallas kernel in interpret mode, fp32, atol 2e-5:
    scalar extents on and off chunk boundaries, per-row extents with one
    row at 1, a chunk inside the extent with no valid key (row 1's keys
    start at 130) and layer views of the (L, ...) stacks."""
    rng = np.random.default_rng(19)
    L, B, S, H, Hkv, D = 3, 2, SPLIT_S, 8, 4, 16
    q, kq, ks, vq, vs = _int8_cache(rng, B, S, H, Hkv, D, L)
    base = np.zeros((B, S), bool)
    base[0, :170] = True
    base[1, 130:180] = True
    scale = D ** -0.5
    pos = np.arange(S)
    for extent in (None, 192, 128, 150, [150, 1], [64, 190]):
        ext = np.full(B, S) if extent is None else np.broadcast_to(extent, B)
        valid = base & (pos[None, :] < ext[:, None])   # none past the extent
        if extent == [150, 1]:
            valid[1, 0] = True
        for lay in (0, 2):
            kw = {} if extent is None else dict(
                extent=jnp.asarray(extent, jnp.int32))
            ref = np.asarray(jpa.flash_decode_int8_hs(
                jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(valid), scale,
                block_k=40, interpret=True, layer=jnp.int32(lay), **kw))
            pext = (torch.tensor(extent, dtype=torch.int32)
                    if isinstance(extent, list) else extent)
            out = fa.flash_decode_int8_hs_split_plain(
                T_(q), T_(kq), T_(ks), T_(vq), T_(vs), T_(valid), scale,
                extent=pext, layer=lay, n_split=n_split).numpy()
            # a row with no valid key: unspecified in the TPU kernel, 0 here
            live = valid.any(axis=1)
            np.testing.assert_allclose(out[live], ref[live], atol=2e-5)
            np.testing.assert_array_equal(out[~live], 0.0)


def test_int8_decode_wrapper_split_on_cpu_runs_split_plain():
    """On a CPU tensor, flash_decode_int8_hs with a split runs the plain
    split arithmetic at that split, which agrees with the dense plain
    version to fp32 rounding."""
    rng = np.random.default_rng(37)
    q, kq, ks, vq, vs = _int8_cache(rng, 2, 150, 8, 4, 16)
    valid = np.ones((2, 150), bool)
    valid[:, 140:] = False
    valid[1, :70] = False
    args = tuple(T_(x) for x in (q, kq, ks, vq, vs, valid)) + (0.25,)
    for n_split, chunk in ((1, 192), (2, 128), (3, 64)):
        out = fa.flash_decode_int8_hs(*args, extent=140,
                                      split=(n_split, chunk))
        ref = fa.flash_decode_int8_hs_split_plain(*args, extent=140,
                                                  n_split=n_split,
                                                  chunk=chunk)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        np.testing.assert_allclose(out.numpy(), fa.flash_decode_int8_hs(
            *args, extent=140).numpy(), atol=2e-6)


# ---------------------------------------------------------------------------
# The quantized LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_quantized_logits_match_jax(bias):
    """Cache-free logits of the int8 model, the restricted-window text
    logits and the audit's outside-window max."""
    jcfg, qtree, cfg, model = quantized_models(3, bias)
    rng = np.random.default_rng(4)
    ids = rand_ids(cfg, rng, 2, 11)
    mask = np.ones((2, 11), np.int64)
    mask[1, :4] = 0
    jm = jlm.AsteroidLM(jcfg)
    jt, js = jm.apply(qtree, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        pt, ps = model(T_(ids), T_(mask))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL)

    rcfg = dataclasses.replace(jcfg, restricted_text_head=True)
    model.cfg = dataclasses.replace(cfg, restricted_text_head=True)
    hid = rng.standard_normal((2, 1, cfg.hidden_size)).astype(np.float32)
    jr = jlm.AsteroidLM(rcfg)
    jt, js = jr.apply(qtree, jnp.asarray(hid), True,
                      method=jlm.AsteroidLM.logits_all)
    jo = jr.apply(qtree, jnp.asarray(hid),
                  method=jlm.AsteroidLM.text_logits_outside_max)
    with torch.no_grad():
        pt, ps = model.logits_all(T_(hid), restricted=True)
        po = model.text_logits_outside_max(T_(hid))
    lo, hi = rcfg.text_head_window()
    assert pt.shape == (2, 1, hi - lo)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL)


def test_restricted_float_logits_match_jax():
    jcfg, params = jax_tiny(5)
    rcfg = dataclasses.replace(jcfg, restricted_text_head=True)
    cfg, model = port_model(rcfg, params)
    hid = np.random.default_rng(6).standard_normal(
        (3, 1, cfg.hidden_size)).astype(np.float32)
    jm = jlm.AsteroidLM(rcfg)
    jt, _ = jm.apply(params, jnp.asarray(hid), True,
                     method=jlm.AsteroidLM.logits_all)
    jo = jm.apply(params, jnp.asarray(hid),
                  method=jlm.AsteroidLM.text_logits_outside_max)
    with torch.no_grad():
        pt, _ = model.logits_all(T_(hid), restricted=True)
        po = model.text_logits_outside_max(T_(hid))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL)


@pytest.mark.parametrize("bias", [False, True])
def test_kv8_prefill_and_decode_step_match_jax(bias):
    """Prefill of a left-padded batch into an int8 cache, then one decode
    step through flash_decode_int8_hs, against the JAX backbone with the
    Pallas kernels in interpret mode, on int8 weights."""
    jcfg, qtree, cfg, model = quantized_models(
        7, bias, kv_quant="int8", attn_impl="pallas", pallas_interpret=True)
    cfg = dataclasses.replace(cfg, kv_quant="int8")
    model.cfg = cfg
    rng = np.random.default_rng(8)
    B, T, S = 2, 9, 16
    ids = rand_ids(cfg, rng, B, T)
    attn = np.ones((B, T), np.int64)
    attn[0, :3] = 0
    pos = np.maximum(np.cumsum(attn, axis=1) - 1, 0)
    kv = np.zeros((B, S), bool)
    kv[:, :T] = attn.astype(bool)
    nxt = rand_ids(cfg, rng, B, 1)
    kv2 = kv.copy()
    kv2[:, T] = True
    pos2 = pos[:, -1:] + 1

    jm = jlm.AsteroidLM(jcfg)
    jcache = jlm.init_cache(jcfg, B, S)
    jh, jcache = jm.apply(qtree, jnp.asarray(ids), jnp.asarray(pos),
                          jnp.asarray(kv), jcache, 0,
                          method=jlm.AsteroidLM.backbone)
    jh2, jcache = jm.apply(qtree, jnp.asarray(nxt), jnp.asarray(pos2),
                           jnp.asarray(kv2), jcache, T,
                           method=jlm.AsteroidLM.backbone)
    jt, js = jm.apply(qtree, jh2, method=jlm.AsteroidLM.logits_all)
    with torch.no_grad():
        cache = init_cache(cfg, B, S, device="cpu")
        assert cache["k"].dtype == torch.int8
        assert cache["k_s"].shape == (cfg.num_hidden_layers, B,
                                      cfg.num_key_value_heads, S)
        ph, _ = model.backbone(T_(ids), T_(pos), T_(kv), cache, 0)
        ph2, _ = model.backbone(T_(nxt), T_(pos2), T_(kv2), cache, T)
        pt, ps = model.logits_all(ph2)
    np.testing.assert_allclose(ph.numpy()[1], np.asarray(jh)[1], atol=ATOL)
    np.testing.assert_allclose(ph.numpy()[0, 3:], np.asarray(jh)[0, 3:],
                               atol=ATOL)
    np.testing.assert_allclose(ph2.numpy(), np.asarray(jh2), atol=ATOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL)
    # the int8 cache holds the JAX engine's bytes at the written valid slots
    for name in ("k", "v", "k_s", "v_s"):
        got, ref = cache[name].numpy(), np.asarray(jcache[name])
        tol = 1 if name in ("k", "v") else 1e-6
        np.testing.assert_allclose(got[:, 1, :, :T + 1], ref[:, 1, :, :T + 1],
                                   atol=tol, rtol=1e-5)
        np.testing.assert_allclose(got[:, 0, :, 3:T + 1],
                                   ref[:, 0, :, 3:T + 1], atol=tol, rtol=1e-5)


# ---------------------------------------------------------------------------
# Engine, pipeline, CLI
# ---------------------------------------------------------------------------

def penalized_greedy(mod, n=24):
    """Greedy draws after a repetition penalty, so the presence masks (and
    the restricted head's window-relative presence) shape the tokens."""
    return mod[1](channels=[mod[0](do_sample=False, temperature=None,
                                   top_k=None, top_p=None,
                                   repetition_penalty=1.3)
                            for _ in range(8)], max_new_tokens=n)


@pytest.fixture(scope="module")
def float_models():
    jcfg, params = jax_tiny(9)
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas", pallas_interpret=True)
    cfg, model = port_model(jcfg, params)
    return jcfg, params, cfg, model


@pytest.mark.parametrize("policy", [
    dict(quant="int8"),
    dict(quant="int8", kv_quant="int8"),
    dict(kv_quant="int8"),
    dict(restricted_text_head=True, restricted_audit_every=2),
    dict(quant="int8", kv_quant="int8", restricted_text_head=True,
         restricted_audit_every=3),
])
def test_engine_policies_greedy_tokens_equal_jax(float_models, policy):
    """Greedy tokens (after a repetition penalty) and the restricted-head
    audit counters of the port's engine equal the JAX engine's; the JAX
    engine runs its Pallas kernels in interpret mode."""
    jcfg, params, cfg, model = float_models
    rng = np.random.default_rng(10)
    prompts = [make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 9, 2)]
    batch, mask = left_pad_batch(prompts, jcfg.pad_token_id,
                                 jcfg.speech_pad_token)
    r_j = jeng.GenerationEngine(jcfg, params, penalized_greedy(JAX_S),
                                bucket=32, cache_dtype=jnp.float32,
                                **policy).generate(batch, mask, 20)
    eng = GenerationEngine(cfg, model, penalized_greedy(TORCH_S), bucket=32,
                           device="cpu", **policy)
    r_t = eng.generate(batch, mask, 20)
    assert eng.cfg.quantized == (policy.get("quant") == "int8")
    assert (r_t.steps, r_t.base) == (r_j.steps, r_j.base)
    np.testing.assert_array_equal(r_t.tokens, r_j.tokens)
    assert r_t.audit == r_j.audit
    if policy.get("restricted_audit_every"):
        assert r_t.audit[0] > 0


def test_prequantized_state_dict_matches_online_quantization(float_models):
    """An engine given a state dict already in the int8 layout decodes as
    one that quantizes the float weights itself."""
    from moss_ttsd_torch.ops.quantize import quantize_lm_params
    jcfg, params, cfg, model = float_models
    rng = np.random.default_rng(11)
    batch, mask = left_pad_batch([make_prompt(jcfg, rng, 6, 4)],
                                 jcfg.pad_token_id, jcfg.speech_pad_token)
    kw = dict(bucket=32, device="cpu", quant="int8", kv_quant="int8")
    online = GenerationEngine(cfg, model, penalized_greedy(TORCH_S), **kw)
    pre = GenerationEngine(cfg, quantize_lm_params(model.state_dict()),
                           penalized_greedy(TORCH_S), **kw)
    np.testing.assert_array_equal(pre.generate(batch, mask, 12).tokens,
                                  online.generate(batch, mask, 12).tokens)
    with pytest.raises(ValueError, match="quant='int8'"):
        GenerationEngine(cfg, quantize_lm_params(model.state_dict()),
                         device="cpu")


def test_int8_pipeline_codes_equal_jax():
    from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig
    from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY
    from moss_ttsd_tpu.pipeline.batch import TTSPipeline as JPipeline
    from moss_ttsd_tpu.utils.mock_tokenizer import MockTokenizer as JTok
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils.convert_jax import codec_state_from_jax
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    from tests.test_torch_engine import greedy
    from tests.test_torch_pipeline import _spy

    jcfg, params = jax_tiny(
        0, vocab_size=300, speech_vocab_size=65, speech_pad_token=64,
        speech_token_range=(0, 290), eos_token_id=290, pad_token_id=0)
    jspt = JXY.init_random(JCodecConfig().tiny(), seed=0)
    jpipe = JPipeline(JTok(), jcfg, params, jspt, greedy(JAX_S), bucket=32,
                      quant="int8")
    jpipe.engine.cache_dtype = jnp.float32
    cfg, model = port_model(jcfg, params)
    ccfg = CodecConfig().tiny()
    spt = XYTokenizer(ccfg, codec_state_from_jax(_np_tree(jspt.params), ccfg),
                      device="cpu")
    pipe = TTSPipeline(MockTokenizer(), cfg, model, spt, greedy(TORCH_S),
                       bucket=32, quant="int8", device="cpu")
    assert pipe.lm_cfg.quantized and not cfg.quantized
    items = [json.loads(l) for l in
             (ROOT / "examples" / "examples_only_text.jsonl").read_text()
             .splitlines() if l.strip()]
    js, ps = _spy(jpipe.engine), _spy(pipe.engine)
    jpipe.process_batch(items, max_new_tokens=20)
    _, audio = pipe.process_batch(items, max_new_tokens=20)
    assert ps[-1].steps == js[-1].steps
    np.testing.assert_array_equal(ps[-1].tokens, js[-1].tokens)
    for a, b in zip(pipe.extract_codes(ps[-1]), jpipe.extract_codes(js[-1])):
        np.testing.assert_array_equal(a, b)
    assert sum(r is not None for r in audio) == 2


@pytest.mark.parametrize("extra", [["--quant", "int8"],
                                   ["--quant", "int8",
                                    "--restricted_text_head"]])
def test_cli_int8_tiny_cpu_writes_wavs(tmp_path, extra):
    from moss_ttsd_torch.cli.inference import main
    rc = main(["--jsonl", str(ROOT / "examples" / "examples_only_text.jsonl"),
               "--tiny", "--platform", "cpu", "--max_new_tokens", "16",
               "--output_dir", str(tmp_path), *extra])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("*.wav")) == [
        "output_0.wav", "output_1.wav"]

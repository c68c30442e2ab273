"""The static engine's captured decode step, on the CPU at tiny width. The
CPU has no CUDA graphs, so ``EagerStepGraph`` stands in for the captured
step: everything of ``decode/step_graph.py`` but the capture (the
workspace, the prefill into it, the bind, the kept key, the lock), its
replay the captured body played eagerly. Checked: a state bound to it
gives the eager step's tokens, cache, presence sets, flags and audit
counters; the workspace is shaped as a prefill's state; a one-token
block forward (Qwen3 and AFMoE) with a tensor ``cache_pos`` writes the
scalar write's cache; the rule that decides where a request may replay;
the kept key under two live requests and two threads. The replays
themselves run on the card (``tests/test_torch_cuda.py``)."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from moss_ttsd_torch.core.config import (ChannelSamplingConfig, LMConfig,
                                         SamplingConfig)
from moss_ttsd_torch.decode import step_graph
from moss_ttsd_torch.decode.engine import GenerationEngine
from moss_ttsd_torch.models.lm import (AFMoEBlock, AsteroidLM, Qwen3Block,
                                       init_cache)
from moss_ttsd_torch.ops.rope import rope_cos_sin
from moss_ttsd_torch.utils.profiling import metrics

STEPS = 30
COUNTERS = ("engine_graph_steps", "engine_eager_steps",
            "engine_graph_captures")


class EagerStepGraph(step_graph.StepGraph):
    """A ``StepGraph`` whose replay plays the captured body eagerly."""

    def _capture(self):
        return {}

    def replay(self):
        self._body()


@pytest.fixture
def eager_graphs(monkeypatch):
    """Every engine's requests bound to an ``EagerStepGraph`` (on the card
    they would replay); returns a function that holds one engine eager,
    as the reference."""
    monkeypatch.setattr(step_graph, "StepGraph", EagerStepGraph)
    monkeypatch.setattr(GenerationEngine, "_graphable",
                        lambda self, gen, adapters: adapters is None)

    def eager(eng):
        monkeypatch.setattr(eng, "_graphable", lambda gen, adapters: False)
        return eng
    return eager


def _counters():
    return np.array([metrics.get(k) for k in COUNTERS])


def _parts(dtype="float32", do_sample=False, **fields):
    cfg = LMConfig(dtype=dtype, param_dtype="float32").tiny(
        **{"speech_token_range": (0, 160), **fields})
    sampling = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=do_sample, temperature=0.9 if do_sample else None,
        top_k=20 if do_sample else None, top_p=0.9 if do_sample else None)
        for _ in range(cfg.channels)], max_new_tokens=STEPS)
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    with torch.no_grad():       # EOS logit 0: the rows decode every step
        model.embed_text[cfg.eos_token_id] = 0.0
    return cfg, sampling, model, *_prompt(cfg, 3, 1)


def _prompt(cfg, B, seed):
    rng = np.random.default_rng(seed)
    prompt = np.full((B, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (B, 20))
    mask = np.ones((B, 20), np.int64)
    for b in range(1, B):
        mask[b, :rng.integers(1, 9)] = 0
    return prompt, mask


def _state_fields(st, base):
    out = {n: getattr(st, n) for n in (
        "key_valid", "hidden_last", "last_pos", "needs", "unfinished",
        "presence_text", "presence_speech", "audit_rows", "audit_flagged",
        "pos")}
    out["tokens"] = st.tokens[:, :base + st.step]
    out.update({"cache_" + k: v for k, v in st.cache.items()})
    return out


POLICIES = {
    "fp32": ("float32", {}, {}),
    "bf16": ("bfloat16", {}, {}),
    "int8_weights": ("float32", {}, dict(quant="int8")),
    "bf16_int8_kv": ("bfloat16", {}, dict(kv_quant="int8")),
    "restricted_audit": ("float32", dict(restricted_text_head=True,
                                         speech_token_range=(100, 150)),
                         dict(restricted_audit_every=4)),
}


def _engines(policy, do_sample=False, n=1):
    """``n`` engines of ``policy`` on one tiny model, and a prompt."""
    dtype, fields, kw = POLICIES[policy]
    cfg, sampling, model, prompt, mask = _parts(dtype, do_sample, **fields)
    return [GenerationEngine(cfg, model, sampling, bucket=32, device="cpu",
                             **kw) for _ in range(n)], prompt, mask


@pytest.mark.parametrize("do_sample", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_captured_body_equals_eager_step(eager_graphs, policy, do_sample):
    """A request prefilled into a workspace and bound to its step (the
    captured body past the teacher-forcing window, the cache written at
    the device slot; the eager step with its fields copied back in the
    window and on audit steps) leaves every field of the state as the
    eager engine does."""
    (eng, ref), prompt, mask = _engines(policy, do_sample, 2)
    eager_graphs(ref)
    C = eng.cfg.channels
    runs = []
    for e in (ref, eng):
        st, base, steps, _, gen, *_ = e._start(prompt, mask, STEPS, 5, None)
        assert (st.graph is not None) == (e is eng)
        e.run(st, base, steps, gen)
        runs.append((st.step, _state_fields(st, base)))
    g = st.graph
    assert st.tokens is g.ws.tokens and st.cache is g.ws.cache
    assert int(st.pos) == base + st.step
    for name, t in g.fixed.items():
        assert getattr(st, name) is t, name
    assert runs[0][0] == runs[1][0] > C + 8
    for name, a in runs[0][1].items():
        assert torch.equal(a, runs[1][1][name]), name
    if POLICIES[policy][2].get("restricted_audit_every"):
        assert int(runs[1][1]["audit_rows"]) > 0


@pytest.mark.parametrize("do_sample", [False, True],
                         ids=["greedy", "sampled"])
def test_captured_body_through_stream_segments(eager_graphs, do_sample):
    """generate_stream at the overlap's boundaries on a bound request:
    every segment's tokens are the eager generate's; the registry counts
    C - 1 eager steps, the rest replayed, and one capture."""
    cfg, sampling, model, prompt, mask = _parts("bfloat16", do_sample)
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    ref = eager_graphs(GenerationEngine(cfg, model, sampling, bucket=32,
                                        device="cpu"))
    full = ref.generate(prompt, mask, STEPS, seed=9)
    C = cfg.channels
    c0 = _counters()
    res = list(eng.generate_stream(prompt, mask, STEPS, seed=9,
                                   boundaries=[C + 3, 19, 26]))
    assert [r.steps for r in res] == [C + 3, 19, 26, STEPS]
    for r in res:
        np.testing.assert_array_equal(
            r.tokens, full.tokens[:, :r.base + r.steps])
    assert list(_counters() - c0) == [STEPS - (C - 1), C - 1, 1]


@pytest.mark.parametrize("policy", list(POLICIES))
def test_workspace_is_shaped_as_a_prefilled_state(policy):
    """``_empty_state`` gives every field the shape and dtype of a
    prefilled state's (a copy into the workspace never casts), and a
    prefill into it fills the workspace's own buffers."""
    (eng,), prompt, mask = _engines(policy)
    st, base, _, buf, *_ = eng._start(prompt, mask, STEPS, 0, None)
    ws = eng._empty_state(prompt.shape[0], base + buf)
    for f in dataclasses.fields(st):
        a, w = getattr(st, f.name), getattr(ws, f.name)
        if isinstance(a, torch.Tensor):
            assert (a.shape, a.dtype) == (w.shape, w.dtype), f.name
    assert st.cache.keys() == ws.cache.keys()
    for k, v in st.cache.items():
        assert (v.shape, v.dtype) == (ws.cache[k].shape, ws.cache[k].dtype)
    ids, m, base = eng._bucket_prompt(prompt, mask)
    into = eng.prefill(torch.as_tensor(ids), torch.as_tensor(m), base, buf,
                       into=ws)
    assert into.tokens is ws.tokens and into.cache is ws.cache
    for name, a in _state_fields(st, base).items():
        assert torch.equal(a, _state_fields(into, base)[name]), name


@pytest.mark.parametrize("block_type,kv_quant", [
    pytest.param("qwen3", "none", id="none"),
    pytest.param("qwen3", "int8", id="int8"),
    pytest.param("afmoe", "none", id="afmoe-none")])
def test_block_tensor_cache_pos_writes_scalar_cache(block_type, kv_quant):
    """One token through a block's ``forward`` at a () int64 tensor
    ``cache_pos``: the same output and the same cache (every slot) as the
    scalar write; a Qwen3 block over bf16 and int8 KV, and an AFMoE
    sliding layer (window 8, past it) over bf16 KV, both through the one
    ``attend_cached``."""
    afmoe = dict(block_type="afmoe", sliding_window=8,
                 layer_types=("sliding_attention",) * 2, num_dense_layers=2)
    cfg = LMConfig(dtype="bfloat16", param_dtype="bfloat16").tiny(
        kv_quant=kv_quant, **(afmoe if block_type == "afmoe" else {}))
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    block = model.layers[1]
    assert isinstance(block, AFMoEBlock if cfg.afmoe else Qwen3Block)
    B, S, pos = 2, 24, 13
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, 1, cfg.hidden_size, generator=g).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.full((B, 1), pos), cfg.head_dim,
                            cfg.rope_theta)
    valid = torch.zeros(B, S, dtype=torch.bool)
    valid[0, :pos + 1] = True
    valid[1, 4:pos + 1] = True
    outs, caches = [], []
    for cp in (pos, torch.tensor(pos)):
        cache = init_cache(cfg, B, S, torch.bfloat16, "cpu")
        for k, v in cache.items():      # earlier slots already written
            v.copy_(torch.randn(v.shape, generator=torch.Generator()
                                .manual_seed(1)).to(v.dtype))
        outs.append(block(x, cos, sin, 1, cache, cp, valid))
        caches.append(cache)
    assert torch.equal(outs[0], outs[1])
    for k in caches[0]:
        assert torch.equal(caches[0][k], caches[1][k]), k
    with pytest.raises(ValueError, match="one ungated token"):
        block(x.expand(B, 2, -1), cos.expand(B, 2, -1), sin.expand(B, 2, -1),
              1, caches[1], torch.tensor(pos), valid)


def test_backbone_tensor_cache_pos_refuses_dense_backend():
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny(
        attn_impl="xla")
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 1, 8, torch.float32, "cpu")
    ids = torch.zeros((1, 1, cfg.channels), dtype=torch.int64)
    with pytest.raises(ValueError, match="dense backend"):
        model.backbone(ids, torch.zeros((1, 1), dtype=torch.int64),
                       torch.ones((1, 8), dtype=torch.bool), cache,
                       torch.tensor(3))


def test_replay_rule():
    """Where a request may replay a captured step: on the card, with no
    mesh, no dense backend, no adapters and a generator; the restricted
    head's audit steps every ``restricted_audit_every``."""
    cfg, sampling, model, prompt, mask = _parts(
        speech_token_range=(100, 140))
    gen = torch.Generator()
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    assert not eng._graphable(gen, None)        # the CPU
    eng.device = torch.device("cuda")           # the rule alone, no card
    assert eng._graphable(gen, None)
    assert not eng._graphable(None, None)
    assert not eng._graphable(gen, {"q_proj": None})
    eng.mesh = object()
    assert not eng._graphable(gen, None)
    xla = GenerationEngine(dataclasses.replace(cfg, attn_impl="xla"), model,
                           sampling, bucket=32, device="cpu")
    xla.device = torch.device("cuda")
    assert not xla._graphable(gen, None)
    audited = GenerationEngine(cfg, model, sampling, bucket=32,
                               device="cpu", restricted_text_head=True,
                               restricted_audit_every=5)
    assert [s for s in range(16) if audited._audit_step(s)] == [0, 5, 10, 15]
    assert not any(eng._audit_step(s) for s in range(16))


def test_bound_request_runs_window_and_audit_steps_eagerly(eager_graphs):
    """A bound request replays every step past the teacher-forcing window
    but its audit steps; the registry counts the rest eager."""
    cfg, sampling, model, prompt, mask = _parts(
        speech_token_range=(100, 140))
    C = cfg.channels
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu",
                           restricted_text_head=True,
                           restricted_audit_every=5)
    c0 = _counters()
    res = eng.generate(prompt, mask, STEPS, seed=0)
    audits = [s for s in range(C - 1, res.steps) if s % 5 == 0]
    assert audits and res.steps == STEPS
    assert list(_counters() - c0) == [res.steps - (C - 1) - len(audits),
                                      C - 1 + len(audits), 1]


def test_kept_key_two_live_requests_and_a_new_key(eager_graphs):
    """The engine keeps one key: a second live request of it decodes
    eagerly; the workspace is free again once its state dies (or its
    prefill fails); a new key replaces the kept one while a live state
    keeps its own. Every request's tokens are the eager engine's."""
    cfg, sampling, model, p3, m3 = _parts(do_sample=True)
    p2, m2 = _prompt(cfg, 2, 2)
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    ref = eager_graphs(GenerationEngine(cfg, model, sampling, bucket=32,
                                        device="cpu"))
    C = cfg.channels

    def check(res, p, m, seed):
        np.testing.assert_array_equal(
            res.tokens, ref.generate(p, m, STEPS, seed=seed).tokens)

    c0 = _counters()
    first = eng.generate_stream(p3, m3, STEPS, seed=1, boundaries=[12])
    r1 = next(first)                            # live, bound, holds the key
    kept = eng._graphs.kept
    assert kept.busy and eng._graphs.take(*kept.key) is None
    res = eng.generate(p3[::-1].copy(), m3[::-1].copy(), STEPS, seed=2)
    assert list(_counters() - c0) == [12 - (C - 1), C - 1 + STEPS, 1]
    check(res, p3[::-1], m3[::-1], 2)           # eager: the key is held
    other = eng.generate_stream(p2, m2, STEPS, seed=3, boundaries=[15])
    next(other)                                 # a new key replaces it
    assert eng._graphs.kept is not kept and kept.busy
    *_, r1 = [r1, *first]
    check(r1, p3, m3, 1)
    assert not kept.busy                        # its state died
    *_, r2 = other
    check(r2, p2, m2, 3)
    c1 = _counters()
    res = eng.generate(p2, m2, STEPS, seed=4)   # the kept key, free again
    assert list(_counters() - c1) == [STEPS - (C - 1), C - 1, 0]
    check(res, p2, m2, 4)

    def fail(*a, **k):
        raise RuntimeError("prefill failed")
    eng.prefill = fail
    with pytest.raises(RuntimeError, match="prefill failed"):
        eng.generate(p2, m2, STEPS, seed=5)
    assert not eng._graphs.kept.busy


@pytest.mark.parametrize("keys", ["one", "two"])
def test_two_threads_share_one_engine(eager_graphs, keys):
    """generate in one thread and generate_stream in another on one
    engine, over one key or two (the server's batch worker and stream
    handler): each request's tokens are the eager engine's, however the
    threads interleave their captures, binds and steps."""
    cfg, sampling, model, p3, m3 = _parts(do_sample=True)
    q, n = (p3[::-1].copy(), m3[::-1].copy()) if keys == "one" else \
        _prompt(cfg, 2, 2)
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    ref = eager_graphs(GenerationEngine(cfg, model, sampling, bucket=32,
                                        device="cpu"))
    out, errors = {}, []

    def batch(i):
        # a copy: on the CPU generate's tokens view the state's buffer,
        # here the workspace, which the next request of the key refills
        out["batch", i] = eng.generate(p3, m3, STEPS, seed=i).tokens.copy()

    def stream(i):
        *_, last = eng.generate_stream(q, n, STEPS, seed=i,
                                       boundaries=[9, 17])
        out["stream", i] = last.tokens

    def loop(fn):
        try:
            for i in range(3):
                fn(i)
        except Exception as e:          # pragma: no cover - reported below
            errors.append(e)
    c0 = _counters()
    threads = [threading.Thread(target=loop, args=(f,))
               for f in (batch, stream)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    replayed, _, captures = _counters() - c0
    assert replayed > 0 and captures >= 1
    for i in range(3):
        np.testing.assert_array_equal(
            out["batch", i], ref.generate(p3, m3, STEPS, seed=i).tokens)
        np.testing.assert_array_equal(
            out["stream", i], ref.generate(q, n, STEPS, seed=i).tokens)


def test_cpu_steps_count_eager():
    """On the CPU every step is eager, and the registry counts it."""
    cfg, sampling, model, prompt, mask = _parts()
    eng = GenerationEngine(cfg, model, sampling, bucket=32, device="cpu")
    c0 = _counters()
    res = eng.generate(prompt, mask, 12, seed=0)
    assert res.steps == 12 and eng._graphs.kept is None
    assert list(_counters() - c0) == [0, 12, 0]

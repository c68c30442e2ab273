"""The port's continuous slot pool (``moss_ttsd_torch/decode/continuous.py``)
against the JAX pool and against the port's own static engine, on the same
weights (tiny config, fp32 weights and cache, CPU).

Against JAX: for the same staggered schedule the port's pool gives the JAX
pool's greedy tokens and step counts, identical, for the plain pool, the
int8 KV pool and a pool of mixed LoRA adapters. The port's own contracts
(the cases of the JAX ``tests/test_continuous.py``, all but the mesh one):
a pool row equals the port's isolated batch-1 ``generate``, greedy and
sampled with the same seed; slot reuse clears the old occupant's
key_valid and adapter; ``submit_many`` equals sequential ``submit``;
``collect_async`` survives a splice into the freed slot; the per-row
extents equal whole-cache reads; the refusals come before any device
work."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.decode.continuous import ContinuousBatcher as JBatcher  # noqa: E402
from moss_ttsd_tpu.pipeline.prompt import left_pad_batch  # noqa: E402
from moss_ttsd_torch.core.config import (ChannelSamplingConfig,  # noqa: E402
                                         SamplingConfig)
from moss_ttsd_torch.decode.continuous import ContinuousBatcher  # noqa: E402
from moss_ttsd_torch.decode.engine import GenerationEngine  # noqa: E402
from tests.test_decode import make_prompt  # noqa: E402
from tests.test_torch_engine import JAX_S, TORCH_S, greedy  # noqa: E402
from tests.test_torch_lm import jax_tiny, port_model  # noqa: E402

BASE = 24


@pytest.fixture(scope="module")
def models():
    jcfg, params = jax_tiny(7)
    cfg, model = port_model(jcfg, params)
    return jcfg, params, cfg, model


def rand_adapter(cfg, seed, rank=4, layers=None):
    """A flat factor tree over all seven projections with random a AND b
    (the usual zero b would make the adapter a no-op)."""
    rng = np.random.default_rng(seed)
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    dims = {"q_proj": (hid, H * D), "k_proj": (hid, Hkv * D),
            "v_proj": (hid, Hkv * D), "o_proj": (H * D, hid),
            "gate_proj": (hid, inter), "up_proj": (hid, inter),
            "down_proj": (inter, hid)}
    L = layers or cfg.num_hidden_layers
    return {f"params/layers/block/{t}/kernel": {
        "a": (rng.standard_normal((L, fi, rank)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal((L, rank, fo)) * 0.3).astype(np.float32)}
        for t, (fi, fo) in dims.items()}


def merged(model, tree, alpha=8.0):
    """A copy of ``model`` with the adapter merged into its weights, W +
    scale * (a @ b)^T per layer (the reference's merge_and_unload)."""
    import copy
    from moss_ttsd_torch.utils.convert_lora import lora_scale
    out = copy.deepcopy(model)
    with torch.no_grad():
        for key, ab in tree.items():
            t = key.split("/")[-2]
            a, b = ab["a"], ab["b"]
            sc = lora_scale(a.shape[-1], alpha, True)
            for li, layer in enumerate(out.layers):
                w = getattr(layer, t).weight
                w += torch.from_numpy((a[li] @ b[li]).T * sc)
    return out


def pool(cfg, model, slots=3, max_steps=32, sampling=None, **kw):
    return ContinuousBatcher(cfg, model, sampling or greedy(TORCH_S),
                             slots=slots, base=BASE, max_steps=max_steps,
                             device="cpu", **kw)


def jpool(jcfg, params, slots=3, max_steps=32, **kw):
    return JBatcher(jcfg, params, greedy(JAX_S), slots=slots, base=BASE,
                    max_steps=max_steps, cache_dtype=jnp.float32, **kw)


def isolated(cfg, model, prompt, steps, seed=0, sampling=None, adapter=None,
             adapters=(), step_bucket=32, **kw):
    """The port's static engine at the pool's prompt bucket and capacity."""
    batch, mask = left_pad_batch([prompt], cfg.pad_token_id,
                                 cfg.speech_pad_token)
    eng = GenerationEngine(cfg, model, sampling or greedy(TORCH_S),
                           bucket=BASE + cfg.channels - 1,
                           step_bucket=step_bucket, device="cpu", **kw)
    for name, tree in adapters:
        eng.register_adapter(name, tree, alpha=8.0)
    return eng.generate(batch, mask, max_new_tokens=steps, seed=seed,
                        adapter=adapter)


def drive(cb, schedule, seg=4, rounds=16):
    """Submit (prompt, budget, seed, adapter) requests at the pool steps of
    ``schedule`` [(steps to run first, request), ...], then run segments
    of ``seg`` until all finish. Returns the collected results in order."""
    slots = []
    for pre, req in schedule:
        if pre:
            cb.run(steps=pre)
        slots.append(cb.submit(req[0], max_new_tokens=req[1], seed=req[2],
                               adapter=req[3]))
    for _ in range(rounds):
        cb.run(steps=seg)
        if len(cb.finished()) == len(slots):
            break
    assert sorted(cb.finished()) == sorted(slots)
    return [cb.collect(s) for s in slots]


def _schedule(jcfg, seed, adapters=(None, None, None)):
    rng = np.random.default_rng(seed)
    prompts = [make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 9, 2),
               make_prompt(jcfg, rng, 4, 7)]
    budgets = [20, 14, 18]
    pre = [0, 5, 3]
    return [(p0, (p, b, 0, a)) for p0, p, b, a in zip(pre, prompts, budgets,
                                                       adapters)]


def _assert_same(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.steps == e.steps
        np.testing.assert_array_equal(g.tokens[0, g.base:],
                                      e.tokens[0, e.base:])


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_staggered_pool_matches_jax_pool(models, kv_quant):
    """Three requests joining at pool steps 0, 5 and 8: the port's pool
    gives the JAX pool's greedy tokens, identical (the fp32 cache, or the
    int8 KV cache with its ring-gated scale writes)."""
    jcfg, params, cfg, model = models
    sched = _schedule(jcfg, 0)
    got = drive(pool(cfg, model, kv_quant=kv_quant), sched)
    ref = drive(jpool(jcfg, params, kv_quant=kv_quant), sched)
    _assert_same(got, ref)
    # and each row is the port's isolated batch-1 run with the same cache
    _assert_same(got, [isolated(cfg, model, r[0], r[1], kv_quant=kv_quant)
                       for _, r in sched])


def test_mixed_adapter_pool_matches_jax_pool(models):
    """Base, adapter v1 and adapter v2 rows decode in one pool (staggered
    joins, rank 4 and rank 2): identical to the JAX pool with the same
    registrations, and each row to the port's isolated run with its
    adapter."""
    jcfg, params, cfg, model = models
    ad1, ad2 = rand_adapter(cfg, 1, rank=4), rand_adapter(cfg, 2, rank=2)
    sched = _schedule(jcfg, 21, adapters=(None, "v1", "v2"))
    cb, jcb = pool(cfg, model), jpool(jcfg, params)
    for c in (cb, jcb):
        c.register_adapter("v1", ad1, alpha=8.0)
        c.register_adapter("v2", ad2, alpha=8.0)
    got = drive(cb, sched)
    _assert_same(got, drive(jcb, sched))
    iso = [isolated(cfg, model, r[0], r[1], adapter=r[3],
                    adapters=[("v1", ad1), ("v2", ad2)]) for _, r in sched]
    _assert_same(got, iso)
    plain = isolated(cfg, model, sched[1][1][0], sched[1][1][1])
    assert not (plain.steps == got[1].steps and np.array_equal(
        plain.tokens[0, plain.base:], got[1].tokens[0, got[1].base:])), \
        "adapter v1 is a no-op"
    # the v1 row is the base model with v1 merged into its weights
    _assert_same([got[1]], [isolated(cfg, merged(model, ad1),
                                     sched[1][1][0], sched[1][1][1])])


def test_int8_weights_adapter_pool_matches_int8_engine(models):
    """Adapters over a w8a16 pool: a row with an adapter equals the int8
    static engine with the same adapter registered."""
    jcfg, params, cfg, model = models
    ad1 = rand_adapter(cfg, 19)
    rng = np.random.default_rng(41)
    pa, pb = make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 8, 2)
    cb = pool(cfg, model, slots=2, quant="int8")
    cb.register_adapter("v1", ad1, alpha=8.0)
    got = drive(cb, [(0, (pa, 12, 0, "v1")), (3, (pb, 10, 0, None))])
    _assert_same(got, [
        isolated(cfg, model, pa, 12, adapter="v1", adapters=[("v1", ad1)],
                 quant="int8"),
        isolated(cfg, model, pb, 10, quant="int8")])


def _sampling(n=16):
    return SamplingConfig(
        channels=[ChannelSamplingConfig(do_sample=True, temperature=0.9,
                                        top_k=8, top_p=0.9)
                  for _ in range(8)], max_new_tokens=n)


def test_sampled_rows_equal_isolated_generate(models):
    """A SAMPLED request joined into a busy pool draws, token for token,
    what an isolated batch-1 generate with its seed draws; mixed with a
    greedy-budget row and an adapter row."""
    jcfg, params, cfg, model = models
    ad1 = rand_adapter(cfg, 5)
    rng = np.random.default_rng(7)
    prompts = [make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 8, 3),
               make_prompt(jcfg, rng, 5, 5)]
    sampling = _sampling()
    cb = pool(cfg, model, sampling=sampling)
    cb.register_adapter("v1", ad1, alpha=8.0)
    got = drive(cb, [(0, (prompts[0], 14, 123, None)),
                     (4, (prompts[1], 10, 7, "v1")),
                     (2, (prompts[2], 12, 99, None))])
    exp = [isolated(cfg, model, prompts[0], 14, 123, sampling),
           isolated(cfg, model, prompts[1], 10, 7, sampling, "v1",
                    [("v1", ad1)]),
           isolated(cfg, model, prompts[2], 12, 99, sampling)]
    _assert_same(got, exp)


def test_submit_many_matches_sequential(models):
    """A burst through one batched prefill (3 rows padded to 4, one row
    through an adapter) gives the tokens of one-by-one submits, greedy and
    sampled."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(13)
    prompts = [make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 9, 2),
               make_prompt(jcfg, rng, 4, 7)]
    budgets, seeds, rows = [20, 14, 18], [3, 4, 5], [None, "v1", None]
    ad1 = rand_adapter(cfg, 7)
    for sampling in (None, _sampling(24)):
        cb, seq = (pool(cfg, model, slots=4, sampling=sampling)
                   for _ in range(2))
        for c in (cb, seq):
            c.register_adapter("v1", ad1, alpha=8.0)
        slots = cb.submit_many(list(zip(prompts, budgets, seeds, rows)))
        assert len(slots) == 3 and cb.free_slots == 1
        for _ in range(12):
            cb.run(steps=4)
            if len(cb.finished()) == 3:
                break
        burst = [cb.collect(s) for s in slots]
        _assert_same(burst, drive(seq, [(0, r) for r in zip(
            prompts, budgets, seeds, rows)]))


def test_submit_many_burst_into_running_pool(models):
    """A burst joins a pool with a live row mid-decode without disturbing
    it; burst validation failures leave the pool untouched."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(14)
    p0 = make_prompt(jcfg, rng, 6, 4)
    pa, pb = make_prompt(jcfg, rng, 9, 2), make_prompt(jcfg, rng, 4, 7)
    cb = pool(cfg, model)
    s0 = cb.submit(p0, max_new_tokens=20)
    cb.run(steps=5)
    with pytest.raises(ValueError):               # burst > free slots
        cb.submit_many([(pa, 12, 0), (pb, 16, 0), (p0, 20, 0)])
    with pytest.raises(ValueError):               # over-capacity budget
        cb.submit_many([(pa, 12, 0), (pb, 999, 0)])
    with pytest.raises(ValueError, match="unknown adapter"):
        cb.submit_many([(pa, 12, 0, "nope")])
    assert cb.free_slots == 2
    sa, sb = cb.submit_many([(pa, 12, 0), (pb, 16, 0)])
    for _ in range(12):
        cb.run(steps=4)
        if len(cb.finished()) == 3:
            break
    got = [cb.collect(s) for s in (s0, sa, sb)]
    _assert_same(got, [isolated(cfg, model, p, b)
                       for p, b in ((p0, 20), (pa, 12), (pb, 16))])


def test_slot_reuse_clears_key_valid_and_adapter(models):
    """A slot freed by an adapter request with a long history serves a base
    request cleanly: the old occupant's valid bits and adapter are gone."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(23)
    p1, p2 = make_prompt(jcfg, rng, 5, 3), make_prompt(jcfg, rng, 8, 1)
    cb = pool(cfg, model, slots=1)
    cb.register_adapter("v1", rand_adapter(cfg, 9), alpha=8.0)
    slot = cb.submit(p1, max_new_tokens=20, adapter="v1")
    assert cb.submit(p2) is None                  # pool full
    cb.run(steps=24)
    assert cb.finished() == [slot]
    cb.collect(slot)
    slot2 = cb.submit(p2, max_new_tokens=12)
    assert slot2 == slot
    st = cb.state
    assert int(st.adapter_r[slot]) == 0
    assert not bool(st.key_valid[slot, BASE:].any())
    cb.run(steps=16)
    _assert_same([cb.collect(slot2)], [isolated(cfg, model, p2, 12)])


def test_shared_registry_and_base_rows_skip_adapter_work(models):
    """A pool built on an engine's registry serves the voices registered
    there (one copy of the stacks, registered once, also after the pool
    was made) and gives that engine's tokens; while every occupied slot is
    on the base model the step gets no adapter operands; a registry of
    another dtype is refused."""
    from moss_ttsd_torch.decode.lora_registry import LoraRegistry
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(29)
    p1, p2 = make_prompt(jcfg, rng, 5, 3), make_prompt(jcfg, rng, 7, 2)
    eng = GenerationEngine(cfg, model, greedy(TORCH_S), device="cpu")
    cb = pool(cfg, model, slots=2, lora=eng.lora)
    eng.register_adapter("v1", rand_adapter(cfg, 9), alpha=8.0)
    assert cb.lora is eng.lora and cb.engine.lora is eng.lora
    s1 = cb.submit(p1, max_new_tokens=12)
    assert cb._row_adapters() is None             # base rows only
    s2 = cb.submit(p2, max_new_tokens=12, adapter="v1")
    assert cb._row_adapters() is not None
    cb.run(steps=16)
    got = [cb.collect(s1), cb.collect(s2)]
    _assert_same(got, [isolated(cfg, model, p1, 12),
                       isolated(cfg, model, p2, 12, adapter="v1",
                                adapters=[("v1", rand_adapter(cfg, 9))])])
    s3 = cb.submit(p1, max_new_tokens=4)          # into a voiced row's slot
    assert cb._row_adapters() is None
    cb.release(s3)
    assert eng._adapter_operands([None, ""], 2) is None
    assert eng._adapter_operands([None, "v1"], 2) is not None
    with pytest.raises(ValueError, match="does not match the pool"):
        pool(cfg, model, lora=LoraRegistry(torch.bfloat16,
                                           cfg.num_hidden_layers))


def test_budget_freeze_does_not_corrupt_neighbours(models):
    """A row frozen at its budget leaves its neighbour unaffected and its
    own buffer intact across further segments."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(2)
    pa, pb = make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 9, 2)
    cb = pool(cfg, model, slots=2)
    sa = cb.submit(pa, max_new_tokens=4)
    sb = cb.submit(pb, max_new_tokens=20)
    cb.run(steps=6)
    assert sa in cb.finished()
    snap = cb.state.tokens[sa].clone()
    cb.run(steps=30)
    assert torch.equal(cb.state.tokens[sa], snap)
    _assert_same([cb.collect(sa), cb.collect(sb)],
                 [isolated(cfg, model, pa, 4), isolated(cfg, model, pb, 20)])


def test_collect_async_survives_splice_into_freed_slot(models):
    """collect_async frees the slot at once; its tokens are a copy, so a
    splice into the same slot does not overwrite them."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(5)
    pa, pb = make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 9, 2)
    cb = pool(cfg, model, slots=1)
    sa = cb.submit(pa, max_new_tokens=6)
    cb.run(steps=8)
    (slot, steps), = cb.poll()
    assert slot == sa and steps == 6
    steps_a, tokens_a = cb.collect_async(sa, steps)
    assert cb.submit(pb, max_new_tokens=6) == sa
    cb.run(steps=8)
    (slot_b, steps_b), = cb.poll()
    res_b = cb.collect(slot_b, steps_b)
    exp_a, exp_b = isolated(cfg, model, pa, 6), isolated(cfg, model, pb, 6)
    _assert_same([type(exp_a)(tokens=tokens_a.numpy()[None], steps=steps_a,
                              base=BASE), res_b], [exp_a, exp_b])


def test_progress_and_peek_tokens_follow_live_rows(models):
    """progress lists every live row with its steps; peek_tokens reads a
    live row's written prefix from a row offset, equal to what collect
    returns later."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(6)
    pa, pb = make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 7, 3)
    cb = pool(cfg, model, slots=2)
    sa = cb.submit(pa, max_new_tokens=6)
    cb.run(steps=3)
    sb = cb.submit(pb, max_new_tokens=16)
    cb.run(steps=4)
    prog = dict((s, (n, f)) for s, n, f in cb.progress())
    assert prog == {sa: (6, True), sb: (4, False)}
    head = cb.peek_tokens([sb], [4], frm=0)[0]
    tail = cb.peek_tokens([sb], [4], frm=BASE + 2)[0]
    np.testing.assert_array_equal(head[BASE + 2:], tail)
    cb.collect(sa)
    cb.run(steps=16)
    res = cb.collect(sb)
    np.testing.assert_array_equal(res.tokens[0, :BASE + 4], head)


def test_pool_extent_matches_full_reads(models):
    """Each row's extent (its last valid slot + 1) reads the same as whole
    -cache reads, across staggered joins, a mid-run collect (stale valid
    bits past the extent) and a ring that wraps."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(11)
    prompts = [make_prompt(jcfg, rng, 6, 4), make_prompt(jcfg, rng, 9, 2),
               make_prompt(jcfg, rng, 4, 7)]

    def run(len_aware):
        cb = pool(cfg, model, slots=2, max_steps=20, len_aware=len_aware)
        s0 = cb.submit(prompts[0], max_new_tokens=18)
        cb.run(steps=5)
        s1 = cb.submit(prompts[1], max_new_tokens=12)
        cb.run(steps=12)
        out = {1: cb.collect(s1)}
        s2 = cb.submit(prompts[2], max_new_tokens=16)
        for _ in range(12):
            cb.run(steps=4)
            if len(cb.finished()) == 2:
                break
        out[0], out[2] = cb.collect(s0), cb.collect(s2)
        return [out[i] for i in range(3)]

    _assert_same(run(True), run(False))


def test_pool_honours_max_length_like_static_engine(models):
    """With sampling.max_length and no explicit budget the pool counts the
    step budget as the static engine does."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(8)
    prompt = make_prompt(jcfg, rng, 6, 4)
    counted = len(prompt) - cfg.channels + 1
    sampling = greedy(TORCH_S, 100, max_length=counted + 3)
    batch, mask = left_pad_batch([prompt], cfg.pad_token_id,
                                 cfg.speech_pad_token)
    ref = GenerationEngine(cfg, model, sampling,
                           bucket=BASE + cfg.channels - 1, step_bucket=16,
                           device="cpu").generate(batch, mask, seed=0)
    cb = pool(cfg, model, slots=1, max_steps=16, sampling=sampling)
    s0 = cb.submit(prompt)
    cb.run(steps=8)
    got = cb.collect(s0)
    assert ref.steps <= 3
    _assert_same([got], [ref])


def test_fuzz_random_schedule_matches_isolated(models):
    """A random join/leave schedule over a 3-slot pool (segments of 1-6
    steps, the ring wrapping many times): every request equals its
    isolated run."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(42)
    cb = pool(cfg, model, slots=3, max_steps=16)
    queue = [(i, make_prompt(jcfg, rng, int(rng.integers(3, 10)),
                             int(rng.integers(1, 6))),
              int(rng.integers(4, 17))) for i in range(8)]
    live, done, guard = {}, 0, 0
    while done < 8:
        guard += 1
        assert guard < 200
        while queue and cb.free_slots and rng.random() < 0.8:
            i, p, b = queue.pop(0)
            live[cb.submit(p, max_new_tokens=b)] = (i, p, b)
        if not live:
            continue
        cb.run(steps=int(rng.integers(1, 7)))
        for slot, steps in cb.poll():
            i, p, b = live.pop(slot)
            _assert_same([cb.collect(slot, steps)],
                         [isolated(cfg, model, p, b, step_bucket=16)])
            done += 1


def test_refusals_come_before_device_work(models):
    """Oversized prompt, over-capacity and zero budgets, an unknown
    adapter: ValueError, the pool untouched; the config default clamps;
    a mesh that does not fit the process group is refused."""
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(3)
    cb = pool(cfg, model, slots=1, max_steps=16)
    p = make_prompt(jcfg, rng, 5, 3)
    with pytest.raises(ValueError, match="exceeds the pool bucket"):
        cb.submit(make_prompt(jcfg, rng, BASE + 10, 4))
    with pytest.raises(ValueError, match="per-slot capacity"):
        cb.submit(p, max_new_tokens=17)
    with pytest.raises(ValueError, match="must be >= 1"):
        cb.submit(p, max_new_tokens=0)
    with pytest.raises(ValueError, match="unknown adapter"):
        cb.submit(p, max_new_tokens=4, adapter="nope")
    assert cb.free_slots == 1 and not bool(cb.state.active.any())
    assert cb.submit(p) is not None               # default budget clamps
    from moss_ttsd_torch.parallel.mesh import parse_mesh_arg
    with pytest.raises(ValueError, match="needs 2 processes"):
        pool(cfg, model, mesh=parse_mesh_arg("1x2", device_type="cpu"))
    with pytest.raises(ValueError, match="channels-1"):
        pool(cfg, model, max_steps=cfg.channels - 2)


# -- the bench-only ablate knob and the dense backend -------------------------

ABLATE_ORDER = ("sampling", "logits", "tf_flush", "tokenwrite", "presence",
                "extentcalc")


@pytest.mark.parametrize("n", range(len(ABLATE_ORDER) + 1),
                         ids=["full", *ABLATE_ORDER])
def test_ablated_pool_state_matches_jax_segment(models, n):
    """bench_full's seven cumulative variants (the first n components
    stubbed): from the same admitted state (three requests, one burst),
    greedy, the port's pool after 6 steps holds the state of JAX's
    ``_build_segment_fn(ablate=...)``: tokens, needs, unfinished, presence
    and step_r equal."""
    import jax
    from moss_ttsd_tpu.decode.continuous import _build_segment_fn
    jcfg, params, cfg, model = models
    abl = frozenset(ABLATE_ORDER[:n])
    reqs = [r for _, r in _schedule(jcfg, 5)]
    cb = pool(cfg, model, ablate=abl)
    jcb = jpool(jcfg, params)
    for c in (cb, jcb):
        c.submit_many(reqs)
    cb.run(steps=6)
    seg = jax.jit(_build_segment_fn(jcb.model, jcb.cfg, jcb.sampling, BASE,
                                    32, ablate=abl))
    st = seg(jcb.params, jcb.state, jnp.int32(6), jcb.lora.stacks)
    for name in ("tokens", "needs", "unfinished", "presence_text",
                 "presence_speech", "step_r"):
        np.testing.assert_array_equal(getattr(cb.state, name).numpy(),
                                      np.asarray(getattr(st, name)),
                                      err_msg=name)
    assert int(cb.state.step_r.max()) == 6


def test_pool_refuses_unknown_ablate_component(models):
    cfg, model = models[2], models[3]
    with pytest.raises(ValueError, match="unknown pool components"):
        pool(cfg, model, ablate={"sampling", "attention"})


@pytest.mark.parametrize("len_aware", [True, False])
def test_xla_pool_matches_jax_pool(models, len_aware):
    """The pool under attn_impl="xla": with per-row extents it still reads
    through the decode kernels (their plain versions here), without them
    it attends densely over the whole cache; both give the JAX xla pool's
    greedy tokens."""
    import dataclasses
    jcfg, params, cfg, model = models
    sched = _schedule(jcfg, 1)
    got = drive(pool(dataclasses.replace(cfg, attn_impl="xla"), model,
                     len_aware=len_aware), sched)
    ref = drive(jpool(dataclasses.replace(jcfg, attn_impl="xla"), params,
                      len_aware=len_aware), sched)
    _assert_same(got, ref)

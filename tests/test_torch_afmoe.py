"""The port's AFMoE block (``LMConfig.block_type == "afmoe"``: routed
experts, windowed and full attention, untied heads, muP) against the plain
reference ``tests/torch_afmoe_ref.py``, on the CPU at a small size (hidden
64, 8 experts of 32, top 2, window 8, 6 layers of which 2 dense), float32
on both sides; the windowed plain attentions against a masked dense one;
and the paths that do not run the block refusing it.

The ``cuda``-marked tests hold the expert kernels (decode and grouped
GEMM) and the windowed B1 / B2 against their plain versions at the
``afmoe-longform-b16`` cell's shapes, and the captured decode step against
the eager one; they skip
without a card (``python -m pytest tests/test_torch_afmoe.py -m cuda
--noconftest`` on it)."""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from moss_ttsd_torch.core.config import (ChannelSamplingConfig, LMConfig,
                                         SamplingConfig)
from moss_ttsd_torch.decode.engine import GenerationEngine
from moss_ttsd_torch.models import lm
from moss_ttsd_torch.models.lm import AsteroidLM, MoE, init_cache
from moss_ttsd_torch.ops import flash_attention as fa
from moss_ttsd_torch.ops import moe as pmoe
from moss_ttsd_torch.utils.profiling import metrics

from torch_afmoe_ref import AFMoERef, strict_fp32

PERIOD = ("sliding_attention",) * 3 + ("full_attention",)
# fp32 on both sides: they differ only in the order of their sums (a cached
# decode against a full forward, the experts' tokens grouped against one
# expert at a time), a few ulp a product over 6 layers
TOL = dict(rtol=1e-4, atol=1e-4)


def tiny_afmoe(**over) -> LMConfig:
    small = dict(
        block_type="afmoe", num_hidden_layers=6, layer_types=(PERIOD * 2)[:6],
        sliding_window=8, num_dense_layers=2, num_experts=8,
        router_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
        num_shared_experts=1, route_scale=2.826, route_norm=True,
        mup_enabled=True, tie_word_embeddings=False, rms_norm_eps=1e-5,
        rope_theta=10000.0, dtype="float32", param_dtype="float32",
        speech_token_range=(0, 160))
    small.update(over)
    return LMConfig().tiny(**small)


def greedy(cfg) -> SamplingConfig:
    return SamplingConfig(channels=[ChannelSamplingConfig(do_sample=False)
                                    for _ in range(cfg.channels)])


def _ids(cfg, rows, T, seed):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.speech_vocab_size, (rows, T, cfg.channels),
                        generator=g)
    ids[..., 0] = torch.randint(0, cfg.vocab_size, (rows, T), generator=g)
    return ids


@pytest.fixture(autouse=True)
def _fp32():
    strict_fp32()


# -- the model against the reference ------------------------------------------

def test_prefill_then_decode_past_the_window_matches_the_reference(
        monkeypatch):
    """Two rows (one left-padded by 3) prefilled through the cache, then
    decoded one token at a time to 3 windows past the prompt, the write
    slot a host int and a device tensor in turn: every position's logits
    equal the reference's full forward of the unpadded row, and every MoE
    layer chose the reference's experts at every position."""
    cfg = tiny_afmoe()
    model = AsteroidLM.init_random(cfg, seed=3, device="cpu")
    ref = AFMoERef(cfg, model.state_dict())
    pads, T0, steps = (3, 0), 10, 16
    S = T0 + steps
    ids = _ids(cfg, 2, S, 5)
    valid = torch.ones(2, S, dtype=torch.bool)
    for b, p in enumerate(pads):
        valid[b, :p] = False
    seen = []
    orig = lm.route

    def record(*a, **k):
        idx, w = orig(*a, **k)
        seen.append(idx)
        return idx, w
    monkeypatch.setattr(lm, "route", record)
    cache = init_cache(cfg, 2, S, torch.float32, "cpu")
    kv = torch.zeros(2, S, dtype=torch.bool)
    kv[:, :T0] = valid[:, :T0]
    pos = (torch.cumsum(kv[:, :T0].long(), 1) - 1).clamp_min(0)
    hid, _ = model.backbone(ids[:, :T0], pos, kv, cache, 0)
    hs = [hid]
    last = pos[:, -1]
    for s in range(steps):
        slot = T0 + s
        kv[:, slot] = True
        last = last + 1
        cp = torch.tensor(slot) if s % 2 else slot
        h, _ = model.backbone(ids[:, slot:slot + 1], last[:, None], kv,
                              cache, cp)
        hs.append(h)
    hid = torch.cat(hs, 1)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers))
    assert len(seen) == n_moe * (1 + steps)
    for b, p in enumerate(pads):
        h_ref = ref.hidden(ids[b, p:])
        text, speech = model.logits_all(hid[b, p:])
        torch.testing.assert_close(text, ref.logits(h_ref, 0), **TOL)
        torch.testing.assert_close(speech[:, 3], ref.logits(h_ref, 4),
                                   **TOL)
        for j, chosen in enumerate(ref.chosen):
            port = [seen[j].reshape(2, T0, -1)[b, p:]]
            port += [seen[n_moe * (1 + s) + j].reshape(2, 1, -1)[b]
                     for s in range(steps)]
            port = torch.cat(port).sort(-1).values
            assert torch.equal(port, chosen.sort(-1).values), (b, j)


def test_engine_serves_the_reference_greedy_tokens_and_counts_experts():
    """``GenerationEngine.generate`` over the block (CPU, fp32, greedy):
    every sampled token is the reference's best under the decode loop's
    masks, past the window; the expert counters reach the registry at the
    readback (all experts are held here: every pair is held)."""
    cfg = tiny_afmoe()
    model = AsteroidLM.init_random(cfg, seed=4, device="cpu")
    ref = AFMoERef(cfg, model.state_dict())
    eng = GenerationEngine(cfg, model, greedy(cfg), bucket=16,
                           step_bucket=32, device="cpu")
    rng = np.random.default_rng(1)
    prompt = np.full((2, 12, 8), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (2, 12))
    mask = np.ones((2, 12), np.int64)
    mask[0, :3] = 0
    before = {n: metrics.get(n) for n in ("moe_pairs_held", "moe_calls",
                                          "moe_experts_read")}
    res = eng.generate(prompt, mask, 20)
    assert res.steps > cfg.channels + cfg.sliding_window
    C = cfg.channels
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers))
    bucket_pad = 16 - prompt.shape[1]
    for b in range(2):
        row = torch.as_tensor(res.tokens[b])
        seq = row[bucket_pad + int((mask[b] == 0).sum()):]
        T = seq.shape[0] - res.steps
        h = ref.hidden(seq)
        s = torch.arange(res.steps)
        eos = torch.nonzero(seq[T:, 0] == cfg.eos_token_id)
        upto = int(eos[0]) + 1 if eos.numel() else res.steps
        for c in range(C):
            lg = ref.logits(h[T - 1:-1], c)
            if c == 0:
                lg[s < C - 1, cfg.eos_token_id] = -math.inf
            else:
                lg[s >= c, cfg.speech_pad_token] = -math.inf
            sampled = ((s >= C - 1) | (c <= s)) & (s < upto)
            assert torch.equal(lg.argmax(-1)[sampled],
                               seq[T:, c][sampled]), (b, c)
    got = {n: metrics.get(n) - before[n] for n in before}
    assert got["moe_calls"] == n_moe * res.steps
    assert got["moe_pairs_held"] == 2 * cfg.num_experts_per_tok * \
        got["moe_calls"]
    assert 0 < got["moe_experts_read"] <= cfg.num_experts * got["moe_calls"]


def test_traced_expert_counters_cover_the_profiled_steps_only():
    """Steps run under a ``torch.profiler`` session (as a traced benchmark
    run profiles the first steps of its first batch) add their expert
    counts to ``moe_*_traced`` as well; steps before and after it do not,
    and the prefill counts nowhere."""
    cfg = tiny_afmoe()
    model = AsteroidLM.init_random(cfg, seed=4, device="cpu")
    eng = GenerationEngine(cfg, model, greedy(cfg), bucket=16,
                           step_bucket=32, device="cpu")
    prompt = np.full((2, 12, 8), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = np.random.default_rng(1).integers(1, 90, (2, 12))
    ids, m, base = eng._bucket_prompt(prompt, np.ones((2, 12), np.int64))
    gen = torch.Generator().manual_seed(1)
    st, _ = eng._decode_state(torch.as_tensor(ids), torch.as_tensor(m),
                              base, 32, gen)
    names = ("moe_pairs_held", "moe_experts_read", "moe_calls")
    traced = [f"{n}_traced" for n in names]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers))
    eng.run(st, base, 3, gen)
    before = {n: metrics.get(n) for n in traced}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.run(st, base, 8, gen)
    eng.run(st, base, 12, gen)
    assert st.step == 12
    got = {n: metrics.get(n) - before[n] for n in traced}
    assert got["moe_calls_traced"] == n_moe * 5
    assert got["moe_pairs_held_traced"] == 2 * cfg.num_experts_per_tok * \
        got["moe_calls_traced"]
    assert 0 < got["moe_experts_read_traced"] <= \
        cfg.num_experts * got["moe_calls_traced"]


def test_stream_serves_the_tokens_of_generate():
    """``generate_stream`` over the block, in segments, decodes the tokens
    of one ``generate`` call (one decode state, one generator)."""
    cfg = tiny_afmoe()
    model = AsteroidLM.init_random(cfg, seed=8, device="cpu")
    eng = GenerationEngine(cfg, model, greedy(cfg), bucket=16,
                           step_bucket=32, device="cpu")
    rng = np.random.default_rng(2)
    prompt = np.full((2, 10, 8), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (2, 10))
    mask = np.ones((2, 10), np.int64)
    want = eng.generate(prompt, mask, 24, seed=3)
    *_, last = eng.generate_stream(prompt, mask, 24, seed=3, chunk_steps=5)
    assert last.steps == want.steps
    np.testing.assert_array_equal(last.tokens, want.tokens)


def test_expert_bias_moves_the_choice_and_not_the_weights():
    """The bias chooses: the top-k of s + bias differs from that of s on
    some tokens (so a port that chose on s would fail the reference), and
    the weights are the chosen s's, normalised and scaled."""
    cfg = tiny_afmoe()
    model = AsteroidLM.init_random(cfg, seed=6, device="cpu")
    mlp = model.layers[cfg.num_dense_layers].mlp
    h = torch.randn(64, cfg.hidden_size)
    idx, w = pmoe.route(h, mlp.router.weight, mlp.expert_bias,
                        cfg.num_experts_per_tok, cfg.route_scale, True)
    plain, _ = pmoe.route(h, mlp.router.weight, torch.zeros_like(
        mlp.expert_bias), cfg.num_experts_per_tok, cfg.route_scale, True)
    assert not torch.equal(idx.sort(-1).values, plain.sort(-1).values)
    s = torch.sigmoid(h @ mlp.router.weight.t())
    sel = s.gather(-1, idx)
    torch.testing.assert_close(w, cfg.route_scale * sel
                               / sel.sum(-1, keepdim=True))
    from torch_afmoe_ref import route as ref_route
    r_idx, r_w = ref_route(cfg, h, mlp.router.weight, mlp.expert_bias)
    assert torch.equal(idx, r_idx)
    torch.testing.assert_close(w, r_w)


@pytest.mark.parametrize("shares", [2, 4])
def test_expert_shares_add_up_to_the_uncut_layer(shares):
    """Expert parallelism's identity: each share's layer (the port's ``MoE``
    holding experts [offset, offset + 8 / shares)) routes over all 8 and
    computes its own experts' part; the parts, with the shared expert
    counted once, add up to the uncut reference's layer, and each share
    equals the reference given that share."""
    cfg = tiny_afmoe()
    full = AsteroidLM.init_random(cfg, seed=7, device="cpu")
    li = cfg.num_dense_layers
    W = full.state_dict()
    h = torch.randn(1, 40, cfg.hidden_size)
    ref = AFMoERef(cfg, W)
    part, shared = ref.mlp(li, h[0])
    uncut = part + shared
    n = cfg.num_experts // shares
    total = torch.zeros_like(h[0])
    for i in range(shares):
        c = dataclasses.replace(cfg, num_experts=n, expert_offset=i * n)
        with torch.device("meta"):
            m = MoE(c)
        p = f"layers.{li}.mlp."
        m.load_state_dict({
            k[len(p):]: (v[i * n:(i + 1) * n] if k[len(p):] in (
                "gate_proj", "up_proj", "down_proj") else v)
            for k, v in W.items() if k.startswith(p)}, assign=True)
        out = m(h)[0]
        s_part, s_shared = AFMoERef(cfg, W, share=(i * n, n)).mlp(li, h[0])
        torch.testing.assert_close(out, s_part + s_shared, **TOL)
        total = total + (out - s_shared)
    torch.testing.assert_close(total + shared, uncut, **TOL)


def test_grouped_expert_plain_path_counts_on_the_device():
    """``moe_experts`` on the CPU (the plain path): a share's output equals
    the reference's, and the counters gain the held pairs, the distinct
    held experts and one call."""
    g = torch.Generator().manual_seed(2)
    N, H, I, E, k, off = 5, 16, 8, 3, 2, 2
    x = torch.randn(N, H, generator=g)
    idx = torch.tensor([[2, 0], [4, 3], [7, 2], [1, 0], [3, 2]])
    w = torch.rand(N, k, generator=g)
    gate, up = torch.randn(2, E, I, H, generator=g)
    down = torch.randn(E, H, I, generator=g)
    counts = torch.zeros(3, dtype=torch.int64)
    out = pmoe.moe_experts(x, idx, w, gate, up, down, off, counts)
    from torch_afmoe_ref import routed
    want = routed(None, x, idx, w, gate, up, down, off)
    torch.testing.assert_close(out, want, **TOL)
    assert counts.tolist() == [6, 3, 1]      # held: 2,4 | 4,3 | 2 | - | 3,2


# -- the window in B1 and B2's plain paths -------------------------------------

def _dense(q, k, v, see, scale):
    """Masked dense attention: q (B, T, H, D), k/v (B, S, Hkv, D), see (B,
    T, S)."""
    G = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    s = s.masked_fill(~see[:, None], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, -1))
    return torch.einsum("bhts,bshd->bthd", p, v)


@pytest.mark.parametrize("window", [1, 5, 32])
def test_windowed_prefill_and_decode_plain_match_masked_dense(window):
    """B1's and B2's plain versions with a window against a masked dense
    attention: prefill query i sees valid keys in (i - W, i]; a decode row
    the valid slots in [extent - W, extent), for an int extent, a (B,)
    tensor one, and the split-K arithmetic."""
    g = torch.Generator().manual_seed(window)
    B, T, H, Hkv, D = 2, 20, 4, 2, 16
    q = torch.randn(B, T, H, D, generator=g)
    k, v = torch.randn(2, B, T, Hkv, D, generator=g)
    valid = torch.ones(B, T, dtype=torch.bool)
    valid[0, :4] = False
    i = torch.arange(T)
    see = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    see = see[None] & valid[:, None, :]
    want = _dense(q, k, v, see, 0.25)
    for got in (fa.flash_prefill(q, k, v, valid, 0.25, window=window),
                fa.flash_prefill_plain(q, k, v, valid, 0.25,
                                       window=window)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    q1 = q[:, -1:]
    for ext in (13, torch.tensor([9, 20], dtype=torch.int32)):
        e = torch.as_tensor(ext).expand(B)
        slot = torch.arange(T)
        see1 = ((slot[None, :] < e[:, None])
                & (slot[None, :] >= e[:, None] - window) & valid)[:, None]
        want = _dense(q1, k, v, see1, 0.25)
        got = fa.flash_decode_hs(q1, kt, vt, valid, 0.25, extent=ext,
                                 window=window)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        got = fa.flash_decode_hs_split_plain(q1, kt, vt, valid, 0.25, ext,
                                             n_split=3, chunk=64 if T > 64
                                             else None, window=window)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_windowless_attention_is_unchanged():
    """Window 0 is the attention of before: the same plain outputs as a
    call that does not name it."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 9, 4, 16, generator=g)
    k = torch.randn(1, 9, 2, 16, generator=g)
    valid = torch.ones(1, 9, dtype=torch.bool)
    assert torch.equal(fa.flash_prefill(q, k, k, valid, 0.25),
                       fa.flash_prefill(q, k, k, valid, 0.25, window=0))
    kt = k.transpose(1, 2)
    assert torch.equal(fa.flash_decode_hs(q[:, :1], kt, kt, valid, 0.25, 6),
                       fa.flash_decode_hs(q[:, :1], kt, kt, valid, 0.25, 6,
                                          window=0))


def test_qwen3_config_dict_is_unchanged():
    """The AFMoE fields at their defaults stay out of a config's dict (the
    JAX package's dict, the checkpoints' config.json), and round-trip."""
    d = LMConfig().to_dict()
    assert not {"block_type", "layer_types", "num_experts",
                "mup_enabled"} & set(d)
    cfg = tiny_afmoe()
    assert LMConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict()["layer_types"] == list(cfg.layer_types)


# -- refusals --------------------------------------------------------------------

@pytest.fixture
def afmoe_model():
    cfg = tiny_afmoe()
    return cfg, AsteroidLM.init_random(cfg, seed=0, device="cpu")


def test_continuous_pool_refuses_the_block(afmoe_model):
    from moss_ttsd_torch.decode.continuous import ContinuousBatcher
    cfg, model = afmoe_model
    eng = GenerationEngine(cfg, model, greedy(cfg), device="cpu")
    with pytest.raises(ValueError, match="continuous pool.*AFMoE.*time "
                                         "order"):
        eng.make_pool(slots=2, base=16, max_steps=16)
    with pytest.raises(ValueError, match="continuous pool"):
        ContinuousBatcher(cfg, model, greedy(cfg), slots=2, base=16,
                          max_steps=16, device="cpu")


def test_int8_serving_refuses_the_block(afmoe_model):
    cfg, model = afmoe_model
    with pytest.raises(ValueError, match="int8 serving.*AFMoE"):
        GenerationEngine(cfg, model, greedy(cfg), device="cpu", quant="int8")
    with pytest.raises(ValueError, match="int8 KV cache.*AFMoE"):
        GenerationEngine(cfg, model, greedy(cfg), device="cpu",
                         kv_quant="int8")


def test_lora_refuses_the_block(afmoe_model):
    cfg, model = afmoe_model
    eng = GenerationEngine(cfg, model, greedy(cfg), device="cpu")
    with pytest.raises(ValueError, match="LoRA adapters.*AFMoE"):
        eng.register_adapter("v", {})
    with pytest.raises(ValueError, match="LoRA.*AFMoE"):
        dataclasses.replace(cfg, lora_rank=4)


def test_tensor_parallel_mesh_refuses_the_block(afmoe_model):
    from moss_ttsd_torch.parallel.mesh import Mesh
    cfg, _ = afmoe_model
    with pytest.raises(ValueError, match="tensor-parallel mesh.*AFMoE"):
        Mesh.tensor_parallel(SimpleNamespace(model=2), cfg)
    with pytest.raises(ValueError, match="tensor-parallel mesh.*AFMoE"):
        with torch.device("meta"):
            AsteroidLM(dataclasses.replace(cfg, tie_word_embeddings=True),
                       tp=object())


def test_training_step_refuses_the_block(afmoe_model):
    from moss_ttsd_torch.train import step
    cfg, model = afmoe_model
    opt = step.make_optimizer()
    with pytest.raises(ValueError, match="training step.*AFMoE"):
        step.make_train_step(cfg, opt)
    with pytest.raises(ValueError, match="training step.*AFMoE"):
        step.init_train_state(cfg, opt, model, device="cpu")
    with pytest.raises(ValueError, match="cache-free forward.*AFMoE"):
        model(_ids(cfg, 1, 4, 0))


def test_checkpoint_format_refuses_the_block(afmoe_model, tmp_path):
    """No AFMoE checkpoint format exists: the Qwen3-named reference
    format's export and load refuse the block."""
    from moss_ttsd_torch.utils import convert_lm
    cfg, model = afmoe_model
    with pytest.raises(ValueError, match="checkpoint format.*AFMoE"):
        convert_lm.export_asteroid_state_dict(model, cfg)
    with pytest.raises(ValueError, match="checkpoint format.*AFMoE"):
        convert_lm.load_asteroid_checkpoint(str(tmp_path), cfg)


def test_dense_backend_refuses_the_block(afmoe_model):
    cfg, model = afmoe_model
    with pytest.raises(ValueError, match='attn_impl="xla".*AFMoE'):
        GenerationEngine(cfg, model, greedy(cfg), device="cpu",
                         attn_impl="xla")


# -- on the card: the kernels at the cell's shapes -----------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 300, 10240])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_expert_kernel_matches_plain_at_the_cell_shapes(cuda, dtype, N):
    """Top 8 of 128, experts 0-63 held, hidden 2048, width 1024 (bf16, the
    cell's; fp32 too) over N tokens: a decode step's 16 (the decode
    kernel), the cell's prefill of 16 rows of 640 (the grouped GEMM) and
    300, against ``moe_experts_plain`` on the same device, with its
    counters, and no host sync. bf16: the products round act to bf16 on
    both sides, so they differ by the order of fp32 sums (and a rare bf16
    rounding of act one ulp apart): within 2^-7 of the output's scale."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(N)
    H, I, E, R, k = 2048, 1024, 64, 128, 8
    x = torch.randn(N, H, device=cuda, generator=g).to(dt)
    s = torch.rand(N, R, device=cuda, generator=g)
    idx = torch.topk(s, k, dim=-1).indices
    w = torch.rand(N, k, device=cuda, generator=g)
    gate, up = (torch.randn(E, I, H, device=cuda, generator=g)
                .mul_(H ** -0.5).to(dt) for _ in range(2))
    down = torch.randn(E, H, I, device=cuda, generator=g).mul_(
        I ** -0.5).to(dt)
    c_k = torch.zeros(3, dtype=torch.int64, device=cuda)
    c_p = torch.zeros(3, dtype=torch.int64, device=cuda)
    before = pmoe.moe_experts.launches
    pmoe.moe_experts(x[:1], idx[:1], w[:1], gate, up, down, 0)  # built
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pmoe.moe_experts(x, idx, w, gate, up, down, 0, c_k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = pmoe.moe_experts_plain(x, idx, w, gate, up, down, 0, c_p)
    torch.cuda.synchronize()
    assert pmoe.moe_experts.launches == before + 2
    assert c_k.tolist() == c_p.tolist()
    held = (idx < E)
    assert c_k[0] == held.sum() and c_k[2] == 1
    scale = float(want.float().abs().max())
    tol = (2 ** -7 if dt == torch.bfloat16 else 1e-5) * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    # a share from expert 64: the same pairs land on other experts
    got2 = pmoe.moe_experts(x, idx, w, gate, up, down, 64)
    want2 = pmoe.moe_experts_plain(x, idx, w, gate, up, down, 64)
    torch.testing.assert_close(got2.float(), want2.float(), rtol=0,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2048, 300])
def test_windowed_prefill_kernel_at_the_cell_shapes(cuda, window):
    """B1 at the cell's prefill (16 rows bucketed to 640, pads from the
    prompt lengths 200-600, 32 / 4 heads of 128, bf16) with the sliding
    layers' window (2048, wider than the prompt) and a narrower one,
    against the bf16-P plain version."""
    g = torch.Generator(device=cuda).manual_seed(window)
    B, T, H, Hkv, D = 16, 640, 32, 4, 128
    q = torch.randn(B, T, H, D, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(B, T, Hkv, D, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    lens = np.rint(200 + (np.arange(B) + 0.5) / B * 400).astype(int)
    valid = torch.zeros(B, T, dtype=torch.bool, device=cuda)
    for b, n in enumerate(lens):
        valid[b, T - n:] = True
    got = fa.flash_prefill(q, k, v, valid, D ** -0.5, window=window)
    want = fa.flash_prefill_plain(q, k, v, valid, D ** -0.5,
                                  out_dtype=torch.float32,
                                  p_dtype=torch.bfloat16, window=window)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [1500, 2048, 2600, 3300])
def test_windowed_decode_kernel_at_the_cell_shapes(cuda, ext):
    """B2 at the cell's decode (16 rows, 32 / 4 heads of 128, a 3700-slot
    bf16 cache) with the 2048 window, at extents below and past it, a
    per-row (B,) extent too, against the split plain version at the
    kernel's own plan."""
    g = torch.Generator(device=cuda).manual_seed(ext)
    B, S, H, Hkv, D, W = 16, 3700, 32, 4, 128, 2048
    q = torch.randn(B, 1, H, D, device=cuda, generator=g).bfloat16()
    kt, vt = (torch.randn(B, Hkv, S, D, device=cuda, generator=g).bfloat16()
              for _ in range(2))
    valid = torch.zeros(B, S, dtype=torch.bool, device=cuda)
    valid[:, 40:ext] = True
    valid[0, :200] = False
    plan = fa.decode_split_plan(B, Hkv, S, fa.sm_count(cuda))
    for e in (ext, torch.full((B,), ext, dtype=torch.int32, device=cuda)):
        got = fa.flash_decode_hs(q, kt, vt, valid, D ** -0.5, extent=e,
                                 window=W)
        want = fa.flash_decode_hs_split_plain(
            q, kt, vt, valid, D ** -0.5, e, n_split=plan[0], chunk=plan[1],
            out_dtype=torch.float32, p_dtype=torch.bfloat16, window=W)
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8,
                                   atol=2e-3)


@pytest.mark.cuda
def test_captured_afmoe_step_matches_eager(cuda):
    """The tiny block in bf16 on the card: the engine's captured decode
    steps (past the teacher-forcing window, 3 windows past the prompt)
    serve the eager engine's greedy tokens, and count as graph steps."""
    cfg = tiny_afmoe(dtype="bfloat16", param_dtype="bfloat16",
                     hidden_size=128, head_dim=64, num_attention_heads=4,
                     num_key_value_heads=1, moe_intermediate_size=64)
    model = AsteroidLM.init_random(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    prompt = np.full((3, 20, 8), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (3, 20))
    mask = np.ones((3, 20), np.int64)
    mask[1, :6] = 0
    out = []
    for graph in (True, False):
        eng = GenerationEngine(cfg, model, greedy(cfg), bucket=32,
                               step_bucket=32, device=cuda)
        if not graph:
            eng._graphable = lambda *a: False
        g0 = metrics.get("engine_graph_steps")
        res = eng.generate(prompt, mask, 30)
        out.append(res.tokens)
        if graph:
            assert metrics.get("engine_graph_steps") - g0 == res.steps - 7
    np.testing.assert_array_equal(out[0], out[1])

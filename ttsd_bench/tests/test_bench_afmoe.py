"""The ``asteroid-afmoe`` architecture in the harness, on the CPU at tiny
sizes: its interface, its spec against the port's state dict at the cell's
full size, its work counted by hand, its reference against the port's
tests' own (``tests/torch_afmoe_ref.py``), and whole tiny runs of the
``afmoe-longform-b16`` cell, sound and broken.

    python -m pytest ttsd_bench/tests -q
"""

from __future__ import annotations

import math

import pytest
import torch

from ttsd_bench import arch, faults, program, run, weights

from test_bench_harness import tiny_spec

AFMOE = "afmoe-longform-b16"


def tiny_afmoe_spec(**over) -> dict:
    """The AFMoE cell at a tiny size: 6 layers (2 dense, windows of 8 in
    the sliding ones), 4 experts held of the router's 8 from expert 2,
    top 2, the tiny codec and a short traffic."""
    spec = tiny_spec(AFMOE, **over)
    spec["cfg"].update(
        num_hidden_layers=6, sliding_window=8, num_dense_layers=2,
        layer_types=(["sliding_attention"] * 3 + ["full_attention"]) * 1
        + ["sliding_attention"] * 2,
        num_experts=4, router_experts=8, expert_offset=2,
        num_experts_per_tok=2, moe_intermediate_size=32)
    return spec


def _test_reference():
    """``tests/torch_afmoe_ref.py``, the port's tests' own reference."""
    import importlib.util
    path = run.ROOT / "tests" / "torch_afmoe_ref.py"
    spec = importlib.util.spec_from_file_location("torch_afmoe_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_asteroid_afmoe_has_the_whole_interface():
    cfg = run.load_cell(AFMOE)["cfg"]
    mod = arch.of(cfg)
    assert mod is arch.load("asteroid-afmoe")
    for name in arch.INTERFACE + ("moe_work",):
        assert callable(getattr(mod, name)) or name == "port_model", name
    assert mod.port_model == "moss_ttsd_torch.models.lm.AsteroidLM"
    assert mod.lora_targets(cfg) == {}
    assert cfg["num_experts"] == 64 and cfg["router_experts"] == 128
    assert len(cfg["layer_types"]) == cfg["num_hidden_layers"] == 32
    assert cfg["layer_types"].count("sliding_attention") == 24


def test_asteroid_afmoe_spec_is_the_port_state_dict():
    """At the cell's full size, on the meta device: every tensor of the
    port's ``AsteroidLM`` under its name and shape, 14.07 B parameters."""
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = run.load_cell(AFMOE)["cfg"]
    with torch.device("meta"):
        model = AsteroidLM(program.lm_config(cfg))
    port = sorted((n, tuple(t.shape)) for n, t in model.state_dict().items())
    spec = sorted(arch.of(cfg).lm_spec(cfg))
    assert port == spec
    assert sum(math.prod(s) for _, s in spec) == 14_073_767_680
    assert dict(spec)["layers.5.mlp.gate_proj"] == (64, 1024, 2048)
    assert dict(spec)["layers.5.mlp.router.weight"] == (128, 2048)


def test_asteroid_afmoe_work_counted_by_hand():
    """The counts at a small shape (4 layers, window 6 in 3 of them, 2
    heads of 4 on 1 kv head), each layer's keys clipped to its window."""
    a = arch.load("asteroid-afmoe")
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "num_hidden_layers": 4,
           "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
           "sliding_window": 6, "num_dense_layers": 1,
           "intermediate_size": 12, "moe_intermediate_size": 3,
           "num_experts": 2, "router_experts": 4, "num_experts_per_tok": 2,
           "num_shared_experts": 1, "vocab_size": 10, "channels": 3,
           "speech_vocab_size": 5}
    attn = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8 + 8 * 8           # q k v g o
    moe = 4 * 8 + 3 * 8 * 3 + (2 * 2 / 4) * 3 * 8 * 3      # router shared held
    p = a.lm_params(cfg)
    assert p["backbone"] == 4 * attn + 3 * 8 * 12 + 3 * moe
    assert p["heads"] == (10 + 2 * 5) * 8
    # a row of 10 keys: 6 in each sliding layer, 10 in the full one
    assert a.decode_flops(cfg, [10]) == (2 * (p["backbone"] + p["heads"])
                                         + 4 * 2 * 4 * (3 * 6 + 10))
    w = a.decode_attention_work(cfg, [10, 3], 2, 2)
    assert w["bytes"] == 2 * 2 * 8 * 2 + (3 * (6 + 3) + 13) / 4 * (
        2 * 4 * 2 + 1)
    assert w["flops"] == 4 * 2 * 4 * (3 * 9 + 13) / 4
    b1 = a.b1_work(cfg, [10, 4])
    # sliding: 6^2/2 + 4 * 6 pairs for 10 tokens, 8 for 4; full 50 and 8
    assert b1["flops"] == 4 * 2 * 4 * (3 * (18 + 24 + 8) + (50 + 8)) / 4
    assert b1["bytes"] == 14 * (2 * 8 + 2 * 4) * 2 + 14
    m = a.moe_work(cfg, 5, 2)
    assert m == {"flops": 2.0 * 72 * 5, "bytes": 2 * 72 * 2 + 5 * 2 * 8 * 2}


def test_harness_afmoe_reference_matches_the_tests_reference():
    """``reference/afmoe.py`` (bf16 tensors kept, cast per use, attention
    in blocks of queries) against ``tests/torch_afmoe_ref.py`` (float32
    throughout) on one seed's weights, a row longer than the query block
    and three windows: float32 on both sides, the same sums in blocks."""
    from ttsd_bench.reference import afmoe as rafmoe
    cfg = tiny_afmoe_spec()["cfg"]
    a = arch.of(cfg)
    W = weights.make(a.lm_spec(cfg), a.lm_rule, 2 ** 31 + 3,
                     weights.GROUPS["lm"], "cpu", torch.bfloat16)
    ids = torch.randint(0, 33, (40, 8), generator=torch.Generator()
                        .manual_seed(1))
    ids[:, 0] = torch.randint(0, 160, (40,))
    old = rafmoe.QUERY_BLOCK
    rafmoe.QUERY_BLOCK = 16
    try:
        ref = a.reference(cfg, W)
        h = ref.hidden(ids, 30)
    finally:
        rafmoe.QUERY_BLOCK = old
    theirs = _test_reference().AFMoERef(program.lm_config(cfg), W)
    h2 = theirs.hidden(ids)
    torch.testing.assert_close(h, h2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ref.logits(h, 0), theirs.logits(h2, 0),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ref.logits(h, 5), theirs.logits(h2, 5),
                               rtol=1e-4, atol=1e-4)
    # a control quantizes the router and experts too: another model
    fp8 = a.reference(cfg, W, "fp8", torch.bfloat16).hidden(ids, 30)
    assert float((fp8.float() - h).abs().max()) > 1e-3


def test_afmoe_run_is_correct_and_counts_its_experts():
    """A whole tiny run of the AFMoE cell on the CPU, traced: ``correct``
    (the share of experts 2-5 on both sides), and the expert counters
    published by the program: those of the traced steps alone too, the 4
    expert layers of each of the 3 traced steps."""
    from moss_ttsd_torch.utils.profiling import metrics
    before = metrics.get("moe_calls")
    traced = metrics.get("moe_calls_traced")
    out = run.execute(tiny_afmoe_spec(trace_steps=3), 2 ** 31 + 91, 0.5,
                      True, device="cpu")
    assert out["correct"], out["compared"]
    assert metrics.get("moe_calls") > before
    assert metrics.get("moe_calls_traced") - traced == 4 * 3
    assert "decode_step_ms.batch" in out["metrics"]
    # no kernel runs on the CPU: the device-trace readers find nothing
    assert "moe_roofline.batch" not in out["metrics"]
    assert "experts_ms_per_step.batch" not in out["metrics"]


@pytest.mark.parametrize("how", ["unchanged", "token"])
def test_afmoe_broken_step_is_not_correct(lively_afmoe, how):
    with faults.planted(how):
        out = run.execute(tiny_afmoe_spec(), 2 ** 31 + 92, 0.5, False,
                          device="cpu")
    assert not out["correct"], out["compared"]


@pytest.fixture
def lively_afmoe(monkeypatch):
    """Embeddings at scale 1, as ``lively`` does for asteroid-qwen3."""
    lm_arch = arch.load("asteroid-afmoe")
    rule = lm_arch.lm_rule
    monkeypatch.setattr(lm_arch, "lm_rule", lambda n, s: (
        ("normal", 1.0) if n.startswith("embed_") else rule(n, s)))

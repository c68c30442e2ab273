"""The benchmark harness on the CPU at tiny sizes: discovery by name (a
second architecture among it), the seeded traffic, the work counters, the
reference against the port's plain path, the import guard, and whole runs
of both entries with the timed path broken underneath (``correct`` must
come out false).

    python -m pytest ttsd_bench/tests -q

Tests that need the card carry the ``cuda`` marker and skip here."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import shutil

import numpy as np
import pytest
import torch

from ttsd_bench import (arch, cells, check, counts, faults, program, readers,
                        run, traffic, weights)
from ttsd_bench.reference import lm as rlm
from ttsd_bench.reference import prompt
from ttsd_bench.trace import summarize

BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# the streamed pool's mix, measured but not a cell of the benchmark yet
POOL = ("moss-ttsd-v0.5-bf16", "pool-stream")


def _spec(cell: str) -> dict:
    if cell == "bf16-pool-stream":
        spec = run.parts(*POOL)
        spec["per_layer"] = [{"name": p.name[:-3], "unit": "x"}
                             for p in sorted(readers.METRICS.glob("*.pool.py"))]
        return spec
    return run.load_cell(cell)


def tiny_spec(cell: str, **over) -> dict:
    """A cell with the port's tiny LM and codec and a short traffic."""
    from moss_ttsd_torch.core.config import CodecConfig
    spec = _spec(cell)
    spec["cfg"].update(
        vocab_size=160, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, speech_token_range=[0, 160], pad_token_id=0,
        eos_token_id=150, speech_vocab_size=33, speech_pad_token=32,
        dtype="float32", param_dtype="float32", codec_dtype="float32")
    codec = dataclasses.asdict(CodecConfig().tiny())
    codec.pop("dtype")
    spec["cfg"]["codec"] = codec
    if spec["traffic"]["entry"] == "server":
        spec["traffic"].update(budget_frames=[5, 40], slots=4,
                               pool_max_steps=128, rate_per_s=3.0,
                               warm_requests=2)
    else:
        spec["traffic"].update(budget_steps=[20, 40], batch=3, warm_steps=4,
                               max_batches=2)
    spec["traffic"].update(over)
    spec["limits"] = {"prompt_mismatch": 0, "lm_gap_max": 1e-3,
                      "lm_gap_mean": 1e-4, "lm_gap_rel": 1.0,
                      "codec_err": 1e-3}
    return spec


# -- discovery ---------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = run.load_cell(cell)
    assert spec["traffic"]["entry"] in ("batch", "server")
    assert set(spec["limits"]) >= {"prompt_mismatch", "lm_gap_max",
                                   "codec_err"}
    assert set(spec["limits"]) & {"lm_gap_mean", "lm_gap_rel"}
    assert set(spec["limits"]) <= set(check.NUMBERS)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(readers.load(m["name"]))


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in readers.METRICS.glob("*.py")}
    # the pool's readers wait for its cell
    pool = {p.name[:-3] for p in readers.METRICS.glob("*.pool.py")}
    assert names == files - pool


def test_benchmark_names_only_its_own_cells():
    bench = run.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    assert {c["name"] for c in bench["configs"]} == {
        w["config"] for w in bench["workloads"]}
    with pytest.raises(SystemExit):
        run.load_cell("bf16-pool-stream")


# -- architectures -----------------------------------------------------------

def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return h.hexdigest()[:16]


def _tensors_digest(W: dict) -> str:
    return _digest(*[x for n in sorted(W) for x in (
        n.encode(), W[n].contiguous().float().numpy().tobytes())])


@pytest.mark.parametrize("config", sorted(
    {c["file"] for c in BENCH["configs"]}
    | {f"ttsd_bench/configs/{POOL[0]}.json"}))
def test_every_configuration_names_an_architecture(config):
    cfg = json.loads((run.ROOT / config).read_text())
    mod = arch.of(cfg)
    assert mod is arch.load(cfg["architecture"])
    for name in arch.INTERFACE:
        assert hasattr(mod, name), name
    assert isinstance(mod.port_model, str)
    assert all(callable(getattr(mod, n)) for n in arch.INTERFACE[1:])


def test_missing_or_unknown_architecture_stops_the_run():
    cfg = tiny_spec("bf16-dialogue-b8")["cfg"]
    for name in (None, "", "no-such-architecture"):
        bad = {**cfg, "architecture": name}
        with pytest.raises(SystemExit, match="architecture"):
            arch.of(bad)
        with pytest.raises(SystemExit, match="architecture"):
            program.lm_weights(bad, 1, "cpu")
    with pytest.raises(SystemExit, match="architecture"):
        arch.of({k: v for k, v in cfg.items() if k != "architecture"})


def test_asteroid_qwen3_gives_what_the_harness_gave_before_it():
    """The spec, the weights and voices on a fixed seed, the reference's
    hidden states and the work counts of ``asteroid-qwen3``, pinned to what
    the harness computed before the architecture had a module of its own.
    Digests are exact; the hidden states are summed over float32 CPU
    matrix products, whose kernels may add in another order on another CPU
    (a few ulp), where a tensor moved or renamed changes them outright."""
    full = run.load_cell("bf16-dialogue-b8")["cfg"]
    a = arch.of(full)
    assert len(a.lm_spec(full)) == 311
    assert _digest(sorted(a.lm_spec(full))) == "383bfb0fc1f032c4"
    cfg = tiny_spec("bf16-dialogue-b8")["cfg"]
    seed = 2 ** 31 + 11
    assert _digest(sorted(a.lm_spec(cfg))) == "d5273d81d094e7b1"
    W = weights.make(a.lm_spec(cfg), a.lm_rule, seed, weights.GROUPS["lm"],
                     "cpu", torch.float32)
    assert _tensors_digest(W) == "1fbae4b016d3c3eb"
    Wb = weights.make(a.lm_spec(cfg), a.lm_rule, seed, weights.GROUPS["lm"],
                      "cpu", torch.bfloat16)
    assert _tensors_digest(Wb) == "cedee49a61710fbc"
    assert [_tensors_digest(v) for v in weights.voices(cfg, seed, 2, "cpu")] \
        == ["8c37b77611b5c81e", "5a32d785f9d7123b"]
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 33, (40, 8), generator=g)
    ids[:, 0] = torch.randint(0, 160, (40,), generator=g)
    for fmt, total, absolute, row in (
            (None, -93.35132620151853, 2061.6486807864276,
             [0.6826072931289673, -0.9577236175537109, -2.0948374271392822]),
            ("int8", -87.29536186737823, 2061.67047214412,
             [0.6774007678031921, -0.9574113488197327, -2.0776517391204834])):
        h = a.reference(cfg, Wb, fmt).hidden(ids, 30, 8).double()
        assert float(h.sum()) == pytest.approx(total, rel=1e-6)
        assert float(h.abs().sum()) == pytest.approx(absolute, rel=1e-6)
        assert h[5, :3].tolist() == pytest.approx(row, rel=1e-5)
    for cell in CELLS:
        c = run.load_cell(cell)["cfg"]
        w = arch.of(c)
        assert w.decode_flops(c, [1000, 17, 640]) == 10800386048.0
        assert w.b1_work(c, [225, 575, 10]) == {"flops": 1562009600.0,
                                                "bytes": 9954090.0}
        assert w.decode_attention_work(c, [100, 200, 1], 3, 2) == {
            "flops": 2465792.0, "bytes": 1257773.0}
        assert w.decode_attention_work(c, [100, 200, 1], 16, 1) == {
            "flops": 2465792.0, "bytes": 767085.0}


TOY = '''"""toy-dense: asteroid-qwen3's tensors under an init of its own, two
LoRA targets, a reference that records its building, and work counted
by rules of its own: what the harness reads of it can only come from
here."""
import torch
from ttsd_bench import arch

base = arch.load("asteroid-qwen3")
port_model = base.port_model
EXTRA = []      # tensors the port lacks: the spec check must refuse them
MADE = []       # (weight format, dtype) of the references built


def lm_spec(cfg):
    return base.lm_spec(cfg) + EXTRA


def lm_rule(name, shape):
    if name.endswith("norm.weight"):
        return "const", 0.5
    return base.lm_rule(name, shape)


def lora_targets(cfg):
    t = base.lora_targets(cfg)
    return {"q_proj": t["q_proj"], "v_proj": t["v_proj"]}


def reference(cfg, weights, weight_format=None, dtype=torch.float32):
    MADE.append((weight_format, dtype))
    return base.reference(cfg, weights, weight_format, dtype)


def decode_flops(cfg, keys):
    return 7.0 * len(list(keys))


def b1_work(cfg, valid):
    return {"flops": 5.0, "bytes": float(sum(valid))}


def decode_attention_work(cfg, keys, rows, kv_bytes):
    return {"flops": 3.0, "bytes": float(rows * kv_bytes)}
'''


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """A second architecture, added as files only: ``toy-dense.py`` beside
    a copy of ``asteroid-qwen3.py`` in an ``arch/`` directory of its own."""
    d = tmp_path / "arch"
    d.mkdir()
    shutil.copy(arch.DIR / "asteroid-qwen3.py", d)
    (d / "toy-dense.py").write_text(TOY)
    monkeypatch.setattr(arch, "DIR", d)
    return arch.load("toy-dense")


def test_toy_architecture_is_found_by_name(toy):
    cfg = {**tiny_spec("bf16-dialogue-b8")["cfg"], "architecture": "toy-dense"}
    assert arch.of(cfg) is toy
    W = program.lm_weights(cfg, 3, "cpu")
    assert set(W) == {n for n, _ in toy.lm_spec(cfg)}
    assert bool((W["final_norm.weight"] == 0.5).all())
    assert bool((W["layers.0.q_norm.weight"] == 0.5).all())
    v = weights.voices(cfg, 3, 1, "cpu")[0]
    assert sorted(v) == ["q_proj.a", "q_proj.b", "v_proj.a", "v_proj.b"]
    assert sorted(program.voice_trees(cfg, 3, 1, "cpu")["voice0"]) == [
        "voice/q_proj/kernel", "voice/v_proj/kernel"]
    assert sorted(check._voices(cfg, 3, [{"voice": "voice0"}], "cpu")[
        "voice0"]) == ["q_proj", "v_proj"]
    toy.EXTRA.append(("layers.0.router.weight", (4, 64)))
    with pytest.raises(RuntimeError, match="differ"):
        program.lm_weights(cfg, 3, "cpu")


@pytest.mark.parametrize("cell", ["bf16-dialogue-b8", "bf16-pool-stream"])
def test_toy_architecture_drives_a_whole_run(toy, cell):
    """Both entries on the toy: its weights on both sides (``correct``), its
    reference in ``judge``, its counts in the traced run's work lists."""
    spec = tiny_spec(cell, trace_steps=3,
                     **({"rate_per_s": 8.0} if "pool" in cell else {}))
    spec["cfg"]["architecture"] = "toy-dense"
    t = spec["traffic"]
    args = cells.Args(cfg=spec["cfg"], traffic=t, seed=2 ** 31 + 81,
                      seconds=1.0, trace=True, t_start=0.0, device="cpu")
    res, _ = cells.ENTRIES[t["entry"]](args)
    numbers = check.judge(spec["cfg"], res["kind"], res["samples"],
                          2 ** 31 + 81, "cpu",
                          t if res["kind"] == "server" else None)
    assert toy.MADE == [(None, torch.float32), (None, torch.bfloat16)]
    assert all(numbers[k] <= spec["limits"][k] for k in check.NUMBERS), \
        numbers
    layer = res["layer"]
    if t["entry"] == "batch":
        assert layer["b1"]["flops"] == 5.0 and layer["b1"]["bytes"] > 0
        assert layer["b2"] and all(w == {"flops": 3.0, "bytes": 6.0}
                                   for w in layer["b2"])
        assert layer["batches"]
        for b in layer["batches"]:
            assert b["flops"] == 7.0 * t["batch"] * b["steps"]
    else:
        assert layer["runs"] and all(f == 7.0 * int(f / 7.0) and f > 0
                                     for _, _, f in layer["runs"])
        assert layer["b3"] and all(w == {"flops": 3.0, "bytes": 4.0}
                                   for w in layer["b3"])


# -- traffic -----------------------------------------------------------------

def test_same_seed_same_traffic_and_sizes_fixed_across_seeds():
    t = run.parts(*POOL)["traffic"]
    a = traffic.requests(t, 2 ** 31 + 5, 50, 2.2)
    assert a == traffic.requests(t, 2 ** 31 + 5, 50, 2.2)
    b = traffic.requests(t, 17, 50, 2.2)
    assert [x["script"] for x in a] != [x["script"] for x in b]
    assert [(x["due"], x["frames"], x["voice"]) for x in a] == \
        [(x["due"], x["frames"], x["voice"]) for x in b]
    assert len(a) == len(b) == 110
    for r in a:
        assert prompt.prompt_tokens(r["script"]) <= 400
        assert r["max_tokens"] == r["frames"] + 7
    d = run.load_cell("bf16-dialogue-b8")["traffic"]
    x, y = traffic.batches(d, 3, 4), traffic.batches(d, 3, 4)
    assert x == y
    assert sorted(b["steps"] for b in x) == [281, 344, 406, 469]
    assert sorted(prompt.prompt_tokens(s) for s in x[0]["scripts"]) == \
        [225, 275, 325, 375, 425, 475, 525, 575]


def test_percentile_counts_missing_as_infinite():
    assert traffic.percentile([1, 2, 3, math.inf], 50) == 2
    assert traffic.percentile([1] * 9 + [math.inf], 90) == 1
    assert traffic.percentile([1] * 8 + [math.inf] * 2, 90) == math.inf


# -- counters ----------------------------------------------------------------

def test_flop_and_byte_counts_by_hand():
    cfg = run.load_cell("bf16-dialogue-b8")["cfg"]
    work = arch.of(cfg)
    p = work.lm_params(cfg)
    assert p["backbone"] == 28 * (2 * 2048 * 2048 + 2 * 2048 * 1024
                                  + 3 * 2048 * 6144)
    assert p["heads"] == (152704 + 7 * 1025) * 2048
    one = work.decode_flops(cfg, [1000])
    assert one == 2 * (p["backbone"] + p["heads"]) + 28 * 4 * 16 * 128 * 1000
    w = work.decode_attention_work(cfg, [100, 200], 2, 2)
    assert w["bytes"] == 2 * 2 * 2048 * 2 + 300 * (2 * 1024 * 2 + 1)
    w8 = work.decode_attention_work(cfg, [100], 1, 1)
    assert w8["bytes"] == 2048 * 2 * 2 + 100 * (2 * 1024 + 2 * 8 * 4 + 1)
    b1 = work.b1_work(cfg, [10])
    assert b1["flops"] == 4 * 16 * 128 * 100 / 2
    assert b1["bytes"] == 10 * (2 * 2048 + 2 * 1024) * 2 + 10
    assert counts.roofline_percent(0, 3.35e12, 2.0) == 50.0


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "s", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 10, "dur": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 20, "dur": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
           "dur": 60},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 30, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 80, "dur": 50}]
    s = summarize(ev, "s")
    assert s["launches"] == 2 and s["steps"] == 1
    assert s["window_s"] == pytest.approx(130e-6)
    assert s["busy_s"] == pytest.approx(80e-6)
    assert s["device_ops"][0] == ["k2", pytest.approx(50e-6)]
    assert s["idle_gaps"][0][0] == "aten::mm"
    assert readers.idle_percent({"trace": s}) == pytest.approx(100 * 50 / 130)
    assert readers.launches_per_step({"trace": s}) == 2
    assert readers.roofline({"trace": s}, lambda n: n == "k9",
                            [{"flops": 1, "bytes": 1}]) is None


# -- the reference against the port --------------------------------------

def test_reference_lm_matches_the_port_plain_path():
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = tiny_spec("bf16-dialogue-b8")["cfg"]
    cfg["param_dtype"] = cfg["dtype"] = "float32"
    lm_arch = arch.of(cfg)
    W = weights.make(lm_arch.lm_spec(cfg), lm_arch.lm_rule, 5,
                     weights.GROUPS["lm"], "cpu", torch.float32)
    with torch.device("meta"):
        model = AsteroidLM(program.lm_config(cfg))
    model.load_state_dict(W, assign=True)
    ids = torch.randint(0, 33, (1, 40, 8))
    ids[..., 0] = torch.randint(0, 160, (1, 40))
    text, speech = model(ids)
    ref = lm_arch.reference(cfg, W)
    h = ref.hidden(ids[0], 40)
    torch.testing.assert_close(ref.logits(h, 0), text[0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(ref.logits(h, 3), speech[0, :, 2],
                               rtol=1e-4, atol=1e-4)


def test_reference_prompt_matches_the_port():
    from moss_ttsd_torch.pipeline import prompt as pp
    from moss_ttsd_torch.pipeline.batch import SYSTEM_PROMPT
    from moss_ttsd_torch.pipeline.text import rewrite_speaker_tags
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    s = traffic.script(300, np.random.default_rng(0))
    tok = MockTokenizer()
    ids = pp.build_prompt_ids(tok, SYSTEM_PROMPT, rewrite_speaker_tags(s))
    port = pp.shift_delay_pattern(ids, tok.pad_token_id, 1024)
    np.testing.assert_array_equal(port, prompt.shifted_prompt(s, 8, 1024))
    assert ids.shape[0] == 300


def test_reference_int8_matches_the_port_quantizer():
    from moss_ttsd_torch.ops.quantize import quantize_lm_params
    w = torch.randn(64, 48)
    q = quantize_lm_params({"layers.0.q_proj.weight": w})
    port = q["layers.0.q_proj.weight_q"].float() * q["layers.0.q_proj.weight_s"]
    torch.testing.assert_close(rlm.fake_quant(w, "int8"), port)


# -- the import guard ------------------------------------------------------

def test_banned_modules_compared_by_whole_top_level_name():
    assert run.banned_modules(["moss_ttsd_torch", "moss_ttsd_torch.ops",
                               "jaxtyping", "flax_like", "numpy"]) == []
    assert run.banned_modules(["jax.numpy", "moss_ttsd_tpu.models",
                               "flax"]) == ["flax", "jax.numpy",
                                            "moss_ttsd_tpu.models"]


# -- whole runs, sound and broken ------------------------------------------

def _run(cell, **over):
    """A whole tiny run on the CPU that judges every row it served."""
    if "pool" in cell:
        over = {"check_requests": 64, "rate_per_s": 12.0, **over}
    return run.execute(tiny_spec(cell, **over), 2 ** 31 + 77, 0.5, False,
                       device="cpu")


@pytest.mark.parametrize("cell", ["bf16-dialogue-b8", "bf16-pool-stream"])
def test_sound_run_is_correct(lively, cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "compared"
    assert set(out["compared"]) == set(tiny_spec(cell)["limits"])


def test_a_cell_compares_the_numbers_its_limits_name():
    spec = tiny_spec("bf16-dialogue-b8")
    del spec["limits"]["lm_gap_mean"]
    out = run.execute(spec, 2 ** 31 + 83, 0.5, False, device="cpu")
    assert list(out["compared"]) == ["prompt_mismatch", "lm_gap_max",
                                     "lm_gap_rel", "codec_err"]
    spec["limits"]["lm_gap_spread"] = 1.0
    with pytest.raises(SystemExit, match="lm_gap_spread"):
        run.execute(spec, 2 ** 31 + 83, 0.5, False, device="cpu")


@pytest.mark.parametrize("cell", ["bf16-dialogue-b8", "bf16-pool-stream"])
def test_traced_run_reads_its_spans_and_counters(cell):
    over = ({"rate_per_s": 8.0, "trace_steps": 3} if "pool" in cell
            else {"trace_steps": 3})
    out = run.execute(tiny_spec(cell, **over), 2 ** 31 + 78, 1.0, True,
                      device="cpu")
    m = out["metrics"]
    # the device-trace metrics need the card (no kernel runs here)
    want = (["join_wait_ms.pool", "admit_ms.pool", "pool_step_ms.pool",
             "mfu.pool"] if "pool" in cell else
            ["prefill_ms.batch", "decode_step_ms.batch", "mfu.batch",
             "vocode_ms_per_audio_s.batch"])
    for name in want:
        assert name in m and m[name]["value"] >= 0, (name, m)
    assert out["correct"]


def test_traced_run_fails_when_the_probe_misses_steps():
    """A probe that labels fewer steps than ``trace_steps`` (the port's
    step no longer called where ``cells.py`` wraps it) fails the run
    instead of leaving the trace's metrics out of the line."""
    spec = tiny_spec("bf16-dialogue-b8", trace_steps=10 ** 4)
    with pytest.raises(SystemExit, match="labelled"):
        run.execute(spec, 2 ** 31 + 79, 0.5, True, device="cpu")


@pytest.fixture
def lively(monkeypatch):
    """At the tiny width the default embedding scale (0.02) leaves the
    greedy tokens independent of what came before from the second step
    on; embeddings at scale 1 let a frozen state show in the tokens. Both
    sides read the rule, so they still hold the same weights."""
    lm_arch = arch.load("asteroid-qwen3")
    rule = lm_arch.lm_rule
    monkeypatch.setattr(lm_arch, "lm_rule", lambda n, s: (
        ("normal", 1.0) if n.startswith("embed_") else rule(n, s)))


@pytest.mark.parametrize("cell", ["bf16-dialogue-b8", "bf16-pool-stream"])
@pytest.mark.parametrize("how", ["unchanged", "token", "half_batch"])
def test_broken_step_is_not_correct(lively, cell, how):
    with faults.planted(how):
        out = _run(cell)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("rows", ["last_half", "first_half", "odd", "even"])
@pytest.mark.parametrize("seed", [2 ** 31 + 201, 7])
def test_cell_sample_reaches_a_spared_half(monkeypatch, seed, rows):
    """The cell's own check (every row the window served, a batch of 8)
    reads a fault confined to half of the batch's rows. At the tiny width every row decodes the same greedy tokens, so
    the half-batch fault of ``faults.py`` leaves no trace here (the card
    reads it at the cell's width, PERF.md); a token altered in just those
    rows stands in for it."""
    from moss_ttsd_torch.decode import engine
    orig = engine.sample_channels
    pick = {"last_half": lambda b, B: b >= B - B // 2,
            "first_half": lambda b, B: b < B // 2,
            "odd": lambda b, B: b % 2 == 1,
            "even": lambda b, B: b % 2 == 0}[rows]

    def sample(*a, **k):
        t = orig(*a, **k)
        B = t.shape[0]
        for b in range(B):
            if pick(b, B):
                t[b, 1] = (t[b, 1] + 1) % 32
        return t
    monkeypatch.setattr(engine, "sample_channels", sample)
    spec = tiny_spec("bf16-dialogue-b8", batch=8)
    out = run.execute(spec, seed, 0.5, False, device="cpu")
    assert not out["correct"], out["compared"]


def test_broken_vocoder_is_not_correct(monkeypatch):
    from moss_ttsd_torch.models.codec import model
    orig = model.XYTokenizerModule.detokenize

    def detok(self, codes, lengths):
        out = orig(self, codes, lengths)
        out["wav"] = out["wav"] * 0.9
        return out
    monkeypatch.setattr(model.XYTokenizerModule, "detokenize", detok)
    out = _run("bf16-dialogue-b8")
    assert not out["correct"]
    assert out["compared"]["codec_err"]["value"] > 0.05


@pytest.mark.cuda
def test_cuda_run_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run.execute(tiny_spec("bf16-dialogue-b8"), 9, 0.5, False)
    assert out["correct"], out["compared"]

"""The port's multi-LoRA pieces against the JAX package (tiny config, fp32,
CPU): the registry's stacks equal JAX's exactly (rank padding, layer-subset
padding, the layerwise tree, the atomic failure); ``convert_peft_lora`` and
``load_peft_adapter`` give JAX's trees from one peft directory written as
``.safetensors`` and as ``.bin``; the port's own safetensors reader equals
the ``safetensors`` package on F32 / F16 / BF16 / I64; a
``lora_factors.npz`` saved by JAX's ``save_pytree`` loads to the same tree;
per-row adapters in ``generate`` give the JAX engine's tokens; the CLI's
``--lora_adapter`` with a per-item ``"voice"``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core import checkpoint as jckpt  # noqa: E402
from moss_ttsd_tpu.decode import engine as jeng  # noqa: E402
from moss_ttsd_tpu.decode.lora_registry import LoraRegistry as JRegistry  # noqa: E402
from moss_ttsd_tpu.train.lora import lora_scale as jlora_scale  # noqa: E402
from moss_ttsd_tpu.utils import convert_lora as jconv  # noqa: E402
from moss_ttsd_torch.core.checkpoint import load_pytree  # noqa: E402
from moss_ttsd_torch.decode.engine import GenerationEngine  # noqa: E402
from moss_ttsd_torch.decode.lora_registry import LoraRegistry  # noqa: E402
from moss_ttsd_torch.utils import convert_lora as conv  # noqa: E402
from tests.test_torch_continuous import rand_adapter  # noqa: E402
from tests.test_torch_engine import JAX_S, TORCH_S, _batch, greedy  # noqa: E402
from tests.test_torch_lm import jax_tiny, port_model  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg, params = jax_tiny(7)
    cfg, model = port_model(jcfg, params)
    return jcfg, params, cfg, model


def _stacks_equal(reg, jreg):
    assert sorted(reg.stacks) == sorted(jreg.stacks)
    for t, (a, b) in reg.stacks.items():
        ja, jb = jreg.stacks[t]
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("rank,alpha,rslora", [(16, 32.0, True),
                                               (8, 16.0, False), (1, 4.0,
                                                                  True)])
def test_lora_scale_matches_jax(rank, alpha, rslora):
    assert conv.lora_scale(rank, alpha, rslora) == \
        jlora_scale(rank, alpha, rslora)


def test_registry_stacks_match_jax(models):
    """Two adapters of ranks 4 and 2 (rank padding), one covering a layer
    prefix only (layer padding), one as the finetune CLI's layerwise tree:
    the stacks, ids, names and row ids equal JAX's, atol 0."""
    cfg = models[2]
    L = cfg.num_hidden_layers
    ad1 = rand_adapter(cfg, 1, rank=4)
    ad2 = rand_adapter(cfg, 2, rank=2, layers=L - 1)
    layerwise = {"params": {"layers": {"block": {
        t.split("/")[-2]: {"lora_a": ab["a"], "lora_b": ab["b"]}
        for t, ab in rand_adapter(cfg, 3, rank=3).items()}}}}
    reg, jreg = (LoraRegistry(torch.float32, L),
                 JRegistry(jnp.float32, num_layers=L))
    for r in (reg, jreg):
        assert not r
        assert r.register("v1", ad1, alpha=8.0) == 1
        assert r.register("v2", ad2, alpha=16.0, use_rslora=False) == 2
        assert r.register("v3", layerwise, alpha=32.0) == 3
        assert r
    _stacks_equal(reg, jreg)
    assert reg.stacks["q_proj"][0].shape == (L, 4, cfg.hidden_size, 4)
    assert float(reg.stacks["q_proj"][0][L - 1, 2].abs().sum()) == 0.0
    assert reg.names == jreg.names == ["v1", "v2", "v3"]
    for name in (None, "", "v2"):
        assert reg.id_of(name) == jreg.id_of(name)
    rows = ["v3", None, "v1"]
    assert reg.row_ids(rows, 3) == np.asarray(jreg.row_ids(rows, 3)).tolist()
    assert reg.row_ids("v2", 2) == [2, 2]
    with pytest.raises(ValueError, match="unknown adapter"):
        reg.id_of("nope")
    with pytest.raises(ValueError, match="already registered"):
        reg.register("v1", ad1)
    with pytest.raises(ValueError):
        reg.row_ids(["v1"], 2)


def test_registry_partial_layers_and_atomic_failure(models):
    """A factor tree with more layers than the model, or with dims that do
    not match the registered ones, raises and leaves the registry as it
    was (JAX's case, and the same refusals)."""
    cfg = models[2]
    L, hd = cfg.num_hidden_layers, cfg.hidden_size
    qd = cfg.num_attention_heads * cfg.head_dim
    reg = LoraRegistry(torch.float32, num_layers=L)
    jreg = JRegistry(jnp.float32, num_layers=L)
    partial = {"layers/block/q_proj/kernel": {
        "a": np.ones((1, hd, 2), np.float32),
        "b": np.ones((1, 2, qd), np.float32)}}
    too_many = {"layers/block/q_proj/kernel": {
        "a": np.ones((L + 1, hd, 2), np.float32),
        "b": np.ones((L + 1, 2, qd), np.float32)}}
    wrong_dims = {"layers/block/q_proj/kernel": {
        "a": np.ones((L, hd + 1, 2), np.float32),
        "b": np.ones((L, 2, qd), np.float32)}}
    for r in (reg, jreg):
        assert r.register("p", partial) == 1
        with pytest.raises(ValueError, match="layers"):
            r.register("bad", too_many)
        with pytest.raises(ValueError, match="do not match"):
            r.register("bad2", wrong_dims)
        with pytest.raises(ValueError, match="no LoRA factors"):
            r.register("empty", {"x": {"y": np.zeros(3)}})
        assert "bad" not in r.ids and "bad2" not in r.ids
        assert r.id_of("p") == 1
    _stacks_equal(reg, jreg)
    assert reg.stacks["q_proj"][0].shape == (L, 2, hd, 2)
    assert float(reg.stacks["q_proj"][0][1:].abs().sum()) == 0.0


def _peft_state(cfg, seed, rank=4, layers=(0, 1)):
    """A peft-style state dict: lora_A (r, in) / lora_B (out, r) torch
    tensors under the reference's key names, plus a leaf on an unsupported
    module (dropped with a warning)."""
    rng = np.random.default_rng(seed)
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    qd = cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    mods = {"self_attn.q_proj": (hid, qd), "self_attn.k_proj": (hid, kvd),
            "self_attn.v_proj": (hid, kvd), "self_attn.o_proj": (qd, hid),
            "mlp.gate_proj": (hid, inter), "mlp.up_proj": (hid, inter),
            "mlp.down_proj": (inter, hid)}
    sd = {}
    for layer in layers:
        for m, (fi, fo) in mods.items():
            pre = f"base_model.model.model.language_model.layers.{layer}.{m}"
            sd[pre + ".lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((rank, fi)).astype(np.float32))
            sd[pre + ".lora_B.weight"] = torch.from_numpy(
                rng.standard_normal((fo, rank)).astype(np.float32))
    sd["base_model.model.lm_head.lora_A.weight"] = torch.zeros(rank, hid)
    return sd


def _trees_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in got:
        for ab in ("a", "b"):
            np.testing.assert_array_equal(got[k][ab], np.asarray(ref[k][ab]))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_peft_adapter_matches_jax(models, tmp_path, fmt):
    """One peft directory (adapter_config.json with alpha 32 and rslora)
    written as adapter_model.safetensors or adapter_model.bin: the port's
    loader gives JAX's tree, alpha and rslora; a layer the adapter leaves
    out is zero."""
    cfg = models[2]
    sd = _peft_state(cfg, 4, layers=(1,))
    if fmt == "safetensors":
        from safetensors.torch import save_file
        save_file(sd, str(tmp_path / "adapter_model.safetensors"))
    else:
        torch.save(sd, str(tmp_path / "adapter_model.bin"))
    (tmp_path / "adapter_config.json").write_text(json.dumps(
        {"r": 4, "lora_alpha": 32, "use_rslora": True}))
    tree, alpha, rslora = conv.load_peft_adapter(str(tmp_path),
                                                 cfg.num_hidden_layers)
    jtree, jalpha, jrslora = jconv.load_peft_adapter(str(tmp_path),
                                                     cfg.num_hidden_layers)
    assert (alpha, rslora) == (jalpha, jrslora) == (32.0, True)
    _trees_equal(tree, jtree)
    assert float(np.abs(tree["layers/block/q_proj/kernel"]["a"][0]).sum()) \
        == 0.0
    assert conv.load_adapter_any(str(tmp_path))[1:] == (32.0, True)


def test_convert_peft_lora_matches_jax_and_refuses_non_peft(models):
    cfg = models[2]
    sd = _peft_state(cfg, 5)
    _trees_equal(conv.convert_peft_lora(sd), jconv.convert_peft_lora(sd))
    with pytest.raises(ValueError, match="no lora_A"):
        conv.convert_peft_lora({"model.embed.weight": torch.zeros(2)})
    bad = {k: v for k, v in sd.items() if "q_proj.lora_B" not in k}
    with pytest.raises(ValueError, match="incomplete"):
        conv.convert_peft_lora(bad)


def test_read_safetensors_matches_the_package(tmp_path):
    """The port's reader against safetensors.torch on F32, F16, BF16, I64
    (and a scalar and an empty tensor)."""
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    sd = {"f32": torch.randn(3, 5, generator=g),
          "f16": torch.randn(4, generator=g).half(),
          "bf16": torch.randn(2, 3, 2, generator=g).bfloat16(),
          "i64": torch.arange(-4, 8).reshape(3, 4),
          "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "t.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = conv.read_safetensors(path)
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    with open(path, "r+b") as f:              # a header past the file end
        f.write((1 << 40).to_bytes(8, "little"))
    with pytest.raises(ValueError, match="header"):
        conv.read_safetensors(path)


def test_lora_factors_npz_from_jax_save_pytree(models, tmp_path):
    """A finetune CLI lora_factors.npz (JAX ``save_pytree`` of the
    layerwise trainable tree) loads to the same tree, and through
    load_adapter_any and parse_adapter_specs with the reference defaults
    (alpha from the flag, rslora); it registers to JAX's stacks."""
    cfg = models[2]
    tree = {"params": {"layers": {"block": {
        t.split("/")[-2]: {"lora_a": ab["a"], "lora_b": ab["b"]}
        for t, ab in rand_adapter(cfg, 6, rank=2).items()}}}}
    path = str(tmp_path / "lora_factors.npz")
    jckpt.save_pytree(path, jax.tree_util.tree_map(jnp.asarray, tree))
    got = load_pytree(path)
    ref = jckpt.load_pytree(path)
    flat = lambda t, p="": ({p[:-1]: t} if not isinstance(t, dict) else {
        k: v for kk, vv in t.items() for k, v in flat(vv, p + kk + "/").items()})
    assert sorted(flat(got)) == sorted(flat(ref))
    for k, v in flat(got).items():
        np.testing.assert_array_equal(v, np.asarray(flat(ref)[k]))
    specs = conv.parse_adapter_specs([f"narrator={path}"], 16.0)
    jspecs = jconv.parse_adapter_specs([f"narrator={path}"], 16.0)
    assert specs["narrator"][1:] == jspecs["narrator"][1:] == (16.0, True)
    reg = LoraRegistry(torch.float32, cfg.num_hidden_layers)
    jreg = JRegistry(jnp.float32, num_layers=cfg.num_hidden_layers)
    reg.register("n", *specs["narrator"])
    jreg.register("n", *jspecs["narrator"])
    _stacks_equal(reg, jreg)
    for bad in (["narrator"], ["=x"], [f"n={tmp_path / 'missing.npz'}"]):
        with pytest.raises(ValueError):
            conv.parse_adapter_specs(bad)


def test_generate_per_row_adapters_match_jax(models):
    """One batched generate with per-row adapters (prefill and every decode
    step through each row's factors) gives the JAX engine's greedy tokens;
    generate_stream gives the same; an unknown name raises."""
    jcfg, params, cfg, model = models
    ad1 = rand_adapter(cfg, 13)
    batch, mask = _batch(jcfg, 31, [(6, 4), (6, 3), (8, 2)])
    eng = GenerationEngine(cfg, model, greedy(TORCH_S), bucket=32,
                           device="cpu")
    jeng_ = jeng.GenerationEngine(jcfg, params, greedy(JAX_S), bucket=32,
                                  cache_dtype=jnp.float32)
    eng.register_adapter("v1", ad1, alpha=8.0)
    jeng_.register_adapter("v1", ad1, alpha=8.0)
    rows = ["v1", None, "v1"]
    r_t = eng.generate(batch, mask, 16, adapter=rows)
    r_j = jeng_.generate(batch, mask, 16, adapter=rows)
    assert r_t.steps == r_j.steps
    np.testing.assert_array_equal(r_t.tokens, r_j.tokens)
    last = list(eng.generate_stream(batch, mask, 16, adapter=rows,
                                    chunk_steps=5))[-1]
    np.testing.assert_array_equal(last.tokens, r_t.tokens)
    base = eng.generate(batch, mask, 16)
    n = min(base.tokens.shape[1], r_t.tokens.shape[1])
    assert not np.array_equal(base.tokens[0, :n], r_t.tokens[0, :n])
    np.testing.assert_array_equal(base.tokens[1, :n], r_t.tokens[1, :n])
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.generate(batch, mask, 4, adapter="nope")


def test_inference_cli_serves_a_voice(models, tmp_path):
    """``--lora_adapter narrator=<lora_factors.npz>`` and an item whose
    "voice" names it: the CLI writes both items' wavs; an unknown voice is
    refused."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline, main
    pipe = build_tiny_pipeline(device="cpu")
    tree = {"params": {"layers": {"block": {
        t.split("/")[-2]: {"lora_a": ab["a"], "lora_b": ab["b"]}
        for t, ab in rand_adapter(pipe.lm_cfg, 8, rank=2).items()}}}}
    npz = str(tmp_path / "lora_factors.npz")
    jckpt.save_pytree(npz, tree)
    jsonl = tmp_path / "items.jsonl"
    jsonl.write_text(
        json.dumps({"text": "[S1]with a voice[S2]yes", "voice": "narrator"})
        + "\n" + json.dumps({"text": "[S1]the base model[S2]ok"}) + "\n")
    out = tmp_path / "out"
    args = ["--jsonl", str(jsonl), "--tiny", "--platform", "cpu",
            "--output_dir", str(out), "--max_new_tokens", "16",
            "--lora_adapter", f"narrator={npz}", "--adapter_alpha", "16"]
    assert main(args) == 0
    assert sorted(p.name for p in out.iterdir()) == ["output_0.wav",
                                                     "output_1.wav"]
    jsonl.write_text(json.dumps({"text": "[S1]x[S2]y", "voice": "who"})
                     + "\n")
    with pytest.raises(ValueError, match="unknown adapter"):
        main(args)


def test_process_batch_voices_follow_the_surviving_items(tmp_path):
    """A per-item voice list with one item that fails preparation (an
    unreadable prompt wav): the failed item is isolated and the voiced item
    is served with its adapter's tokens, the same audio as alone; a list of
    the wrong length raises."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline
    pipe = build_tiny_pipeline(device="cpu")
    pipe.engine.register_adapter(
        "narrator", rand_adapter(pipe.lm_cfg, 8, rank=2), alpha=16.0)
    bad = {"text": "[S1]cloned", "prompt_audio": str(tmp_path / "no.wav"),
           "prompt_text": "[S1]hi"}
    good = {"text": "[S1]with a voice[S2]yes"}
    texts, audio = pipe.process_batch([bad, good], max_new_tokens=16,
                                      adapter=[None, "narrator"])
    assert "error" in texts[0] and audio[0] is None
    _, alone = pipe.process_batch([good], max_new_tokens=16,
                                  adapter=["narrator"])
    _, base = pipe.process_batch([good], max_new_tokens=16)
    np.testing.assert_array_equal(audio[1]["audio_data"],
                                  alone[0]["audio_data"])
    assert not np.array_equal(alone[0]["audio_data"], base[0]["audio_data"])
    with pytest.raises(ValueError, match="adapter names for 2 items"):
        pipe.process_batch([bad, good], max_new_tokens=4,
                           adapter=["narrator"])

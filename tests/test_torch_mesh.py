"""The port's mesh (``moss_ttsd_torch/parallel/mesh.py``) against the JAX
package on the CPU: the tensor-parallel spec tree leaf by leaf, the mesh
argument's refusals, and the engine on (data, model) meshes of spawned
gloo ranks (``tests/torch_mesh_ref.py``), whose fp32 greedy tokens and
``steps`` must equal the JAX unsharded engine's on weights carried from
JAX (float and int8, the restricted head and its audit, streaming), with
prefill logits within 1e-5. One group of 2 ranks and one of 4 serve every
case of this file (module-scoped fixtures)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_mesh_ref as R  # noqa: E402
from moss_ttsd_tpu.decode import engine as jeng  # noqa: E402
from moss_ttsd_tpu.models import lm as jlm  # noqa: E402
from moss_ttsd_tpu.ops.quantize import quantize_lm_params  # noqa: E402
from moss_ttsd_tpu.parallel.mesh import lm_param_specs as jax_specs  # noqa: E402
from moss_ttsd_tpu.pipeline.prompt import left_pad_batch  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.decode.engine import GenerationEngine  # noqa: E402
from moss_ttsd_torch.parallel import mesh as pmesh  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from tests.test_decode import greedy_sampling, make_prompt  # noqa: E402
from tests.test_torch_lm import jax_tiny  # noqa: E402

STEPS = 12
TOL = dict(rtol=1e-5, atol=1e-5)

# (name, (data, model), engine keywords, kind) of each spawned group
CASES = {
    2: [("tp", (1, 2), {}, "generate"),
        ("dp", (2, 1), {}, "generate"),
        ("stream", (1, 2), {}, "stream"),
        ("int8_tp", (1, 2), {"quant": "int8"}, "generate"),
        ("int8_dp", (2, 1), {"quant": "int8"}, "generate"),
        ("restricted", (1, 2), {"restricted_text_head": True,
                                "restricted_audit_every": 1}, "generate"),
        ("draws", (2, 1), {}, "draws"),
        # the dense backend on each rank's heads
        ("xla_tp", (1, 2), {"attn_impl": "xla"}, "generate"),
        ("xla_kv8_tp", (1, 2), {"attn_impl": "xla", "kv_quant": "int8"},
         "generate")],
    4: [("tp", (1, 4), {}, "generate"),
        ("dp_tp", (2, 2), {}, "generate"),
        ("int8_tp", (1, 4), {"quant": "int8"}, "generate"),
        ("restricted", (1, 4), {"restricted_text_head": True,
                                "restricted_audit_every": 1}, "generate")],
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX weights (attention biases on, randomized) and a left-padded
    batch of 8, written for the ranks as the port's state dict."""
    jcfg, params = jax_tiny(9, attention_bias=True)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(21)
    prompts = [make_prompt(jcfg, rng, 4 + i % 3, 3) for i in range(8)]
    batch, mask = left_pad_batch(prompts, jcfg.pad_token_id,
                                 jcfg.speech_pad_token)
    tmp = tmp_path_factory.mktemp("mesh")
    inp = str(tmp / "inputs.pt")
    torch.save({"cfg": cfg.to_dict(), "state": lm_state_from_jax(params, cfg),
                "batch": batch, "mask": mask}, inp)
    return jcfg, params, cfg, batch, mask, tmp, inp


@pytest.fixture(scope="module")
def ranks2(setup):
    *_, tmp, inp = setup
    return R.spawn(2, R.file_cases, str(tmp / "w2"), inp, CASES[2])


@pytest.fixture(scope="module")
def ranks4(setup):
    *_, tmp, inp = setup
    return R.spawn(4, R.file_cases, str(tmp / "w4"), inp, CASES[4])


def _ranks(request, world):
    return request.getfixturevalue(f"ranks{world}")


def _jax_generate(setup, **kw):
    jcfg, params, _, batch, mask, *_ = setup
    eng = jeng.GenerationEngine(jcfg, params, greedy_sampling(), bucket=32,
                                cache_dtype=jnp.float32, **kw)
    return eng.generate(batch, mask, max_new_tokens=STEPS, seed=0)


# -- specs ---------------------------------------------------------------------

def _jax_kind(jspecs, name):
    """The kind of the JAX spec of the port parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "layers":
        mod, leaf = parts[2], parts[3]
        if mod.endswith("proj"):
            leaf = {"weight": "kernel", "weight_q": "kernel_q",
                    "weight_s": "kernel_s", "bias": "bias"}[leaf]
        spec = jspecs["params"]["layers"]["block"][mod][leaf]
    elif parts[0] == "final_norm":
        spec = jspecs["params"]["final_norm"]["weight"]
    else:
        spec = jspecs["params"][name]
        mod = name
    if spec == P():
        return "replicated"
    if name.startswith("embed_text"):
        return "vocab"
    return "colwise" if mod in pmesh.COLWISE else "rowwise"


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_param_specs_match_jax(model_size, quant):
    """Every leaf of the attention-bias tree (and of its int8 form), at
    model sizes 2 and 4: colwise q/k/v/gate/up and their biases, rowwise
    o/down kernels with their scales and biases whole, the text table
    vocab-split, the odd speech vocab degraded to replicated."""
    jcfg, params = jax_tiny(0, attention_bias=True)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    if quant:
        params = jax.tree_util.tree_map(np.asarray,
                                        quantize_lm_params(params))
        cfg = dataclasses.replace(cfg, quantized=True)
    state = lm_state_from_jax(params, cfg)
    jspecs = jax_specs(params, model_size=model_size)
    kinds = pmesh.lm_param_specs(state, cfg, model_size=model_size)
    assert set(kinds) == set(state)
    for name, kind in kinds.items():
        assert kind == _jax_kind(jspecs, name), name
    assert kinds["layers.0.o_proj.bias"] == "replicated"
    assert kinds["layers.1.q_proj.bias" if not quant
                 else "layers.1.q_proj.weight_s"] == "colwise"
    assert kinds["embed_speech" + ("_q" if quant else "")] == "replicated"


def test_specs_degrade_and_shard_shapes():
    """An indivisible dim stays whole (a 6-wide MLP over 4 ranks); the
    KV heads a rank holds are those its query heads read, replicated where
    there are fewer KV heads than ranks."""
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny(
        intermediate_size=6)
    state = {"layers.0.gate_proj.weight": torch.zeros(6, 64),
             "layers.0.down_proj.weight": torch.zeros(64, 6)}
    assert set(pmesh.lm_param_specs(state, cfg, 4).values()) == {
        "replicated"}
    assert pmesh.kv_heads_for(3, 4, H=4, Hkv=2) == [1]
    assert pmesh.kv_heads_for(1, 2, H=16, Hkv=8) == [4, 5, 6, 7]
    assert pmesh.kv_heads_for(1, 4, H=12, Hkv=6) == [1, 2, 2]
    tp = pmesh.TensorParallel(cfg, 1, 4)
    assert not tp.mlp_split and tp.ffn == 6 and tp.vocab == (40, 80)
    with pytest.raises(ValueError, match="query heads"):
        pmesh.TensorParallel(cfg, 0, 3)


# -- the mesh argument -----------------------------------------------------------

def test_parse_mesh_arg_refuses_a_mismatch_without_a_group():
    """No group is a world of one: 1x2 does not fit it."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        pmesh.parse_mesh_arg("1x2", device_type="cpu")
    with pytest.raises(ValueError, match="DATAxMODEL"):
        pmesh.parse_mesh_arg("two", device_type="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        pmesh.make_mesh(1, 1, seq=2, device_type="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_parse_mesh_arg_in_a_group(request, world):
    """Every rank refuses the specs its group's size does not fit and takes
    the one that does."""
    for r in _ranks(request, world):
        msgs = r["parse"]
        assert msgs["fits"] == {"data": 1, "model": world}
        for spec in ("2x2", "1x1", "4x1"):
            n = int(spec[0]) * int(spec[2])
            if n == world:
                assert msgs[spec] is None, spec
            else:
                assert f"needs {n} processes" in msgs[spec], spec
        assert "must be >= 1" in msgs["0x2"]
        assert "DATAxMODEL" in msgs["x2"]


# -- the engine ------------------------------------------------------------------

GENERATE = [(w, name) for w, cases in CASES.items()
            for name, _, _, kind in cases if kind == "generate"]


@pytest.mark.parametrize("world,name", GENERATE)
def test_mesh_engine_matches_jax_unsharded(request, setup, world, name):
    """Greedy fp32 tokens and steps of every rank equal the JAX unsharded
    engine's (int8 against JAX's int8 engine; the restricted head's audit
    counts too); prefill logits within 1e-5 of JAX's forward."""
    kw = dict(next(c for c in CASES[world] if c[0] == name)[2])
    ref = _jax_generate(setup, **kw)
    for r in _ranks(request, world):
        got = r["engine"][name]
        assert got["steps"] == ref.steps
        np.testing.assert_array_equal(got["tokens"], ref.tokens)
        if "restricted_audit_every" in kw:
            assert got["audit"] == tuple(int(v) for v in ref.audit)
            assert got["audit"][0] > 0
    if kw:
        return
    jcfg, params, _, batch, mask, *_ = setup
    eng = GenerationEngine(LMConfig.from_dict(jcfg.to_dict()),
                           lm_state_from_jax(params, setup[2]),
                           R.greedy(), bucket=32, device="cpu")
    ids, m, base = eng._bucket_prompt(batch, mask)
    jt, js = jlm.AsteroidLM(jcfg).apply(params, jnp.asarray(ids[:, :base]),
                                        jnp.asarray(m[:, :base]))
    for r in _ranks(request, world):
        got = r["engine"][name]
        np.testing.assert_allclose(got["text"], np.asarray(jt)[:, -1], **TOL)
        np.testing.assert_allclose(got["speech"], np.asarray(js)[:, -1],
                                   **TOL)


def test_mesh_engine_streaming_matches_jax(ranks2, setup):
    """generate_stream in chunks of 5 under (1, 2): the last result holds
    JAX's tokens."""
    ref = _jax_generate(setup)
    for r in ranks2:
        got = r["engine"]["stream"]
        assert got["steps"] == ref.steps
        np.testing.assert_array_equal(got["tokens"], ref.tokens)


def test_sampled_draws_under_a_data_axis(ranks2, setup):
    """Under (2, 1) every row's step-0 per-channel logits (masks and the
    repetition penalty applied: what the draw sees) equal one process's on
    the whole batch, whose prefill logits match JAX's above; the draws
    themselves come from each data rank's own generator."""
    jcfg, params, cfg, batch, mask, *_ = setup
    eng = GenerationEngine(cfg, lm_state_from_jax(params, cfg), R.sampled(),
                           bucket=32, device="cpu")
    with R.recorded_draws() as seen:
        eng.generate(batch, mask, max_new_tokens=4, seed=3)
    for r in ranks2:
        got = r["engine"]["draws"]["draw_logits"]
        assert len(got) == cfg.channels
        for c, (g, x) in enumerate(zip(got, seen)):
            np.testing.assert_allclose(g, x.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"channel {c}")
    toks = [r["engine"]["draws"]["tokens"] for r in ranks2]
    np.testing.assert_array_equal(toks[0], toks[1])


def test_collectives_are_counted(ranks2):
    """The TP run counts its collectives on the host (the smoke reports
    them a step)."""
    for r in ranks2:
        assert r["engine"]["tp"]["collectives"] > 0
        assert r["engine"]["dp"]["collectives"] > 0

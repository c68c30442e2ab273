"""Pipeline-parallel (GPipe) LM finetuning of the port on the CPU: spawned
gloo ranks (``tests/torch_mesh_ref.py``) on ("pipe", "data") meshes (2, 1),
(2, 2) and (4, 1), against JAX's plain step on the flattened batch (JAX
``tests/test_pipeline_parallel.py``): a 4-layer tiny model, 2 steps at
lr 1e-3 with the clip at 1.0 (the grad norms are above it, so a wrong
global norm moves every parameter), a left-padded row and a fully masked
label row in every microbatch. Losses, per-channel losses and grad norms
to rel 1e-5, the whole trained LM (gathered by ``pp_full_state``) by
``assert_params_close``; microbatch-count invariance, remat equal to no
remat, the LoRA-configured model, the ``ablate_norms`` stub, the
send/recv count a step. Then the
finetune CLI: ``pipeline_stages: 2`` against one process with the same
accumulation, and the layout (``pp_param_specs``) in one process."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ref as R  # noqa: E402
from moss_ttsd_tpu.train import step as jstep  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from tests.test_torch_finetune_cli import (_config, _run,  # noqa: E402
                                           tiny_data)  # noqa: F401
from tests.test_torch_lm import jax_tiny  # noqa: E402
from tests.test_torch_seqpar import assert_weights_close  # noqa: E402
from tests.test_torch_train import assert_params_close  # noqa: E402

REL = 1e-5
ROWS, T, STEPS = 6, 12, 2
# (name, pipe, data, M, remat, variant)
CASES2 = [("pp2x1", 2, 1, 3, False, ""), ("pp2x1_m6", 2, 1, 6, False, ""),
          ("pp2x1_remat", 2, 1, 3, True, ""),
          ("pp2x1_lora", 2, 1, 3, False, "lora_")]
CASES4 = [("pp2x2", 2, 2, 3, False, ""), ("pp4x1", 4, 1, 6, True, "")]
CASES = CASES2 + CASES4
ABLATE = ("pp2x1_ablate_norms", 2, 1, 3, False, "ablate_")


def _batch(cfg, seed=3):
    """6 rows of T 12: rows 0 and 3 left-padded, rows 1 and 4 with every
    label masked, so each microbatch of two rows has one of each."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 30, (ROWS, T, cfg.channels))
    ids[..., 0] = rng.integers(0, cfg.vocab_size, (ROWS, T))
    labels = rng.integers(0, 30, (ROWS, T, cfg.channels))
    labels[..., 0] = rng.integers(0, cfg.vocab_size, (ROWS, T))
    mask = np.ones((ROWS, T), np.int64)
    for r in (0, 3):
        mask[r, :3] = 0
        labels[r, :3] = -100
    labels[[1, 4]] = -100
    labels[:, :2, 2] = -100
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX weights of a 4-layer tiny LM, plain, LoRA-configured (rank 2 on
    q/v/o/down) and under ablate_norms, and the batch."""
    models = {"": jax_tiny(8, num_hidden_layers=4),
              "lora_": jax_tiny(9, num_hidden_layers=4, lora_rank=2,
                                lora_alpha=4.0,
                                lora_targets=("q_proj", "v_proj", "o_proj",
                                              "down_proj")),
              # the bench-only norm stub (every RMSNorm x*w), the stages'
              # final norm included
              "ablate_": jax_tiny(8, num_hidden_layers=4, ablate_norms=True)}
    cfgs = {v: LMConfig.from_dict(j.to_dict()) for v, (j, _) in models.items()}
    batch = _batch(cfgs[""])
    tmp = tmp_path_factory.mktemp("pp")
    inp = str(tmp / "inputs.pt")
    payload = {"pp_batch": batch}
    for v, (_, params) in models.items():
        payload[v + "cfg"] = cfgs[v].to_dict()
        payload[v + "state"] = lm_state_from_jax(params, cfgs[v])
    torch.save(payload, inp)
    return models, cfgs, batch, tmp, inp


@pytest.fixture(scope="module")
def ranks(setup):
    *_, tmp, inp = setup
    out = {}
    for world, cases in ((2, CASES2 + [ABLATE]), (4, CASES4)):
        res = R.spawn(world, R.pp_train_cases, str(tmp / f"w{world}"), inp,
                      cases, STEPS)
        for name, *_ in cases:
            out[name] = [r[name] for r in res]
    return out


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's plain step (no accumulation) on the flattened 6 rows, 2
    steps, for each model."""
    models, cfgs, batch, *_ = setup
    out = {}
    for v, (jcfg, params) in models.items():
        opt = jstep.make_optimizer(learning_rate=R.LR, total_steps=10,
                                   warmup_ratio=0.0,
                                   lr_scheduler_type="constant")
        state = jstep.init_train_state(jcfg, opt, params=params)
        step = jax.jit(jstep.make_train_step(jcfg, opt, remat=False,
                                             ce_chunks=2))
        jb = {k: jnp.asarray(x.astype(np.int32)) for k, x in batch.items()}
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, jb)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[v] = {"loss": np.array(losses), "grad_norm": np.array(norms),
                  "per_channel": np.asarray(m["loss_per_channel"]),
                  "params": lm_state_from_jax(
                      jax.tree.map(np.asarray, state.params), cfgs[v])}
    return out


@pytest.mark.parametrize("name,pipe,data,M,remat,variant", CASES,
                         ids=[c[0] for c in CASES])
def test_pp_step_matches_jax_plain_step(ranks, jax_runs, name, pipe, data,
                                        M, remat, variant):
    """Every rank reports the plain step's loss, per-channel loss and
    grad norm (the global norm over every stage; above the clip, so the
    parameters check the clip too); rank 0's gathered LM is the plain
    step's; each stage sends and receives once a microbatch a neighbour
    in each pass."""
    want = jax_runs[variant]
    assert want["grad_norm"].min() > 1.0          # the clip acts
    for rank, got in enumerate(ranks[name]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=REL)
        np.testing.assert_allclose(got["per_channel"], want["per_channel"],
                                   rtol=REL, atol=1e-7)
        stage = rank // data
        neighbours = (stage > 0) + (stage < pipe - 1)
        assert got["p2p_per_step"] == 2 * M * neighbours
    full = ranks[name][0]["params"]
    assert set(full) == set(want["params"])
    for k, v in want["params"].items():
        assert_params_close(full[k], v.numpy(), lr=R.LR,
                            err_msg=f"{name} {k}")
    assert all(r["params"] is None for r in ranks[name][1:])


def test_pp_ablate_norms_step_matches_jax_plain_step(ranks, jax_runs):
    """Two stages under the bench-only ablate_norms (every RMSNorm x*w,
    the last stage's final norm too): losses, per-channel losses and grad
    norms of JAX's plain step within rel 1e-5 (the stub's small gradients
    stay under the clip), and its trained LM."""
    want = jax_runs["ablate_"]
    for got in ranks[ABLATE[0]]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=REL)
        np.testing.assert_allclose(got["per_channel"], want["per_channel"],
                                   rtol=REL, atol=1e-7)
    assert not np.allclose(want["loss"], jax_runs[""]["loss"])
    full = ranks[ABLATE[0]][0]["params"]
    for k, v in want["params"].items():
        assert_params_close(full[k], v.numpy(), lr=R.LR, err_msg=k)


def test_pp_microbatch_count_and_remat_invariance(ranks):
    """The same rows as 3 microbatches of 2 or 6 of 1, with remat or
    without: the same loss (rel 1e-6) and grad norm (rel 1e-5)."""
    base = ranks["pp2x1"][0]
    for other in ("pp2x1_m6", "pp2x1_remat"):
        got = ranks[other][0]
        np.testing.assert_allclose(got["loss"], base["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], base["grad_norm"],
                                   rtol=REL)


def test_pp_lora_factors_train(ranks, setup):
    """The LoRA-configured model pipe-shards its factors like any layer
    leaf: lora_b (zero at init) moved in every layer of both stages."""
    cfg = setup[1]["lora_"]
    init = torch.load(setup[-1], weights_only=False)["lora_state"]
    full = ranks["pp2x1_lora"][0]["params"]
    for i in range(cfg.num_hidden_layers):
        k = f"layers.{i}.q_proj.lora_b"
        assert not np.allclose(full[k], init[k].numpy()), k


def test_pp_param_specs():
    """Layer leaves (LoRA factors too) are "pipe", the embeddings and the
    final norm replicated; a layer count the stages do not divide is
    refused; ``stage_layers`` gives stage s its contiguous layers."""
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.parallel.pipeline import (pp_batch_specs,
                                                   pp_param_specs,
                                                   stage_layers)
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny(
        num_hidden_layers=4, lora_rank=2)
    params = dict(AsteroidLM(cfg).named_parameters())
    specs = pp_param_specs(params, 2)
    assert specs["layers.3.q_proj.lora_a"] == "pipe"
    assert specs["layers.0.input_ln.weight"] == "pipe"
    assert {k for k, v in specs.items() if v == "replicated"} == {
        "embed_text", "embed_speech", "final_norm.weight"}
    with pytest.raises(ValueError, match="not divisible"):
        pp_param_specs(params, 3)
    assert [list(stage_layers(4, 2, s)) for s in (0, 1)] == [[0, 1], [2, 3]]
    assert pp_batch_specs()["labels"] == (None, "data")


def test_finetune_cli_pipeline_matches_accumulation(tiny_data, tmp_path):
    """``pipeline_stages: 2`` over two ranks (one layer a stage, K 2 = two
    microbatches of 2 rows) against one process at K 2, 3 steps,
    checkpointed at step 2 (each stage writes its part): the same
    model.npz (``assert_weights_close``) and logs."""
    import json
    one = _config(tmp_path, sched="constant")
    pp = tmp_path / "pp.yaml"
    pp.write_text(open(one).read() + "pipeline_stages: 2\n")
    a, b = str(tmp_path / "one"), str(tmp_path / "pp")
    _run("--data_dir", tiny_data, "--output_dir", a, "--training_config",
         one, "--max_steps", "3")
    out = R.launch_finetune(2, "--data_dir", tiny_data, "--output_dir", b,
                            "--training_config", str(pp), "--max_steps",
                            "3", "--save_steps", "2")
    assert out.count("checkpointed step 2") == 1
    assert sorted(os.listdir(os.path.join(b, "checkpoints", "step_2"))) == [
        "state_stage0.pt", "state_stage1.pt"]
    assert_weights_close(os.path.join(a, "model.npz"),
                         os.path.join(b, "model.npz"), lr=1e-3)
    logs = [[json.loads(line) for line in open(os.path.join(d,
                                                            "train_log.jsonl"))]
            for d in (a, b)]
    for la, lb in zip(*logs):
        np.testing.assert_allclose(lb["loss"], la["loss"], rtol=REL)
        np.testing.assert_allclose(lb["grad_norm"], la["grad_norm"],
                                   rtol=REL)

"""Data-parallel LM finetuning of the port on the CPU: two spawned gloo
ranks (``tests/torch_mesh_ref.py``), one row of each micro batch a rank,
against one process on the whole batch for the full and the layerwise
LoRA step at accumulation 1 and 2 (losses and grad norms to rel 1e-5,
the trained tensors by ``assert_params_close``), the first step's loss
against the JAX DP step's; and the finetune CLI under a two-rank
``torch.distributed.run`` launch: one checkpoint written, resumed, equal
to one process's run on the same global batch. One group serves every
step case (a module-scoped fixture)."""
import dataclasses
import json
import os
import socket
import subprocess
import sys

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
from tests.test_torch_finetune_cli import (_config, _load_port,  # noqa: E402
                                           tiny_data)  # noqa: F401
from tests.test_torch_lm import jax_tiny  # noqa: E402
from tests.test_torch_train import assert_params_close  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
# (name, lora, K): every step case of the group
CASES = [("full_k1", False, 1), ("full_k2", False, 2),
         ("lora_k1", True, 1), ("lora_k2", True, 2)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX weights and a global batch of 4 rows with -100 labels."""
    jcfg, params = jax_tiny(4)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(4)
    B, T = 4, 12
    ids = rng.integers(0, 30, (B, T, cfg.channels))
    ids[..., 0] = rng.integers(0, cfg.vocab_size, (B, T))
    labels = rng.integers(0, 30, (B, T, cfg.channels))
    labels[:, :3] = -100
    labels[1, :7, 2] = -100
    mask = np.ones((B, T), np.int64)
    mask[3, :2] = 0
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask}
    tmp = tmp_path_factory.mktemp("dp")
    inp = str(tmp / "inputs.pt")
    torch.save({"cfg": cfg.to_dict(), "state": lm_state_from_jax(params, cfg),
                "train_batch": batch}, inp)
    return jcfg, params, batch, tmp, inp


@pytest.fixture(scope="module")
def ranks(setup):
    *_, tmp, inp = setup
    return R.spawn(2, R.dp_train_cases, str(tmp / "w2"), inp, CASES)


@pytest.mark.parametrize("name,lora,K", CASES, ids=[c[0] for c in CASES])
def test_dp_step_matches_one_process(ranks, setup, name, lora, K):
    """3 steps: both ranks report the global loss and grad norm of one
    process on the whole batch, and hold its trained tensors."""
    inp = setup[-1]
    single = R.train_run(inp, lora, K)
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], single["grad_norm"],
                                   rtol=REL)
        np.testing.assert_allclose(got["per_channel"],
                                   single["per_channel"], rtol=REL,
                                   atol=1e-7)
        assert set(got["params"]) == set(single["params"])
        for k, v in single["params"].items():
            assert_params_close(got["params"][k], v, lr=R.LR, err_msg=k)
    if lora:
        assert all(".lora_" in k for k in single["params"])


@pytest.mark.parametrize("K", [1, 2])
def test_dp_first_loss_matches_jax(ranks, setup, K):
    """The DP step's first loss is the JAX step's on the same weights and
    batch (JAX ``tests/test_train.py``'s DP equivalence, here across
    frameworks)."""
    jcfg, params, batch, *_ = setup
    opt = jstep.make_optimizer(learning_rate=R.LR, total_steps=10,
                               warmup_ratio=0.0)
    state = jstep.init_train_state(jcfg, opt, params=params)
    step = jstep.make_train_step(jcfg, opt, remat=False, ce_chunks=2,
                                 grad_accum_steps=K)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if K > 1:
        jb = jax.tree.map(lambda x: x.reshape((K, -1) + x.shape[1:]), jb)
    _, m = jax.jit(step)(state, jb)
    for r in ranks:
        np.testing.assert_allclose(r[f"full_k{K}"]["loss"][0],
                                   float(m["loss"]), rtol=REL)


# -- the finetune CLI under torch.distributed.run --------------------------------

def _launch(*args):
    """The finetune CLI as two ranks of ``torch.distributed.run`` on the
    CPU (its own store on a free 127.0.0.1 port)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(port), "-m", "moss_ttsd_torch.cli.finetune",
           "--tiny", "--platform", "cpu", *args]
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-5000:]
    return p.stdout


def test_finetune_cli_data_parallel_resume(tiny_data, tmp_path):
    """Two ranks of one row a micro batch (K 2) take the global batch one
    process takes with per_device_train_batch_size 2: 2 steps checkpointed
    (one checkpoint, by rank 0), then --resume to step 4; the logs of
    steps 3-4 and model.npz equal the one-process straight run's."""
    one = _config(tmp_path, sched="constant")
    two = tmp_path / "train_dp.yaml"
    two.write_text(open(one).read().replace(
        "per_device_train_batch_size: 2", "per_device_train_batch_size: 1"))
    a, b = str(tmp_path / "one"), str(tmp_path / "dp")
    from moss_ttsd_torch.cli.finetune import main
    assert main(["--tiny", "--platform", "cpu", "--data_dir", tiny_data,
                 "--output_dir", a, "--training_config", one,
                 "--max_steps", "4"]) == 0
    out = _launch("--data_dir", tiny_data, "--output_dir", b,
                  "--training_config", str(two), "--max_steps", "2",
                  "--save_steps", "2")
    assert out.count("checkpointed step 2") == 1
    assert os.listdir(os.path.join(b, "checkpoints")) == ["step_2"]
    out = _launch("--data_dir", tiny_data, "--output_dir", b,
                  "--training_config", str(two), "--max_steps", "4",
                  "--resume")
    assert out.count("resumed from") == 1
    logs = [[json.loads(l) for l in open(os.path.join(d, "train_log.jsonl"))]
            for d in (a, b)]
    assert [l["step"] for l in logs[1]] == [1, 2, 3, 4]
    for la, lb in zip(logs[0], logs[1]):
        np.testing.assert_allclose(lb["loss"], la["loss"], rtol=REL)
        np.testing.assert_allclose(lb["grad_norm"], la["grad_norm"],
                                   rtol=REL)
    x, y = _load_port(os.path.join(a, "model.npz")), _load_port(
        os.path.join(b, "model.npz"))
    for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
        assert_params_close(w.numpy(), v.numpy(), lr=1e-3, err_msg=k)
    meta = json.load(open(os.path.join(b, "train_config.json")))
    assert meta["steps"] == 4


REFUSALS = [
    ("sequence_parallel: 2\n", True, "full finetuning"),
    ("pipeline_stages: 2\n", True, "full finetuning"),
    ("sequence_parallel: 2\npipeline_stages: 2\n", False,
     "not pipeline_stages"),
    ("sequence_parallel: 2\n", False, "must divide the 1 processes"),
    ("pipeline_stages: 3\n", False, "must divide the model's 2 layers"),
]


@pytest.mark.parametrize("yaml,lora,message", REFUSALS,
                         ids=["sp_lora", "pp_lora", "sp_with_pp",
                              "sp_not_dividing_world",
                              "pp_not_dividing_layers"])
def test_finetune_cli_refuses_what_jax_refuses(tiny_data, tmp_path, yaml,
                                               lora, message):
    """The combinations the JAX CLI refuses (moss_ttsd_tpu/cli/finetune.py)
    exit with the reason (status 1), before any model is built: sequence or
    pipeline parallelism with --lora, the two together, a
    sequence_parallel that does not divide the processes (one here), a
    pipeline_stages that does not divide the --tiny model's 2 layers."""
    from moss_ttsd_torch.cli.finetune import main
    cfg = tmp_path / "train.yaml"
    cfg.write_text(yaml)
    out = tmp_path / "x"
    with pytest.raises(SystemExit) as e:
        main(["--tiny", "--platform", "cpu", "--data_dir", tiny_data,
              "--output_dir", str(out), "--training_config", str(cfg)]
             + (["--lora"] if lora else []))
    assert message in str(e.value.code)
    assert not out.exists()


def test_global_mesh_and_specs_of_the_train_state(tmp_path):
    """``global_mesh`` over a one-process group, and the train state's
    layout: the AdamW moments take their parameter's kind."""
    import torch.distributed as dist
    from moss_ttsd_torch.parallel.distributed import (global_mesh,
                                                      initialize_multihost)
    from moss_ttsd_torch.parallel.mesh import lm_param_specs
    from moss_ttsd_torch.train.step import (init_train_state, make_optimizer,
                                            make_train_step,
                                            shard_train_step,
                                            train_state_specs)
    cfg = dataclasses.replace(LMConfig().tiny(), dtype="float32",
                              param_dtype="float32")
    assert initialize_multihost("file://" + str(tmp_path / "store"), 1, 0,
                                device="cpu")
    try:
        mesh = global_mesh(device_type="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        opt = make_optimizer(total_steps=4)
        state = init_train_state(cfg, opt, device="cpu")
        step = shard_train_step(make_train_step, mesh, cfg, opt, remat=False)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 30, (2, 8, cfg.channels))
        step(state, {"input_ids": ids, "labels": ids,
                     "attention_mask": np.ones((2, 8), np.int64)})
        specs = lm_param_specs(state.params, cfg, model_size=2)
        tree = train_state_specs(state, specs)
        name = "layers.0.q_proj.weight"
        assert tree["params"][name] == "colwise"
        assert tree["opt_state"][name]["exp_avg"] == "colwise"
        assert tree["opt_state"][name]["step"] == "replicated"
        assert tree["opt_state"]["embed_text"]["exp_avg_sq"] == "vocab"
    finally:
        dist.destroy_process_group()

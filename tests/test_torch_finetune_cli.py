"""The port's finetune CLI and workflow, ``--tiny --platform cpu``: a
checkpointed run resumed to the end equals the straight run; ``model.npz``
loads through JAX's ``load_pytree`` and gives JAX's forward the port's
logits; ``lora_factors.npz`` serves as a voice through the port's
inference CLI (``--lora_adapter``, per-item ``"voice"``), and in fp32 the
greedy tokens of ``model_merged.npz`` equal those of the base model with
that voice; ``finetune_workflow --tiny`` preprocesses the examples' voices
with the port's codec and trains."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from moss_ttsd_tpu.core import checkpoint as jckpt  # noqa: E402
from moss_ttsd_tpu.core.config import LMConfig as JLMConfig  # noqa: E402
from moss_ttsd_tpu.models import lm as jlm  # noqa: E402
from moss_ttsd_torch.cli.finetune import main as finetune_main  # noqa: E402
from moss_ttsd_torch.cli.inference import tiny_lm_config  # noqa: E402
from moss_ttsd_torch.core.checkpoint import load_pytree  # noqa: E402
from moss_ttsd_torch.models.lm import AsteroidLM  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from tests.test_torch_train_data import voice_training_jsonl  # noqa: E402

CFG_YAML = """# a short run: every step logged, fp32 compute
per_device_train_batch_size: 2
gradient_accumulation_steps: 2
learning_rate: {lr}
lr_scheduler_type: {sched}
warmup_ratio: 0.25
logging_steps: 1
dataloader_num_workers: 1
gradient_checkpointing: true
max_length: 48
bf16: false
report_to: none
"""


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    """Eight records of the tiny geometry, written as process_data writes
    them (speech pad 64, channel-0 ids in the tiny vocab, the first half of
    each labelled -100)."""
    d = tmp_path_factory.mktemp("ft_data")
    rng = np.random.default_rng(0)
    flat = {}
    for i in range(8):
        T = 12 + 3 * i
        ids = rng.integers(0, 64, (T, 8))
        ids[:, 0] = rng.integers(1, 160, T)
        labels = ids.copy()
        labels[: T // 2] = -100
        flat[f"input_ids_{i}"] = ids
        flat[f"labels_{i}"] = labels
    np.savez(os.path.join(d, "processed_data_00000.npz"), **flat)
    return str(d)


def _config(tmp_path, lr=1e-3, sched="cosine"):
    path = tmp_path / f"train_{lr}_{sched}.yaml"
    path.write_text(CFG_YAML.format(lr=lr, sched=sched))
    return str(path)


def _run(*args):
    assert finetune_main(["--tiny", "--platform", "cpu", *args]) == 0


def _load_port(path, cfg=None):
    cfg = cfg or tiny_lm_config()
    model = AsteroidLM(cfg)
    model.load_state_dict(lm_state_from_jax(load_pytree(path), cfg))
    return model


def test_resume_equals_straight_run(tiny_data, tmp_path):
    """K 2 accumulation, remat, the cosine warmup; 2 steps checkpointed,
    then --resume to step 4: the same model.npz as 4 straight steps, and
    the logs of steps 3-4 equal."""
    cfg = _config(tmp_path)
    a, b = str(tmp_path / "straight"), str(tmp_path / "resumed")
    _run("--data_dir", tiny_data, "--output_dir", a, "--training_config",
         cfg, "--max_steps", "4")
    _run("--data_dir", tiny_data, "--output_dir", b, "--training_config",
         cfg, "--max_steps", "2", "--save_steps", "2")
    assert os.path.isfile(os.path.join(b, "checkpoints", "step_2",
                                       "state.pt"))
    _run("--data_dir", tiny_data, "--output_dir", b, "--training_config",
         cfg, "--max_steps", "4", "--save_steps", "2", "--resume")
    with np.load(os.path.join(a, "model.npz")) as x, \
            np.load(os.path.join(b, "model.npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    logs = [[json.loads(l) for l in open(os.path.join(d, "train_log.jsonl"))]
            for d in (a, b)]
    assert [l["step"] for l in logs[0]] == [1, 2, 3, 4]
    assert [l["step"] for l in logs[1]] == [1, 2, 3, 4]
    for la, lb in zip(logs[0][2:], logs[1][2:]):
        assert la["loss"] == lb["loss"] and la["grad_norm"] == lb["grad_norm"]
    assert logs[0][-1]["loss"] < logs[0][0]["loss"]
    meta = json.load(open(os.path.join(b, "train_config.json")))
    assert meta["steps"] == 4 and meta["lora"] is False
    assert meta["config"]["max_length"] == 48


def test_labels_beyond_the_vocab_fail_loudly(tmp_path):
    """A record whose labels the tiny model's heads cannot hold is refused
    on the host, before a gather on the card would assert."""
    ids = np.full((12, 8), 64, np.int64)
    ids[:, 0] = 400                                  # vocab is 300
    np.savez(tmp_path / "processed_data_00000.npz", input_ids_0=ids,
             labels_0=ids)
    with pytest.raises(ValueError, match="beyond the model's vocab"):
        _run("--data_dir", str(tmp_path), "--output_dir",
             str(tmp_path / "out"), "--max_steps", "1")


def test_model_npz_gives_jax_forward_the_port_logits(tiny_data, tmp_path):
    out = str(tmp_path / "full")
    _run("--data_dir", tiny_data, "--output_dir", out, "--training_config",
         _config(tmp_path), "--max_steps", "2")
    path = os.path.join(out, "model.npz")
    model = _load_port(path)
    base = AsteroidLM.init_random(tiny_lm_config(), seed=0, device="cpu")
    assert not torch.equal(model.embed_text, base.embed_text)   # it trained
    jcfg = JLMConfig.from_dict(tiny_lm_config().to_dict())
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 9, 8))
    ids[..., 0] = rng.integers(0, 300, (2, 9))
    jt, js = jlm.AsteroidLM(jcfg).apply(jckpt.load_pytree(path),
                                        jnp.asarray(ids))
    with torch.no_grad():
        pt, ps = model(torch.from_numpy(ids))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-4)


@pytest.fixture(scope="module")
def lora_run(tiny_data, tmp_path_factory):
    """Three LoRA steps at a rate high enough to move the voice."""
    tmp = tmp_path_factory.mktemp("lora")
    out = str(tmp / "lora")
    _run("--data_dir", tiny_data, "--output_dir", out, "--training_config",
         _config(tmp, lr=3e-2, sched="constant"), "--lora", "--max_steps", "3")
    return out


def test_lora_outputs_and_jax_layout(lora_run):
    files = sorted(os.listdir(lora_run))
    assert {"lora_factors.npz", "model_merged.npz", "train_config.json",
            "train_log.jsonl"} <= set(files)
    tree = jckpt.load_pytree(os.path.join(lora_run, "lora_factors.npz"))
    block = tree["params"]["layers"]["block"]
    assert sorted(block) == sorted(["q_proj", "k_proj", "v_proj", "o_proj",
                                    "gate_proj", "up_proj", "down_proj"])
    assert block["q_proj"]["lora_a"].shape == (2, 64, 16)
    assert block["down_proj"]["lora_b"].shape == (2, 16, 64)
    assert float(jnp.abs(block["q_proj"]["lora_b"]).max()) > 0
    merged = jckpt.load_pytree(os.path.join(lora_run, "model_merged.npz"))
    assert "lora_a" not in merged["params"]["layers"]["block"]["q_proj"]


def _greedy_tokens(model, adapter_tree=None):
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    cfg = tiny_lm_config()
    sampling = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(cfg.channels)], max_new_tokens=24)
    eng = GenerationEngine(cfg, model, sampling, device="cpu")
    if adapter_tree is not None:
        eng.register_adapter("v", adapter_tree, alpha=32.0, use_rslora=True)
    rng = np.random.default_rng(2)
    ids = np.full((2, 10, cfg.channels), cfg.speech_pad_token, np.int64)
    ids[..., 0] = rng.integers(1, 80, (2, 10))
    res = eng.generate(ids, np.ones((2, 10), np.int64), seed=0,
                       adapter=None if adapter_tree is None else "v")
    return np.asarray(res.tokens)


def test_merged_model_tokens_equal_base_with_voice(lora_run):
    """fp32 greedy decode: model_merged.npz gives the tokens the base model
    gives with lora_factors.npz as a registered voice (and the voice
    changes them)."""
    base = AsteroidLM.init_random(tiny_lm_config(), seed=0, device="cpu")
    factors = load_pytree(os.path.join(lora_run, "lora_factors.npz"))
    voiced = _greedy_tokens(base, factors)
    merged = _greedy_tokens(_load_port(os.path.join(lora_run,
                                                    "model_merged.npz")))
    np.testing.assert_array_equal(merged, voiced)
    assert not np.array_equal(voiced, _greedy_tokens(base))


def test_lora_factors_serve_through_the_inference_cli(lora_run, tmp_path):
    from moss_ttsd_torch.cli.inference import main as infer_main
    jsonl = tmp_path / "voices.jsonl"
    jsonl.write_text(json.dumps({"text": "[S1]hello there[S2]hi",
                                 "voice": "trained"}) + "\n"
                     + json.dumps({"text": "[S1]the base voice"}) + "\n")
    out = tmp_path / "wav"
    rc = infer_main(["--jsonl", str(jsonl), "--tiny", "--platform", "cpu",
                     "--output_dir", str(out), "--max_new_tokens", "40",
                     "--lora_adapter",
                     f"trained={os.path.join(lora_run, 'lora_factors.npz')}"])
    assert rc == 0
    assert "output_0.wav" in os.listdir(out)


def test_finetune_workflow_tiny(tmp_path):
    """Preprocess the examples' voices with the port's codec, then two
    LoRA steps, from one workflow YAML read by the port's YAML reader."""
    from moss_ttsd_torch.cli.finetune_workflow import main as wf_main
    jsonl = voice_training_jsonl(tmp_path / "train.jsonl")
    wf = tmp_path / "wf.yaml"
    wf.write_text(f"""data_preprocess:
  jsonl: {jsonl}
  output_dir: {tmp_path / 'processed'}
  use_normalize: true
finetune:
  output_dir: {tmp_path / 'ft_out'}
  lora: true
  max_steps: 2
""")
    assert wf_main(["--config", str(wf), "--tiny", "--platform", "cpu"]) == 0
    index = json.load(open(tmp_path / "processed" /
                           "processed_data_index.json"))
    assert index["total"] == 2
    assert os.path.isfile(tmp_path / "ft_out" / "lora_factors.npz")
    # the second run skips preprocessing and trains on what is there
    assert wf_main(["--config", str(wf), "--tiny", "--platform", "cpu",
                    "--pass_data_preprocess"]) == 0

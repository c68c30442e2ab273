"""The PyTorch port imports nothing of JAX or the JAX package, and its entry
points refuse to run on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "moss_ttsd_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "moss_ttsd_tpu")


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_ref_codec.py",
       ROOT / "tests" / "torch_codec_train_ref.py"]))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


@pytest.mark.parametrize("module", ["moss_ttsd_torch.train.codec_step",
                                    "moss_ttsd_torch.parallel.distributed"])
def test_codec_training_imports_without_jax_cuda_or_triton(module):
    """Codec training and the process-group init import with JAX and
    Triton unimportable and no card visible."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'triton'):\n"
            "    sys.modules[m] = None\n"
            f"import {module}\n"
            "import torch\n"
            "assert not torch.cuda.is_available()\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_lm():
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    return cfg, AsteroidLM.init_random(cfg, seed=0, device="cpu")


def test_engine_without_cuda_raises(no_cuda):
    from moss_ttsd_torch.decode.engine import GenerationEngine
    cfg, model = _tiny_lm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(cfg, model)
    GenerationEngine(cfg, model, device="cpu")          # asked for: runs


def test_pool_and_registry_without_cuda_raise(no_cuda):
    """The continuous pool runs on the card unless asked for the CPU; a
    CPU engine's LoRA stacks stay on the CPU."""
    from moss_ttsd_torch.decode.continuous import ContinuousBatcher
    from moss_ttsd_torch.decode.engine import GenerationEngine
    cfg, model = _tiny_lm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(cfg, model, slots=2, base=16, max_steps=16)
    cb = ContinuousBatcher(cfg, model, slots=2, base=16, max_steps=16,
                           device="cpu")
    assert cb.state.tokens.device.type == "cpu"
    eng = GenerationEngine(cfg, model, device="cpu")
    assert eng.lora.device.type == "cpu"


def test_codec_without_cuda_raises(no_cuda):
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        XYTokenizer.init_random(CodecConfig().tiny())
    XYTokenizer.init_random(CodecConfig().tiny(), device="cpu")


def test_codec_training_without_cuda_raises(no_cuda, monkeypatch):
    """The codec train state is made on the card unless asked for the CPU;
    the process-group init has nothing to do without an address and would
    join an nccl group on the card."""
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    from moss_ttsd_torch.train.codec_step import init_codec_train_state
    from moss_ttsd_torch.train.step import make_optimizer
    opt = make_optimizer(total_steps=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_codec_train_state(CodecConfig().tiny(), opt)
    state = init_codec_train_state(CodecConfig().tiny(), opt, device="cpu")
    assert state.cluster_size.device.type == "cpu"
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_multihost() is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_multihost("localhost:1", 2, 0)


def test_lm_without_cuda_raises(no_cuda):
    """AsteroidLM.init_random and init_cache default to the card too."""
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.models.lm import AsteroidLM, init_cache
    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsteroidLM.init_random(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    model = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert init_cache(cfg, 1, 8, device="cpu")["k"].device.type == "cpu"


def test_pipeline_without_cuda_raises(no_cuda):
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    cfg, model = _tiny_lm()
    spt = XYTokenizer.init_random(CodecConfig().tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSPipeline(MockTokenizer(), cfg, model, spt)


def test_cli_without_cuda_raises(no_cuda, tmp_path):
    from moss_ttsd_torch.cli.inference import main
    args = ["--jsonl", str(ROOT / "examples" / "examples_only_text.jsonl"),
            "--tiny", "--max_new_tokens", "4", "--output_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


def test_cli_unported_flags_fail_loudly(tmp_path):
    from moss_ttsd_torch.cli.inference import main
    for extra in (["--mesh", "2x1"], ["--attn_impl", "flash"],
                  ["--profiler_port", "9999"],
                  ["--lora_adapter", "a=b"], ["--quant", "int4"]):
        with pytest.raises(SystemExit):
            main(["--tiny", "--platform", "cpu", *extra])
    # without --tiny the CLI loads the checkpoint (TTSPipeline.load): the
    # default --model_path is no directory here
    with pytest.raises(FileNotFoundError, match="fnlp/MOSS-TTSD-v0.5"):
        main(["--platform", "cpu", "--output_dir", str(tmp_path)])


def test_server_without_cuda_raises(no_cuda):
    """The server CLI and the tiny pipeline it serves run on the card
    unless asked for the CPU; the streaming path has no CPU fallback."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline
    from moss_ttsd_torch.serve.server import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--tiny", "--host", "127.0.0.1", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--host", "127.0.0.1", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tiny_pipeline()


def test_stream_item_runs_where_its_pipeline_runs(no_cuda):
    """stream_item runs on its pipeline's device: a CPU pipeline streams on
    the CPU with no card; a card pipeline cannot be built without one."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline
    pipe = build_tiny_pipeline(device="cpu")
    chunks = list(pipe.stream_item({"text": "[S1]hi[S2]there"},
                                   max_new_tokens=12, chunk_steps=4))
    assert chunks and all(sr == 24000 for _, sr in chunks)
    assert pipe.engine.device.type == pipe.spt.device.type == "cpu"


def test_codec_roundtrip_cli_refuses_unported_flags(tmp_path):
    from moss_ttsd_torch.cli.codec_roundtrip import main
    base = ["--input_dir", str(ROOT / "examples"), "--output_dir",
            str(tmp_path)]
    # --debug 1 waits for a debugger, as the JAX CLI's does
    # (tests/test_torch_helpers.py)
    with pytest.raises(SystemExit):
        main([*base, "--platform", "cpu", "--config", "c.yaml"])
    # --config / --checkpoint load the codec (XYTokenizer.load_from_checkpoint)
    with pytest.raises(FileNotFoundError, match="c.yaml"):
        main([*base, "--platform", "cpu", "--config", "c.yaml",
              "--checkpoint", "c.ckpt"])
    assert not list(tmp_path.iterdir())


def test_codec_roundtrip_cli_without_cuda_raises(no_cuda, tmp_path):
    from moss_ttsd_torch.cli.codec_roundtrip import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--input_dir", str(ROOT / "examples"), "--output_dir",
              str(tmp_path), "--tiny"])


def test_cli_tiny_cpu_writes_wavs(tmp_path):
    from moss_ttsd_torch.cli.inference import main
    rc = main(["--jsonl", str(ROOT / "examples" / "examples_only_text.jsonl"),
               "--tiny", "--platform", "cpu", "--max_new_tokens", "16",
               "--output_dir", str(tmp_path),
               "--summary_file", str(tmp_path / "summary.jsonl")])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("*.wav")) == [
        "output_0.wav", "output_1.wav"]
    assert len((tmp_path / "summary.jsonl").read_text().splitlines()) == 2


def _one_record(tmp_path):
    import numpy as np
    ids = np.full((16, 8), 64, np.int64)
    ids[:, 0] = np.arange(1, 17)
    np.savez(tmp_path / "processed_data_00000.npz", input_ids_0=ids,
             labels_0=ids)
    return str(tmp_path)


def test_finetune_cli_without_cuda_raises(no_cuda, tmp_path):
    """The finetune CLI and the workflow train (and preprocess) on the
    card unless --platform cpu."""
    from moss_ttsd_torch.cli.finetune import main
    from moss_ttsd_torch.cli.finetune_workflow import main as wf_main
    data = _one_record(tmp_path)
    args = ["--data_dir", data, "--output_dir", str(tmp_path / "out"),
            "--tiny", "--max_steps", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    assert main(args + ["--platform", "cpu"]) == 0
    wf = tmp_path / "wf.yaml"
    wf.write_text(f"data_preprocess:\n  jsonl: {tmp_path / 'x.jsonl'}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf_main(["--config", str(wf), "--tiny"])


@pytest.mark.parametrize("config,extra", [
    ("", []),                      # no --tiny and no --model_path
    ("pipeline_stages: 2\n", ["--tiny"]),
    ("sequence_parallel: 2\n", ["--tiny"]),
    ("learning_rate: 1e-4\n", ["--tiny"]),         # YAML 1.1 reads a string
])
def test_finetune_cli_unported_fail_loudly(tmp_path, config, extra):
    from moss_ttsd_torch.cli.finetune import main
    tc = tmp_path / "tc.yaml"
    tc.write_text(config)
    with pytest.raises(SystemExit):
        main(["--data_dir", _one_record(tmp_path), "--output_dir",
              str(tmp_path / "out"), "--platform", "cpu",
              "--training_config", str(tc), *extra])
    assert not (tmp_path / "out").exists()


def test_finetune_workflow_without_tiny_fails_loudly(tmp_path):
    from moss_ttsd_torch.cli.finetune_workflow import main
    wf = tmp_path / "wf.yaml"
    wf.write_text(f"data_preprocess:\n  jsonl: {tmp_path / 'x.jsonl'}\n")
    with pytest.raises(SystemExit):
        main(["--config", str(wf), "--platform", "cpu"])

"""Finetuning CLI for the PyTorch port: full finetuning or layerwise LoRA
on the CUDA card (``--platform cpu`` runs on the CPU), data-parallel over
a process group when one is named.

Mirrors ``moss_ttsd_tpu/cli/finetune.py``: the same flags (--model_path
--data_dir --output_dir --training_config --lora_config --lora --tiny
--platform --max_steps --save_steps --resume), the same training-config
keys and defaults, and the same output files, written in the JAX
package's npz layout (``utils/convert_jax.lm_state_to_jax``):
``model.npz`` (full) or ``model_merged.npz`` + ``lora_factors.npz``
(LoRA; the factors serve as a voice through ``--lora_adapter`` of the
inference CLI and the server), ``train_config.json``, ``train_log.jsonl``
and ``checkpoints/step_<n>`` (``--save_steps``; ``--resume`` continues
from the newest).

    python -m moss_ttsd_torch.cli.finetune --data_dir processed_data \\
        --output_dir finetune_out --tiny --platform cpu --max_steps 4

``--model_path`` (without ``--tiny``) finetunes a real checkpoint: the
HF-format directory's weights as fp32 masters and its tokenizer (which
needs ``transformers``).

Data parallelism: launched as N processes (``python -m
torch.distributed.run --nproc_per_node N``, or the ``JAX_*`` variables of
``parallel/distributed.py``), the ranks join one group and one step
takes ``per_device_train_batch_size`` x D rows (x the accumulation), D
the data ranks: every rank builds the same global batch and trains on its
rows, the gradients are summed over the group. Rank 0 logs and writes
every file; the others wait for it.

``sequence_parallel: SP`` (full finetuning only) splits the N ranks into
N/SP data ranks of SP seq ranks each (``make_mesh(seq=)``): a data rank's
seq ranks get its rows and each trains on its 1/SP of their time axis
(collate pads T to a multiple of 64). ``pipeline_stages: S`` (full
finetuning only) runs the GPipe step (``parallel/pipeline.py``) on an
(S, N/S) ("pipe", "data") mesh: each stage holds L/S layers, the
accumulation axis is the microbatch stream, rank 0 gathers the layers to
write ``model.npz``, and each stage checkpoints its own part. As in JAX,
both are refused with ``--lora``, together, or where they do not divide
the ranks (or the layers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

def _read_config(path, parser):
    from ..utils import config_yaml
    if not path or not os.path.exists(path):
        return {}
    try:
        return config_yaml.load(path) or {}
    except ValueError as e:
        parser.error(f"{path}: {e}")


def _hf_layers(model_path: str) -> int:
    with open(os.path.join(model_path, "config.json")) as f:
        return int(json.load(f)["num_hidden_layers"])


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Finetune AsteroidLM (PyTorch / CUDA port)")
    parser.add_argument("--model_path", default=None,
                        help="HF checkpoint dir; omit with --tiny")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--training_config", default=None)
    parser.add_argument("--lora_config", default=None)
    parser.add_argument("--lora", action="store_true")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random model (smoke test)")
    parser.add_argument("--platform", choices=["default", "cpu"],
                        default="default",
                        help="default = the CUDA card; cpu = run on the CPU")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--save_steps", type=int, default=None,
                        help="checkpoint the train state every N steps "
                             "(default: training_config save_steps, else off)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "<output_dir>/checkpoints")
    args = parser.parse_args(argv)

    tc = _read_config(args.training_config, parser)
    from ..train.lora import DEFAULT_TARGETS
    lc = {"r": 16, "lora_alpha": 32, "use_rslora": True,
          "target_modules": list(DEFAULT_TARGETS)}
    lc.update(_read_config(args.lora_config, parser))

    if not args.tiny and not args.model_path:
        parser.error("--model_path is required without --tiny")

    import torch
    import torch.distributed as dist
    from ..core.checkpoint import (latest_step, restore_train_state,
                                   save_pytree, save_train_state)
    from ..core.device import resolve_device
    from ..models.lm import AsteroidLM
    from ..parallel.distributed import initialize_multihost
    from ..parallel.mesh import batch_spec, make_mesh
    from ..parallel.pipeline import (make_pp_mesh, make_pp_train_step,
                                     pp_full_state, pp_stage_model)
    from ..train.data import Prefetcher, TrainingDataset, collate
    from ..train.step import (init_train_state, make_optimizer,
                              make_train_step, shard_train_step)
    from ..train.telemetry import TrainLogger
    from ..utils.convert_jax import lm_state_to_jax
    from ..utils.mock_tokenizer import MockTokenizer
    from .inference import tiny_lm_config

    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    # a launcher (or the JAX variables) names a group: data parallelism,
    # with a seq or a pipe axis when the config asks for one
    grouped = initialize_multihost(device=device)
    world = dist.get_world_size() if grouped else 1
    pp_stages = int(tc.get("pipeline_stages", 0) or 0)
    sp = int(tc.get("sequence_parallel", 1) or 1)

    def refuse(msg):
        # exit status 1 with the reason, as JAX's CLI returns 1
        if grouped:
            dist.destroy_process_group()
        raise SystemExit(msg)
    if pp_stages > 1 or sp > 1:
        # JAX's refusals (moss_ttsd_tpu/cli/finetune.py)
        if args.lora:
            refuse("pipeline_stages and sequence_parallel are for full "
                   "finetuning; the layerwise LoRA step shards over the "
                   "data ranks only")
        if pp_stages > 1 and sp > 1:
            refuse("sequence_parallel composes with the full-finetune DP "
                   "step only (not pipeline_stages)")
        n = pp_stages if pp_stages > 1 else sp
        layers = (tiny_lm_config().num_hidden_layers if args.tiny else
                  _hf_layers(args.model_path))
        if pp_stages > 1 and layers % pp_stages:
            refuse(f"pipeline_stages={pp_stages} must divide the model's "
                   f"{layers} layers")
        if world % n:
            key = ("pipeline_stages" if pp_stages > 1
                   else "sequence_parallel")
            refuse(f"{key}={n} must divide the {world} processes")
    mesh = None
    if pp_stages > 1:
        mesh = make_pp_mesh(pipe=pp_stages, data=world // pp_stages,
                            device_type=device.type)
    elif grouped:
        mesh = make_mesh(data=world // sp, model=1, seq=sp,
                         device_type=device.type)
    data_ranks = 1 if mesh is None else mesh.data
    lead = not grouped or dist.get_rank() == 0

    def wait_for_lead():
        if mesh is not None:
            dist.barrier()
    if args.tiny:
        tokenizer = MockTokenizer()
        # the inference CLI's tiny LM from the same seed: a voice trained
        # here serves on the base it was trained on (--lora_adapter)
        cfg = tiny_lm_config()
    else:
        from ..core.config import LMConfig
        from ..pipeline.batch import load_tokenizer
        from ..utils.convert_lm import load_asteroid_checkpoint
        cfg = LMConfig.from_hf_config_json(
            os.path.join(args.model_path, "config.json"))
        tokenizer = load_tokenizer(args.model_path)
    if "bf16" in tc:        # the compute dtype; parameters stay fp32 masters
        cfg = dataclasses.replace(
            cfg, dtype="bfloat16" if tc["bf16"] else "float32")
    if args.tiny:
        model = AsteroidLM.init_random(cfg, seed=0, device=device,
                                       dtype=torch.float32)
    else:
        with torch.device("meta"):
            model = AsteroidLM(cfg)
        model.load_state_dict(load_asteroid_checkpoint(
            args.model_path, cfg, dtype=torch.float32, device=device),
            assign=True)
        model = model.eval().requires_grad_(False)

    dataset = TrainingDataset(args.data_dir, cfg.channels,
                              tokenizer.pad_token_id, cfg.speech_pad_token)
    if len(dataset) == 0:
        print("no training data found", file=sys.stderr)
        return 1

    # one step = one optimizer update over grad_accum micro batches of
    # per_device_train_batch_size rows on each data rank
    micro_bs = int(tc.get("per_device_train_batch_size", 1)) * data_ranks
    grad_accum = max(1, int(tc.get("gradient_accumulation_steps", 1)))
    batch_size = micro_bs * grad_accum
    epochs = int(tc.get("num_train_epochs", 1))
    steps_per_epoch = max(1, len(dataset) // batch_size)
    total_steps = args.max_steps or steps_per_epoch * epochs
    remat = bool(tc.get("gradient_checkpointing", True))
    optimizer = make_optimizer(
        learning_rate=float(tc.get("learning_rate", 1e-4)),
        warmup_ratio=float(tc.get("warmup_ratio", 0.1)),
        total_steps=total_steps,
        weight_decay=float(tc.get("weight_decay", 0.0)),
        grad_clip=float(tc.get("max_grad_norm", 1.0)),
        lr_scheduler_type=str(tc.get("lr_scheduler_type", "cosine")))

    if pp_stages > 1:
        model = pp_stage_model(model, mesh)
    if args.lora:
        # layerwise adapters (models/lm.Dense): the base frozen, the
        # optimizer over the factors alone
        from ..train.lora import (graft_lora_params, init_lora_state,
                                  make_layerwise_lora_step)
        lcfg = dataclasses.replace(
            cfg, lora_rank=int(lc["r"]), lora_alpha=float(lc["lora_alpha"]),
            lora_rslora=bool(lc["use_rslora"]),
            lora_targets=tuple(lc["target_modules"]))
        model = graft_lora_params(model, lcfg, seed=1)
        state = init_lora_state(model, optimizer)
        make, step_cfg = make_layerwise_lora_step, lcfg
    else:
        state = init_train_state(cfg, optimizer, model=model)
        make, step_cfg = make_train_step, cfg
    step_kw = dict(remat=remat, grad_accum_steps=grad_accum)
    if pp_stages > 1:
        # the accumulation axis is the pipeline's microbatch stream
        step_fn = make_pp_train_step(cfg, optimizer, mesh, remat=remat)
    elif mesh is None:
        step_fn = make(step_cfg, optimizer, **step_kw)
    else:
        step_fn = shard_train_step(make, mesh, step_cfg, optimizer,
                                   **step_kw)
    # a pipeline stage's first data rank checkpoints the stage's part
    ckpt_name = ("state.pt" if pp_stages <= 1
                 else f"state_stage{mesh.pipe_rank}.pt")
    ckpt_writer = lead or (pp_stages > 1 and mesh.data_rank == 0)

    if lead:
        os.makedirs(args.output_dir, exist_ok=True)
    wait_for_lead()
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    save_every = (args.save_steps if args.save_steps is not None
                  else int(tc.get("save_steps", 0) or 0))
    save_limit = int(tc.get("save_total_limit", 0) or 0)
    log_every = max(1, int(tc.get("logging_steps", 10) or 10))

    start_step = 0
    if args.resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore_train_state(ckpt_dir, last, state,
                                        name=ckpt_name)
            start_step = last
            if lead:
                print(f"resumed from {ckpt_dir}/step_{last}")

    def batch_indices(step: int) -> np.ndarray:
        """Deterministic per-epoch shuffles, so a resumed run sees the data
        in the order the interrupted one would have."""
        epoch_i, bi = divmod(step, steps_per_epoch)
        order = np.random.default_rng(epoch_i).permutation(len(dataset))
        # tile so a batch larger than the dataset still has batch_size rows
        reps = -(-((bi * batch_size) % len(dataset) + batch_size)
                 // len(dataset))
        tiled = np.concatenate([order] * max(reps, 1))
        return tiled[(bi * batch_size) % len(dataset):][:batch_size]

    def make_batch(step: int):
        idx = batch_indices(step - 1)
        batch = collate([dataset[i] for i in idx], tokenizer.pad_token_id,
                        max_length=int(tc.get("max_length", 16000)),
                        pad_token=cfg.speech_pad_token, pad_to_multiple=64)
        labels = batch["labels"]
        if (labels[..., 0].max() >= cfg.vocab_size
                or labels[..., 1:].max() >= cfg.speech_vocab_size):
            raise ValueError(f"step {step}: labels beyond the model's vocab "
                             f"({cfg.vocab_size} / {cfg.speech_vocab_size})")
        micro = grad_accum > 1 or pp_stages > 1
        if micro:
            # (K*B, T, ...) -> (K, B, T, ...): one padded length for all;
            # the accumulation's micro axis or the pipeline's microbatches
            batch = {k: v.reshape((grad_accum, micro_bs) + v.shape[1:])
                     for k, v in batch.items()}
        if mesh is not None:        # this data rank's rows of each micro
            rows = batch_spec(mesh, micro_bs)
            batch = {k: (v[:, rows] if micro else v[rows])
                     for k, v in batch.items()}
        return batch

    steps = range(start_step + 1, total_steps + 1)
    workers = int(tc.get("dataloader_num_workers", 1))
    batches = (Prefetcher(make_batch, steps, depth=1 + workers)
               if workers > 0 else ((s, make_batch(s)) for s in steps))

    report_to = tc.get("report_to", "tensorboard")
    if isinstance(report_to, str):
        report_to = [report_to]
    logger = (TrainLogger(args.output_dir,
                          use_tensorboard="tensorboard" in report_to)
              if lead else None)
    t0 = time.perf_counter()
    step = start_step
    try:
        for step, batch in batches:
            state, metrics = step_fn(state, batch)
            if lead and (step % log_every == 0 or step == total_steps):
                done = step - start_step
                sps = done / max(time.perf_counter() - t0, 1e-9)
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
                logger.log(step, {"loss": loss, "grad_norm": gnorm,
                                  "steps_per_sec": sps,
                                  "epoch": step / steps_per_epoch})
                print(f"step {step}/{total_steps} loss={loss:.4f} "
                      f"grad_norm={gnorm:.3f} ({1.0 / max(sps, 1e-9):.2f}s/step)")
            if save_every and (step % save_every == 0 or step == total_steps):
                if ckpt_writer:
                    save_train_state(ckpt_dir, state, step, keep=save_limit,
                                     name=ckpt_name)
                if lead:
                    print(f"checkpointed step {step} -> {ckpt_dir}")
                wait_for_lead()
    finally:
        if logger is not None:
            logger.close()
        if hasattr(batches, "close"):
            batches.close()

    full = (pp_full_state(model, mesh) if pp_stages > 1
            else model.state_dict())
    if not lead:
        wait_for_lead()             # the lead writes the outputs below
        dist.destroy_process_group()
        return 0

    if args.lora:
        from ..train.lora import fold_lora_tree
        save_pytree(os.path.join(args.output_dir, "model_merged.npz"),
                    lm_state_to_jax(fold_lora_tree(model.state_dict(), lcfg),
                                    cfg))
        save_pytree(os.path.join(args.output_dir, "lora_factors.npz"),
                    lm_state_to_jax(state.params, cfg))
        print(f"LoRA merged model saved to {args.output_dir}")
    else:
        save_pytree(os.path.join(args.output_dir, "model.npz"),
                    lm_state_to_jax(full, cfg))
        print(f"Model saved to {args.output_dir}")
    with open(os.path.join(args.output_dir, "train_config.json"), "w") as f:
        json.dump({"steps": step, "lora": args.lora, "config": tc}, f)
    if mesh is not None:
        wait_for_lead()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

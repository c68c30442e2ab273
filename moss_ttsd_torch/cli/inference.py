"""JSONL batch inference CLI for the PyTorch port.

Mirrors ``moss_ttsd_tpu/cli/inference.py`` (flags --jsonl --seed
--output_dir --summary_file --use_normalize --dtype --max_new_tokens --tiny
--platform --quant --restricted_text_head --attn_impl --profile_dir
--lora_adapter --adapter_alpha). Runs on the CUDA card unless
``--platform cpu``. ``--attn_impl xla`` attends with the dense einsums
instead of the kernels (the reference's ``--attn_implementation``);
``--model_path`` (an HF-format LM directory with its tokenizer, which
needs ``transformers``), ``--spt_config`` and ``--spt_ckpt`` (the
XY-Tokenizer yaml and checkpoint) load real weights through
``TTSPipeline.load``; ``--dtype fp32`` runs the codec in fp32.
``--tiny`` runs tiny random-weight models (no checkpoint needed).
``MOSS_TTSD_DEBUG=host:port`` (or ``port``) blocks at start until a
debugpy client attaches. Items
with prompt audio clone their voices: the prompt wavs are encoded by the
codec into the prompt's speech codes. ``--lora_adapter NAME=PATH``
(repeatable) registers a LoRA voice, a finetune CLI lora_factors.npz or a
peft adapter directory; an item's ``"voice"`` field selects it.

    python -m moss_ttsd_torch.cli.inference --jsonl examples/examples.jsonl \\
        --tiny --platform cpu --output_dir outputs --max_new_tokens 32
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

MODEL_PATH = "fnlp/MOSS-TTSD-v0.5"
SPT_CONFIG_PATH = "XY_Tokenizer/config/xy_tokenizer_config.yaml"
SPT_CHECKPOINT_PATH = "XY_Tokenizer/weights/xy_tokenizer.ckpt"


TINY_SPEECH_OFFSET = 100     # channel 0 of the tiny codec's codes in training


def tiny_lm_config():
    """The tiny LM of ``--tiny`` (fp32): the speech range dominates the
    vocab so a random model emits speech, and the vocab holds the tiny
    codec's 64 codes at ``TINY_SPEECH_OFFSET`` (the finetune workflow's
    channel-0 offset)."""
    from ..core.config import LMConfig
    from ..utils.mock_tokenizer import MockTokenizer
    return LMConfig(dtype="float32", param_dtype="float32").tiny(
        vocab_size=300, speech_vocab_size=65, speech_pad_token=64,
        speech_token_range=(0, 290), eos_token_id=290,
        pad_token_id=MockTokenizer().pad_token_id)


def build_tiny_pipeline(seed: int = 0, bucket: int = 64, device="cuda",
                        quant=None, restricted_text_head: bool = False,
                        restricted_audit_every=None, mesh=None,
                        attn_impl=None):
    """Random tiny LM + codec + mock tokenizer wired into the real pipeline
    (the JAX ``build_tiny_pipeline`` geometry and sampling)."""
    from ..core.config import (ChannelSamplingConfig, CodecConfig,
                               SamplingConfig)
    from ..core.device import resolve_device
    from ..models.codec.model import XYTokenizer
    from ..models.lm import AsteroidLM
    from ..pipeline.batch import TTSPipeline
    from ..utils.mock_tokenizer import MockTokenizer

    dev = resolve_device(device)
    tokenizer = MockTokenizer()
    lm_cfg = tiny_lm_config()
    model = AsteroidLM.init_random(lm_cfg, seed=seed, device=dev)
    spt = XYTokenizer.init_random(CodecConfig().tiny(), seed=seed, device=dev)
    sampling = SamplingConfig(
        channels=[ChannelSamplingConfig(do_sample=True, temperature=1.0,
                                        top_k=30, top_p=0.95)
                  for _ in range(lm_cfg.channels)],
        max_new_tokens=64)
    return TTSPipeline(tokenizer, lm_cfg, model, spt, sampling, bucket=bucket,
                       quant=quant,
                       restricted_text_head=restricted_text_head or None,
                       restricted_audit_every=restricted_audit_every,
                       device=dev, mesh=mesh, attn_impl=attn_impl)


def join_mesh(spec: str, device: str, error):
    """The ("data", "model") mesh of ``--mesh DATAxMODEL``: the process
    group the launcher (``torch.distributed.run``) or the ``JAX_*``
    variables name is joined first; a mesh that does not match its world
    size is an error (``error``, the parser's)."""
    from ..parallel.distributed import initialize_multihost
    from ..parallel.mesh import parse_mesh_arg
    initialize_multihost(device=device, timeout_s=600)
    try:
        return parse_mesh_arg(spec, device_type=device)
    except ValueError as e:
        error(str(e))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="MOSS-TTSD inference (PyTorch / CUDA port)")
    parser.add_argument("--jsonl", default="examples/examples.jsonl")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--output_dir", default="outputs")
    parser.add_argument("--summary_file", default=None)
    parser.add_argument("--use_normalize", action="store_true", default=False)
    parser.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    parser.add_argument("--model_path", default=MODEL_PATH)
    parser.add_argument("--spt_config", default=SPT_CONFIG_PATH)
    parser.add_argument("--spt_ckpt", default=SPT_CHECKPOINT_PATH)
    parser.add_argument("--max_new_tokens", type=int, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="run with tiny random models (smoke test)")
    parser.add_argument("--platform", choices=["default", "cpu"],
                        default="default",
                        help="default = the CUDA card; cpu = run on the CPU")
    parser.add_argument("--quant", choices=["int8"], default=None,
                        help="weight-only int8 serving (w8a16)")
    parser.add_argument("--restricted_text_head", action="store_true",
                        help="channel-0 logits over the speech window only")
    parser.add_argument("--attn_impl", choices=["mixed", "pallas", "xla"],
                        default=None,
                        help="attention backend (reference "
                             "--attn_implementation): mixed and pallas = "
                             "the CUDA kernels (default), xla = dense "
                             "einsum attention")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the batch "
                             "(Chrome trace JSON, the program's spans "
                             "included) into this directory")
    parser.add_argument("--lora_adapter", action="append", default=[],
                        metavar="NAME=PATH",
                        help="register a LoRA voice; items select one with a "
                             "\"voice\" field. PATH is a lora_factors.npz "
                             "or a peft adapter directory. Repeatable")
    parser.add_argument("--adapter_alpha", type=float, default=32.0,
                        help="LoRA alpha of lora_factors.npz adapters (a "
                             "peft directory brings its own)")
    parser.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                        help="a (data, model) mesh of processes, e.g. 1x2 "
                             "under torch.distributed.run --nproc_per_node "
                             "2: rows split over data, weights over model; "
                             "rank 0 writes the outputs")
    args = parser.parse_args(argv)

    from ..utils.helpers import maybe_debug_attach
    maybe_debug_attach()

    from ..utils import profiling

    device = "cpu" if args.platform == "cpu" else "cuda"
    # every rank of a mesh runs the same pipeline; rank 0 writes
    mesh = join_mesh(args.mesh, device, parser.error) if args.mesh else None
    if args.tiny:
        pipe = build_tiny_pipeline(
            seed=args.seed or 0, device=device, quant=args.quant,
            restricted_text_head=args.restricted_text_head, mesh=mesh,
            attn_impl=args.attn_impl)
    else:
        from ..pipeline.batch import TTSPipeline
        pipe = TTSPipeline.load(
            args.model_path, args.spt_config, args.spt_ckpt, quant=args.quant,
            codec_dtype="bfloat16" if args.dtype == "bf16" else None,
            restricted_text_head=args.restricted_text_head or None,
            attn_impl=args.attn_impl, device=device, mesh=mesh)
    lead = pipe.is_lead

    from ..utils.convert_lora import parse_adapter_specs
    for name, (tree, alpha, rslora) in parse_adapter_specs(
            args.lora_adapter, args.adapter_alpha, parser.error).items():
        pipe.engine.register_adapter(name, tree, alpha=alpha,
                                     use_rslora=rslora)

    from ..utils.audio_io import write_wav
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.jsonl) as f:
        items = [json.loads(line) for line in f if line.strip()]
    print(f"Loaded {len(items)} items from {args.jsonl}")
    # per-item LoRA voices: a "voice" field names a registered adapter
    voices = [it.get("voice") or None for it in items]
    adapter = voices if any(voices) else None
    prof = (profiling.trace(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with prof:
        texts_data, audio_results = pipe.process_batch(
            items, use_normalize=args.use_normalize,
            max_new_tokens=args.max_new_tokens, seed=args.seed or 0,
            adapter=adapter)
    if args.profile_dir:
        print(f"Saved profiler trace to {args.profile_dir}")
    if not lead:
        import torch.distributed as dist
        dist.destroy_process_group()
        return 0

    if args.summary_file:
        with open(args.summary_file, "w", encoding="utf-8") as f:
            for t in texts_data:
                f.write(json.dumps({
                    "text": t.get("original_text"),
                    "normalized_text": t.get("normalized_text"),
                    "final_text": t.get("final_text"),
                    **({"error": t["error"]} if "error" in t else {}),
                }, ensure_ascii=False) + "\n")
        print(f"Saved summary to {args.summary_file}")

    saved = 0
    for idx, res in enumerate(audio_results):
        if res is None:
            print(f"Skipping sample {idx} (no valid speech tokens)")
            continue
        out = os.path.join(args.output_dir, f"output_{idx}.wav")
        write_wav(out, res["audio_data"], res["sample_rate"])
        print(f"Saved audio to {out}")
        saved += 1

    print(f"Phase timings: {pipe.timings.as_dict()}")
    print(f"Inference completed. Saved {saved}/{len(items)} audio files to "
          f"{args.output_dir}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

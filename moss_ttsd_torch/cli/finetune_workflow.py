"""One-click finetune workflow for the PyTorch port: preprocess, then train,
from one YAML (``configs/finetune_workflow.yaml``'s keys), as
``moss_ttsd_tpu/cli/finetune_workflow.py`` does.

    python -m moss_ttsd_torch.cli.finetune_workflow --config wf.yaml \\
        --tiny --platform cpu

``data_preprocess`` encodes the JSONL's audio with the port's codec
(``train/data.process_data``) into ``output_dir``; ``--pass_data_preprocess``
skips that step. ``finetune`` runs ``cli/finetune.py`` on the result.
``--tiny`` uses the tiny random codec, the mock tokenizer and the tiny LM;
without it ``data_preprocess`` names the checkpoint (``model_path`` for
the tokenizer, ``spt_config`` / ``spt_checkpoint`` for the codec, which
runs in fp32) and ``finetune.model_path`` the LM to train.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="Finetune workflow (PyTorch / "
                                            "CUDA port)")
    p.add_argument("--config", required=True, help="workflow yaml")
    p.add_argument("--pass_data_preprocess", action="store_true",
                   help="skip preprocessing (data already prepared)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="default = the CUDA card; cpu = run on the CPU")
    args = p.parse_args(argv)

    from ..utils import config_yaml
    try:
        cfg = config_yaml.load(args.config) or {}
    except ValueError as e:
        p.error(f"{args.config}: {e}")
    data_cfg = cfg.get("data_preprocess") or {}
    train_cfg = cfg.get("finetune") or {}
    processed_dir = data_cfg.get("output_dir", "processed_data")

    if not args.pass_data_preprocess:
        from ..models.codec.model import XYTokenizer
        from ..train.data import process_data
        device = "cpu" if args.platform == "cpu" else "cuda"
        if args.tiny:
            from ..core.config import CodecConfig
            from ..utils.mock_tokenizer import MockTokenizer
            from .inference import TINY_SPEECH_OFFSET
            tokenizer = MockTokenizer()
            spt = XYTokenizer.init_random(CodecConfig().tiny(), seed=0,
                                          device=device)
            speech_offset = TINY_SPEECH_OFFSET
        else:
            missing = [k for k in ("model_path", "spt_config",
                                   "spt_checkpoint") if not data_cfg.get(k)]
            if missing:
                p.error(f"{args.config}: data_preprocess needs "
                        f"{', '.join(missing)} without --tiny")
            from ..pipeline.batch import load_tokenizer
            tokenizer = load_tokenizer(data_cfg["model_path"])
            spt = XYTokenizer.load_from_checkpoint(
                data_cfg["spt_config"], data_cfg["spt_checkpoint"],
                device=device)
            speech_offset = 151665       # the reference's speech token range
        process_data(data_cfg["jsonl"], tokenizer, spt, processed_dir,
                     data_name=data_cfg.get("data_name", "processed_data"),
                     use_normalize=data_cfg.get("use_normalize", True),
                     speech_offset=speech_offset)

    from .finetune import main as finetune_main
    ft_args = ["--data_dir", processed_dir,
               "--output_dir", train_cfg.get("output_dir", "finetune_out")]
    if train_cfg.get("model_path"):
        ft_args += ["--model_path", train_cfg["model_path"]]
    if train_cfg.get("training_config"):
        ft_args += ["--training_config", train_cfg["training_config"]]
    if train_cfg.get("lora"):
        ft_args += ["--lora"]
        if train_cfg.get("lora_config"):
            ft_args += ["--lora_config", train_cfg["lora_config"]]
    if train_cfg.get("max_steps"):
        ft_args += ["--max_steps", str(train_cfg["max_steps"])]
    if args.tiny:
        ft_args += ["--tiny"]
    if args.platform != "default":
        ft_args += ["--platform", args.platform]
    return finetune_main(ft_args)


if __name__ == "__main__":
    sys.exit(main())

"""Device resolution for the port's entry points.

Every entry point (``GenerationEngine``, ``XYTokenizer``, ``TTSPipeline``,
the CLI) runs on the card unless the caller asks for the CPU: ``device``
defaults to ``"cuda"``, and a CUDA request without a CUDA device raises
instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--platform cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None

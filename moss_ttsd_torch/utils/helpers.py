"""Misc utilities, port of ``moss_ttsd_tpu/utils/helpers.py``: parameter
counts by module, rank-tagged logging, audio-file discovery, ASR-style text
normalization and the remote-debug hooks of the CLI entry points.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List

AUDIO_EXTENSIONS = (".wav", ".flac", ".mp3", ".ogg", ".m4a")


def count_params_by_module(params) -> Dict[str, int]:
    """Parameter counts grouped by top-level name, plus ``__total__``.

    ``params`` is an ``nn.Module`` (its parameters, a tied weight counted
    once) or a state dict of dotted names."""
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    counts: Dict[str, int] = {}
    for name, t in items:
        top = name.split(".", 1)[0] or "root"
        counts[top] = counts.get(top, 0) + int(t.numel())
    counts["__total__"] = sum(counts.values())
    return counts


def format_param_report(params) -> str:
    counts = count_params_by_module(params)
    total = counts.pop("__total__")
    lines = [f"{k:32s} {v / 1e6:10.2f}M" for k, v in sorted(counts.items())]
    lines.append(f"{'TOTAL':32s} {total / 1e6:10.2f}M")
    return "\n".join(lines)


def set_logging(level=logging.INFO) -> None:
    """Rank-tagged logging: the rank of an initialised process group of
    more than one process, else 0."""
    import torch.distributed as dist
    rank = (dist.get_rank() if dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1 else 0)
    logging.basicConfig(
        level=level,
        format=f"[proc {rank}] %(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True)


def find_audio_files(directory: str) -> List[str]:
    """Recursively list audio files, sorted within each directory."""
    out: List[str] = []
    for root, _, files in os.walk(directory):
        for f in sorted(files):
            if f.lower().endswith(AUDIO_EXTENSIONS):
                out.append(os.path.join(root, f))
    return out


def asr_normalize_text(text: str) -> str:
    """Lowercase and strip punctuation (ASR-metric preparation)."""
    text = text.lower()
    text = re.sub(r"[^\w\s一-鿿]", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def maybe_debug_attach() -> None:
    """Env-gated remote-debug hook of the CLI entry points: with
    ``MOSS_TTSD_DEBUG=host:port`` (or just ``port``) set, block at start
    until a debugpy client attaches."""
    spec = os.environ.get("MOSS_TTSD_DEBUG")
    if not spec:
        return
    host, _, port = spec.rpartition(":")
    waiting_for_debug(host or "localhost", int(port))


def waiting_for_debug(ip: str = "localhost", port: int = 5678) -> None:
    """Block until a debugpy client attaches. Without debugpy installed
    this logs a warning and returns."""
    rank = os.environ.get("RANK", "0")
    try:
        import debugpy
    except ImportError:
        logging.warning("[rank %s] debugpy not installed; skipping "
                        "remote-attach wait", rank)
        return
    debugpy.listen((ip, port))
    logging.info("[rank %s] Waiting for debugger attach on %s:%d...",
                 rank, ip, port)
    debugpy.wait_for_client()
    logging.info("[rank %s] Debugger attached", rank)

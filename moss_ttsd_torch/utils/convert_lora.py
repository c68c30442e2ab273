"""LoRA adapters -> the stacked factor trees of the multi-LoRA registry,
PyTorch port of ``moss_ttsd_tpu/utils/convert_lora.py``.

The reference finetunes with peft (reference finetune/finetune.py:145-191:
r 16, alpha 32, rslora, the attention and MLP projections) and can only
merge the adapter into the checkpoint at export (:237-241). These loaders
read a peft adapter directory (``adapter_model.safetensors`` or
``adapter_model.bin`` plus ``adapter_config.json``) or a finetune CLI
``lora_factors.npz`` into the flat factor-tree format that
``decode/lora_registry.LoraRegistry.register`` accepts, so trained voices
serve per request without touching the base weights.

``adapter_model.safetensors`` is read by ``read_safetensors``, a small
reader of the format (an 8-byte little-endian header length, a JSON header
of dtype / shape / byte offsets, then the raw bytes): no ``safetensors``
package is needed. ``write_safetensors`` writes the format (the LM
checkpoint export, ``utils/convert_lm.py``).
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import struct
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import load_pytree

# matches e.g. "base_model.model.model.language_model.layers.3.self_attn.
# q_proj.lora_A.weight" and the in-training variant with a ".default."
# adapter-name infix, whatever the prefix depth
_KEY = re.compile(
    r"layers\.(\d+)\.(?:[\w]+\.)*?"
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)"
    r"\.lora_(A|B)(?:\.[\w]+)?\.weight$")

# the float types checkpoints and adapter factors are saved in, and I64
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64}
_ST_TAGS = {v: k for k, v in _ST_DTYPES.items()}


def lora_scale(rank: int, alpha: float, use_rslora: bool = True) -> float:
    """peft's LoRA scale: alpha / sqrt(r) with rslora, else alpha / r."""
    return alpha / math.sqrt(rank) if use_rslora else alpha / rank


def read_safetensors(path: str, dtype: Optional[torch.dtype] = None,
                     device=None, keep: Optional[Callable[[str], bool]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: tensor} (the header's
    ``__metadata__`` entry is skipped). Tensors are read one at a time
    into their own buffers, then cast once to ``dtype`` (floating tensors
    only) and moved to ``device``, so the host never holds more than the
    result and one tensor's bytes. ``keep(name)`` False skips a tensor
    without reading it."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        if 8 + n > size:
            raise ValueError(f"{path}: header length {n} past the end of file")
        header = json.loads(f.read(n))
        base = 8 + n
        out: Dict[str, torch.Tensor] = {}
        for name, info in header.items():
            if name == "__metadata__" or (keep is not None and not keep(name)):
                continue
            st_dtype = _ST_DTYPES.get(info["dtype"])
            if st_dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has unsupported "
                                 f"dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            shape = list(info["shape"])
            count = math.prod(shape)
            if end - begin != count * st_dtype.itemsize or base + end > size:
                raise ValueError(f"{path}: tensor {name!r} offsets {begin}:"
                                 f"{end} do not fit {info['dtype']} {shape}")
            buf = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(base + begin)
            if f.readinto(buf.numpy()) != end - begin:
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            t = buf.view(st_dtype).reshape(shape)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            out[name] = t.to(device) if device is not None else t
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      dtype: Optional[torch.dtype] = None,
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write {name: tensor} as one ``.safetensors`` file, tensor by tensor
    (each copied to the host and cast to ``dtype``, floating tensors only,
    as it is written). bf16 is written as torch's bytes under the ``BF16``
    tag. A tensor under two names is written under each. Returns the
    bytes of tensor data written."""
    def out_dtype(t):
        return dtype if dtype is not None and t.is_floating_point() \
            else t.dtype

    header: Dict[str, dict] = {"__metadata__": dict(metadata or {})}
    offset = 0
    for name, t in tensors.items():
        dt = out_dtype(t)
        if dt not in _ST_TAGS:
            raise ValueError(f"tensor {name!r}: dtype {dt} has no "
                             f"safetensors tag here")
        nbytes = t.numel() * dt.itemsize
        header[name] = {"dtype": _ST_TAGS[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)      # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            t = t.detach().to("cpu", out_dtype(t)).contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
    return offset


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def convert_peft_lora(sd: Dict[str, object], num_layers: int = None) -> dict:
    """peft state dict (torch tensors or numpy) -> flat factor tree
    {"layers/block/<target>/kernel": {"a": (L, in, r), "b": (L, r, out)}}
    in fp32 numpy.

    peft stores torch Linear layouts, lora_A.weight (r, in) and
    lora_B.weight (out, r); the stacked factors are their transposes.
    Layers an adapter leaves out are zero. No scale is folded in: pass the
    adapter_config.json lora_alpha / use_rslora to register (or use
    ``load_peft_adapter``, which reads them). LoRA leaves on other modules
    (embeddings, heads) are dropped with a warning."""
    per: dict = {}
    dropped = []
    for key, t in sd.items():
        m = _KEY.search(key)
        if not m:
            if "lora_A" in key or "lora_B" in key:
                dropped.append(key)
            continue
        layer, target, ab = int(m.group(1)), m.group(2), m.group(3)
        per.setdefault(target, {"A": {}, "B": {}})[ab][layer] = _to_np(t).T
    if not per:
        raise ValueError("no lora_A/lora_B leaves found — is this a peft "
                         "adapter state dict?")
    if dropped:
        # a silently partial voice would be worse than a loud one
        logging.getLogger(__name__).warning(
            "convert_peft_lora: %d LoRA leaves target unsupported modules "
            "and were DROPPED (only %s convert): %s%s",
            len(dropped), "q/k/v/o/gate/up/down projections",
            ", ".join(sorted(dropped)[:4]),
            "…" if len(dropped) > 4 else "")
    out = {}
    for target, d in per.items():
        if not d["A"] or not d["B"]:
            raise ValueError(f"target {target!r}: incomplete A/B pair")
        L = num_layers or max(max(d["A"]), max(d["B"])) + 1
        a0 = next(iter(d["A"].values()))
        b0 = next(iter(d["B"].values()))
        a = np.zeros((L,) + a0.shape, np.float32)
        b = np.zeros((L,) + b0.shape, np.float32)
        for layer, v in d["A"].items():
            a[layer] = v
        for layer, v in d["B"].items():
            b[layer] = v
        out[f"layers/block/{target}/kernel"] = {"a": a, "b": b}
    return out


def load_peft_adapter(adapter_dir: str,
                      num_layers: int = None) -> Tuple[dict, float, bool]:
    """peft adapter directory -> (factor tree, lora_alpha, use_rslora).

    Reads adapter_model.safetensors (preferred) or adapter_model.bin plus
    adapter_config.json (alpha 32 and no rslora when it is absent)."""
    alpha, rslora = 32.0, False
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            c = json.load(f)
        alpha = float(c.get("lora_alpha", 32.0))
        rslora = bool(c.get("use_rslora", False))
    st = os.path.join(adapter_dir, "adapter_model.safetensors")
    bn = os.path.join(adapter_dir, "adapter_model.bin")
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(bn):
        sd = torch.load(bn, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"no adapter_model.safetensors/.bin under {adapter_dir}")
    return convert_peft_lora(sd, num_layers), alpha, rslora


def load_adapter_any(path: str,
                     default_alpha: float = 32.0) -> Tuple[dict, float, bool]:
    """A peft adapter DIRECTORY loads with its own adapter_config.json
    scale; a ``.npz`` FILE is a finetune CLI lora_factors.npz (the layerwise
    tree; the reference lora_config defaults: alpha ``default_alpha``,
    rslora)."""
    if os.path.isdir(path):
        return load_peft_adapter(path)
    return load_pytree(path), default_alpha, True


def parse_adapter_specs(specs: List[str], default_alpha: float = 32.0,
                        error=None) -> Dict[str, Tuple[dict, float, bool]]:
    """Repeated ``--lora_adapter NAME=PATH`` flags -> {name: (factor tree,
    alpha, use_rslora)} through ``load_adapter_any``. ``error`` is
    argparse's ``parser.error`` (a ValueError when absent); a malformed
    spec or a missing path goes to it."""
    out: Dict[str, Tuple[dict, float, bool]] = {}
    for spec in specs:
        name, _, path = spec.partition("=")
        msg = None
        if not name or not path:
            msg = f"--lora_adapter expects NAME=PATH, got {spec!r}"
        elif not os.path.exists(path):
            msg = f"--lora_adapter {name}: no such file or directory {path!r}"
        if msg is not None:
            if error is not None:
                error(msg)
            raise ValueError(msg)
        out[name] = load_adapter_any(path, default_alpha)
    return out

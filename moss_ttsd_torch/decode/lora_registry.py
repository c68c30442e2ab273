"""Multi-LoRA adapter registry shared by the serving engines, PyTorch port
of ``moss_ttsd_tpu/decode/lora_registry.py``.

Holds named LoRA factor trees stacked per target projection: a (L, N, in,
r), b (L, N, r, out), with row 0 the zero adapter (the base model), as
tensors on the engine's device in its compute dtype.
``models/lm.select_adapters`` gathers each batch row's factors by adapter
id, and every projection of the decoder adds two rank-sized batched
products, so one batch serves any mix of adapters. The per-adapter LoRA
scale (peft's alpha / rank semantics) folds into ``b`` at registration;
adapters of different ranks zero-pad to the widest. Both are exact.

Used by ``decode/continuous.ContinuousBatcher`` (per-slot adapters) and
``decode/engine.GenerationEngine`` (per-row adapters on the static path).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.convert_lora import lora_scale


class LoraRegistry:
    """Name -> id registry and the stacked factors for per-row serving.

    ``num_layers`` (the model's depth) fixes the stacked L dim: adapters
    that cover only some layers (peft layers_to_transform) zero-pad to it,
    and a factor tree with more layers than the model is refused at
    registration. ``shard(target, a, b) -> (a, b)`` cuts each full stack
    to a tensor-parallel rank's slice before it goes to the device
    (``parallel/mesh.TensorParallel.shard_lora``)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 num_layers: Optional[int] = None,
                 device: torch.device = torch.device("cpu"), shard=None):
        self.dtype = dtype
        self.shard = shard
        self.num_layers = num_layers
        self.device = torch.device(device)
        self.ids: Dict[Optional[str], int] = {None: 0, "": 0}
        self._entries: List[dict] = []     # id-1 -> {target: (a, b*scale)}
        self.stacks: Dict[str, tuple] = {}  # target -> (a (L,N,in,r), b)

    def __bool__(self) -> bool:
        return bool(self._entries)

    @property
    def names(self) -> List[str]:
        return sorted(k for k in self.ids if k)

    def id_of(self, adapter: Optional[str]) -> int:
        try:
            return self.ids[adapter]
        except KeyError:
            raise ValueError(
                f"unknown adapter {adapter!r}; registered: "
                f"{self.names}") from None

    def register(self, name: str, lora: dict, alpha: float = 32.0,
                 use_rslora: bool = True) -> int:
        """Register a factor tree under ``name``; returns its id.

        ``lora`` is either the flat format ({".../<target>/kernel": {"a":
        (L, in, r), "b": (L, r, out)}}, what ``convert_peft_lora`` and the
        JAX ``init_lora`` give) or the layerwise trainable tree the finetune
        CLI saves as lora_factors.npz (nested dicts with lora_a / lora_b
        leaves); numpy arrays or tensors, layer-stacked. Registration
        rebuilds the stacks (their N dimension grows): register every
        adapter before serving traffic."""
        if name in self.ids:
            raise ValueError(f"adapter {name!r} already registered")
        lora = self._normalize(lora)
        entry = {}
        for key, ab in lora.items():
            parts = key.split("/")
            target = parts[-2] if parts[-1] == "kernel" else parts[-1]
            a, b = _np32(ab["a"]), _np32(ab["b"])
            if a.ndim != 3 or b.ndim != 3:
                raise ValueError(
                    f"adapter {name!r} target {target!r}: expected "
                    f"layer-stacked (L, in, r)/(L, r, out) factors, got "
                    f"{a.shape}/{b.shape}")
            rank = a.shape[-1]
            entry[target] = (a, b * lora_scale(rank, alpha, use_rslora))
        if not entry:
            raise ValueError(f"adapter {name!r}: no LoRA factors found")
        # commit atomically: a failed _rebuild (layer-count or shape
        # mismatch) leaves the registry as it was, so no half-registered
        # name resolves to an id without factors
        self._entries.append(entry)
        try:
            self._rebuild()
        except Exception:
            self._entries.pop()
            raise
        aid = len(self._entries)
        self.ids[name] = aid
        return aid

    @staticmethod
    def _normalize(lora: dict) -> dict:
        """Take the flat format as it is; flatten a layerwise trainable tree
        (lora_a / lora_b leaves) into it."""
        if lora and all(isinstance(v, dict) and {"a", "b"} <= set(v)
                        for v in lora.values()):
            return lora
        groups: dict = {}

        def walk(node, names):
            for k in sorted(node):
                v = node[k]
                if isinstance(v, dict):
                    walk(v, names + [str(k)])
                elif k in ("lora_a", "lora_b"):
                    key = "/".join(names) + "/kernel"
                    groups.setdefault(key, {})[k[-1]] = v

        walk(lora, [])
        return {k: v for k, v in groups.items() if {"a", "b"} <= set(v)}

    def _rebuild(self) -> None:
        targets = sorted({t for e in self._entries for t in e})
        N = len(self._entries) + 1            # id 0 = zero adapter
        stacks = {}
        for t in targets:
            shapes = [e[t] for e in self._entries if t in e]
            fin = shapes[0][0].shape[1]
            fout = shapes[0][1].shape[-1]
            r = max(a.shape[-1] for a, _ in shapes)
            # the model's depth when known, else the widest adapter; shorter
            # trees zero-pad: a zero delta IS the base model on those layers
            L = self.num_layers or max(a.shape[0] for a, _ in shapes)
            A = np.zeros((L, N, fin, r), np.float32)
            B = np.zeros((L, N, r, fout), np.float32)
            for i, e in enumerate(self._entries):
                if t not in e:
                    continue
                a, b = e[t]
                if a.shape[0] > L or b.shape[0] > L:
                    raise ValueError(
                        f"target {t!r}: factors cover {a.shape[0]} layers "
                        f"but the model has {L}")
                if a.shape[1] != fin or b.shape[-1] != fout:
                    raise ValueError(
                        f"target {t!r}: factor dims {a.shape[1]}->"
                        f"{b.shape[-1]} do not match the registered "
                        f"{fin}->{fout}")
                A[:a.shape[0], i + 1, :, :a.shape[-1]] = a
                B[:b.shape[0], i + 1, :b.shape[1]] = b
            if self.shard is not None:
                A, B = self.shard(t, A, B)
            stacks[t] = tuple(
                torch.from_numpy(x).to(device=self.device, dtype=self.dtype)
                for x in (A, B))
        self.stacks = stacks

    def row_ids(self, adapter, batch: int) -> List[int]:
        """(B,) adapter ids from one name or a per-row list of names."""
        if adapter is None or isinstance(adapter, str):
            return [self.id_of(adapter)] * batch
        if len(adapter) != batch:
            raise ValueError(f"{len(adapter)} adapter names for a "
                             f"batch of {batch}")
        return [self.id_of(a) for a in adapter]


def _np32(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)

"""Checkpoint IO, PyTorch port of ``moss_ttsd_tpu/core/checkpoint.py``.

  * The native format: a flat ``.npz`` whose keys are the ``/``-joined
    paths of a nested dict (what the JAX ``save_pytree`` writes, e.g. the
    finetune CLI's ``model.npz`` and ``lora_factors.npz``). numpy only: both
    packages read what either writes; tensors are saved as fp32/int numpy.
  * The train state: ``torch.save`` of {step, trainable state dict,
    optimizer state dict} under ``<ckpt_dir>/step_<n>/state.pt``, with
    ``keep`` rotation (the JAX package uses Orbax here; neither package
    reads the other's train state). A codec train state adds its EMA
    ``cluster_size`` and ``embed_avg`` to the same file.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device; bf16 as fp32) or array-like -> numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def flatten_pytree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"a/b": numpy x}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = to_numpy(tree)
    return out


def unflatten_pytree(flat: Dict[str, Any]) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def save_pytree(path: str, tree) -> None:
    """A nested dict of arrays or tensors -> one ``.npz`` (bf16 as fp32)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_pytree(tree))


def load_pytree(path: str) -> dict:
    """An ``.npz`` checkpoint -> a nested dict of numpy arrays."""
    with np.load(path) as data:
        flat = {k: np.asarray(data[k]) for k in data.files}
    return unflatten_pytree(flat)


# -- the train state ---------------------------------------------------------

def _steps(root: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(root)
                  if d.startswith("step_") and d.split("_")[1].isdigit())


_EMA = ("cluster_size", "embed_avg")


def save_train_state(ckpt_dir: str, state, step: int, keep: int = 0,
                     name: str = "state.pt") -> None:
    """Save ``state`` (``train.step.TrainState``: its step, the trainable
    parameters and the optimizer; ``train.codec_step.CodecTrainState``: the
    same and its EMA ``cluster_size`` and ``embed_avg``) under
    <ckpt_dir>/step_<step>/``name``. ``keep`` > 0 keeps only the ``keep``
    highest steps (HF ``save_total_limit``). A pipeline stage writes its
    own part under a name of its own."""
    root = os.path.abspath(ckpt_dir)
    path = os.path.join(root, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(state.step),
               "params": {k: v.detach().cpu()
                          for k, v in state.params.items()},
               "optimizer": state.optimizer.state_dict()}
    for k in _EMA:
        if hasattr(state, k):
            payload[k] = getattr(state, k).detach().cpu()
    tmp = os.path.join(path, name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, name))
    if keep > 0:
        for old in _steps(root)[:-keep]:
            shutil.rmtree(os.path.join(root, f"step_{old}"),
                          ignore_errors=True)


def restore_train_state(ckpt_dir: str, step: int, state,
                        name: str = "state.pt"):
    """Load <ckpt_dir>/step_<step> into ``state`` (built as for a fresh
    run: the same model and optimizer; a codec state's EMA tensors too) in
    place; returns it."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", name)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        params = state.params
        if set(params) != set(payload["params"]):
            raise ValueError(f"{path}: its parameters are not this model's")
        for k, p in params.items():
            p.copy_(payload["params"][k])
        for k in _EMA:
            if hasattr(state, k):
                getattr(state, k).copy_(payload[k])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None

"""The read side of the native checkpoint format, PyTorch port of
``moss_ttsd_tpu/core/checkpoint.py``: a flat ``.npz`` whose keys are the
``/``-joined paths of a nested dict (what the JAX ``save_pytree`` writes,
e.g. the finetune CLI's ``lora_factors.npz``). numpy only; the arrays come
back as numpy, and the caller moves them to its device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


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


def load_pytree(path: str) -> dict:
    """An ``.npz`` checkpoint -> a nested dict of numpy arrays."""
    with np.load(path) as data:
        flat = {k: np.asarray(data[k]) for k in data.files}
    return unflatten_pytree(flat)

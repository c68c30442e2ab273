"""The LM architectures a configuration can name, found by that name.

A configuration file states ``"architecture": "<name>"``; its module is
``arch/<name>.py``, loaded by file name as ``readers.load`` loads a metric.
The module holds all that the harness knows of one architecture, and every
caller (``program.py``, ``check.py``, ``weights.py``, ``cells.py``) takes it
from there:

* ``port_model``: the port's model class as a dotted string (only
  ``program.py`` imports it);
* ``lm_spec(cfg)``: [(name, shape)] of the LM's tensors, under the port's
  state-dict names;
* ``lm_rule(name, shape)``: ("normal", std) or ("const", value), each
  tensor's init for ``weights.make``;
* ``lora_targets(cfg)``: {target: (in, out)}, the projections a LoRA voice
  adapts in every layer, with their widths;
* ``reference(cfg, weights, weight_format=None, dtype=torch.float32)``:
  the plain model over a {name: tensor} dict, with ``cfg``,
  ``hidden(ids, prompt_len, kv_bits, voice)`` and ``logits(hidden,
  channel)`` (``reference/lm.py``'s ``RefLM`` says what each takes);
* ``decode_flops(cfg, keys)``: one decode step of rows attending over
  ``keys`` each; ``b1_work(cfg, valid)``: one prefill attention call over
  rows of ``valid`` prompt tokens; ``decode_attention_work(cfg, keys, rows,
  kv_bytes)``: one decode attention call. The latter two return {"flops",
  "bytes"}, counted as ``counts.py`` says; where the layers are of several
  kinds, a call's work is its mean over the layers.

A name that is missing or has no module stops the run: there is no default.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

DIR = Path(__file__).resolve().parent
INTERFACE = ("port_model", "lm_spec", "lm_rule", "lora_targets", "reference",
             "decode_flops", "b1_work", "decode_attention_work")
_loaded = {}


def load(name: str) -> ModuleType:
    """``arch/<name>.py``, loaded once a path."""
    path = DIR / f"{name}.py"
    if path in _loaded:
        return _loaded[path]
    if not path.is_file():
        raise SystemExit(f"unknown architecture {name!r}: no {path.name} in "
                         f"{DIR}")
    spec = importlib.util.spec_from_file_location(
        "ttsd_bench_arch_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in INTERFACE if not hasattr(mod, k)]
    if missing:
        raise SystemExit(f"architecture {name!r} lacks {', '.join(missing)}")
    _loaded[path] = mod
    return mod


def of(cfg: dict) -> ModuleType:
    """The module of the architecture that the configuration names."""
    name = cfg.get("architecture")
    if not name:
        raise SystemExit(f"configuration {cfg.get('name')!r} names no "
                         "architecture")
    return load(name)

"""LoRA finetuning, PyTorch port of ``moss_ttsd_tpu/train/lora.py`` (the
reference's peft setup: r 16, alpha 32, rslora, the seven projections).

Two forms, as in the JAX package:
  * layerwise (the finetune CLI's): a model built with ``cfg.lora_rank > 0``
    carries ``lora_a`` (in, r) / ``lora_b`` (r, out) beside each target
    projection's weight (``models/lm.Dense``), so the backward's
    cotangents stay rank-sized. ``graft_lora_params`` puts fresh factors on
    a plain checkpoint, ``split_lora_tree`` freezes the base
    (``requires_grad_(False)``) and hands the optimizer only the factors,
    ``fold_lora_tree`` folds them into the weights (peft merge_and_unload);
  * merge-based (tests and tiny geometries): factors kept apart from the
    model by the name of the weight they adapt, merged ``W + scale (A B)^T``
    before a functional forward (``apply_lora``, ``make_lora_train_step``).

Factors are kept in JAX's layout, A (in, r) and B (r, out), so they export
unchanged (``utils/convert_jax.lm_state_to_jax``). ``lora_dropout`` of the
reference's LoRA config is read by neither package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import LMConfig
from ..models.lm import AsteroidLM
from ..ops.chunked_ce import asteroid_loss
from ..utils.convert_lora import lora_scale
from .step import (DEFAULT_LOSS_WEIGHTS, ClippedAdamW, TrainState,
                   make_train_step, to_device)

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                   "gate_proj", "up_proj", "down_proj")   # reference finetune.py:153

Params = Mapping[str, torch.Tensor]
_LORA = ("lora_a", "lora_b")


def _is_lora(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in _LORA


def _is_target(name: str, targets: Sequence[str]) -> bool:
    parts = name.split(".")
    return (parts[0] == "layers" and parts[-1] == "weight"
            and parts[-2] in targets)


# -- merge-based -------------------------------------------------------------

def init_lora(params: Params, seed: int = 0, rank: int = 16,
              targets: Sequence[str] = DEFAULT_TARGETS
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{weight name: {"a": (in, r) N(0, 0.02), "b": (r, out) zeros}} for
    every target projection weight (out, in) of ``params``, fp32, on the
    weights' device."""
    lora = {}
    for name, w in params.items():
        if not _is_target(name, targets):
            continue
        gen = torch.Generator(device=w.device).manual_seed(seed + len(lora))
        fan_out, fan_in = w.shape
        a = torch.randn((fan_in, rank), generator=gen, device=w.device) * 0.02
        lora[name] = {"a": a, "b": torch.zeros((rank, fan_out),
                                               device=w.device)}
    return lora


def apply_lora(params: Params, lora: Mapping, rank: int = 16,
               alpha: float = 32.0, use_rslora: bool = True
               ) -> Dict[str, torch.Tensor]:
    """Merged params W + scale (A B)^T, differentiable in the factors.
    ``rank`` enters only through the scale, so it must be the factors'
    own rank (checked)."""
    for key, fac in lora.items():
        if fac["a"].shape[-1] != rank:
            raise ValueError(
                f"rank={rank} but factor {key!r} has rank "
                f"{fac['a'].shape[-1]}; the scale would be wrong — pass "
                f"the rank the factors were built with")
    scale = lora_scale(rank, alpha, use_rslora)
    merged = dict(params)
    for key, fac in lora.items():
        w = params[key]
        delta = (fac["a"] @ fac["b"]) * scale
        merged[key] = (w.to(torch.float32) + delta.t()).to(w.dtype)
    return merged


def merge_lora(params: Params, lora: Mapping, rank: int = 16,
               alpha: float = 32.0, use_rslora: bool = True
               ) -> Dict[str, torch.Tensor]:
    """Fold factors into a plain state dict (peft merge_and_unload)."""
    with torch.no_grad():
        return {k: v.detach() for k, v in
                apply_lora(params, lora, rank, alpha, use_rslora).items()}


def lora_state(lora: Mapping, optimizer: ClippedAdamW) -> TrainState:
    """The merge-based step's state: the factors as trainable tensors
    "<weight name>/a" and "/b"."""
    params = {}
    for key, fac in lora.items():
        for ab in ("a", "b"):
            params[f"{key}/{ab}"] = fac[ab].detach().clone().requires_grad_(
                True)
    return TrainState(0, params, optimizer.init(params.values()))


def lora_tree(params: Params) -> Dict[str, Dict[str, torch.Tensor]]:
    """Inverse of ``lora_state``'s naming: {"w/a": a, "w/b": b} ->
    {"w": {"a": a, "b": b}}."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in params.items():
        key, ab = k.rsplit("/", 1)
        tree.setdefault(key, {})[ab] = v
    return tree


def make_lora_train_step(cfg: LMConfig, optimizer: ClippedAdamW,
                         base_params: Optional[AsteroidLM] = None,
                         rank: int = 16, alpha: float = 32.0,
                         use_rslora: bool = True, loss_weights=None,
                         remat: bool = True, ce_chunks: int = 8):
    """train_step(state, batch, base=None) over the factors only: ``base``
    (default ``base_params``) is a plain ``AsteroidLM`` that stays frozen;
    each step merges the factors into its weights and runs the merged
    forward functionally (``torch.func.functional_call``), the backbone
    recomputed in the backward under ``remat``."""
    del cfg
    weights = loss_weights or DEFAULT_LOSS_WEIGHTS

    def train_step(state: TrainState, batch, base: Optional[AsteroidLM] = None):
        model = base_params if base is None else base
        base_sd = {k: v.detach() for k, v in model.state_dict().items()}
        batch = to_device(batch, next(model.parameters()).device)
        state.optimizer.zero_grad(set_to_none=True)
        mask = batch["attention_mask"]
        positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)

        def forward(merged):
            return torch.func.functional_call(
                _Backbone(model), {f"inner.{k}": v for k, v in merged.items()},
                (batch["input_ids"], positions, mask.bool()))

        merged = apply_lora(base_sd, lora_tree(state.params), rank, alpha,
                            use_rslora)
        hidden = (checkpoint(forward, merged, use_reentrant=False) if remat
                  else forward(merged))
        loss, per = asteroid_loss(hidden, batch["labels"],
                                  merged["embed_text"], merged["embed_speech"],
                                  weights, num_chunks=ce_chunks)
        loss.backward()
        norm = optimizer.update(state.optimizer, state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "loss_per_channel": per.detach(),
                       "grad_norm": norm}

    return train_step


class _Backbone(nn.Module):
    """The cache-free ``backbone`` of ``inner`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, inner: AsteroidLM):
        super().__init__()
        self.inner = inner

    def forward(self, ids, positions, key_valid):
        return self.inner.backbone(ids, positions, key_valid, None, 0,
                                   remat=False)[0]


# -- layerwise ---------------------------------------------------------------

def split_lora_tree(params: Union[AsteroidLM, Params]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """A LoRA model (or its state dict) -> (frozen base, trainable factors),
    by name. Given the model, the base is also set ``requires_grad_(False)``
    and the factors ``requires_grad_(True)``."""
    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        for name, p in named.items():
            p.requires_grad_(_is_lora(name))
    else:
        named = dict(params)
    frozen = {k: v for k, v in named.items() if not _is_lora(k)}
    trainable = {k: v for k, v in named.items() if _is_lora(k)}
    return frozen, trainable


def merge_lora_tree(frozen: Params, trainable: Params
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``split_lora_tree``: one state dict."""
    return {**frozen, **trainable}


def graft_lora_params(base: Union[AsteroidLM, Params], cfg: LMConfig,
                      seed: int = 1) -> AsteroidLM:
    """A plain model (or state dict) + fresh adapters -> an ``AsteroidLM``
    of ``cfg`` (``lora_rank`` > 0) with the base weights and ``lora_a``
    N(0, 0.02) from ``seed``, ``lora_b`` zeros, on the base's device and in
    its dtype. Nothing is frozen yet (``split_lora_tree``)."""
    if cfg.lora_rank <= 0:
        raise ValueError("graft_lora_params needs cfg.lora_rank > 0")
    sd = base.state_dict() if isinstance(base, nn.Module) else dict(base)
    ref = sd["embed_text"]
    with torch.device(ref.device):
        model = AsteroidLM(cfg).to(ref.dtype)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not _is_lora(k) for k in missing):
        raise ValueError(f"the base does not fit cfg: missing "
                         f"{[k for k in missing if not _is_lora(k)]}, "
                         f"unexpected {unexpected}")
    gen = torch.Generator(device=ref.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".lora_a"):
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith(".lora_b"):
                p.zero_()
    return model


def fold_lora_tree(params: Params, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """Fold every projection's factors into its weight and drop them (the
    layerwise merge_and_unload): W + scale (A B)^T, in fp32, cast back."""
    scale = lora_scale(cfg.lora_rank, cfg.lora_alpha, cfg.lora_rslora)
    out = {k: v for k, v in params.items() if not _is_lora(k)}
    with torch.no_grad():
        for k, a in params.items():
            if not k.endswith(".lora_a"):
                continue
            pre = k[:-len(".lora_a")]
            b = params[pre + ".lora_b"]
            w = params[pre + ".weight"]
            delta = (a.to(torch.float32) @ b.to(torch.float32)) * scale
            out[pre + ".weight"] = (w.detach().to(torch.float32)
                                    + delta.t()).to(w.dtype)
    return out


def init_lora_state(model: AsteroidLM, optimizer: ClippedAdamW
                    ) -> TrainState:
    """The layerwise step's state over a grafted LoRA model: the base
    frozen, the optimizer over the factors alone."""
    _, trainable = split_lora_tree(model)
    return TrainState(0, trainable, optimizer.init(trainable.values()), model)


def make_layerwise_lora_step(cfg: LMConfig, optimizer: ClippedAdamW,
                             loss_weights=None, remat: bool = True,
                             ce_chunks: int = 8, grad_accum_steps: int = 1,
                             group=None):
    """train_step(state, batch) for a model with ``cfg.lora_rank`` > 0 (see
    ``init_lora_state``): the full step's forward, loss and accumulation,
    with gradients only for the factors (the frozen tables still give the
    loss its heads). Under ``group`` (data parallelism) only the factors'
    gradients are summed over it."""
    if cfg.lora_rank <= 0:
        raise ValueError("cfg.lora_rank must be set for layerwise LoRA")
    return make_train_step(cfg, optimizer,
                           loss_weights or DEFAULT_LOSS_WEIGHTS, remat=remat,
                           ce_chunks=ce_chunks,
                           grad_accum_steps=grad_accum_steps, group=group)

"""The training step of AsteroidLM finetuning, PyTorch port of
``moss_ttsd_tpu/train/step.py``.

One optimizer step: the cache-free backbone (each block recomputed in the
backward under ``remat``), the chunked multi-channel loss, exact gradient
accumulation over a leading micro axis, then optax's ``clip_by_global_norm``
and ``adamw`` as the JAX package chains them: the learning rate of update n
(counted from 0) is ``schedule(n)``, weight decay is decoupled and applies
to every trainable tensor, and the reported ``grad_norm`` is the norm before
clipping.

Data parallelism (``group=``, or ``shard_train_step`` over a mesh's data
group): each rank runs its rows of the global batch, the CE denominators
(``valid_label_counts``) are summed over the group so every rank
normalises by the global count, the gradients are summed after the
accumulation and before the clip, and the reported loss, per-channel loss
and grad norm are the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import LMConfig
from ..core.device import DeviceLike, torch_dtype
from ..models.lm import AsteroidLM
from ..ops.chunked_ce import asteroid_loss, valid_label_counts

DEFAULT_LOSS_WEIGHTS = (8, 2, 1, 1, 1, 1, 1, 1)   # reference finetune.py:132


@dataclass
class TrainState:
    """``step``: optimizer updates taken; ``params``: the trainable tensors
    by name (the whole model, or the LoRA factors); ``optimizer``: the
    ``torch.optim`` state over them; ``model``: the module they live in
    (None for the merge-based LoRA step, whose factors live outside it)."""
    step: int
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    model: Optional[AsteroidLM] = None


# -- schedules (optax's arithmetic, in float32) --------------------------------

def _f32(x) -> np.float32:
    return np.float32(x)


def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: _f32(init)

    def sched(count):
        c = _f32(min(max(count, 0), steps))
        frac = _f32(1) - c / _f32(steps)
        return _f32(init - end) * frac + _f32(end)
    return sched


def _cosine(init: float, decay_steps: int) -> Callable[[int], np.float32]:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def sched(count):
        c = _f32(min(count, decay_steps))
        decay = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c
                                              / _f32(decay_steps)))
        return _f32(init) * decay
    return sched


def _join(first, then, boundary: int) -> Callable[[int], np.float32]:
    """optax.join_schedules of two schedules."""
    return lambda count: (first(count) if count < boundary
                          else then(count - boundary))


def make_lr_schedule(learning_rate: float, warmup_ratio: float,
                     total_steps: int, lr_scheduler_type: str
                     ) -> Callable[[int], float]:
    """HF ``lr_scheduler_type`` semantics as the JAX package builds them
    from optax: "cosine" / "linear" warm up for ``max(1, int(total *
    ratio))`` updates, then decay to 0; "constant" is flat from update 0
    (no warmup); "constant_with_warmup" ramps then holds. The first update
    uses ``schedule(0)``, so cosine and linear take a zero-LR first step."""
    warmup = max(1, int(total_steps * warmup_ratio))
    end = max(total_steps, warmup + 1)
    lr = learning_rate
    if lr_scheduler_type == "cosine":
        sched = _join(_linear(0.0, lr, warmup), _cosine(lr, end - warmup),
                      warmup)
    elif lr_scheduler_type == "linear":
        sched = _join(_linear(0.0, lr, warmup),
                      _linear(lr, 0.0, end - warmup), warmup)
    elif lr_scheduler_type == "constant":
        sched = lambda count: _f32(lr)
    elif lr_scheduler_type == "constant_with_warmup":
        sched = _join(_linear(0.0, lr, warmup), lambda count: _f32(lr),
                      warmup)
    else:
        raise ValueError(f"unknown lr_scheduler_type {lr_scheduler_type!r}")
    return lambda count: float(sched(int(count)))


# -- the optimizer ---------------------------------------------------------------

def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


@dataclass(frozen=True)
class ClippedAdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1 0.9,
    b2 0.999, eps 1e-8, weight_decay)): ``init`` builds the
    ``torch.optim.AdamW`` over the trainable tensors, ``update`` clips
    their gradients, sets the scheduled rate and steps it."""
    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params), lr=self.schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def update(self, optimizer: torch.optim.Optimizer, step: int
               ) -> torch.Tensor:
        """Apply update number ``step`` to the gradients in ``.grad`` (a
        tensor that got none counts as zero, as in JAX); returns their
        global norm before clipping, and leaves ``.grad`` cleared."""
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if not bool(norm < self.grad_clip):
            for g in grads:      # optax: (g / norm) * max_norm, in order
                g.div_(norm).mul_(self.grad_clip)
        lr = self.schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return norm


def make_optimizer(learning_rate: float = 1e-4, warmup_ratio: float = 0.1,
                   total_steps: int = 10_000, weight_decay: float = 0.0,
                   grad_clip: float = 1.0, lr_scheduler_type: str = "cosine"
                   ) -> ClippedAdamW:
    """AdamW + schedule + global-norm clip (the reference's training config
    through HF TrainingArguments; see make_lr_schedule)."""
    return ClippedAdamW(make_lr_schedule(learning_rate, warmup_ratio,
                                         total_steps, lr_scheduler_type),
                        weight_decay, grad_clip)


# -- the step --------------------------------------------------------------------

def to_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def lm_loss(model: AsteroidLM, batch: Mapping[str, torch.Tensor],
            loss_weights: Sequence[float], ce_chunks: int, remat: bool,
            counts: Optional[torch.Tensor] = None):
    """(total, per-channel) loss of one batch {"input_ids" (B, T, C),
    "labels" (B, T, C), "attention_mask" (B, T)}: the cache-free backbone,
    then the chunked CE against the model's tied tables."""
    if model.tp is not None:
        raise NotImplementedError("tensor-parallel training is not ported: "
                                  "the step is data-parallel only")
    mask = batch["attention_mask"]
    positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
    hidden, _ = model.backbone(batch["input_ids"], positions, mask.bool(),
                               None, 0, remat=remat)
    return asteroid_loss(hidden, batch["labels"], model.embed_text,
                         model.embed_speech, loss_weights,
                         num_chunks=ce_chunks, counts=counts)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (itself without one)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def global_label_counts(labels: torch.Tensor, group=None) -> torch.Tensor:
    """``valid_label_counts`` of the global batch: this rank's, summed over
    ``group``."""
    return _sum(valid_label_counts(labels), group)


def all_reduce_grads(params, group, bucket_bytes: int = 256 << 20) -> None:
    """Sum the ``.grad`` of ``params`` over ``group`` in place (a tensor
    without one counts as zero): flat buckets of at most ``bucket_bytes``,
    one collective each."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket: list = []
    size = 0
    for p in params + [None]:
        if p is not None and (not bucket or (
                size + p.grad.nbytes <= bucket_bytes
                and p.grad.dtype == bucket[0].grad.dtype)):
            bucket.append(p)
            size += p.grad.nbytes
            continue
        if not bucket:
            break
        flat = torch.cat([q.grad.reshape(-1) for q in bucket])
        dist.all_reduce(flat, group=group)
        for q, g in zip(bucket, flat.split([q.grad.numel()
                                            for q in bucket])):
            q.grad.copy_(g.view_as(q.grad))
        bucket, size = ([p], p.grad.nbytes) if p is not None else ([], 0)


def accum_value_and_grad(loss_fn, batch: Mapping[str, torch.Tensor],
                         group=None):
    """Gradient accumulation over a (K, ...) micro-batched ``batch``.

    ``loss_fn(micro_batch, counts) -> (loss, per_channel)`` normalises by
    the shared ``counts`` (valid_label_counts of the whole superbatch; over
    ``group``, of every rank's), so the micro losses are linear in the
    micro batches and the gradients that K ``backward`` calls sum into
    ``.grad`` equal the one-big-batch gradient up to reduction order.
    Returns (summed loss, summed per-channel), both detached: this rank's
    share of the global ones."""
    counts = global_label_counts(batch["labels"], group)
    K = batch["labels"].shape[0]
    loss_sum = per_sum = None
    for k in range(K):
        loss, per = loss_fn({n: v[k] for n, v in batch.items()}, counts)
        loss.backward()
        loss, per = loss.detach(), per.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        per_sum = per if per_sum is None else per_sum + per
    return loss_sum, per_sum


def make_train_step(cfg: LMConfig, optimizer: ClippedAdamW,
                    loss_weights: Sequence[float] = DEFAULT_LOSS_WEIGHTS,
                    remat: bool = True, ce_chunks: int = 8,
                    grad_accum_steps: int = 1, group=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``state.model`` runs the forward and ``state.params`` are what the
    optimizer updates. ``batch`` holds tensors (or numpy) of
    {"input_ids" (B, T, C), "labels" (B, T, C), "attention_mask" (B, T)};
    with ``grad_accum_steps`` K > 1 every leaf gains a leading (K,) micro
    axis and K forward/backwards run before the one update. ``state`` is
    updated in place and returned; metrics are device tensors: "loss",
    "loss_per_channel" (C,), "grad_norm" (before clipping). Under
    ``group`` (data parallelism) ``batch`` is this rank's rows, the
    gradients of ``state.params`` are summed over the group before the
    clip, and the metrics are the global batch's."""
    del cfg     # the model carries its config; kept for the JAX signature

    def train_step(state: TrainState, batch):
        model = state.model
        batch = to_device(batch, next(model.parameters()).device)
        state.optimizer.zero_grad(set_to_none=True)

        def loss_fn(b, counts=None):
            return lm_loss(model, b, loss_weights, ce_chunks, remat, counts)

        if grad_accum_steps > 1:
            loss, per = accum_value_and_grad(loss_fn, batch, group)
        else:
            counts = (None if group is None
                      else global_label_counts(batch["labels"], group))
            loss, per = loss_fn(batch, counts)
            loss.backward()
            loss, per = loss.detach(), per.detach()
        if group is not None:
            all_reduce_grads(state.params.values(), group)
            parts = _sum(torch.cat([loss.reshape(1), per]), group)
            loss, per = parts[0], parts[1:]
        norm = optimizer.update(state.optimizer, state.step)
        state.step += 1
        return state, {"loss": loss, "loss_per_channel": per,
                       "grad_norm": norm}

    return train_step


# -- data parallelism over a mesh ----------------------------------------------

def opt_state_specs(state: TrainState, param_specs: Mapping[str, str]
                    ) -> Dict[str, Dict[str, str]]:
    """The layout of the AdamW state (``parallel/mesh.lm_param_specs``
    kinds): each moment inherits its parameter's kind, the step counters
    are replicated (JAX ``opt_state_specs``)."""
    names = {id(p): n for n, p in state.params.items()}
    out = {}
    for p, st in state.optimizer.state.items():
        name = names[id(p)]
        out[name] = {k: (param_specs[name] if torch.is_tensor(v)
                         and v.shape == p.shape else "replicated")
                     for k, v in st.items()}
    return out


def train_state_specs(state: TrainState, param_specs: Mapping[str, str]
                      ) -> dict:
    """The whole train state's layout: the step, the parameters and the
    optimizer state (JAX ``train_state_specs``)."""
    return {"step": "replicated",
            "params": {n: param_specs[n] for n in state.params},
            "opt_state": opt_state_specs(state, param_specs)}


def shard_train_step(make_step, mesh, *args, **kwargs):
    """The step ``make_step(*args, **kwargs)`` (``make_train_step`` or
    ``train.lora.make_layerwise_lora_step``) over ``mesh``'s data group:
    the parameters and the AdamW moments replicated on every data rank,
    the batch's rows split over them (JAX ``shard_train_step``). The model
    axis must be 1: tensor-parallel training is not ported."""
    if mesh.model != 1:
        raise NotImplementedError("tensor-parallel training (a model axis "
                                  "> 1) is not ported")
    return make_step(*args, group=mesh.data_group, **kwargs)


def init_train_state(cfg: LMConfig, optimizer: ClippedAdamW,
                     model: Optional[AsteroidLM] = None, seed: int = 0,
                     device: DeviceLike = "cuda") -> TrainState:
    """A full-finetune state: ``model`` (or a random one in
    ``cfg.param_dtype`` from ``seed`` on ``device``) with every parameter
    trainable, and the optimizer over all of them."""
    if model is None:
        model = AsteroidLM.init_random(cfg, seed=seed, device=device,
                                       dtype=torch_dtype(cfg.param_dtype))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return TrainState(0, params, optimizer.init(params.values()), model)

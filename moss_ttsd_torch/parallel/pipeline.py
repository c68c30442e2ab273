"""Pipeline-parallel LM training (GPipe) over a "pipe" mesh axis, PyTorch
port of ``moss_ttsd_tpu/parallel/pipeline.py``.

JAX shards the stacked layer axis over "pipe" and differentiates a
``shard_map``'d scan of ``ppermute`` hops, so autodiff writes the backward
pipeline. Here each stage is a process that holds its contiguous layers
[s L/S, (s+1) L/S) (``pp_stage_model``; ``pp_param_specs`` names the
layout) and a hand-written schedule runs them (``make_pp_backbone``):
every microbatch's forward first, in order, then every backward in
reverse (GPipe). Activations go forward and their cotangents backward by
``dist.send`` / ``dist.recv`` over the pipe group (gloo on the CPU, NCCL
between cards).

The embeddings, the final norm and the tied heads stay replicated over
"pipe", as in JAX. Stage 0 embeds; the last stage runs the final norm and
the loss, whose sums every stage then receives. The replicated
parameters' gradients are summed over the pipe group: each stage adds what
its own part computed, so the tied text table gets stage 0's embedding
gradient and the last stage's head gradient once each. The clip's global
norm adds every stage's squared layer norms over the pipe group, plus the
replicated part once (``ClippedAdamW.update(norm=)``), so ``grad_norm``
and the clip equal the plain step's. Within a stage the "data" ranks split
each microbatch's rows and sum their gradients, as the data-parallel step
does.

``torch.distributed.pipelining`` is not used: its schedules own the loss
call and the stage modules, and neither the tied table's gradient across
stages nor the global clip comes out of them in the form JAX computes; a
schedule of its own is short and is held against JAX line by line.

Bubble: (S-1)/(M+S-1) of each pass, as in GPipe. A stage keeps its layers'
inputs for all M microbatches (remat recomputes each layer's interior in
the backward).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import LMConfig
from ..core.device import torch_dtype
from ..ops.attention import causal_mask
from ..ops.chunked_ce import asteroid_loss
from ..ops.rope import rope_cos_sin
from ..train.step import (DEFAULT_LOSS_WEIGHTS, all_reduce_grads,
                          global_label_counts, to_device)
from .mesh import Mesh

PP_AXES = ("pipe", "data")


def make_pp_mesh(pipe: int, data: int = 1, device_type: str = "cuda"
                 ) -> Mesh:
    """A ("pipe", "data") mesh over every process of the default group,
    ranks pipe major (rank = stage x data + data rank), as JAX lays its
    device array out."""
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs a process group: "
                           "parallel.distributed.initialize_multihost")
    world = dist.get_world_size()
    if pipe * data != world:
        raise ValueError(f"{pipe}x{data} pipeline mesh != {world} processes")
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(device_type, (pipe, data),
                                 mesh_dim_names=PP_AXES))


def _send(t: torch.Tensor, peer: int, group) -> None:
    """``dist.send`` of ``t`` to global rank ``peer``; gloo takes CPU
    tensors only, so a CUDA tensor goes through the host there."""
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.cpu()
    dist.send(t, peer, group=group)


def _recv(t: torch.Tensor, peer: int, group) -> torch.Tensor:
    """``dist.recv`` into ``t`` from global rank ``peer`` (through the
    host for a CUDA tensor over gloo); returns ``t``."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        buf = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(buf, peer, group=group)
        return t.copy_(buf)
    dist.recv(t, peer, group=group)
    return t


def _layer_index(name: str):
    parts = name.split(".")
    if parts[0] == "layers" and len(parts) > 1 and parts[1].isdigit():
        return int(parts[1])
    return None


def stage_layers(num_layers: int, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` owns: [s L/S, (s+1) L/S)."""
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers not divisible by {n_stages} "
                         f"stages")
    per = num_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def pp_param_specs(params: Mapping[str, torch.Tensor], n_stages: int
                   ) -> Dict[str, str]:
    """Each parameter of the full LM state dict -> "pipe" (a layer's:
    stage s owns layers [s L/S, (s+1) L/S), ``stage_layers``) or
    "replicated" (the embeddings and the final norm). The AdamW moments
    inherit these kinds (``train.step.opt_state_specs``), so the optimizer
    state is pipe-sharded too. LoRA factors are layer leaves like any
    other."""
    layers = [i for i in map(_layer_index, params) if i is not None]
    L = max(layers) + 1 if layers else 0
    if L % n_stages:
        raise ValueError(f"layer axis {L} not divisible by {n_stages} "
                         f"stages")
    return {k: ("pipe" if _layer_index(k) is not None else "replicated")
            for k in params}


def pp_stage_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``model`` (an ``AsteroidLM`` with every layer) to this stage's
    share, in place: its layers (renumbered from 0 in its state dict) and
    the replicated embeddings and final norm. Returns it."""
    r = stage_layers(len(model.layers), mesh.pipe, mesh.pipe_rank)
    model.layers = nn.ModuleList(model.layers[r.start:r.stop])
    return model


def pp_full_state(model: nn.Module, mesh: Mesh):
    """Every stage's layers under their global names, with the replicated
    parameters, on the mesh's first rank (a state dict for the whole LM);
    None on every other rank. The first data column's stages send their
    layers to stage 0 over the pipe group."""
    if mesh.data_rank != 0:
        return None
    state = model.state_dict()
    local = [(k, v) for k, v in state.items() if _layer_index(k) is not None]
    per = len(model.layers)
    if mesh.pipe_rank > 0:
        dst = dist.get_global_rank(mesh.pipe_group, 0)
        for _, v in local:
            _send(v, dst, mesh.pipe_group)
        return None

    def rename(k, off):
        head, idx, rest = k.split(".", 2)
        return f"{head}.{int(idx) + off}.{rest}"
    full = {k: v for k, v in state.items() if _layer_index(k) is None}
    full.update(local)
    for s in range(1, mesh.pipe):
        src = dist.get_global_rank(mesh.pipe_group, s)
        for k, v in local:
            full[rename(k, s * per)] = _recv(torch.empty_like(v), src,
                                             mesh.pipe_group)
    return full


def make_pp_backbone(cfg: LMConfig, mesh: Mesh, remat: bool = True):
    """Returns pp_backbone(layers, embed, inputs, head, M) -> the last
    stage's head outputs (detached; [] on other stages), having run the
    GPipe forward and backward of M microbatches through this stage.

    ``layers``: the stage's blocks; ``embed(m)`` -> stage 0's input of
    microbatch m; ``inputs(m)`` -> (cos, sin, key_valid, mask) of
    microbatch m (every stage computes them from the batch it holds);
    ``head(m, y)`` -> (total, per-channel) loss of the last stage's
    output y. The schedule calls ``backward`` itself, so the gradients of
    every parameter it reached sit in ``.grad`` when it returns.
    Activations cross stage boundaries in the compute dtype, as
    (mb, T, hidden)."""
    S, s = mesh.pipe, mesh.pipe_rank
    stage_layers(cfg.num_hidden_layers, S, s)          # divisibility
    group = mesh.pipe_group
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < S - 1 else None
    dtype = torch_dtype(cfg.dtype)

    def send(t, peer):
        _send(t, peer, group)
        mesh.collectives += 1

    def recv(t, peer):
        mesh.collectives += 1
        return _recv(t, peer, group)

    def run_layers(layers, x, cos, sin, kv, mask):
        for layer in layers:
            args = (x, cos, sin, 0, None, 0, kv, mask)
            x = (checkpoint(layer, *args, use_reentrant=False) if remat
                 else layer(*args))
        return x

    def pp_backbone(layers, embed, inputs, head, M: int):
        saved, outs = [], []
        for m in range(M):                       # every forward, in order
            cos, sin, kv, mask = inputs(m)
            if s == 0:
                x = embed(m)
            else:
                x = recv(torch.empty(kv.shape + (cfg.hidden_size,),
                                     dtype=dtype, device=kv.device), prev)
                x.requires_grad_(True)
            y = run_layers(layers, x, cos, sin, kv, mask)
            if nxt is None:
                total, per = head(m, y)
                outs.append((total.detach(), per.detach()))
                saved.append((x, total))
            else:
                send(y.detach(), nxt)
                saved.append((x, y))
        for m in reversed(range(M)):             # every backward, reversed
            x, out = saved.pop()
            if nxt is None:
                out.backward()
            else:
                out.backward(recv(torch.empty_like(out), nxt))
            if prev is not None:
                send(x.grad, prev)
        return outs

    return pp_backbone


def _sq_norm(params) -> torch.Tensor:
    """Sum of squares of the ``.grad`` of ``params`` (None as zero), fp32."""
    return torch.stack([torch.linalg.vector_norm(p.grad.float()) ** 2
                        for p in params if p.grad is not None]).sum()


def make_pp_train_step(cfg: LMConfig, optimizer, mesh: Mesh,
                       loss_weights: Sequence[float] = DEFAULT_LOSS_WEIGHTS,
                       remat: bool = True, ce_chunks: int = 8):
    """Pipeline-parallel train_step(state, batch) -> (state, metrics).

    ``state``: ``train.step.init_train_state`` over this stage's model
    (``pp_stage_model``). ``batch`` leaves carry a leading microbatch
    axis: input_ids / labels (M, mb, T, C), attention_mask (M, mb, T),
    mb this data rank's rows (``pp_batch_specs``: ``mesh.batch_spec`` of
    axis 1). The loss is ``train.step.make_train_step``'s on the
    flattened (M * mb, T, ...) batch: the CE denominators are shared over
    the whole effective batch (every microbatch, every data rank), and
    the reference's loss weights. Every rank returns the global loss,
    per-channel loss and grad norm (before the clip)."""
    if cfg.quantized:
        raise ValueError("pipeline training expects unquantized parameters")
    backbone = make_pp_backbone(cfg, mesh, remat=remat)
    S = mesh.pipe
    data_group = mesh.data_group if mesh.data > 1 else None
    pipe_group = mesh.pipe_group if S > 1 else None

    def train_step(state, batch):
        model = state.model
        dev = next(model.parameters()).device
        batch = to_device(batch, dev)
        ids, labels = batch["input_ids"], batch["labels"]
        am = batch["attention_mask"]
        M, _, T = am.shape
        state.optimizer.zero_grad(set_to_none=True)
        counts = global_label_counts(labels, data_group)

        def inputs(m):
            positions = (torch.cumsum(am[m], dim=1) - 1).clamp_min(0)
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
            kv = am[m].bool()
            return cos, sin, kv, causal_mask(0, T, T, kv)

        def head(m, y):
            return asteroid_loss(model.final_norm(y), labels[m],
                                 model.embed_text, model.embed_speech,
                                 loss_weights, num_chunks=ce_chunks,
                                 counts=counts)

        outs = backbone(model.layers, lambda m: model.embed(ids[m]), inputs,
                        head, M)
        parts = torch.zeros(1 + cfg.channels, device=dev)
        for total, per in outs:
            parts = parts + torch.cat([total.reshape(1), per])
        named = state.params
        layer = [p for n, p in named.items() if _layer_index(n) is not None]
        rep = [p for n, p in named.items() if _layer_index(n) is None]
        if pipe_group is not None:
            all_reduce_grads(rep, pipe_group)
        if data_group is not None:
            all_reduce_grads(named.values(), data_group)
        sq = _sq_norm(layer).reshape(1)
        if pipe_group is not None:
            dist.all_reduce(sq, group=pipe_group)
            dist.all_reduce(parts, group=pipe_group)
        if data_group is not None:
            dist.all_reduce(parts, group=data_group)
        norm = torch.sqrt(sq[0] + _sq_norm(rep))
        norm = optimizer.update(state.optimizer, state.step, norm=norm)
        state.step += 1
        return state, {"loss": parts[0], "loss_per_channel": parts[1:],
                       "grad_norm": norm}

    return train_step


def pp_batch_specs() -> dict:
    """The (M, mb, ...) microbatched layout: each leaf's rows (its axis 1)
    split over "data", the microbatch axis whole (JAX ``P(None,
    "data")``)."""
    return {"input_ids": (None, "data"), "labels": (None, "data"),
            "attention_mask": (None, "data")}

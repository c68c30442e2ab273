"""The XY-Tokenizer codec's training step, PyTorch port of
``moss_ttsd_tpu/train/codec_step.py``.

  * AdamW (``ClippedAdamW``, optax's clip + adamw) on every parameter; the
    codebook's gradient is exactly zero (it is reached only through
    detached paths), so its update is the EMA overwrite below;
  * the EMA codebook update from the batch statistics that
    ``ResidualVQ.train_call`` returns, with the state's ``cluster_size`` and
    ``embed_avg``, then dead-code replacement from the batch's candidates;
  * an optional one-shot k-means bootstrap of every stage;
  * the loss: waveform L1 plus 24 kHz log-mel L1 plus the commitment loss,
    against the input resampled on the device (a self-supervised round
    trip).

Everything runs in fp32. Data parallel: pass ``group`` (a
``torch.distributed`` process group; each rank holds B rows of the global
batch, padded to one length). The draws are made over the global batch
from a generator seeded alike on every rank, the VQ statistics and the
loss denominators are global, each rank's loss is its share of the global
loss, and the gradients are ``all_reduce``d (SUM) before the clip: every
rank then takes the single-process step of the global batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from ..core.config import CodecConfig
from ..core.device import DeviceLike, resolve_device
from ..models.codec.model import XYTokenizerModule, _init_random
from ..models.codec.rvq import _all_reduce, _world, ema_update_stacked
from ..ops.dsp import log_mel_spectrogram, resample_torch
from .step import ClippedAdamW


@dataclass
class CodecTrainState:
    """``step``: optimizer updates taken; ``params``: the module's
    parameters by name; ``optimizer``: AdamW over them; ``cluster_size``
    (nq, K) the EMA cluster counts; ``embed_avg`` (nq, K, D) the EMA
    embedding sums; ``module``: the codec they live in."""
    step: int
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor
    module: XYTokenizerModule


def init_codec_train_state(cfg: CodecConfig, optimizer: ClippedAdamW,
                           seed: int = 0,
                           params: Optional[Mapping[str, torch.Tensor]] = None,
                           device: DeviceLike = "cuda") -> CodecTrainState:
    """A fresh state in fp32 on ``device``: the module's weights from
    ``params`` (a state dict, e.g. ``codec_state_from_jax`` of a loaded
    checkpoint) or random from ``seed``; ``embed_avg`` a copy of the
    codebook and ``cluster_size`` zero."""
    dev = resolve_device(device)
    with torch.device(dev):
        module = XYTokenizerModule(cfg)
    module = module.to(dev)                  # the position tables too
    if params is None:
        _init_random(module, seed, dev)
    else:
        module.load_state_dict(params)
    module.train().requires_grad_(True)
    named = dict(module.named_parameters())
    codebook = module.quantizer.codebook.detach()
    return CodecTrainState(
        step=0, params=named, optimizer=optimizer.init(named.values()),
        cluster_size=torch.zeros(codebook.shape[:2], device=dev),
        embed_avg=codebook.clone(), module=module)


def _as_batch(state: CodecTrainState, wav, lengths):
    dev = state.cluster_size.device
    return (torch.as_tensor(wav, dtype=torch.float32, device=dev),
            torch.as_tensor(lengths, device=dev).long())


@torch.no_grad()
def kmeans_bootstrap(cfg: CodecConfig, state: CodecTrainState, wav, lengths,
                     generator: Optional[torch.Generator] = None,
                     init_idx_override: Optional[torch.Tensor] = None
                     ) -> CodecTrainState:
    """One-shot k-means init of every RVQ stage from a bootstrap batch:
    codebook := the k-means means, embed_avg := codebook, cluster_size :=
    the final bin counts. Call once before the first step; under data
    parallelism every rank runs it on the same batch and generator seed."""
    del cfg     # the module carries its config; kept for the JAX signature
    wav, lengths = _as_batch(state, wav, lengths)
    new_cb, bins = state.module.kmeans_init_codebooks(
        wav, lengths, generator, init_idx_override=init_idx_override)
    state.module.quantizer.codebook.copy_(new_cb)
    state.cluster_size = bins
    state.embed_avg = new_cb.clone()
    return state


def make_codec_train_step(cfg: CodecConfig, optimizer: ClippedAdamW,
                          commit_weight: float = 1.0,
                          mel_weight: float = 1.0,
                          wave_weight: float = 1.0,
                          mel_n_fft: int = 1024, mel_hop: int = 256,
                          mel_bins: int = 80, group=None):
    """Returns train_step(state, batch, generator=None, **draws) ->
    (state, metrics).

    batch: {"wav": (B, T) 16 kHz float32, "lengths": (B,)}; under ``group``
    this rank's rows of the global batch. ``draws`` are
    ``ResidualVQ.train_call``'s overrides over the global batch
    (``n_active_override``, ``skip_override``, ``sample_idx_override``);
    what is not overridden is drawn from ``generator``. ``state`` is updated
    in place and returned; metrics are device tensors of the global batch:
    "loss", "wave_l1", "mel_l1", "commit", "grad_norm" (before clipping,
    the codebook's zeros counted) and "codebook_usage"."""
    qc = cfg.quantizer
    in_sr, out_sr = cfg.input_sample_rate, cfg.output_sample_rate
    g = math.gcd(out_sr, in_sr)
    world, _ = _world(group)

    def log_mel(x):
        return log_mel_spectrogram(x, n_fft=mel_n_fft, hop=mel_hop,
                                   num_mels=mel_bins, sampling_rate=out_sr)

    def train_step(state: CodecTrainState, batch,
                   generator: Optional[torch.Generator] = None, **draws):
        wav, lengths = _as_batch(state, batch["wav"], batch["lengths"])
        state.optimizer.zero_grad(set_to_none=True)
        out = state.module.train_forward(wav, lengths, generator,
                                         group=group, **draws)
        target = resample_torch(wav, in_sr, out_sr)             # (B, T24)
        recon = out["wav"]
        n = min(recon.shape[-1], target.shape[-1])
        recon, target = recon[..., :n], target[..., :n]
        # the reduced ratio keeps lengths x 24000 inside int32 in the JAX
        # package; int64 here gives the same t_len
        t_len = torch.minimum(out["wav_lengths"],
                              (lengths * (out_sr // g)) // (in_sr // g))
        valid = (torch.arange(n, device=wav.device)[None, :]
                 < t_len[:, None]).to(torch.float32)
        # denominators of the global batch; each rank's terms are its share
        denom = _all_reduce(valid.sum(), group).clamp_min(1.0)
        wave_l1 = ((recon - target).abs() * valid).sum() / denom
        mel_r, mel_t = log_mel(recon * valid), log_mel(target * valid)
        mel_l1 = (mel_r - mel_t).abs().sum() / (mel_r.numel() * world)
        commit = out["commit_losses"].mean()
        loss = (wave_weight * wave_l1 + mel_weight * mel_l1
                + commit_weight * commit)
        loss.backward()
        if group is not None:
            for p in state.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                torch.distributed.all_reduce(p.grad, group=group)
        norm = optimizer.update(state.optimizer, state.step)

        # the EMA overwrite of the codebook (its gradient is zero, so this
        # is its whole update), then dead-code replacement after the EMA
        stats = out["vq_stats"]
        new_cluster, new_avg, new_cb = ema_update_stacked(
            state.cluster_size, state.embed_avg, stats["cluster_new"],
            stats["embed_sum"], decay=qc.decay, epsilon=qc.epsilon)
        if qc.threshold_ema_dead > 0:
            dead = new_cluster < qc.threshold_ema_dead
            new_cb = torch.where(dead[..., None], stats["samples"], new_cb)
        with torch.no_grad():
            state.module.quantizer.codebook.copy_(new_cb)
        state.cluster_size, state.embed_avg = new_cluster, new_avg
        state.step += 1

        parts = _all_reduce(torch.stack([x.detach() for x in (
            loss, wave_l1, mel_l1, commit)]), group)
        metrics = dict(zip(("loss", "wave_l1", "mel_l1", "commit"), parts))
        metrics["grad_norm"] = norm
        metrics["codebook_usage"] = (stats["cluster_new"] > 0).to(
            torch.float32).mean()
        return state, metrics

    return train_step

"""Autoregressive generation engine, PyTorch port of
``moss_ttsd_tpu/decode/engine.py`` (the static-batch ``generate``, with the
attention backends of ``attn_impl``, the int8 serving policies:
``quant="int8"`` weights, the ``kv_quant="int8"`` cache and the
restricted text head with its audit; per-row LoRA adapters through
``register_adapter`` and ``adapter=``).

Prefill runs the left-padded, bucketed prompt through the LM once; a
host-driven step loop (the JAX ``while_loop``) then runs the decode
``_step`` until the step budget or until every row finished. All of the
reference's delay-pattern control flow stays on the device as tensor ops:

  * teacher-forcing window — channels > s of the first C-1 steps come from
    the shifted prompt tail;
  * per-channel hard masks — pad forbidden on channel i once its delay has
    elapsed, end-of-speech forbidden on channel 0 inside the TF window;
  * EOS flush — a non-speech channel-0 token starts a (C-1)-step staggered
    pad flush tracked by an integer countdown; finished rows emit eos/pad.

Shapes stay static: the prompt bucket, ``buf_steps`` (the token buffer and
the full-capacity KV cache) and a per-step decode extent ``cur_len + 1``
passed to the extent-clamped decode kernel. Each decode step makes exactly
one host sync, the ``unfinished.any()`` loop test (counted on the card by
``chip_smoke.py``). ``generate_stream`` runs the same loop in segments over
one decode state and one generator, so its tokens are ``generate``'s.

On a ("data", "model") mesh (``parallel/mesh.py``) each process holds its
model rank's shard of the weights and its data rank's rows; the sampled
tokens are broadcast from the model group's first rank every step (so the
ranks' caches never diverge), the loop test is taken over the whole mesh
(every data rank runs the batch's steps, as the JAX loop does) and the
tokens are gathered to every rank at the end of each call or segment.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import LMConfig, SamplingConfig
from ..core.device import DeviceLike, resolve_device, torch_dtype
from ..models.lm import AsteroidLM, init_cache, select_adapters
from ..ops.attention import NEG_INF
from ..ops.quantize import is_quantized_tree, quantize_lm_params
from ..ops.sampling import (ChannelParams, apply_repetition_penalty,
                            presence_from_history, sample_from_channel,
                            scatter_presence)
from ..parallel.mesh import batch_spec, shard_params
from .lora_registry import LoraRegistry


class GenerateResult(NamedTuple):
    tokens: np.ndarray       # (B, base + steps, C) — prompt-minus-tail + generated
    steps: int               # decode steps actually run
    base: int                # index of the first generated row (bucketed L - C + 1)
    unfinished: Optional[np.ndarray] = None   # (B,) bool, rows still
    #                          decoding (generate_stream; None from generate)
    audit: Optional[Tuple[int, int]] = None   # restricted-head audit
    #                          (rows_audited, rows_flagged); None when off


@dataclasses.dataclass
class DecodeState:
    step: int
    tokens: torch.Tensor         # (B, S, C) token buffer
    cache: dict                  # {"k","v"[,"k_s","v_s"]} (L, B, Hkv, S[, D])
    key_valid: torch.Tensor      # (B, S) bool
    hidden_last: torch.Tensor    # (B, 1, H)
    last_pos: torch.Tensor       # (B,) last RoPE position used
    needs: torch.Tensor          # (B,) EOS-flush countdown, -1 = inactive
    unfinished: torch.Tensor     # (B,) bool
    presence_text: torch.Tensor  # (B, V_text) bool; restricted head: (B, window)
    presence_speech: torch.Tensor  # (B, C-1, V_speech) bool
    audit_rows: torch.Tensor     # () int64 — unfinished rows audited
    audit_flagged: torch.Tensor  # () int64 — rows whose full-head best
    #                              out-of-window logit beat the window max


def sample_channels(gen, text_logits, speech_logits, presence_text,
                    presence_speech, srow, ch_params, prefilter,
                    approx_topk, eos, pad_speech, text_offset: int = 0):
    """One sampling round -> next_tokens (B, C). ``srow`` is the decode
    step: a host int (static batch, all rows in lockstep) or a (B,) tensor
    (continuous pool, each row at its own depth). ``gen``: one generator
    for the batch, or a list of one per row (the continuous pool's
    sampler: row b draws, channel by channel, exactly the noise of a
    batch-1 call with ``gen[b]``, i.e. the static engine's draws for that
    request; the logits work stays batched).
    ``text_offset``: vocab id of column 0 of text_logits / presence_text
    (the restricted head's window start); ``eos`` and the returned channel-0
    tokens are full vocab ids."""
    lg = channel_logits(text_logits, speech_logits, presence_text,
                        presence_speech, srow, ch_params, eos, pad_speech,
                        text_offset)
    toks = [sample_from_channel(gen, x, ch_params[i], prefilter, approx_topk)
            for i, x in enumerate(lg)]
    toks[0] = toks[0] + text_offset
    return torch.stack(toks, dim=-1)


def channel_logits(text_logits, speech_logits, presence_text,
                   presence_speech, srow, ch_params, eos, pad_speech,
                   text_offset: int = 0):
    """The masked + penalized per-channel logits the draws see (the JAX
    ``_sample_channels_body`` chain, the one copy shared by the static and
    the per-row samplers): channel 0 gets -1e30 on eos inside the TF
    window, channel i >= 1 on the speech pad once its delay elapsed; then
    the repetition penalty. ``srow``: a host int, or a (B,) tensor of
    per-row steps (each row masked by its own)."""
    C = len(ch_params)
    t = text_logits.clone()
    per_row = isinstance(srow, torch.Tensor)
    if per_row:
        t[:, eos - text_offset] += torch.where(srow < C - 1, NEG_INF, 0.0)
    elif srow < C - 1:
        t[:, eos - text_offset] += NEG_INF
    out = [apply_repetition_penalty(t, presence_text,
                                    ch_params[0].repetition_penalty)]
    for i in range(1, C):
        sl = speech_logits[:, i - 1]
        if per_row:
            sl = sl.clone()
            sl[:, pad_speech] += torch.where(srow >= i, NEG_INF, 0.0)
        elif srow >= i:
            sl = sl.clone()
            sl[:, pad_speech] += NEG_INF
        out.append(apply_repetition_penalty(sl, presence_speech[:, i - 1],
                                            ch_params[i].repetition_penalty))
    return out


ATTN_IMPLS = ("mixed", "pallas", "xla")


def _check_policies(cfg: LMConfig) -> None:
    """ValueError for an attention backend or a KV-cache mode that neither
    package knows.

    ``attn_impl``: "mixed" and "pallas" attend through the port's kernels,
    "xla" through the dense einsums (``models/lm.py``). TPU performance
    knobs with no numeric effect (``decode_len_bucket``,
    ``decode_extent_kernel``, ``decode_block_k``, ``pallas_interpret``,
    ``fuse_qk_norm_rope``) are accepted and ignored, as is
    ``remat_layers`` (no backward at serving)."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} "
                         f"(choices: {', '.join(ATTN_IMPLS)})")
    if cfg.kv_quant not in ("none", "int8"):
        raise ValueError(f"unknown kv_quant mode {cfg.kv_quant!r}")


class GenerationEngine:
    """Prefill + decode loop over a static-shape KV cache.

    ``params``: an ``AsteroidLM`` or a state dict for one. Float weights are
    cast once to ``cfg.dtype`` (the decode step is weight-bandwidth-bound)
    and then, with ``quant="int8"``, quantized to w8a16
    (``ops/quantize.py``); a state dict already in the int8 layout skips
    both. The engine builds its own module around the weights (no copy), so
    its decode policy never leaks into the caller's model.

    ``kv_quant="int8"``: int8 KV cache with per-head-per-token scales, read
    by ``flash_decode_int8_hs`` at every decode step; otherwise the cache is
    in ``cfg.dtype`` (the kernels read it in the compute dtype).
    ``restricted_text_head``: channel-0 logits over the speech window only;
    ``restricted_audit_every=N`` streams the full text head every N-th step
    and counts the rows where it would have preferred an out-of-window
    token (``GenerateResult.audit``). ``attn_impl`` ("mixed" | "pallas" |
    "xla") picks the attention backend (``models/lm.py``; "xla" is the
    dense one, the others the kernels). The five keywords override
    ``cfg``.

    LoRA voices: ``register_adapter`` stacks an adapter's factors
    (``decode/lora_registry.py``); ``generate(adapter=...)`` then runs the
    prefill and every decode step of each row through its adapter. A
    ``cfg.lora_rank`` > 0 config serves its own ``lora_a`` / ``lora_b``
    factors layerwise (JAX ``LoRADense``); int8 serving drops them, as the
    JAX engine does.

    ``mesh`` (``parallel/mesh.Mesh``): tensor-parallel weights over its
    "model" axis (the full weights are cast, quantized and then sharded;
    an ``AsteroidLM`` that is already a shard is taken as it is) and the
    batch's rows split over its "data" axis (the batch must divide by it).
    Each data rank seeds its generator from (seed, data rank), so sampled
    rows draw other noise than without a mesh; greedy tokens are the
    same."""

    def __init__(self, cfg: LMConfig,
                 params: Union[AsteroidLM, Mapping[str, torch.Tensor]],
                 sampling: Optional[SamplingConfig] = None,
                 bucket: int = 128, step_bucket: int = 256,
                 device: DeviceLike = "cuda", quant: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 restricted_text_head: Optional[bool] = None,
                 restricted_audit_every: Optional[int] = None, mesh=None,
                 attn_impl: Optional[str] = None):
        self.device = resolve_device(device)
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        overrides = {k: v for k, v in (
            ("kv_quant", kv_quant),
            ("restricted_text_head", restricted_text_head),
            ("attn_impl", attn_impl),
            ("restricted_audit_every", restricted_audit_every)) if v is not None}
        if quant == "int8":
            # int8 serving runs merged weights (the JAX engine's rule)
            overrides.update(quantized=True, lora_rank=0)
        cfg = dataclasses.replace(cfg, **overrides)
        _check_policies(cfg)
        self.cfg = cfg
        self.text_window = cfg.text_head_window()
        self.mesh = mesh
        self.tp = None if mesh is None else mesh.tensor_parallel(cfg)
        self.model = self._build_model(cfg, params)
        self.cache_dtype = torch_dtype(cfg.dtype)
        self.sampling = sampling or SamplingConfig.default(cfg.channels)
        if step_bucket < cfg.channels - 1:
            raise ValueError(
                f"step_bucket={step_bucket} must be >= channels-1 "
                f"({cfg.channels - 1}) to hold the teacher-forcing tail")
        self.bucket = bucket
        self.step_bucket = step_bucket
        self.ch_params: List[ChannelParams] = [
            ChannelParams.from_config(c, exact_top_p=self.sampling.exact_top_p)
            for c in self.sampling.channels]
        # host-clock split of the last generate() (prefill / decode loop)
        self.last_stats: dict = {}
        # multi-LoRA registry: id 0 = the base model; under tensor
        # parallelism its stacks hold the rank's factor slices
        self.lora = LoraRegistry(
            self.cache_dtype, cfg.num_hidden_layers, self.device,
            shard=None if self.tp is None else self.tp.shard_lora)

    def register_adapter(self, name: str, lora: dict, alpha: float = 32.0,
                         use_rslora: bool = True) -> int:
        """Register a LoRA adapter for per-row serving; returns its id (see
        ``LoraRegistry.register`` for the tree formats and the scale).
        Register every adapter before serving traffic."""
        return self.lora.register(name, lora, alpha, use_rslora)

    def _adapter_operands(self, adapter, batch: int,
                          rows: slice = slice(None)) -> Optional[dict]:
        """The LoRA factors (``select_adapters``) of the batch's ``rows``
        for ``adapter`` (one name, or a per-row list over the whole batch;
        None = the base model), or None when every row is on the base
        model (nothing to add in any projection). Every name is checked,
        also those of other data ranks' rows."""
        if not self.lora:
            named = ([adapter] if adapter is None or isinstance(adapter, str)
                     else list(adapter))
            if any(a not in (None, "") for a in named):
                raise ValueError(
                    f"unknown adapter {adapter!r}; none registered")
            return None
        row_ids = self.lora.row_ids(adapter, batch)[rows]
        if not any(row_ids):
            return None
        ids = torch.tensor(row_ids, dtype=torch.int64, device=self.device)
        return select_adapters(self.lora.stacks, ids)

    def _build_model(self, cfg: LMConfig, params) -> AsteroidLM:
        """The engine's own ``AsteroidLM(cfg)`` around the given weights:
        cast to ``cfg.dtype`` first, quantized after (``cfg.quantized``); a
        state dict already quantized is taken as it is. The module is made
        on the meta device and the tensors assigned, so nothing is copied
        that needs no cast."""
        state = (params.state_dict() if isinstance(params, AsteroidLM)
                 else dict(params))
        shard = isinstance(params, AsteroidLM) and params.tp is not None
        if shard and (self.tp is None or (params.tp.rank, params.tp.size)
                      != (self.tp.rank, self.tp.size)):
            raise ValueError("a tensor-parallel shard needs the engine's "
                             "mesh to hold the same model rank")
        dev = self.device
        if is_quantized_tree(state):
            if not cfg.quantized:
                raise ValueError("int8 weights need quant='int8'")
            state = {k: v.to(dev) for k, v in state.items()}
        else:
            if shard and cfg.quantized:
                raise ValueError("quantize the full weights, not a shard "
                                 "(rowwise scales span every rank)")
            state = {k: v.to(device=dev, dtype=torch_dtype(cfg.dtype))
                     for k, v in state.items()}
            if cfg.quantized:
                state = quantize_lm_params(state)
        if self.tp is not None and not shard:
            state = shard_params(state, self.mesh, cfg)
        with torch.device("meta"):
            model = AsteroidLM(cfg, self.tp)
        model.load_state_dict(state, assign=True)
        return model.eval().requires_grad_(False)

    # -- budget / bucketing (host) -------------------------------------------

    def _step_budget(self, max_new_tokens: Optional[int], prompt_len: int):
        """(steps to run, buffer capacity): HF max_length counts from the
        prompt minus its C-1 teacher-forcing rows; a prompt already at
        max_length gets 0 steps. Capacity is bucketed upward."""
        if max_new_tokens is not None and max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        steps = (self.sampling.max_new_tokens if max_new_tokens is None
                 else max_new_tokens)
        if self.sampling.max_length is not None and max_new_tokens is None:
            counted = prompt_len - (self.cfg.channels - 1)
            steps = min(steps, max(0, self.sampling.max_length - counted))
        sb = self.step_bucket
        buf = max(sb, -(-steps // sb) * sb)
        return steps, buf

    def _bucket_prompt(self, input_ids: np.ndarray, attention_mask: np.ndarray):
        """Left-pad the prompt to a bucket multiple; returns (ids, mask, base)."""
        C = self.cfg.channels
        B, L, _ = input_ids.shape
        L_b = max(self.bucket, -(-L // self.bucket) * self.bucket)
        pad = L_b - L
        if pad:
            pad_ids = np.zeros((B, pad, C), input_ids.dtype)
            pad_ids[..., 0] = self.cfg.pad_token_id
            pad_ids[..., 1:] = self.cfg.speech_pad_token
            input_ids = np.concatenate([pad_ids, input_ids], axis=1)
            attention_mask = np.concatenate(
                [np.zeros((B, pad), attention_mask.dtype), attention_mask],
                axis=1)
        return input_ids, attention_mask, L_b - C + 1

    # -- device programs -----------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens_full: torch.Tensor, attn_mask: torch.Tensor,
                base: int, buf_steps: int,
                adapters: Optional[dict] = None) -> DecodeState:
        """tokens_full (B, L, C) shifted prompt (bucketed, left-padded);
        attn_mask (B, L) 1 = real. Runs the first ``base`` rows (the
        reference drops the last C-1 before its loop) into a fresh cache of
        base + buf_steps slots, through the rows' ``adapters``."""
        cfg, dev = self.cfg, self.device
        C = cfg.channels
        B, L, _ = tokens_full.shape
        S = base + buf_steps
        buf = torch.zeros((B, S, C), dtype=torch.int64, device=dev)
        buf[:, :L] = tokens_full
        m = attn_mask[:, :base].to(torch.int64)
        positions = (torch.cumsum(m, dim=1) - 1).clamp_min(0)
        key_valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
        key_valid[:, :base] = m.to(torch.bool)
        cache = init_cache(cfg, B, S, self.cache_dtype, dev,
                           self.model.kv_heads)
        hidden, cache = self.model.backbone(buf[:, :base], positions,
                                            key_valid, cache, 0,
                                            adapters=adapters)
        lo, hi = self.text_window
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return DecodeState(
            step=0, tokens=buf, cache=cache, key_valid=key_valid,
            hidden_last=hidden[:, -1:], last_pos=positions[:, -1].clone(),
            needs=torch.full((B,), -1, dtype=torch.int64, device=dev),
            unfinished=torch.ones((B,), dtype=torch.bool, device=dev),
            # window-relative ids; ids below the window go negative and
            # are dropped, never wrapped onto window slots
            presence_text=presence_from_history(buf[:, :base, 0] - lo,
                                                hi - lo),
            presence_speech=torch.stack(
                [presence_from_history(buf[:, :base, i],
                                       cfg.speech_vocab_size)
                 for i in range(1, C)], dim=1),
            audit_rows=zero, audit_flagged=zero.clone())

    @torch.no_grad()
    def _step(self, st: DecodeState, base: int,
              gen: Optional[torch.Generator],
              adapters: Optional[dict] = None) -> None:
        """One decode step, in place on ``st`` (JAX engine ``body``)."""
        cfg = self.cfg
        C = cfg.channels
        s = st.step
        cur_len = base + s
        eos, pad_speech = cfg.eos_token_id, cfg.speech_pad_token
        speech_lo, speech_hi = cfg.speech_token_range
        lo = self.text_window[0]
        restricted = cfg.restricted_text_head
        text_logits, speech_logits = self.model.logits_all(st.hidden_last,
                                                           restricted)
        text_logits = text_logits[:, 0]              # (B, hi - lo)
        next_tokens = sample_channels(
            gen, text_logits, speech_logits[:, 0], st.presence_text,
            st.presence_speech, s, self.ch_params,
            self.sampling.topk_prefilter, self.sampling.approx_topk, eos,
            pad_speech, lo)                                      # (B, C)
        if self.tp is not None:     # one draw for the whole model group
            next_tokens = self.tp.broadcast(next_tokens)

        # restricted-head audit: every N-th step stream the full text head
        # once and count the live rows whose best out-of-window raw logit
        # beats the window max (counters stay on the device: no sync)
        every = cfg.restricted_audit_every
        if restricted and every > 0 and s % every == 0:
            outside = self.model.text_logits_outside_max(st.hidden_last)
            live = st.unfinished & (st.needs < 0)
            st.audit_rows += live.sum()
            st.audit_flagged += (live & (outside
                                         > text_logits.amax(dim=-1))).sum()

        # EOS detection on the sampled channel 0
        tok0 = next_tokens[:, 0]
        is_speech = (tok0 >= speech_lo) & (tok0 < speech_hi)
        needs = torch.where((~is_speech) & (st.needs < 0),
                            torch.full_like(st.needs, C - 1), st.needs)

        # teacher forcing: while s < C-1, channels > s come from the prompt
        chan = torch.arange(C, device=self.device)
        if s < C - 1:
            tf_row = st.tokens[:, cur_len]
            next_tokens = torch.where(chan[None, :] > s, tf_row, next_tokens)

        # staggered EOS flush, then finished rows emit eos/pad
        fill = torch.where(chan == 0, eos, pad_speech)[None, :]
        flushing = (needs > 0) & (needs < C - 1)
        flush_chan = (chan[None, :] == 0) | (needs[:, None] < C - chan[None, :])
        next_tokens = torch.where(flushing[:, None] & flush_chan, fill,
                                  next_tokens)
        next_tokens = torch.where(st.unfinished[:, None], next_tokens, fill)

        st.tokens[:, cur_len] = next_tokens
        scatter_presence(st.presence_text, next_tokens[:, 0] - lo)
        scatter_presence(st.presence_speech, next_tokens[:, 1:])
        needs = torch.where(needs > 0, needs - 1, needs)
        stopping = (next_tokens[:, 0] == eos) | (needs == 0)
        st.unfinished = (st.unfinished & ~stopping) | (needs > 0)
        st.needs = needs

        # forward the new token: cache write at cur_len, extent cur_len + 1
        st.key_valid[:, cur_len] = True
        st.last_pos = st.last_pos + 1
        hidden, _ = self.model.backbone(
            next_tokens[:, None, :], st.last_pos[:, None], st.key_valid,
            st.cache, cur_len, adapters=adapters)
        st.hidden_last = hidden
        st.step = s + 1

    def run(self, st: DecodeState, base: int, upto: int,
            gen: Optional[torch.Generator],
            adapters: Optional[dict] = None) -> DecodeState:
        """Decode until step == upto or every row finished (on a mesh:
        every row of every data rank). The ``unfinished.any()`` test is
        the step's one host sync."""
        while st.step < upto and self._any(st.unfinished):
            self._step(st, base, gen, adapters)
        return st

    def _any(self, flags: torch.Tensor) -> bool:
        if self.mesh is None:
            return bool(flags.any())
        return self.mesh.any_unfinished(flags)

    def _rows(self, batch: int) -> slice:
        """This data rank's rows of a ``batch``-row request."""
        if self.mesh is None:
            return slice(None)
        return batch_spec(self.mesh, batch)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x``."""
        return x if self.mesh is None else self.mesh.gather_rows(x)

    def _data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A counter summed over the data ranks."""
        if self.mesh is None:
            return x
        return self.mesh.all_reduce(x.clone(), self.mesh.data_group)

    def _seed(self, seed: int) -> int:
        """Data rank 0 draws from ``seed``; rank d > 0 from (seed, d)."""
        if self.mesh is None or self.mesh.data_rank == 0:
            return int(seed)
        return int(np.random.SeedSequence(
            [int(seed) % 2 ** 63, self.mesh.data_rank]).generate_state(
                1, np.uint64)[0] % 2 ** 63)

    def make_pool(self, **kwargs):
        """A ``ContinuousBatcher`` over this engine's weights, voice
        registry, policies and mesh (no copy); ``kwargs`` are its geometry
        (``slots``, ``base``, ``max_steps``, ``kv_quant``, ...)."""
        from .continuous import ContinuousBatcher
        return ContinuousBatcher(
            self.cfg, self.model, self.sampling, device=self.device,
            quant="int8" if self.cfg.quantized else None,
            restricted_text_head=self.cfg.restricted_text_head,
            lora=self.lora, mesh=self.mesh, **kwargs)

    def _start(self, input_ids: np.ndarray, attention_mask: np.ndarray,
               max_new_tokens: Optional[int], seed: int, adapter):
        """Budget, adapters, bucketed prompt, seeded generator and
        prefilled state of one request -> (state, base, max_steps,
        buf_steps, gen, bucketed ids, bucketed mask, prefill seconds,
        adapters). The ids and mask are the whole batch's; the state holds
        this data rank's rows."""
        max_steps, buf_steps = self._step_budget(max_new_tokens,
                                                 input_ids.shape[1])
        rows = self._rows(input_ids.shape[0])
        adapters = self._adapter_operands(adapter, input_ids.shape[0], rows)
        input_ids, attention_mask, base = self._bucket_prompt(input_ids,
                                                              attention_mask)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(self._seed(seed))
        t0 = time.perf_counter()
        st = self.prefill(torch.as_tensor(input_ids[rows], device=dev),
                          torch.as_tensor(attention_mask[rows], device=dev),
                          base, buf_steps, adapters)
        if dev.type == "cuda":      # the loop's first any() test syncs anyway
            torch.cuda.synchronize(dev)
        return (st, base, max_steps, buf_steps, gen, input_ids,
                attention_mask, time.perf_counter() - t0, adapters)

    def _audit_on(self) -> bool:
        return (self.cfg.restricted_text_head
                and self.cfg.restricted_audit_every > 0)

    def _stats(self, prefill_s, t1, st, base, buf_steps, ids, mask,
               audit) -> None:
        self.last_stats = {
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t1,
            "steps": st.step, "base": base, "buf_steps": buf_steps,
            "batch": int(ids.shape[0]), "audit": audit,
            "left_pad": (mask[:, :base] == 0).sum(axis=1).tolist()}

    def generate(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                 max_new_tokens: Optional[int] = None, seed: int = 0,
                 adapter=None) -> GenerateResult:
        """input_ids: (B, L, C) delay-shifted prompt, left-padded;
        attention_mask: (B, L). Returns the prompt-minus-tail plus the
        generated rows, sliced on the host. ``adapter``: a registered LoRA
        adapter name for the whole batch, or a per-row list of names (None
        = the base model); an unknown name raises ValueError."""
        st, base, max_steps, buf_steps, gen, ids, mask, prefill_s, ad = \
            self._start(input_ids, attention_mask, max_new_tokens, seed,
                        adapter)
        t1 = time.perf_counter()
        st = self.run(st, base, max_steps, gen, ad)
        tokens = self._gather(st.tokens[:, :base + st.step]).cpu().numpy()
        audit = None
        if self._audit_on():
            audit = tuple(int(v) for v in self._data_sum(
                torch.stack([st.audit_rows, st.audit_flagged])).cpu())
        self._stats(prefill_s, t1, st, base, buf_steps, ids, mask, audit)
        return GenerateResult(tokens=tokens,
                              steps=st.step, base=base, audit=audit)

    def generate_stream(self, input_ids: np.ndarray,
                        attention_mask: np.ndarray,
                        max_new_tokens: Optional[int] = None, seed: int = 0,
                        chunk_steps: int = 25,
                        boundaries: Optional[List[int]] = None,
                        adapter=None):
        """Incremental generation: yields a GenerateResult after every
        ``chunk_steps`` decode steps, or at the sorted absolute
        ``boundaries`` inside (0, max_steps) and then at max_steps.

        Each result holds ALL rows generated so far plus the per-row
        ``unfinished`` flags. One prefill, one decode state and one
        generator serve every segment, so the tokens are exactly those of
        ``generate`` with the same seed. A host mirror of the token buffer
        receives only each segment's new rows; those rows, the finish flags
        and (when on) the audit counters come back in one readback per
        segment. A budget of 0 steps yields one prompt-only result.
        ``adapter`` as in ``generate``."""
        st, base, max_steps, buf_steps, gen, ids, mask, prefill_s, ad = \
            self._start(input_ids, attention_mask, max_new_tokens, seed,
                        adapter)
        B, L, C = ids.shape
        host = np.zeros((B, base + buf_steps, C), np.int64)
        host[:, :L] = ids                 # decode overwrites rows >= base
        if max_steps == 0:
            yield GenerateResult(tokens=host[:, :base].copy(), steps=0,
                                 base=base, unfinished=np.zeros(B, bool))
            return
        bounds = (sorted(b for b in boundaries if 0 < b < max_steps)
                  if boundaries else None)
        audit_on = self._audit_on()
        t1 = time.perf_counter()
        done, audit = 0, None
        while done < max_steps:
            if bounds is not None:
                upto = next((b for b in bounds if b > done), max_steps)
            else:
                upto = min(done + chunk_steps, max_steps)
            st = self.run(st, base, upto, gen, ad)
            steps = st.step
            parts = [self._gather(st.tokens[:, base + done:base + steps]
                                  ).reshape(-1),
                     self._gather(st.unfinished.to(torch.int64))]
            if audit_on:
                parts.append(self._data_sum(
                    torch.stack([st.audit_rows, st.audit_flagged])))
            vals = torch.cat(parts).cpu().numpy()
            n_new = B * (steps - done) * C
            host[:, base + done:base + steps] = vals[:n_new].reshape(
                B, steps - done, C)
            unfin = vals[n_new:n_new + B].astype(bool)
            if audit_on:
                audit = (int(vals[-2]), int(vals[-1]))
            yield GenerateResult(tokens=host[:, :base + steps].copy(),
                                 steps=steps, base=base, unfinished=unfin,
                                 audit=audit)
            if steps < upto or not unfin.any():
                break
            done = steps
        self._stats(prefill_s, t1, st, base, buf_steps, ids, mask, audit)

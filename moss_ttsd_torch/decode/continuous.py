"""Continuous batching: a slot pool over the decode step, PyTorch port of
``moss_ttsd_tpu/decode/continuous.py``.

The static engine serves whole batches: one long request holds its batch
and new requests wait for a full drain. This pool keeps ``slots`` rows
decoding in lockstep; requests join at segment boundaries (one batched
prompt prefill a burst, padded to a power of two, then an in-place splice
of each row into a free slot) and a finished row leaves at once, so its
slot serves the next request.

Every slot carries its own decode step, RoPE position, EOS-flush countdown,
repetition-penalty presence sets, step budget, LoRA adapter id and random
generator. The KV cache is ring-addressed: every row writes the one scalar
slot ``base + gstep % max_steps`` each pool step (an in-place write of a
(B, Hkv, D) sliver per layer, rows that do not advance gated off), and the
per-row ``key_valid`` masks carry time order; the token buffer stays in
per-row coordinates (``base + own step``) for teacher forcing and
unshifting. Each row reads the cache up to its own extent (its last valid
slot + 1; 1 for a row that does not advance) through the extent-clamped
decode kernels, so a row that joined late reads only its own history.

A row's tokens equal those of an isolated batch-1 ``GenerationEngine.
generate`` with the request's seed and adapter: the slot's generator is
seeded with the request's seed at the splice and draws, channel by
channel, the noise a batch-1 run draws (``sample_channels`` with one
generator per row).
Rows that do not advance draw too; a finished row's generator is never
read again, and a new request reseeds its slot, so no host read of which
rows advance is needed. One host sync a step (the loop test), one
readback a segment (``poll`` / ``progress``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from ..core.config import LMConfig, SamplingConfig
from ..core.device import DeviceLike
from ..models.lm import init_cache, select_adapters
from ..ops.sampling import scatter_presence
from .engine import (DecodeState, GenerateResult, GenerationEngine,
                     sample_channels)
from .lora_registry import LoraRegistry

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PoolState:
    gstep: int                   # pool step, the ring clock (pre-wrapped)
    active: torch.Tensor         # (B,) bool — slot holds a live request
    step_r: torch.Tensor         # (B,) decode steps done per row
    max_r: torch.Tensor          # (B,) per-row step budget
    tokens: torch.Tensor         # (B, S, C)
    cache: dict                  # {"k","v"[,"k_s","v_s"]} (L, B, Hkv, S[, D])
    key_valid: torch.Tensor      # (B, S) bool
    hidden_last: torch.Tensor    # (B, 1, H)
    last_pos: torch.Tensor       # (B,)
    needs: torch.Tensor          # (B,) EOS-flush countdown, -1 inactive
    unfinished: torch.Tensor     # (B,) bool
    presence_text: torch.Tensor  # (B, V_text) bool; restricted: (B, window)
    presence_speech: torch.Tensor  # (B, C-1, V_speech) bool
    adapter_r: torch.Tensor      # (B,) LoRA adapter id per row (0 = base)


class ContinuousBatcher:
    """Fixed-slot continuous batching over AsteroidLM.

    Parameters mirror ``GenerationEngine``; ``slots`` is the pool width
    (the batch the card decodes), ``base`` the one prompt bucket (shifted
    prompts longer than base + channels - 1 are refused) and ``max_steps``
    the per-slot capacity. ``quant``, ``kv_quant`` and
    ``restricted_text_head`` are the engine's. ``len_aware=False`` reads
    every row's whole cache (extent S), the reference for the per-row
    extents. ``lora``: a ``LoraRegistry`` to share (a serving engine's, so
    its voices are registered and stored once); by default the pool's
    engine has its own. ``mesh`` (``parallel/mesh.Mesh``): the weights
    tensor-parallel over its "model" axis (the engine's sharding; a shard
    is taken as it is), the pool state per rank with the rank's KV heads,
    the sampled tokens broadcast from the model group's first rank every
    step; each data replica runs the same whole pool, as the JAX pool's
    replicated state does.

        cb = ContinuousBatcher(cfg, model, sampling, slots=8, device="cuda")
        cb.submit(shifted_prompt, max_new_tokens=200)   # whenever slots free
        cb.run(steps=25)                                # advance the pool
        for slot in cb.finished():
            result = cb.collect(slot)                   # frees the slot
    """

    def __init__(self, cfg: LMConfig, params,
                 sampling: Optional[SamplingConfig] = None, slots: int = 8,
                 base: int = 128, max_steps: int = 512,
                 device: DeviceLike = "cuda", quant: Optional[str] = None,
                 kv_quant: Optional[str] = None, seed: int = 0, mesh=None,
                 len_aware: bool = True,
                 restricted_text_head: Optional[bool] = None,
                 lora: Optional[LoraRegistry] = None):
        # the engine's weight handling (dtype cast, int8 quantization,
        # sharding) and its prefill; the pool never decodes through the
        # engine's loop
        eng = GenerationEngine(cfg, params, sampling, bucket=base,
                               step_bucket=max_steps, device=device,
                               quant=quant, kv_quant=kv_quant,
                               restricted_text_head=restricted_text_head,
                               mesh=mesh)
        if lora is not None:
            if (lora.dtype, lora.device, lora.num_layers,
                    lora.shard is None) != (
                    eng.cache_dtype, eng.device, eng.cfg.num_hidden_layers,
                    eng.tp is None):
                raise ValueError(
                    f"lora registry ({lora.dtype}, {lora.device}, "
                    f"{lora.num_layers} layers, sharded "
                    f"{lora.shard is not None}) does not match the pool "
                    f"({eng.cache_dtype}, {eng.device}, "
                    f"{eng.cfg.num_hidden_layers} layers, sharded "
                    f"{eng.tp is not None})")
            eng.lora = lora
        self.engine = eng
        self.mesh = mesh
        self.cfg = eng.cfg
        self.model = eng.model
        self.sampling = eng.sampling
        self.device = eng.device
        self.cache_dtype = eng.cache_dtype
        self.base = base
        self.max_steps = max_steps
        self.slots = slots
        self.len_aware = len_aware
        C = self.cfg.channels
        if max_steps < C - 1:
            raise ValueError(f"max_steps={max_steps} must be >= channels-1 "
                             f"({C - 1}): the spliced prompt prefix would "
                             f"not fit the pool buffer")
        self.S = base + max_steps
        self.L = base + C - 1
        # multi-LoRA registry: id 0 = the base model
        self.lora = eng.lora
        self._row_aid = [0] * slots             # host mirror of adapter_r
        # per-row factors, by slot, and the (stacks, row ids) they came from
        self._adapters: Optional[dict] = None
        self._adapters_src: Optional[tuple] = None
        self.state = self._init_state()
        self.gens = [torch.Generator(device=self.device).manual_seed(seed + j)
                     for j in range(slots)]
        self._slot_free = [True] * slots

    # ------------------------------------------------------------------

    def _init_state(self) -> PoolState:
        cfg, B, S, C, dev = self.cfg, self.slots, self.S, self.cfg.channels, \
            self.device
        lo, hi = self.engine.text_window
        i64 = dict(dtype=torch.int64, device=dev)
        no = dict(dtype=torch.bool, device=dev)
        return PoolState(
            gstep=0,
            active=torch.zeros((B,), **no),
            step_r=torch.zeros((B,), **i64),
            max_r=torch.full((B,), self.max_steps, **i64),
            tokens=torch.zeros((B, S, C), **i64),
            cache=init_cache(cfg, B, S, self.cache_dtype, dev,
                             self.model.kv_heads),
            key_valid=torch.zeros((B, S), **no),
            hidden_last=torch.zeros((B, 1, cfg.hidden_size),
                                    dtype=self.cache_dtype, device=dev),
            last_pos=torch.zeros((B,), **i64),
            needs=torch.full((B,), -1, **i64),
            unfinished=torch.zeros((B,), **no),
            presence_text=torch.zeros((B, hi - lo), **no),
            presence_speech=torch.zeros((B, C - 1, cfg.speech_vocab_size),
                                        **no),
            adapter_r=torch.zeros((B,), **i64))

    def _splice(self, s1: DecodeState, k: int, j: int, max_new: int,
                seed: int, aid: int) -> None:
        """Install row ``k`` of a prefilled DecodeState into pool row ``j``,
        in place.

        ``s1`` covers only the prompt prefix (base + C - 1 slots), so the
        prefix of the row's tokens / key_valid / cache is written and the
        rest of the row is reset: key_valid drops the previous occupant's
        valid bits (stale bits past the prefix would leak its history into
        attention), while stale cache contents past the prefix are
        harmless (masked, and overwritten by the ring as the row decodes).
        The slot's generator restarts from the request's seed, as an
        isolated batch-1 run's does; ``aid`` is the row's adapter id."""
        st = self.state
        Sp = s1.key_valid.shape[1]
        for name, v in s1.cache.items():
            st.cache[name][:, j, :, :Sp].copy_(v[:, k])
        st.tokens[j].zero_()
        st.tokens[j, :Sp] = s1.tokens[k]
        st.key_valid[j] = False
        st.key_valid[j, :Sp] = s1.key_valid[k]
        st.active[j] = True
        st.step_r[j] = 0
        st.max_r[j] = max_new
        st.hidden_last[j] = s1.hidden_last[k]
        st.last_pos[j] = s1.last_pos[k]
        st.needs[j] = -1
        st.unfinished[j] = True
        st.presence_text[j] = s1.presence_text[k]
        st.presence_speech[j] = s1.presence_speech[k]
        st.adapter_r[j] = aid
        self._row_aid[j] = aid
        self.gens[j].manual_seed(int(seed))

    # -- multi-LoRA adapters -------------------------------------------

    def register_adapter(self, name: str, lora: dict, alpha: float = 32.0,
                         use_rslora: bool = True) -> int:
        """Register a LoRA adapter for per-request serving; returns its id
        (``LoraRegistry.register``). Rows select adapters per request with
        ``submit(..., adapter=name)``; None is the base model."""
        return self.lora.register(name, lora, alpha, use_rslora)

    def _row_adapters(self) -> Optional[dict]:
        """The pool rows' LoRA factors, gathered again only after a splice
        or a registration (on this registry, through any owner) changed
        them; None (no adapter work in the step) while every occupied slot
        is on the base model."""
        if not any(a for a, free in zip(self._row_aid, self._slot_free)
                   if not free):
            return None
        src = self._adapters_src
        if (src is None or src[0] is not self.lora.stacks
                or src[1] != self._row_aid):
            self._adapters = select_adapters(self.lora.stacks,
                                             self.state.adapter_r)
            self._adapters_src = (self.lora.stacks, list(self._row_aid))
        return self._adapters

    # ------------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return sum(self._slot_free)

    def _padded_row(self, shifted_prompt: np.ndarray):
        """Left-pad one delay-shifted prompt (Lp, C) to the pool bucket."""
        Lp, C = shifted_prompt.shape
        if Lp > self.L:
            raise ValueError(
                f"shifted prompt ({Lp} rows) exceeds the pool bucket "
                f"({self.L}); raise base= or pre-chunk the prompt")
        ids = np.zeros((self.L, C), np.int64)
        ids[:, 0] = self.cfg.pad_token_id
        ids[:, 1:] = self.cfg.speech_pad_token
        ids[self.L - Lp:] = shifted_prompt
        mask = np.zeros((self.L,), np.int64)
        mask[self.L - Lp:] = 1
        return ids, mask

    def _resolve_steps(self, shifted_prompt: np.ndarray,
                       max_new_tokens: Optional[int]) -> int:
        if max_new_tokens is not None and max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if max_new_tokens is None and self.sampling.max_length is not None:
            # HF max_length total cap, counted as the static engine counts
            # it (the prompt minus its channels-1 teacher-forcing rows)
            counted = shifted_prompt.shape[0] - (self.cfg.channels - 1)
            cap = max(1, self.sampling.max_length - counted)
            max_new_tokens = min(self.sampling.max_new_tokens, cap,
                                 self.max_steps)
        if max_new_tokens is not None and max_new_tokens > self.max_steps:
            # an explicit budget above the pool's capacity is an error (a
            # silent cut would end the audio mid-sentence); the config's
            # default budget only clamps
            raise ValueError(
                f"max_new_tokens={max_new_tokens} exceeds the pool's "
                f"per-slot capacity ({self.max_steps}); raise max_steps= "
                f"or route the request to the static engine (window "
                f"scheduler)")
        if max_new_tokens is None:
            max_new_tokens = self.sampling.max_new_tokens
        return min(max_new_tokens, self.max_steps)

    def submit(self, shifted_prompt: np.ndarray,
               max_new_tokens: Optional[int] = None,
               seed: int = 0, adapter: Optional[str] = None) -> Optional[int]:
        """Join one request: shifted_prompt (Lp, C), the delay-shifted
        prompt (``pipeline.prompt.shift_delay_pattern``). Returns the slot
        id, or None when the pool is full. ``adapter`` names a registered
        LoRA adapter (None = the base model)."""
        if not self.free_slots:
            return None
        return self.submit_many(
            [(shifted_prompt, max_new_tokens, seed, adapter)])[0]

    @torch.no_grad()
    def submit_many(self, requests) -> List[int]:
        """Admit a burst of requests with ONE batched prefill.

        ``requests``: ``(shifted_prompt, max_new_tokens, seed)`` or
        ``(shifted_prompt, max_new_tokens, seed, adapter)`` tuples, at most
        ``free_slots`` of them. Returns the slot ids in request order.
        Validation (oversized prompt, over-capacity or zero budget, unknown
        adapter) covers the whole burst before any device work, so a
        ValueError leaves the pool as it was; callers that want per-request
        isolation catch it and admit one by one.

        The batch is padded to the next power of two (at most ``slots``)
        with repeats of row 0, so the prefill runs at few shapes. Each row's
        draws still follow its own seed."""
        K = len(requests)
        if K == 0:
            return []
        if K > self.free_slots:
            raise ValueError(f"{K} requests exceed {self.free_slots} free "
                             f"slots")
        rows = []
        for req in requests:
            prompt, max_new_tokens, seed = req[:3]
            aid = self.lora.id_of(req[3] if len(req) > 3 else None)
            ids, mask = self._padded_row(prompt)
            rows.append((ids, mask,
                         self._resolve_steps(prompt, max_new_tokens), seed,
                         aid))
        Kb = 1
        while Kb < K:
            Kb *= 2
        Kb = min(Kb, self.slots)
        pad = [rows[0]] * (Kb - K)
        dev = self.device
        ids = torch.as_tensor(np.stack([r[0] for r in rows + pad]),
                              device=dev)
        mask = torch.as_tensor(np.stack([r[1] for r in rows + pad]),
                               device=dev)
        adapters = None
        if any(r[4] for r in rows):
            aids = torch.tensor([r[4] for r in rows + pad],
                                dtype=torch.int64, device=dev)
            adapters = select_adapters(self.lora.stacks, aids)
        C = self.cfg.channels
        s1 = self.engine.prefill(ids, mask, self.base, C - 1, adapters)
        out: List[int] = []
        for k, (_, _, steps, seed, aid) in enumerate(rows):
            j = self._slot_free.index(True)
            self._splice(s1, k, j, steps, seed, aid)
            self._slot_free[j] = False
            out.append(j)
        return out

    @torch.no_grad()
    def _step(self) -> None:
        """One pool step, in place on ``self.state`` (the JAX segment
        body)."""
        st, cfg, eng = self.state, self.cfg, self.engine
        C, S = cfg.channels, self.S
        eos, pad_speech = cfg.eos_token_id, cfg.speech_pad_token
        speech_lo, speech_hi = cfg.speech_token_range
        lo = eng.text_window[0]
        dev = self.device
        srow = st.step_r
        cur_r = self.base + srow                 # per-row TOKEN buffer row
        slot = self.base + st.gstep              # the shared cache slot
        adv = st.active & st.unfinished          # rows that advance
        rows = torch.arange(self.slots, device=dev)
        chan = torch.arange(C, device=dev)

        text_logits, speech_logits = self.model.logits_all(
            st.hidden_last, cfg.restricted_text_head)
        next_tokens = sample_channels(
            self.gens, text_logits[:, 0], speech_logits[:, 0],
            st.presence_text, st.presence_speech, srow, eng.ch_params,
            self.sampling.topk_prefilter, self.sampling.approx_topk, eos,
            pad_speech, lo)
        if eng.tp is not None:      # one draw for the whole model group
            next_tokens = eng.tp.broadcast(next_tokens)

        # adv-gated: a row that does not advance samples garbage (dropped
        # below) and must not arm the flush countdown
        tok0 = next_tokens[:, 0]
        is_speech = (tok0 >= speech_lo) & (tok0 < speech_hi)
        needs = torch.where(adv & ~is_speech & (st.needs < 0),
                            torch.full_like(st.needs, C - 1), st.needs)

        # teacher forcing: each row reads its own shifted-prompt tail row
        at = cur_r.clamp(max=S - 1)
        tf_row = st.tokens[rows, at]                               # (B, C)
        tf_mask = (srow[:, None] < C - 1) & (chan[None, :] > srow[:, None])
        next_tokens = torch.where(tf_mask, tf_row, next_tokens)

        fill = torch.where(chan == 0, eos, pad_speech)[None, :]
        flushing = (needs > 0) & (needs < C - 1)
        flush_chan = (chan[None, :] == 0) | (needs[:, None] < C - chan[None, :])
        next_tokens = torch.where(flushing[:, None] & flush_chan, fill,
                                  next_tokens)
        next_tokens = torch.where(adv[:, None], next_tokens, fill)

        # per-row token write; rows that do not advance keep their buffer
        st.tokens[rows, at] = torch.where(adv[:, None], next_tokens, tf_row)
        # presence: ids of rows that do not advance go out of range (dropped)
        scatter_presence(st.presence_text,
                         torch.where(adv, next_tokens[:, 0] - lo, -1))
        scatter_presence(st.presence_speech,
                         torch.where(adv[:, None], next_tokens[:, 1:], -1))

        needs = torch.where(adv & (needs > 0), needs - 1, needs)
        stopping = (next_tokens[:, 0] == eos) | (needs == 0)
        unfinished = (st.unfinished & ~stopping) | (needs > 0)
        # per-row budget: a row that just wrote its max_r-th token stops
        unfinished = unfinished & (srow + 1 < st.max_r)

        # forward the new token; rows that do not advance run too
        # (lockstep), with their cache write gated off and their hidden
        # state kept
        st.key_valid[:, slot] |= adv
        positions = (st.last_pos + 1)[:, None]
        if self.len_aware:
            iota = torch.arange(1, S + 1, device=dev)
            last = torch.where(st.key_valid, iota, 0).amax(dim=1)
            ext = torch.where(adv, last, 1).to(torch.int32)
        else:
            ext = torch.full((self.slots,), S, dtype=torch.int32, device=dev)
        hidden, _ = self.model.backbone(
            next_tokens[:, None, :], positions, st.key_valid, st.cache, slot,
            write_gate=adv, read_extent=ext, adapters=self._row_adapters())
        st.hidden_last = torch.where(adv[:, None, None], hidden,
                                     st.hidden_last)
        # the ring clock stays pre-wrapped
        st.gstep = (st.gstep + 1) % self.max_steps
        st.step_r = st.step_r + adv
        st.last_pos = st.last_pos + adv
        st.needs = needs
        st.unfinished = unfinished & st.active

    def run(self, steps: int = 25) -> int:
        """Advance every live row by up to ``steps`` decode steps; stops
        early when no row is live. The loop test is the step's one host
        sync. Returns the pool steps run."""
        st, t = self.state, 0
        while t < steps and bool((st.active & st.unfinished).any()):
            self._step()
            t += 1
        return t

    def poll(self) -> List[tuple]:
        """[(slot, steps), ...] for completed requests: ONE readback for
        the flags and the step counters together."""
        st = self.state
        arr = torch.stack([(st.active & ~st.unfinished).to(torch.int64),
                           st.step_r]).cpu().numpy()
        return [(j, int(arr[1, j])) for j in range(self.slots) if arr[0, j]]

    def finished(self) -> List[int]:
        """Slot ids holding a completed request (ready to collect)."""
        return [j for j, _ in self.poll()]

    def progress(self) -> List[tuple]:
        """[(slot, steps, finished), ...] for every ACTIVE row, still ONE
        readback a segment: ``poll`` for callers (streaming serving) that
        also follow the live rows' step counts."""
        st = self.state
        arr = torch.stack([st.active.to(torch.int64),
                           (st.active & ~st.unfinished).to(torch.int64),
                           st.step_r]).cpu().numpy()
        return [(j, int(arr[2, j]), bool(arr[1, j]))
                for j in range(self.slots) if arr[0, j]]

    def peek_tokens(self, slots: List[int], steps: List[int],
                    frm: int = 0) -> np.ndarray:
        """Several LIVE rows' token prefixes in ONE readback: (len(slots),
        base + max(steps) - frm, C). Leaves the slots live; a row's written
        prefix never changes, so this is safe for streaming. ``frm``: the
        row the caller already mirrors on the host, so a streaming consumer
        reads each row once."""
        upto = self.base + max(steps)
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        return self.state.tokens[idx, frm:upto].cpu().numpy()

    def collect_async(self, j: int, steps: Optional[int] = None):
        """Free slot j at once; return (steps, device tokens).

        The row's token slice is CLONED on the card's stream before any
        later splice can reuse the slot (the splice writes the pool in
        place, so a view would be overwritten); read it back whenever the
        output is consumed. The serving loop keeps one blocking readback a
        segment (``poll``)."""
        if self._slot_free[j]:
            raise ValueError(f"slot {j} is free")
        st = self.state
        if steps is None:
            steps = int(st.step_r[j])
        tokens_dev = st.tokens[j, :self.base + steps].clone()
        st.active[j] = False
        st.unfinished[j] = False
        self._slot_free[j] = True
        return steps, tokens_dev

    def collect(self, j: int, steps: Optional[int] = None) -> GenerateResult:
        """Read slot j's output and free the slot (blocking)."""
        steps, tokens_dev = self.collect_async(j, steps)
        return GenerateResult(tokens=tokens_dev.cpu().numpy()[None],
                              steps=steps, base=self.base)

    def release(self, j: int) -> None:
        """Free slot j WITHOUT reading its output (error-path cleanup).

        The host's slot bookkeeping is restored even if the device state is
        unusable, so a serving loop can always reclaim its pool after an
        exception."""
        self._slot_free[j] = True
        try:
            self.state.active[j] = False
            self.state.unfinished[j] = False
        except Exception:                       # noqa: BLE001 — device dead
            logger.exception("release(%d): device state update failed", j)

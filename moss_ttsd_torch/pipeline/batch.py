"""End-to-end batch synthesis, PyTorch port of
``moss_ttsd_tpu/pipeline/batch.py``.

JSONL items -> normalized text + prompt audio (mono 16 kHz) -> one batched
``XYTokenizer.encode`` of the prompt voices -> prompt assembly -> delay
shift -> left-pad -> ``GenerationEngine.generate`` -> un-shift ->
``XYTokenizer.decode`` -> per-item audio.

When the step budget spans more than one 30 s codec window,
``process_batch`` overlaps decode and vocode (``overlap_vocode``): the
engine runs in segments that end where a codec window completes, and each
completed window is vocoded while the LM decodes the next segment; the
audio is byte-identical to the serial generate-then-vocode branch.
``stream_item`` streams one item as PCM chunks through ``StreamVocoder``.
Phase times go to ``PhaseTimings`` and to the process-wide ``metrics``
registry (``utils/profiling.py``), which the server exports.

On a ("data", "model") mesh (``parallel/mesh.py``) every rank runs the
same ``process_batch`` in lockstep (the inference CLI under
``torch.distributed.run``): the batch is padded with repeats of its last
row to a multiple of the data axis, the engine shards it, and the codec
runs on rank 0 only (the prompt voices encoded there and broadcast, the
audio vocoded and returned there; the other ranks return None for every
item), as the JAX package's codec is not meshed either. A server's lead
rank instead mirrors its engine calls to follower ranks
(``parallel/mirror.py``) and runs the pipeline alone.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import traceback
from collections import OrderedDict
from typing import ClassVar, List, Optional

import numpy as np

from ..core.config import LMConfig, SamplingConfig
from ..core.device import DeviceLike, resolve_device
from ..decode.engine import GenerationEngine
from ..models.codec.model import (XYTokenizer, chunk_stride_codes,
                                  quarter_window_buckets)
from ..utils.profiling import metrics
from . import prompt as pp
from .jsonl import load_audio_data, process_jsonl_item
from .text import normalize_text, rewrite_speaker_tags

SYSTEM_PROMPT = ("You are a speech synthesizer that generates natural, "
                 "realistic, and human-like conversational audio from dialogue "
                 "text.")


def load_tokenizer(model_path: str):
    """The checkpoint's text tokenizer (MOSS-TTSD's Qwen BPE), read from
    ``model_path`` by transformers' ``AutoTokenizer`` from local files only.
    Every entry point that loads a checkpoint gets its tokenizer here."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "loading a checkpoint's tokenizer needs the 'transformers' "
            "package, which is not installed") from e
    return AutoTokenizer.from_pretrained(model_path, local_files_only=True)


@dataclasses.dataclass
class PhaseTimings:
    """Per-phase wall times (host clock; the device phases end in a
    readback, so each includes its device work)."""

    tokenize_s: float = 0.0
    prefill_decode_s: float = 0.0
    vocode_s: float = 0.0
    generated_steps: int = 0
    # the server's batch worker and its stream thread update one pipeline's
    # timings at the same time
    _lock: ClassVar[threading.Lock] = threading.Lock()

    def add(self, phase: str, value) -> None:
        """Accumulate ``value`` into ``phase`` under the lock."""
        with self._lock:
            setattr(self, phase, getattr(self, phase) + value)

    def as_dict(self):
        return dataclasses.asdict(self)


class StreamVocoder:
    """Sliding-window incremental vocoder for ONE growing token stream.

    Turns an unshifted speech-id stream whose prefix only grows into PCM
    chunks: each ``feed`` vocodes at most one codec window of new frames
    with ``context_frames`` of left context (so a chunk boundary sees real
    receptive field), emits only the new samples, and reads each chunk back
    one feed later, so the copy overlaps the caller's next decode segment;
    the first chunk is read at once (time to first audio). PCM is quantized to int16 on the device (half the readback
    bytes). A partial window runs through the smallest quarter-window
    bucket that holds it."""

    def __init__(self, spt: XYTokenizer, context_frames: int = 25,
                 timings=None):
        if not 0 <= context_frames < spt.chunk_codes:
            # a context as wide as the codec window never lets the sliding
            # window (context + new frames) advance, and finish() would
            # loop forever; effective_context() clamps against the stride
            raise ValueError(
                f"context_frames={context_frames} must be in [0, "
                f"{spt.chunk_codes}) (the codec window in codes)")
        self.spt = spt
        self.context = context_frames
        self.timings = timings
        self.up = spt.cfg.decoder_upsample_rate      # samples per frame
        self.K = spt.cfg.quantizer.codebook_size
        self.buckets = quarter_window_buckets(spt.chunk_codes)
        self.emitted = 0
        self._pending = None

    @staticmethod
    def effective_context(spt: XYTokenizer, overlap_s: int, feed_steps: int,
                          context_frames: int = 25) -> int:
        """Clamp the left context so one feed's sliding window (context +
        new frames) fits a single codec chunk call."""
        return min(context_frames,
                   max(0, chunk_stride_codes(spt, overlap_s) - feed_steps))

    @property
    def sample_rate(self) -> int:
        return self.spt.output_sample_rate

    def _dispatch(self, speech_ids: np.ndarray, start: int, end_c: int):
        spt = self.spt
        codes = np.clip(speech_ids[0, start:end_c].T.astype(np.int64),
                        0, self.K - 1)
        n = codes.shape[-1]
        L = next(b for b in self.buckets if b >= n)
        buf = np.zeros((spt.nq, 1, L), np.int64)
        buf[:, 0, :n] = codes
        out = spt._detokenize(buf, np.array([n]), pcm16=True)
        return out, self.emitted - start, n

    def _read(self, p) -> np.ndarray:
        out, skip_frames, n = p
        t0 = time.perf_counter()
        wav = out["wav"].cpu().numpy()[0].astype(np.float32) / 32768.0
        dt = time.perf_counter() - t0
        if self.timings is not None:
            self.timings.add("vocode_s", dt)
        metrics.add("vocode_s", dt)
        return wav[skip_frames * self.up:n * self.up]

    def feed(self, speech_ids: np.ndarray, end: int) -> List[np.ndarray]:
        """speech_ids (1, T, nq) unshifted, ``end`` = frames valid so far.
        Returns 0-2 ready PCM chunks (float32 in [-1, 1])."""
        out: List[np.ndarray] = []
        new_p, end_c = None, 0
        if end > self.emitted:
            start = max(0, self.emitted - self.context)
            # one dispatch covers at most one codec window (the largest
            # bucket); frames past the cap drain in later feeds / finish
            end_c = min(end, start + self.spt.chunk_codes)
            new_p = self._dispatch(speech_ids, start, end_c)
        if self._pending is not None:
            new = self._read(self._pending)
            self._pending = None
            if new.size:
                out.append(new)
        if new_p is not None:
            if self.emitted == 0:
                new = self._read(new_p)
                if new.size:
                    out.append(new)
            else:
                self._pending = new_p
            self.emitted = end_c
        return out

    def finish(self, speech_ids: Optional[np.ndarray],
               end: int) -> List[np.ndarray]:
        """Drain: vocode the frames the per-feed window cap deferred, then
        read the last pending chunk."""
        out: List[np.ndarray] = []
        while speech_ids is not None and end > self.emitted:
            start = max(0, self.emitted - self.context)
            end_c = min(end, start + self.spt.chunk_codes)
            new_p = self._dispatch(speech_ids, start, end_c)
            if self._pending is not None:
                new = self._read(self._pending)
                if new.size:
                    out.append(new)
            self._pending = new_p
            self.emitted = end_c
        if self._pending is not None:
            new = self._read(self._pending)
            self._pending = None
            if new.size:
                out.append(new)
        return out


class TTSPipeline:
    """Bundles tokenizer + LM engine + codec (reference load_model)."""

    def __init__(self, tokenizer, lm_cfg: LMConfig, lm_params,
                 spt: XYTokenizer, sampling: Optional[SamplingConfig] = None,
                 bucket: int = 128, quant: Optional[str] = None,
                 vocode_rows_per_call: Optional[int] = 4,
                 restricted_text_head: Optional[bool] = None,
                 restricted_audit_every: Optional[int] = None,
                 encode_cache_size: int = 16,
                 overlap_vocode: bool = True,
                 device: DeviceLike = "cuda", mesh=None):
        """``quant="int8"`` serves w8a16 weights; ``restricted_text_head``
        and ``restricted_audit_every`` set the decode policies of the same
        names (``GenerationEngine``). ``self.lm_cfg`` is the engine's config,
        with these overrides applied. ``encode_cache_size`` LRU-caches the
        codec encodings of single prompt voices by wav content (a fixed
        voice is encoded once, not on every request); 0 disables it.
        ``overlap_vocode`` vocodes each completed 30 s codec window while
        the LM keeps decoding (outputs longer than one window only).
        ``mesh``: tensor- and data-parallel serving (``parallel/mesh.py``;
        every rank of the mesh runs ``process_batch`` in lockstep)."""
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.engine = GenerationEngine(
            lm_cfg, lm_params, sampling, bucket=bucket, device=self.device,
            quant=quant, restricted_text_head=restricted_text_head,
            restricted_audit_every=restricted_audit_every, mesh=mesh)
        self.mesh = mesh
        # lockstep: every mesh rank runs process_batch (a server's lead
        # rank clears it: its followers replay engine calls instead)
        self.lockstep = mesh is not None
        self.lm_cfg = self.engine.cfg
        self.spt = spt
        self.vocode_rows_per_call = vocode_rows_per_call
        self.overlap_vocode = overlap_vocode
        # codec window overlap (reference default 10 s on 30 s windows)
        self.vocode_overlap_s = min(10, max(0, spt.chunk_seconds - 1))
        self.timings = PhaseTimings()
        self.encode_cache_size = encode_cache_size
        self._encode_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._encode_cache_lock = threading.Lock()

    @classmethod
    def load(cls, model_path: str, spt_config_path: str, spt_ckpt_path: str,
             sampling: Optional[SamplingConfig] = None, mesh=None,
             quant: Optional[str] = None,
             codec_dtype: Optional[str] = "bfloat16",
             restricted_text_head: Optional[bool] = None,
             attn_impl: Optional[str] = None,
             restricted_audit_every: Optional[int] = None,
             device: DeviceLike = "cuda") -> "TTSPipeline":
        """Load from an HF-format LM directory (``config.json``, the
        weights, ``generation_config.json`` when present, the tokenizer)
        and the codec's yaml + checkpoint (the reference's load_model).

        The LM's weights are read tensor by tensor, cast once to its
        compute dtype and moved to ``device`` as they are read.
        ``codec_dtype="bfloat16"`` (the default, the serving configuration)
        runs the codec in bf16 with its fp32 islands; None runs it in fp32
        as the reference does. ``mesh``: every rank loads the full weights
        and keeps its shard (``GenerationEngine``)."""
        import os
        from ..core.device import torch_dtype
        from ..utils.convert_lm import load_asteroid_checkpoint
        dev = resolve_device(device)
        cfg_path = os.path.join(model_path, "config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(
                f"no config.json in {model_path!r}: expected an HF-format "
                f"checkpoint directory")
        lm_cfg = LMConfig.from_hf_config_json(cfg_path)
        if attn_impl is not None:
            lm_cfg = dataclasses.replace(lm_cfg, attn_impl=attn_impl)
        tokenizer = load_tokenizer(model_path)
        lm_params = load_asteroid_checkpoint(
            model_path, lm_cfg, dtype=torch_dtype(lm_cfg.dtype), device=dev)
        spt = XYTokenizer.load_from_checkpoint(spt_config_path, spt_ckpt_path,
                                               dtype=codec_dtype, device=dev)
        if sampling is None:
            gen_cfg = os.path.join(model_path, "generation_config.json")
            if os.path.exists(gen_cfg):
                sampling = SamplingConfig.from_generation_config_json(
                    gen_cfg, lm_cfg.channels)
        return cls(tokenizer, lm_cfg, lm_params, spt, sampling, quant=quant,
                   restricted_text_head=restricted_text_head,
                   restricted_audit_every=restricted_audit_every,
                   device=dev, mesh=mesh)

    def _prepare_text(self, item: dict, use_normalize: bool):
        """Text half of item preparation -> (final_text, meta, wav-or-None)."""
        processed = process_jsonl_item(item)
        text = processed["text"]
        prompt_text = processed["prompt_text"]
        full_text = prompt_text + text if prompt_text else text
        original = full_text
        if use_normalize:
            full_text = normalize_text(full_text)
        final_text = rewrite_speaker_tags(full_text)
        wav = None
        if processed["prompt_audio"] is not None:
            wav = load_audio_data(processed["prompt_audio"])
        meta = {"original_text": original,
                "normalized_text": full_text if use_normalize else None,
                "final_text": final_text, "use_normalize": use_normalize}
        return final_text, meta, wav

    def _assemble(self, final_text: str, audio_codes, system_prompt: str):
        """Prompt ids + delay shift for one item."""
        ids = pp.build_prompt_ids(self.tokenizer, system_prompt, final_text,
                                  audio_codes, channels=self.lm_cfg.channels,
                                  pad_token=self.lm_cfg.speech_pad_token,
                                  speech_offset=self.lm_cfg.speech_token_range[0])
        return pp.shift_delay_pattern(ids, self.tokenizer.pad_token_id,
                                      self.lm_cfg.speech_pad_token)

    def prepare_item(self, item: dict, system_prompt: str = SYSTEM_PROMPT,
                     use_normalize: bool = False):
        """One JSONL item -> (shifted prompt ids, text metadata); its prompt
        voice goes through the encode LRU."""
        final_text, meta, wav = self._prepare_text(item, use_normalize)
        audio_codes = self._encode_prompt_cached(wav) if wav is not None \
            else None
        return self._assemble(final_text, audio_codes, system_prompt), meta

    def _encode_prompt_cached(self, wav: np.ndarray) -> np.ndarray:
        """Codec-encode ONE prompt wav -> (T, nq) codes, LRU-cached by the
        sha1 of its float32 bytes. A hit returns what the batch-1 call of
        the miss returned (encode is deterministic in the wav). Those codes
        equal the voice's row of a batched encode in fp32; in bf16 on the
        card the GEMM shapes change with the batch, and a code can flip on
        a near tie of the codebook distances (``chip_smoke.py``'s clone
        phase reports the agreement)."""
        key = None
        if self.encode_cache_size > 0:
            key = hashlib.sha1(
                np.ascontiguousarray(wav, np.float32).tobytes()).hexdigest()
            with self._encode_cache_lock:
                cached = self._encode_cache.get(key)
                if cached is not None:
                    self._encode_cache.move_to_end(key)
                    metrics.add("tokenize_cache_hits", 1)
                    return cached
        t0 = time.perf_counter()
        codes = self.spt.encode([wav])["codes_list"][0]     # (nq, T)
        self._add_time("tokenize_s", time.perf_counter() - t0)
        audio_codes = np.asarray(codes).T                   # (T, nq)
        if key is not None:
            with self._encode_cache_lock:
                self._encode_cache[key] = audio_codes
                while len(self._encode_cache) > self.encode_cache_size:
                    self._encode_cache.popitem(last=False)
        return audio_codes

    def _encode_prompts(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """The prompt voices of a batch -> (nq, T) codes each: one batched
        encode (variable lengths are masked inside the codec); a single
        voice goes through the LRU, as a per-request call would."""
        if len(wavs) == 1:
            return [self._encode_prompt_cached(wavs[0]).T]
        if not wavs:
            return []
        t0 = time.perf_counter()
        codes_list = self.spt.encode(wavs)["codes_list"]
        self._add_time("tokenize_s", time.perf_counter() - t0)
        return codes_list

    @property
    def is_lead(self) -> bool:
        """Whether this process runs the codec: always without a lockstep
        mesh, rank 0 with one."""
        import torch.distributed as dist
        return not self.lockstep or dist.get_rank() == 0

    def _encode_shared(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """``_encode_prompts`` on the lead rank, its codes broadcast to the
        other lockstep ranks."""
        if not self.lockstep:
            return self._encode_prompts(wavs)
        import torch.distributed as dist
        box = [self._encode_prompts(wavs) if self.is_lead else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _add_time(self, phase: str, seconds: float) -> None:
        """One phase's wall time into ``timings`` and ``metrics``."""
        self.timings.add(phase, seconds)
        metrics.add(phase, seconds)

    def process_batch(self, batch_items: List[dict],
                      system_prompt: str = SYSTEM_PROMPT,
                      start_idx: int = 0, use_normalize: bool = False,
                      max_new_tokens: Optional[int] = None, seed: int = 0,
                      adapter=None):
        """Returns (texts_data, audio_results); audio_results entries are
        {audio_data (1, T) float32, sample_rate, index} or None.

        Per-item isolation: an item that fails preparation (a malformed
        record, a prompt wav that cannot be read) becomes None plus an
        "error" entry in its text metadata; the rest of the batch still
        generates. ``adapter``: a registered LoRA voice for the whole batch,
        or a per-item list of names (None = the base model); an unknown
        name raises ValueError in the engine. Under a lockstep mesh only
        rank 0 returns audio (the others None for every item)."""
        staged, texts_data = [], []   # (i, meta slot, final_text, wav)
        for i, item in enumerate(batch_items):
            try:
                final_text, meta, wav = self._prepare_text(item, use_normalize)
            except Exception as e:            # noqa: BLE001 — isolate items
                traceback.print_exc()
                texts_data.append({"index": start_idx + i, "error": str(e)})
                continue
            meta["index"] = start_idx + i
            staged.append((i, len(texts_data), final_text, wav))
            texts_data.append(meta)

        codes_iter = iter(self._encode_shared(
            [wav for *_, wav in staged if wav is not None]))
        shifted_list, ok_idx = [], []
        for i, slot, final_text, wav in staged:
            audio_codes = None if wav is None else np.asarray(
                next(codes_iter)).T                          # (T, nq)
            try:
                shifted = self._assemble(final_text, audio_codes,
                                         system_prompt)
            except Exception as e:            # noqa: BLE001 — isolate items
                traceback.print_exc()
                texts_data[slot] = {"index": start_idx + i, "error": str(e)}
                continue
            shifted_list.append(shifted)
            ok_idx.append(i)

        if not shifted_list:
            return texts_data, [None] * len(batch_items)
        if isinstance(adapter, (list, tuple)):
            # per-item voices follow the surviving rows (failed items were
            # isolated above): the engine's adapter list is row-aligned
            if len(adapter) != len(batch_items):
                raise ValueError(f"{len(adapter)} adapter names for "
                                 f"{len(batch_items)} items")
            adapter = [adapter[i] for i in ok_idx]
        batch, mask = pp.left_pad_batch(shifted_list,
                                        self.tokenizer.pad_token_id,
                                        self.lm_cfg.speech_pad_token)
        # a data axis splits the rows: pad with repeats of the last row to
        # a multiple of it (the extra rows are dropped below)
        n_real = batch.shape[0]
        if self.mesh is not None:
            pad_rows = -n_real % self.mesh.data
            if pad_rows:
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], pad_rows, axis=0)])
                mask = np.concatenate(
                    [mask, np.repeat(mask[-1:], pad_rows, axis=0)])
                if isinstance(adapter, (list, tuple)):
                    adapter = list(adapter) + [adapter[-1]] * pad_rows
        lead = self.is_lead

        def trim(res):
            if res.tokens.shape[0] == n_real:
                return res
            return res._replace(tokens=res.tokens[:n_real], unfinished=(
                None if res.unfinished is None else res.unfinished[:n_real]))

        t0 = time.perf_counter()
        C, nq = self.lm_cfg.channels, self.spt.nq
        max_steps, _ = self.engine._step_budget(max_new_tokens,
                                                batch.shape[1])
        # decode <-> vocode overlap when the budget spans more than one
        # codec window: segments end where a window completes for every
        # row, and each completed window's vocode is queued on the card
        # while the LM decodes the next segment (the same device calls as
        # the serial branch, so the audio is byte-identical)
        inc = None
        if self.overlap_vocode and max_steps - (C - 1) > self.spt.chunk_codes:
            inc = self.spt.incremental_decoder(
                overlap_seconds=self.vocode_overlap_s, pcm16=True,
                rows_per_call=self.vocode_rows_per_call)
            first_ready = self.spt.chunk_codes + C - 1
            n_chunks = -(-(max_steps - (C - 1)) // inc.duration_codes)
            bounds = [first_ready + ci * inc.duration_codes
                      for ci in range(n_chunks)]
            result = None
            for result in self.engine.generate_stream(
                    batch, mask, max_new_tokens, seed=seed,
                    boundaries=bounds, adapter=adapter):
                result = trim(result)
                if not lead:        # the codec runs on the lead rank only
                    continue
                inc.feed([c if c is not None else np.zeros((nq, 0), np.int64)
                          for c in self.extract_codes(result)],
                         [not bool(u) for u in result.unfinished])
        else:
            result = trim(self.engine.generate(batch, mask, max_new_tokens,
                                               seed=seed, adapter=adapter))
        self._add_time("prefill_decode_s", time.perf_counter() - t0)
        self.timings.add("generated_steps", result.steps)
        metrics.add("generated_steps", result.steps)
        if result.audit is not None:
            metrics.add("restricted_audit_rows", result.audit[0])
            metrics.add("restricted_audit_flagged", result.audit[1])

        final_codes = self.extract_codes(result)
        valid_idx, valid_codes = [], []
        for row, codes in enumerate(final_codes):
            if codes is not None:
                valid_idx.append(ok_idx[row])
                valid_codes.append(codes)

        wavs = []
        if valid_codes and lead:
            t0 = time.perf_counter()
            if inc is not None and len(valid_codes) == len(final_codes):
                wavs = inc.finish(final_codes)["syn_wav_list"]
            else:
                # the serial branch, also when the overlap ran but some rows
                # made no speech: the serial contract vocodes only the valid
                # rows, and another vocode batch changes the GEMM shapes
                wavs = self.spt.decode(
                    valid_codes, overlap_seconds=self.vocode_overlap_s,
                    pcm16=True,
                    rows_per_call=self.vocode_rows_per_call)["syn_wav_list"]
            self._add_time("vocode_s", time.perf_counter() - t0)

        audio_results = [None] * len(batch_items)
        for i, wav in zip(valid_idx, wavs):
            audio_results[i] = {
                "audio_data": np.asarray(wav, np.float32)[None, :],
                "sample_rate": self.spt.output_sample_rate,
                "index": start_idx + i,
            }
        return texts_data, audio_results

    def extract_codes(self, result) -> List[Optional[np.ndarray]]:
        """GenerateResult -> per-row codec codes (nq, T) int32 or None:
        unshift -> last-valid-row scan -> codebook clip."""
        speech_ids, ends = self.unshift_end(result.tokens, result.base)
        out: List[Optional[np.ndarray]] = []
        for row in range(speech_ids.shape[0]):
            end = int(ends[row])
            if end <= 0:
                out.append(None)
                continue
            codes = speech_ids[row, :end].T.astype(np.int32)    # (nq, T)
            out.append(np.clip(codes, 0,
                               self.spt.cfg.quantizer.codebook_size - 1))
        return out

    def unshift_end(self, tokens: np.ndarray, base: int):
        """(B, T, C) tokens -> (unshifted speech_ids (B, T', C), per-row
        valid-frame counts (B,))."""
        speech_ids = pp.unshift_outputs(tokens, base, self.lm_cfg.channels,
                                        self.lm_cfg.speech_token_range[0])
        li = pp.find_max_valid_positions(speech_ids,
                                         self.lm_cfg.speech_pad_token)
        return speech_ids, li + 1

    def stream_item(self, item: dict, system_prompt: str = SYSTEM_PROMPT,
                    use_normalize: bool = False,
                    max_new_tokens: Optional[int] = None, seed: int = 0,
                    chunk_steps: int = 25, context_frames: int = 25,
                    first_chunk_steps: int = 12, adapter=None):
        """Streaming synthesis of ONE item: yields (audio chunk (T,)
        float32, sample_rate) as generation progresses (~``chunk_steps`` /
        12.5 s of new audio a yield).

        The first segment is only ``first_chunk_steps`` decode steps and
        its vocode is read back at once, so the first audio comes after the
        prefill, those steps and one small vocode. Every later segment's
        vocode runs one segment behind the decode: it is queued on the
        card, and read back while the next segment decodes. The vocoder
        re-runs a sliding window with ``context_frames`` of left context
        (``StreamVocoder``) and emits only the new samples. ``adapter``
        names a registered LoRA voice (None = the base model)."""
        shifted, _ = self.prepare_item(item, system_prompt, use_normalize)
        batch, mask = pp.left_pad_batch([shifted], self.tokenizer.pad_token_id,
                                        self.lm_cfg.speech_pad_token)
        sv = StreamVocoder(
            self.spt, StreamVocoder.effective_context(
                self.spt, self.vocode_overlap_s, chunk_steps, context_frames),
            timings=self.timings)
        max_steps, _ = self.engine._step_budget(max_new_tokens, batch.shape[1])
        bounds = [min(first_chunk_steps, chunk_steps, max_steps)]
        while bounds[-1] < max_steps:
            bounds.append(min(bounds[-1] + chunk_steps, max_steps))

        last_ids, last_end = None, 0
        for result in self.engine.generate_stream(batch, mask, max_new_tokens,
                                                  seed=seed, boundaries=bounds,
                                                  adapter=adapter):
            speech_ids, ends = self.unshift_end(result.tokens, result.base)
            last_ids, last_end = speech_ids, int(ends[0])
            for chunk in sv.feed(speech_ids, last_end):
                yield chunk, sv.sample_rate
        for chunk in sv.finish(last_ids, last_end):
            yield chunk, sv.sample_rate

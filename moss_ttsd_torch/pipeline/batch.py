"""End-to-end batch synthesis, PyTorch port of
``moss_ttsd_tpu/pipeline/batch.py``.

JSONL items -> normalized text + prompt audio (mono 16 kHz) -> one batched
``XYTokenizer.encode`` of the prompt voices -> prompt assembly -> delay
shift -> left-pad -> ``GenerationEngine.generate`` -> un-shift ->
``XYTokenizer.decode`` -> per-item audio. This port always takes the serial
generate-then-vocode branch; the JAX package's decode/vocode overlap branch
(byte-identical to the serial one) and streaming wait for the streaming
slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import traceback
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from ..core.config import LMConfig, SamplingConfig
from ..core.device import DeviceLike, resolve_device
from ..decode.engine import GenerationEngine
from ..models.codec.model import XYTokenizer
from . import prompt as pp
from .jsonl import load_audio_data, process_jsonl_item
from .text import normalize_text, rewrite_speaker_tags

SYSTEM_PROMPT = ("You are a speech synthesizer that generates natural, "
                 "realistic, and human-like conversational audio from dialogue "
                 "text.")


@dataclasses.dataclass
class PhaseTimings:
    """Per-phase wall times (host clock; the device phases end in a
    readback, so each includes its device work)."""

    tokenize_s: float = 0.0
    prefill_decode_s: float = 0.0
    vocode_s: float = 0.0
    generated_steps: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


class TTSPipeline:
    """Bundles tokenizer + LM engine + codec (reference load_model)."""

    def __init__(self, tokenizer, lm_cfg: LMConfig, lm_params,
                 spt: XYTokenizer, sampling: Optional[SamplingConfig] = None,
                 bucket: int = 128, quant: Optional[str] = None,
                 vocode_rows_per_call: Optional[int] = 4,
                 restricted_text_head: Optional[bool] = None,
                 restricted_audit_every: Optional[int] = None,
                 encode_cache_size: int = 16,
                 device: DeviceLike = "cuda"):
        """``quant="int8"`` serves w8a16 weights; ``restricted_text_head``
        and ``restricted_audit_every`` set the decode policies of the same
        names (``GenerationEngine``). ``self.lm_cfg`` is the engine's config,
        with these overrides applied. ``encode_cache_size`` LRU-caches the
        codec encodings of single prompt voices by wav content (a fixed
        voice is encoded once, not on every request); 0 disables it."""
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.engine = GenerationEngine(
            lm_cfg, lm_params, sampling, bucket=bucket, device=self.device,
            quant=quant, restricted_text_head=restricted_text_head,
            restricted_audit_every=restricted_audit_every)
        self.lm_cfg = self.engine.cfg
        self.spt = spt
        self.vocode_rows_per_call = vocode_rows_per_call
        # codec window overlap (reference default 10 s on 30 s windows)
        self.vocode_overlap_s = min(10, max(0, spt.chunk_seconds - 1))
        self.timings = PhaseTimings()
        self.encode_cache_size = encode_cache_size
        self._encode_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._encode_cache_lock = threading.Lock()

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
                    return cached
        t0 = time.perf_counter()
        codes = self.spt.encode([wav])["codes_list"][0]     # (nq, T)
        self.timings.tokenize_s += time.perf_counter() - t0
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
        self.timings.tokenize_s += time.perf_counter() - t0
        return codes_list

    def process_batch(self, batch_items: List[dict],
                      system_prompt: str = SYSTEM_PROMPT,
                      start_idx: int = 0, use_normalize: bool = False,
                      max_new_tokens: Optional[int] = None, seed: int = 0):
        """Returns (texts_data, audio_results); audio_results entries are
        {audio_data (1, T) float32, sample_rate, index} or None.

        Per-item isolation: an item that fails preparation (a malformed
        record, a prompt wav that cannot be read) becomes None plus an
        "error" entry in its text metadata; the rest of the batch still
        generates."""
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

        codes_iter = iter(self._encode_prompts(
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
        batch, mask = pp.left_pad_batch(shifted_list,
                                        self.tokenizer.pad_token_id,
                                        self.lm_cfg.speech_pad_token)

        t0 = time.perf_counter()
        result = self.engine.generate(batch, mask, max_new_tokens, seed=seed)
        self.timings.prefill_decode_s += time.perf_counter() - t0
        self.timings.generated_steps += result.steps

        final_codes = self.extract_codes(result)
        valid_idx, valid_codes = [], []
        for row, codes in enumerate(final_codes):
            if codes is not None:
                valid_idx.append(ok_idx[row])
                valid_codes.append(codes)

        wavs = []
        if valid_codes:
            t0 = time.perf_counter()
            wavs = self.spt.decode(
                valid_codes, overlap_seconds=self.vocode_overlap_s,
                pcm16=True,
                rows_per_call=self.vocode_rows_per_call)["syn_wav_list"]
            self.timings.vocode_s += time.perf_counter() - t0

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

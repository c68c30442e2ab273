"""End-to-end batch synthesis, PyTorch port of
``moss_ttsd_tpu/pipeline/batch.py`` (text-only items).

JSONL items -> normalized text -> prompt assembly -> delay shift -> left-pad
-> ``GenerationEngine.generate`` -> un-shift -> ``XYTokenizer.decode`` ->
per-item audio. This slice always takes the serial generate-then-vocode
branch; the JAX package's decode/vocode overlap branch (byte-identical to
the serial one) and streaming wait for the streaming slice.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
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
                 device: DeviceLike = "cuda"):
        """``quant="int8"`` serves w8a16 weights; ``restricted_text_head``
        and ``restricted_audit_every`` set the decode policies of the same
        names (``GenerationEngine``). ``self.lm_cfg`` is the engine's config,
        with these overrides applied."""
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

    def process_batch(self, batch_items: List[dict],
                      system_prompt: str = SYSTEM_PROMPT,
                      start_idx: int = 0, use_normalize: bool = False,
                      max_new_tokens: Optional[int] = None, seed: int = 0):
        """Returns (texts_data, audio_results); audio_results entries are
        {audio_data (1, T) float32, sample_rate, index} or None.

        Per-item isolation: an item that fails preparation (malformed
        record, prompt audio — not yet ported) becomes None plus an "error"
        entry in its text metadata; the rest of the batch still generates."""
        staged, texts_data = [], []
        for i, item in enumerate(batch_items):
            try:
                final_text, meta, _ = self._prepare_text(item, use_normalize)
                shifted = self._assemble(final_text, None, system_prompt)
            except Exception as e:            # noqa: BLE001 — isolate items
                traceback.print_exc()
                texts_data.append({"index": start_idx + i, "error": str(e)})
                continue
            meta["index"] = start_idx + i
            staged.append((i, shifted))
            texts_data.append(meta)

        if not staged:
            return texts_data, [None] * len(batch_items)
        ok_idx = [i for i, _ in staged]
        batch, mask = pp.left_pad_batch([s for _, s in staged],
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

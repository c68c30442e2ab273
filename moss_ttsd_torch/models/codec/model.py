"""XYTokenizer, the dual-channel neural audio codec: PyTorch port of
``moss_ttsd_tpu/models/codec/model.py``.

Encode: 16 kHz wav -> log-mel (100 Hz, fp32) -> [semantic encoder +
adapter | acoustic encoder] -> concat -> pre-RVQ adapter (50 Hz) -> x4
gated downsample (12.5 Hz) -> ResidualVQ (fp32) -> codes. Decode: codes ->
ResidualVQ.decode (fp32) -> post-RVQ adapter -> x4 upsample -> acoustic
decoder (100 Hz) -> Vocos -> 24 kHz wav. Both run in 30 s windows with an
overlap (the reference's chunking contract), each window one batched call
on static shapes; a partial final decode window runs through the smallest
quarter-window bucket that holds it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ...core.config import CodecConfig
from ...core.device import DeviceLike, resolve_device, torch_dtype
from ...ops.dsp import log_mel_spectrogram
from .rvq import ResidualVQ
from .transformer import (AdapterTransformer, AudioDecoder, AudioEncoder,
                          GatedDownsample, Upsample)
from .vocos import Vocos, mel_scale


class XYTokenizerModule(nn.Module):
    """The codec network: ``tokenize`` (wav -> codes) and ``detokenize``
    (codes -> wav), each on one window's static shapes."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.semantic_encoder = AudioEncoder(c.semantic_encoder)
        self.semantic_encoder_adapter = AdapterTransformer(
            c.semantic_encoder_adapter)
        self.acoustic_encoder = AudioEncoder(c.acoustic_encoder)
        self.pre_rvq_adapter = AdapterTransformer(c.pre_rvq_adapter)
        self.downsample = GatedDownsample(c.downsample_d_model,
                                          c.downsample_factor)
        self.quantizer = ResidualVQ(c.quantizer)
        self.post_rvq_adapter = AdapterTransformer(c.post_rvq_adapter)
        self.upsample = Upsample(c.upsample_d_model, c.upsample_stride)
        self.acoustic_decoder = AudioDecoder(c.acoustic_decoder)
        self.vocos = Vocos(c.vocos)

    def _encode_latents(self, wav: torch.Tensor, lengths: torch.Tensor,
                        cast_compute_dtype: bool = True):
        """wav (B, samples) 16 kHz + valid lengths -> (down (B, T', D * r),
        down_len): the fp32 log-mel through both encoders, the adapters and
        the downsample. Inference casts the mel to the compute dtype at the
        stack boundary; training runs fp32 weights and skips the cast."""
        fe = self.cfg.feature_extractor
        mel = log_mel_spectrogram(wav, n_fft=fe.n_fft, hop=fe.hop_length,
                                  num_mels=fe.feature_size,
                                  sampling_rate=fe.sampling_rate)
        mel = mel.transpose(1, 2)                                  # (B, T, M)
        if cast_compute_dtype:
            mel = mel.to(torch_dtype(self.cfg.dtype))
        mel_lengths = -(-lengths // fe.hop_length)
        sem, sem_len = self.semantic_encoder(mel, mel_lengths)     # 100 -> 50 Hz
        sem, sem_len = self.semantic_encoder_adapter(sem, sem_len)
        aco, aco_len = self.acoustic_encoder(mel, mel_lengths)
        mixed = torch.cat([sem, aco], dim=-1)                      # (B, T, 2D)
        mixed, mix_len = self.pre_rvq_adapter(mixed, aco_len)
        return self.downsample(mixed, mix_len)                     # 50 -> 12.5 Hz

    def tokenize(self, wav: torch.Tensor, lengths: torch.Tensor):
        """wav (B, samples) + lengths -> dict(zq (B, T', D), codes (nq, B,
        T'), codes_lengths (B,)); the quantizer runs in fp32."""
        down, down_len = self._encode_latents(wav, lengths)
        zq, codes, q_len = self.quantizer(down.to(torch.float32), down_len)
        return {"zq": zq, "codes": codes, "codes_lengths": q_len}

    def detokenize(self, codes: torch.Tensor, codes_lengths: torch.Tensor):
        """codes (nq, B, T') -> dict(wav (B, T' * upsample), wav_lengths)."""
        zq = self.quantizer.decode(codes)                  # fp32 RVQ island
        zq = zq.to(torch_dtype(self.cfg.dtype))
        h, h_len = self.post_rvq_adapter(zq, codes_lengths)
        h, h_len = self.upsample(h, h_len)                 # 12.5 -> 50 Hz
        h, h_len = self.acoustic_decoder(h, h_len)         # 50 -> 100 Hz
        wav, wav_len = self.vocos(h, h_len)                # 100 Hz -> 24 kHz
        return {"wav": wav, "wav_lengths": wav_len}

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor):
        """The inference round trip: ``tokenize`` then ``detokenize``."""
        tok = self.tokenize(wav, lengths)
        return {**tok, **self.detokenize(tok["codes"], tok["codes_lengths"])}

    def train_forward(self, wav: torch.Tensor, lengths: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      group=None, **draws):
        """The training round trip in fp32: the encoder stack, the RVQ in
        train mode (``ResidualVQ.train_call``; ``draws`` are its overrides)
        and the decoder stack on the straight-through zq, so gradients reach
        the encoders through the commitment and reconstruction losses.
        Returns dict(wav, wav_lengths, codes, commit_losses (nq,),
        vq_stats)."""
        down, down_len = self._encode_latents(wav, lengths,
                                              cast_compute_dtype=False)
        zq, codes, commits, q_len, stats = self.quantizer.train_call(
            down, down_len, generator, group=group, **draws)
        h, h_len = self.post_rvq_adapter(zq, q_len)
        h, h_len = self.upsample(h, h_len)
        h, h_len = self.acoustic_decoder(h, h_len)
        wav24, wav_len = self.vocos(h, h_len)
        return {"wav": wav24, "wav_lengths": wav_len, "codes": codes,
                "commit_losses": commits, "vq_stats": stats}

    @torch.no_grad()
    def kmeans_init_codebooks(self, wav: torch.Tensor, lengths: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              init_idx_override: Optional[torch.Tensor] = None):
        """The encoder stack, then k-means of every RVQ stage from this
        batch. Returns (new_codebook (nq, K, D), cluster_sizes (nq, K))."""
        down, down_len = self._encode_latents(wav, lengths,
                                              cast_compute_dtype=False)
        return self.quantizer.kmeans_init_call(
            down, down_len, generator, init_idx_override=init_idx_override)

    def detokenize16(self, codes: torch.Tensor, codes_lengths: torch.Tensor):
        """int16-PCM variant: quantized on the device (half the readback
        bytes; audio is written as 16-bit PCM anyway)."""
        out = self.detokenize(codes, codes_lengths)
        pcm = torch.clamp(out["wav"], -1.0, 1.0) * 32767.0
        return {"wav": pcm.to(torch.int16), "wav_lengths": out["wav_lengths"]}


def _cast_infer_params(module: XYTokenizerModule, dtype: torch.dtype) -> None:
    """Cast every floating parameter except the quantizer subtree to the
    compute dtype, in place; buffers (the fp32 position tables) stay fp32."""
    for name, p in module.named_parameters():
        if not name.startswith("quantizer.") and p.dtype == torch.float32:
            p.data = p.data.to(dtype)


def _init_random(module: XYTokenizerModule, seed: int, device) -> None:
    """Seeded random weights made on ``device``: matrices N(0, 1/fan_in),
    codebooks N(0, 1), LayerNorm 1/0, biases 0; the layer-scale gammas and
    the AdaLayerNorm tables keep their constructed values, and the
    IMDCT-symexp head's mel-scale init is applied on top."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "quantizer.codebook":
                p.normal_(0.0, 1.0, generator=gen)
            elif ".gamma" in name or name.endswith(("norm.scale",
                                                    "norm.shift")):
                continue
            elif leaf in ("bias", "q_b", "v_b", "o_b"):
                p.zero_()
            elif p.ndim == 1:                        # LayerNorm weights
                p.fill_(1.0)
            else:
                if leaf in ("q_w", "k_w", "v_w", "o_w"):
                    fan_in = p.shape[0]
                elif isinstance(module.get_submodule(name.rsplit(".", 1)[0]),
                                nn.ConvTranspose1d):
                    fan_in = p.shape[0] * p.shape[2]
                else:
                    fan_in = int(np.prod(p.shape[1:]))
                p.normal_(0.0, fan_in ** -0.5, generator=gen)
        vc = module.cfg.vocos
        if vc.head == "imdct_symexp" and vc.head_sample_rate is not None:
            w = module.vocos.head.out.weight
            w.mul_(torch.as_tensor(mel_scale(vc.head_sample_rate,
                                             w.shape[0]), device=device)[:, None])


class XYTokenizer:
    """User-facing codec with the reference's chunked encode/decode API.

    ``params``: an ``XYTokenizerModule`` or a state dict for one (fp32
    master weights). ``dtype="bfloat16"`` runs the forward in bf16 with the
    reference's fp32 islands (RVQ, position adds, softmax, LayerNorm
    statistics, the log-mel, the ISTFT). TF32: the quantizer's codebook
    distances are fp32 matmuls whose argmin picks each code, so the encode's
    codes depend on them running in true fp32 on the card, PyTorch's default
    for matmuls; a caller's global ``torch.backends.cuda.matmul.allow_tf32``
    changes codes on near ties. Otherwise the serving configuration runs the
    codec in bf16, where TF32 does not apply; an fp32 codec on the card
    follows PyTorch's flags (by default cuDNN convolutions in TF32, matmuls
    in full fp32), which a caller that needs full fp32 turns off, as
    ``chip_smoke.py`` does."""

    def __init__(self, cfg: CodecConfig,
                 params: Union[XYTokenizerModule, dict],
                 chunk_seconds: int = 30, dtype: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        self.cfg = cfg
        if isinstance(params, XYTokenizerModule):
            module = params
            module.cfg = cfg
        else:
            with torch.device(self.device):
                module = XYTokenizerModule(cfg)
            module.load_state_dict(params)
        module = module.to(self.device).eval().requires_grad_(False)
        cd = torch_dtype(cfg.dtype)
        if cd != torch.float32:
            _cast_infer_params(module, cd)
        self.module = module
        self.input_sample_rate = cfg.input_sample_rate
        self.output_sample_rate = cfg.output_sample_rate
        self.encoder_downsample_rate = cfg.encoder_downsample_rate
        self.decoder_upsample_rate = cfg.decoder_upsample_rate
        self.nq = cfg.quantizer.num_quantizers
        self.chunk_seconds = chunk_seconds
        self.chunk_samples = chunk_seconds * cfg.input_sample_rate
        self.chunk_codes = self.chunk_samples // cfg.encoder_downsample_rate

    @classmethod
    def init_random(cls, cfg: CodecConfig, seed: int = 0,
                    dtype: Optional[str] = None,
                    device: DeviceLike = "cuda") -> "XYTokenizer":
        dev = resolve_device(device)
        with torch.device(dev):
            module = XYTokenizerModule(cfg)
        module = module.to(dev)              # the position tables too
        _init_random(module, seed, dev)
        return cls(cfg, module, dtype=dtype, device=dev)

    @classmethod
    def load_from_checkpoint(cls, config_path: str, ckpt_path: str,
                             dtype: Optional[str] = None,
                             device: DeviceLike = "cuda") -> "XYTokenizer":
        """The reference's yaml (``generator_params``) and a torch
        checkpoint (``.ckpt`` / ``.pt`` / ``.bin``, through
        ``utils/convert_codec``), or a native ``.npz`` (the JAX tree; a
        pre-scan per-layer tree is restacked). ``dtype`` None runs the
        codec in fp32, as the reference does; ``"bfloat16"`` is the
        serving configuration."""
        from ...utils.convert_codec import (convert_codec_checkpoint,
                                            restack_legacy_pytree)
        from ...utils.convert_jax import codec_state_from_jax
        cfg = CodecConfig.from_yaml(config_path)
        if ckpt_path.endswith((".ckpt", ".pt", ".bin")):
            params = convert_codec_checkpoint(cfg, ckpt_path)
        else:
            from ...core.checkpoint import load_pytree
            params = restack_legacy_pytree(load_pytree(ckpt_path))
        state = codec_state_from_jax(params, cfg)
        del params
        return cls(cfg, state, dtype=dtype, device=device)

    @torch.no_grad()
    def encode(self, wav_list: List[np.ndarray], overlap_seconds: int = 10):
        """wav_list: B * (T,) 16 kHz float arrays (any length) ->
        {"codes_list": B * (nq, T // 1280) int32}.

        The reference's chunking contract: 30 s windows with a stride of
        (30 - overlap) s, the leading stride's codes kept per window,
        concatenated and trimmed to len // 1280 per item. Every window is
        dispatched before any is read back, so the card computes window
        i + 1 while window i's codes are copied to the host."""
        sr = self.input_sample_rate
        duration = self.chunk_samples - overlap_seconds * sr      # stride
        code_duration = duration // self.encoder_downsample_rate

        B = len(wav_list)
        lengths = np.array([len(w) for w in wav_list], np.int64)
        max_chunks = max(1, -(-int(lengths.max()) // duration))
        pending = []
        for ci in range(max_chunks):
            start = ci * duration
            chunk = np.zeros((B, self.chunk_samples), np.float32)
            chunk_lens = np.clip(lengths - start, 0, self.chunk_samples)
            for b, w in enumerate(wav_list):
                seg = np.asarray(w, np.float32)[start:start + self.chunk_samples]
                chunk[b, :len(seg)] = seg
            if chunk_lens.max() == 0:
                continue
            pending.append(self.module.tokenize(
                torch.as_tensor(chunk, device=self.device),
                torch.as_tensor(chunk_lens, device=self.device)))

        chunks_codes = []
        for out in pending:
            codes = out["codes"].cpu().numpy().astype(np.int32)   # (nq, B, T')
            code_lens = np.clip(out["codes_lengths"].cpu().numpy(), 0,
                                code_duration)
            valid = np.zeros((self.nq, B, code_duration), np.int32)
            for b in range(B):
                n = int(code_lens[b])
                if n > 0:
                    valid[:, b, :n] = codes[:, b, :n]
            chunks_codes.append(valid)
        if not chunks_codes:
            return {"codes_list": [np.zeros((self.nq, 0), np.int32)
                                   for _ in range(B)]}
        all_codes = np.concatenate(chunks_codes, axis=-1)
        return {"codes_list": [
            all_codes[:, b, :int(lengths[b] // self.encoder_downsample_rate)]
            for b in range(B)]}

    @torch.no_grad()
    def _detokenize(self, codes: np.ndarray, lens: np.ndarray, pcm16: bool):
        fn = self.module.detokenize16 if pcm16 else self.module.detokenize
        return fn(torch.as_tensor(codes, device=self.device),
                  torch.as_tensor(lens, device=self.device))

    def decode(self, codes_list: List[np.ndarray], overlap_seconds: int = 10,
               pcm16: bool = False, rows_per_call: Optional[int] = None,
               len_buckets: Optional[str] = "auto"):
        """codes_list: B * (nq, T) -> {"syn_wav_list": B * (T*1920,) 24 kHz}.

        One feed of everything through ``IncrementalDecoder``. pcm16=True
        quantizes to int16 on the device; rows_per_call splits each window's
        batch into calls of at most N rows; len_buckets="auto" runs a
        partial final window through the smallest quarter-window bucket."""
        inc = self.incremental_decoder(overlap_seconds, pcm16, rows_per_call,
                                       len_buckets)
        return inc.finish(codes_list)

    def incremental_decoder(self, overlap_seconds: int = 10,
                            pcm16: bool = False,
                            rows_per_call: Optional[int] = None,
                            len_buckets: Optional[str] = "auto"
                            ) -> "IncrementalDecoder":
        return IncrementalDecoder(self, overlap_seconds, pcm16, rows_per_call,
                                  len_buckets)


def quarter_window_buckets(chunk_codes: int):
    """Quarter-window bucket ladder for partial windows."""
    return sorted({-(-chunk_codes * q // 4) for q in (1, 2, 3, 4)})


def chunk_stride_codes(spt: "XYTokenizer", overlap_seconds: int) -> int:
    """Codes each decode window advances (window minus overlap), the
    reference's formula ((30 - overlap) * sr) // dsr."""
    return ((spt.chunk_seconds - overlap_seconds) * spt.input_sample_rate
            ) // spt.encoder_downsample_rate


class IncrementalDecoder:
    """Chunked detokenization: ``feed`` dispatches every 30 s window that
    has become immutable for every row; ``finish`` dispatches the rest and
    assembles {"syn_wav_list": ...}. Device calls are queued before any
    readback, so early windows' copies overlap later windows' compute."""

    def __init__(self, spt: XYTokenizer, overlap_seconds: int = 10,
                 pcm16: bool = False, rows_per_call: Optional[int] = None,
                 len_buckets: Optional[str] = "auto"):
        self.spt = spt
        self.len_buckets = (quarter_window_buckets(spt.chunk_codes)
                            if len_buckets == "auto" else [spt.chunk_codes])
        self.duration_codes = chunk_stride_codes(spt, overlap_seconds)
        if self.duration_codes <= 0:
            raise ValueError(
                f"overlap_seconds={overlap_seconds} leaves no stride on a "
                f"{spt.chunk_seconds}s codec window")
        self.duration_wav = self.duration_codes * spt.decoder_upsample_rate
        self.pcm16 = pcm16
        self.rows_per_call = rows_per_call
        self.next_chunk = 0
        self.pending: list = []     # (chunk_index, row_slice, device_out)

    def _dispatch(self, codes_list, lengths: np.ndarray, ci: int) -> None:
        spt = self.spt
        B = len(codes_list)
        start = ci * self.duration_codes
        chunk_lens = np.clip(lengths - start, 0, spt.chunk_codes)
        L = next(b for b in self.len_buckets if b >= int(chunk_lens.max()))
        chunk = np.zeros((spt.nq, B, L), np.int64)
        for b, c in enumerate(codes_list):
            seg = np.asarray(c, np.int64)[:, start:start + L]
            chunk[:, b, :seg.shape[-1]] = seg
        step = self.rows_per_call or B
        for g0 in range(0, B, step):
            g1 = min(g0 + step, B)
            out = spt._detokenize(chunk[:, g0:g1], chunk_lens[g0:g1],
                                  self.pcm16)
            self.pending.append((ci, slice(g0, g1), out))

    def feed(self, codes_list: List[np.ndarray],
             finished: Optional[List[bool]] = None) -> int:
        """Dispatch every window that has become immutable (rows only grow
        between calls). Returns the number of windows dispatched so far."""
        B = len(codes_list)
        lengths = np.array([c.shape[-1] for c in codes_list], np.int64)
        fin = finished if finished is not None else [True] * B
        while True:
            start = self.next_chunk * self.duration_codes
            window_done = all(
                fin[b] or lengths[b] >= start + self.spt.chunk_codes
                for b in range(B))
            if not window_done or not bool((lengths > start).any()):
                break
            self._dispatch(codes_list, lengths, self.next_chunk)
            self.next_chunk += 1
        return self.next_chunk

    def finish(self, codes_list: List[np.ndarray]) -> dict:
        B = len(codes_list)
        code_lengths = np.array([c.shape[-1] for c in codes_list], np.int64)
        self.feed(codes_list, [True] * B)
        wav_chunks = [np.zeros((B, self.duration_wav), np.float32)
                      for _ in range(self.next_chunk)]
        for ci, rows, out in self.pending:
            wav = out["wav"].cpu().numpy()
            if self.pcm16:
                wav = wav.astype(np.float32) / 32768.0
            wav_lens = np.clip(out["wav_lengths"].cpu().numpy(), 0,
                               self.duration_wav)
            valid = wav_chunks[ci]
            for gi, b in enumerate(range(rows.start, rows.stop)):
                n = int(wav_lens[gi])
                if n > 0:
                    valid[b, :n] = wav[gi, :n].astype(np.float32)
        if wav_chunks:
            full = np.concatenate(wav_chunks, axis=-1)
            up = self.spt.decoder_upsample_rate
            syn = [full[b, :int(code_lengths[b] * up)] for b in range(B)]
        else:
            syn = [np.zeros((0,), np.float32) for _ in range(B)]
        return {"syn_wav_list": syn}

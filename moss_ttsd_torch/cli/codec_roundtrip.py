"""Codec round-trip CLI for the PyTorch port: encode + decode a directory of
wavs and save the reconstructions (port of
``moss_ttsd_tpu/cli/codec_roundtrip.py``).

``--metrics`` also scores each file: the log-mel L1 at the codec's own
Whisper-mel frontend and the SI-SNR, both at 16 kHz, with a summary JSON.
Runs on the CUDA card unless ``--platform cpu``; ``--config`` /
``--checkpoint`` load the XY-Tokenizer's yaml and checkpoint (fp32, as the
reference runs it); ``--tiny`` uses a random tiny codec (no checkpoint
needed). ``--debug 1`` blocks at start until a debugpy client attaches
on ``--debug_ip``:``--debug_port``.

    python -m moss_ttsd_torch.cli.codec_roundtrip --input_dir examples \\
        --output_dir outputs/recon --tiny --platform cpu --metrics out.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..utils.helpers import find_audio_files


def recon_metrics(inp16: np.ndarray, recon: np.ndarray, out_sr: int) -> dict:
    """Log-mel L1 (the codec's mel) and SI-SNR of a reconstruction against
    its input, both at 16 kHz, computed on the host."""
    import torch
    from ..ops.dsp import log_mel_spectrogram, resample
    r16 = resample(np.asarray(recon, np.float32), out_sr, 16000)
    n = min(len(inp16), len(r16))
    a, b = inp16[:n].astype(np.float32), r16[:n].astype(np.float32)
    mel_a, mel_b = (log_mel_spectrogram(torch.from_numpy(x)[None])[0].numpy()
                    for x in (a, b))
    m = min(mel_a.shape[-1], mel_b.shape[-1])
    mel_l1 = float(np.mean(np.abs(mel_a[..., :m] - mel_b[..., :m])))
    # scale-invariant: the codec does not promise to match the gain
    a0, b0 = a - a.mean(), b - b.mean()
    s_t = (np.dot(b0, a0) / (np.dot(a0, a0) + 1e-8)) * a0
    e = b0 - s_t
    si_snr = float(10 * np.log10(
        (np.dot(s_t, s_t) + 1e-8) / (np.dot(e, e) + 1e-8)))
    return {"mel_l1": round(mel_l1, 4), "si_snr_db": round(si_snr, 2)}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Codec round-trip (PyTorch / CUDA port)")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--config", default=None, help="codec yaml (reference format)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--metrics", nargs="?", const="-", default=None,
                   metavar="OUT.json",
                   help="compute per-file log-mel L1 + SI-SNR vs the input "
                        "(summary JSON to OUT.json, or stdout when bare)")
    p.add_argument("--tiny", action="store_true",
                   help="random tiny codec (smoke test)")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA card; cpu = run on the CPU")
    # remote-attach debug flags: --debug 1 blocks until a debugpy client
    # attaches on --debug_ip:--debug_port
    p.add_argument("--debug", type=int, default=0, nargs="?")
    p.add_argument("--debug_ip", default="localhost")
    p.add_argument("--debug_port", type=int, default=5678)
    args = p.parse_args(argv)

    if args.debug == 1:
        from ..utils.helpers import waiting_for_debug
        waiting_for_debug(args.debug_ip, args.debug_port)
    if not args.tiny and not (args.config and args.checkpoint):
        p.error("--config and --checkpoint are required without --tiny")

    from ..core.config import CodecConfig
    from ..models.codec.model import XYTokenizer
    from ..utils.audio_io import read_wav, to_mono_16k, write_wav

    device = "cpu" if args.platform == "cpu" else "cuda"
    if args.tiny:
        spt = XYTokenizer.init_random(CodecConfig().tiny(), seed=0,
                                      device=device)
    else:
        spt = XYTokenizer.load_from_checkpoint(args.config, args.checkpoint,
                                               device=device)

    files = find_audio_files(args.input_dir)
    if not files:
        print(f"no audio files in {args.input_dir}", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)

    per_file = []
    total_audio, total_wall = 0.0, 0.0
    for bi in range(0, len(files), args.batch_size):
        batch_files = files[bi:bi + args.batch_size]
        wavs = []
        for f in batch_files:
            wav, sr = read_wav(f)
            wavs.append(to_mono_16k(wav, sr, spt.input_sample_rate))
        t0 = time.perf_counter()
        codes = spt.encode(wavs)["codes_list"]
        recon = spt.decode(codes)["syn_wav_list"]
        total_wall += time.perf_counter() - t0
        for f, inp, wav in zip(batch_files, wavs, recon):
            out = os.path.join(args.output_dir, os.path.splitext(
                os.path.basename(f))[0] + "_recon.wav")
            write_wav(out, wav, spt.output_sample_rate)
            total_audio += len(wav) / spt.output_sample_rate
            if args.metrics is not None:
                m = recon_metrics(inp, wav, spt.output_sample_rate)
                m["file"] = os.path.basename(f)
                per_file.append(m)
                print(f"saved {out}  mel_l1={m['mel_l1']} "
                      f"si_snr={m['si_snr_db']}dB")
            else:
                print(f"saved {out}")
    rtf = total_audio / total_wall if total_wall else 0.0
    print(f"round-trip RTF: {rtf:.1f}x realtime "
          f"({total_audio:.1f}s audio / {total_wall:.2f}s wall)")
    if args.metrics is not None and per_file:
        summary = {
            "mean_mel_l1": round(float(np.mean([m["mel_l1"]
                                                for m in per_file])), 4),
            "mean_si_snr_db": round(float(np.mean([m["si_snr_db"]
                                                   for m in per_file])), 2),
            "files": per_file,
        }
        if args.metrics == "-":
            print(json.dumps(summary))
        else:
            with open(args.metrics, "w") as f:
                json.dump(summary, f, indent=1)
            print(f"metrics written to {args.metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

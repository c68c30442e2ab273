"""Remote-API batch synthesis client, PyTorch-port copy of
``moss_ttsd_tpu/serve/api_client.py``.

Fans a JSONL of dialogue items out to an OpenAI-compatible
``/audio/speech`` endpoint (the port's ``serve/server.py`` or a hosted
one): references for voice cloning as base64 prompt audio, thread-pool
concurrency, retries, a lock-guarded summary JSONL. Standard library only
(``urllib.request``); it needs neither torch nor a card.

    python -m moss_ttsd_torch.serve.api_client --jsonl examples/examples.jsonl \\
        --base_url http://127.0.0.1:8000/v1 --output_dir outputs_api
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional

import numpy as np

DEFAULT_MODEL = "fnlp/MOSS-TTSD-v0.5"
MAX_TOKENS = 16384          # the hosted API's max_tokens cap


def audio_file_to_base64(path: str) -> str:
    """wav file -> base64 string."""
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode("utf-8")


def wav_bytes_to_array(data: bytes):
    """Decode in-memory wav bytes -> (float32 (T,), sample_rate)."""
    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        arr = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 3:
        # 24-bit PCM: widen each little-endian triple to int32 by a zero
        # low byte, then scale by 2^31
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        quads = np.zeros((b.shape[0], 4), np.uint8)
        quads[:, 1:] = b
        arr = quads.view("<i4")[:, 0].astype(np.float32) / 2147483648.0
    else:
        arr = np.frombuffer(raw, np.uint8).astype(np.float32) / 128.0 - 1.0
    if ch > 1:
        arr = arr.reshape(-1, ch).mean(axis=1)
    return arr, sr


class SpeechAPIClient:
    """Minimal OpenAI-compatible audio/speech client."""

    def __init__(self, base_url: str, api_key: str = "",
                 model: str = DEFAULT_MODEL, max_retries: int = 3,
                 timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.max_retries = max_retries
        self.timeout = timeout

    def _request(self, payload: dict) -> urllib.request.Request:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        return urllib.request.Request(
            f"{self.base_url}/audio/speech", json.dumps(payload).encode(),
            headers, method="POST")

    def _payload(self, text, references, extra, voice, **fields) -> dict:
        payload = {"model": self.model, "input": text, **fields,
                   "max_tokens": MAX_TOKENS}
        if references:
            payload["references"] = references
        if voice:
            payload["voice"] = voice
        if extra:
            payload.update(extra)
        return payload

    def generate_speech(self, text: str,
                        references: Optional[List[Dict]] = None,
                        extra: Optional[Dict] = None,
                        voice: Optional[str] = None) -> bytes:
        """POST /audio/speech -> wav bytes, retried with backoff except on
        a 4xx other than 429. ``voice`` names a LoRA voice registered on
        the server (None = the base model)."""
        payload = self._payload(text, references, extra, voice,
                                response_format="wav")
        last_err = None
        for attempt in range(self.max_retries):
            try:
                with urllib.request.urlopen(self._request(payload),
                                            timeout=self.timeout) as r:
                    return r.read()
            except Exception as e:               # retry with backoff
                last_err = e
                status = getattr(e, "code", None)
                if isinstance(e, urllib.error.HTTPError) \
                        and 400 <= status < 500 and status != 429:
                    break                        # non-retryable client error
                if attempt < self.max_retries - 1:
                    time.sleep(2.0 * (attempt + 1))
        raise RuntimeError(f"speech API failed after {self.max_retries} "
                           f"retries: {last_err}")

    def stream_speech(self, text: str,
                      references: Optional[List[Dict]] = None,
                      extra: Optional[Dict] = None, chunk_samples: int = 4096,
                      voice: Optional[str] = None):
        """POST with ``stream: true`` -> yields (float32 audio chunk,
        sample_rate) as the server generates. The server sends raw 16-bit
        mono PCM (``audio/L16; rate=N``). No retries: replaying a
        half-delivered stream would repeat audio."""
        payload = self._payload(text, references, extra, voice, stream=True,
                                response_format="pcm")
        with urllib.request.urlopen(self._request(payload),
                                    timeout=self.timeout) as r:
            ct = r.headers.get("Content-Type", "")
            sr = 24000
            if "rate=" in ct:
                sr = int(ct.split("rate=")[1].split(";")[0].strip())
            carry = b""
            while True:
                raw = r.read1(2 * chunk_samples)
                if not raw:
                    break
                raw = carry + raw
                n = len(raw) // 2 * 2           # PCM16 alignment
                carry = raw[n:]
                if n:
                    yield (np.frombuffer(raw[:n], "<i2").astype(np.float32)
                           / 32768.0, sr)
            if carry:
                # the connection ended mid-sample: surface the truncation
                # instead of silently dropping the half PCM16 sample
                raise IOError("PCM16 stream truncated mid-sample "
                              f"({len(carry)} trailing byte)")


def build_references(item: dict) -> List[Dict]:
    """JSONL item -> API ``references`` list (base64 audio + text)."""
    refs = []
    base = item.get("base_path", "")

    def full(p):
        return os.path.join(base, p) if base and not os.path.isabs(p) else p

    if item.get("prompt_audio"):
        refs.append({"audio": audio_file_to_base64(full(item["prompt_audio"])),
                     "text": item.get("prompt_text", "")})
    else:
        for spk in ("speaker1", "speaker2"):
            a = item.get(f"prompt_audio_{spk}")
            if a:
                refs.append({"audio": audio_file_to_base64(full(a)),
                             "text": item.get(f"prompt_text_{spk}", "")})
    return refs


def process_jsonl(jsonl_path: str, output_dir: str, client: SpeechAPIClient,
                  max_workers: int = 4, use_normalize: bool = False,
                  summary_file: Optional[str] = None) -> int:
    """Thread-pool fan-out over the items with per-item isolation and a
    lock-guarded summary JSONL; returns the number of items written."""
    from ..pipeline.text import normalize_text
    os.makedirs(output_dir, exist_ok=True)
    with open(jsonl_path) as f:
        items = [json.loads(l) for l in f if l.strip()]

    lock = threading.Lock()
    done = 0

    def work(idx_item):
        idx, item = idx_item
        text = item.get("text", "")
        if use_normalize:
            text = normalize_text(text)
        refs = build_references(item)
        wav_bytes = client.generate_speech(text, refs,
                                           voice=item.get("voice"))
        out = os.path.join(output_dir, f"output_{idx}.wav")
        with open(out, "wb") as f:
            f.write(wav_bytes)
        if summary_file:
            with lock:
                with open(summary_file, "a", encoding="utf-8") as f:
                    f.write(json.dumps({"index": idx, "text": text,
                                        "output": out},
                                       ensure_ascii=False) + "\n")
        return idx

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures = [ex.submit(work, (i, it)) for i, it in enumerate(items)]
        for fut in as_completed(futures):
            try:
                fut.result()
                done += 1
            except Exception as e:               # per-item isolation
                print(f"item failed: {e}")
    return done


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="Batch TTS via an "
                                            "OpenAI-compatible speech API")
    p.add_argument("--jsonl", required=True)
    p.add_argument("--output_dir", default="outputs_api")
    p.add_argument("--base_url", default=os.environ.get(
        "TTSD_API_BASE", "http://127.0.0.1:8000/v1"))
    p.add_argument("--api_key", default=os.environ.get("TTSD_API_KEY", ""))
    p.add_argument("--model", default=DEFAULT_MODEL)
    p.add_argument("--max_workers", type=int, default=4)
    p.add_argument("--use_normalize", action="store_true")
    p.add_argument("--summary_file", default=None)
    args = p.parse_args(argv)
    client = SpeechAPIClient(args.base_url, args.api_key, args.model)
    n = process_jsonl(args.jsonl, args.output_dir, client,
                      args.max_workers, args.use_normalize, args.summary_file)
    print(f"completed {n} items")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

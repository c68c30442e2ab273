"""OpenAI-compatible local TTS server with request micro-batching, PyTorch
port of ``moss_ttsd_tpu/serve/server.py`` (the window scheduler):

  POST /v1/audio/speech   {"input": "...", "references": [{"audio": b64 wav,
                           "text": "..."}], "seed"?, "max_tokens"?}
                          -> audio/wav bytes
                          with "stream": true -> raw 16-bit PCM chunks
                          (audio/L16) as generation progresses
  GET  /v1/metrics        -> pipeline and server metrics (utils/profiling)
  GET  /v1/models         -> the model and its voices
  GET  /health            -> ok

Concurrent requests are micro-batched: a worker thread gathers requests
for ``batch_window_s`` (or until ``max_batch``) and runs ONE batched
``process_batch`` per (seed, max_tokens, normalize) group, so the engine
decodes the batch in lockstep. ``stream: true`` requests bypass the worker
and run ``TTSPipeline.stream_item`` one at a time under a lock. The HTTP
threads never touch tensors; only the worker thread and the stream holding
the lock call the pipeline, and both queue their kernels on the card's one
CUDA stream, in order; the host-side counters they share (``metrics``,
``pipeline.timings``) update under locks. Standard library only
(http.server + threading).

    python -m moss_ttsd_torch.serve.server --tiny --platform cpu --port 8000

The continuous scheduler (the slot pool), LoRA voices and multi-chip
meshes are not ported yet (ROADMAP A10b, A13): their flags raise.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from ..utils.profiling import metrics
from .api_client import wav_bytes_to_array

# per-request generation cap (the hosted API caps max_tokens at 16384); an
# unbounded value would size the KV cache to the request and fail the whole
# micro-batch
MAX_TOKENS_CAP = 16384
NOT_PORTED = "not yet ported to moss_ttsd_torch (ROADMAP A10b)"


class ServerBusy(Exception):
    """Admission queue at capacity: the handler answers HTTP 429, so
    overload sheds load at the door instead of growing an unbounded
    queue."""


def wav_array_to_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """float32 (T,) -> 16-bit PCM wav bytes."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _pcm16(chunk: np.ndarray) -> bytes:
    return (np.clip(chunk, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


class _Request:
    __slots__ = ("item", "max_new_tokens", "seed", "use_normalize", "event",
                 "wav_bytes", "error", "cancelled")

    def __init__(self, item, max_new_tokens, seed, use_normalize):
        self.item = item
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.use_normalize = use_normalize
        self.event = threading.Event()
        self.wav_bytes: Optional[bytes] = None
        self.error: Optional[str] = None
        # set by the handler when the client gave up (504): the worker
        # skips the request if it is still queued
        self.cancelled = False


class BatchingWorker:
    """Collects concurrent requests into one batched generate call."""

    def __init__(self, pipeline, max_batch: int = 8,
                 batch_window_s: float = 0.05, max_queue: int = 64):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.max_queue = max_queue
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, req: _Request) -> None:
        with self._cv:
            if self._stop:
                raise ServerBusy("server shutting down")
            if len(self._queue) >= self.max_queue:
                metrics.add("server_rejected_busy", 1)
                raise ServerBusy(f"queue full ({self.max_queue} waiting)")
            self._queue.append(req)
            metrics.set("server_queue_depth", len(self._queue))
            self._cv.notify()

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _take_batch(self) -> List[_Request]:
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            if self._stop and not self._queue:
                return []
            # the batching window: keep gathering until the deadline or a
            # full batch (one wait() would end at the first notify)
            deadline = time.monotonic() + self.batch_window_s
            while len(self._queue) < self.max_batch and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch = self._queue[:self.max_batch]
            del self._queue[:len(batch)]
            metrics.set("server_queue_depth", len(self._queue))
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop:
                    return
                continue
            batch = [r for r in batch if not r.cancelled]
            if not batch:
                continue
            metrics.add("server_batches", 1)
            metrics.add("server_batched_requests", len(batch))
            try:
                groups: Dict[tuple, List[_Request]] = {}
                for r in batch:
                    groups.setdefault(
                        (r.seed, r.max_new_tokens, r.use_normalize),
                        []).append(r)
                for (seed, mnt, norm), reqs in groups.items():
                    texts, audio = self.pipeline.process_batch(
                        [r.item for r in reqs], use_normalize=norm,
                        max_new_tokens=mnt, seed=seed)
                    for r, meta, res in zip(reqs, texts, audio):
                        if res is None:
                            # the per-item isolation error (bad prompt
                            # audio, malformed record) names the cause
                            r.error = ((meta or {}).get("error")
                                       or "generation produced no speech "
                                          "tokens")
                        else:
                            r.wav_bytes = wav_array_to_bytes(
                                res["audio_data"][0], res["sample_rate"])
                        r.event.set()
            except Exception as e:                  # noqa: BLE001
                for r in batch:
                    if not r.event.is_set():
                        r.error = f"server error: {e}"
                        r.event.set()


def _references_to_item(text: str, references: List[Dict]) -> dict:
    """API references -> internal JSONL-item schema (in-memory tuples)."""
    item: dict = {"text": text}
    if not references:
        return item
    decoded = []
    for ref in references:
        wav, sr = wav_bytes_to_array(base64.b64decode(ref["audio"]))
        decoded.append(((wav[None, :], sr), ref.get("text", "")))
    if len(decoded) == 1:
        item["prompt_audio"], item["prompt_text"] = decoded[0]
    else:
        item["prompt_audio_speaker1"], item["prompt_text_speaker1"] = decoded[0]
        item["prompt_audio_speaker2"], item["prompt_text_speaker2"] = decoded[1]
    return item


def make_handler(worker: BatchingWorker, request_timeout_s: float = 600.0):
    stream_lock = threading.Lock()      # one streaming generation at a time
    # bound the number of streams waiting for the lock by max_queue, as
    # non-stream admission is bounded, so stream requests cannot each pin
    # an HTTP thread forever
    stream_gate = threading.Condition()
    stream_waiting = [0]
    voices: List[str] = []              # no LoRA registry (ROADMAP A10b)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):    # quiet by default
            pass

        def _json_error(self, code: int, msg: str) -> None:
            body = json.dumps({"error": {"message": msg}}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                body = b"ok"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
            elif self.path in ("/v1/metrics", "/metrics"):
                body = metrics.dump_json().encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
            elif self.path in ("/v1/models", "/models"):
                body = json.dumps({
                    "object": "list",
                    "data": [{"id": "moss-ttsd", "object": "model",
                              "voices": voices}],
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
            else:
                return self._json_error(404, "not found")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path not in ("/v1/audio/speech", "/audio/speech"):
                return self._json_error(404, "not found")
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    return self._json_error(400, "bad request: body must be "
                                                 "a JSON object")
                text = payload["input"]
                seed = int(payload.get("seed", 0))
                max_tokens = payload.get("max_tokens")
                if max_tokens is not None and not (
                        isinstance(max_tokens, int)
                        and 0 < max_tokens <= MAX_TOKENS_CAP):
                    return self._json_error(
                        400, f"bad request: max_tokens must be an int in "
                             f"[1, {MAX_TOKENS_CAP}]")
            except (KeyError, json.JSONDecodeError, ValueError,
                    TypeError) as e:
                return self._json_error(400, f"bad request: {e}")
            voice = payload.get("voice") or None
            if voice not in (None, "default", "base"):
                return self._json_error(
                    400, f"unknown voice {voice!r}; available: {voices}")
            stream = bool(payload.get("stream", False))
            fmt = payload.get("response_format", "pcm" if stream else "wav")
            if stream and fmt != "pcm":
                return self._json_error(
                    400, "streaming supports response_format=pcm only "
                         "(raw 16-bit mono PCM chunks)")
            if not stream and fmt != "wav":
                return self._json_error(400, "only response_format=wav "
                                             "supported")
            try:
                item = _references_to_item(text, payload.get("references", []))
            except Exception as e:                  # noqa: BLE001
                return self._json_error(400, f"bad reference audio: {e}")
            normalize = bool(payload.get("normalize", False))
            if stream:
                return self._stream_speech(item, max_tokens, seed, normalize)

            req = _Request(item, max_tokens, seed, normalize)
            t0 = time.perf_counter()
            try:
                worker.submit(req)
            except ServerBusy as e:
                return self._json_error(429, f"server busy: {e}")
            if not req.event.wait(request_timeout_s):
                # nobody waits for the result any more: the worker skips it
                # if it is still queued
                req.cancelled = True
                return self._json_error(504, "generation timed out")
            if req.error:
                code = (400 if req.error.startswith("bad request")
                        else 429 if req.error.startswith("server busy")
                        else 500)
                return self._json_error(code, req.error)
            metrics.observe("server_request_latency_s",
                            time.perf_counter() - t0)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(req.wav_bytes)))
            self.end_headers()
            self.wfile.write(req.wav_bytes)

        def _stream_speech(self, item, max_tokens, seed, normalize) -> None:
            """Stream raw 16-bit PCM as generation progresses: the first
            audio leaves the socket about one time-to-first-audio after the
            request (prefill + a short first segment + one small vocode,
            ``TTSPipeline.stream_item``). The response has no
            Content-Length; the connection closes at the end of the audio.
            Streams bypass the batching worker and run one at a time."""
            pipe = worker.pipeline
            t0 = time.perf_counter()
            with stream_gate:
                if stream_waiting[0] >= max(1, worker.max_queue):
                    metrics.add("server_rejected_busy", 1)
                    return self._json_error(
                        429, "busy: too many streams waiting (the window "
                             "scheduler streams one at a time)")
                stream_waiting[0] += 1
            try:
                acquired = stream_lock.acquire(timeout=request_timeout_s)
            finally:
                with stream_gate:
                    stream_waiting[0] -= 1
            if not acquired:
                metrics.add("server_rejected_busy", 1)
                return self._json_error(
                    503, "busy: timed out waiting for the stream slot")
            try:
                gen = pipe.stream_item(item, use_normalize=normalize,
                                       max_new_tokens=max_tokens, seed=seed)
                try:
                    # the first chunk before the headers, so prompt and
                    # codec errors still give a JSON error status
                    chunk, sr = next(gen)
                except StopIteration:
                    return self._json_error(
                        500, "generation produced no speech tokens")
                except ValueError as e:
                    return self._json_error(400, f"bad request: {e}")
                except Exception as e:              # noqa: BLE001
                    return self._json_error(500, f"server error: {e}")
                metrics.observe("server_ttfa_s", time.perf_counter() - t0)
                self.send_response(200)
                self.send_header("Content-Type",
                                 f"audio/L16; rate={sr}; channels=1")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    while True:
                        self.wfile.write(_pcm16(chunk))
                        self.wfile.flush()
                        chunk, sr = next(gen)
                except StopIteration:
                    metrics.add("server_streamed", 1)
                except (BrokenPipeError, ConnectionResetError):
                    gen.close()         # the client went away: stop
            finally:
                stream_lock.release()

    return Handler


class SpeechServer:
    """Owns the HTTP server and the batching worker; start()/stop().

    scheduler="window" micro-batches concurrent requests into one static
    generate call. The continuous scheduler and LoRA voices are not ported
    (ValueError)."""

    def __init__(self, pipeline, host: str = "0.0.0.0", port: int = 8000,
                 max_batch: int = 8, batch_window_s: float = 0.05,
                 scheduler: str = "window", max_queue: int = 64,
                 lora_adapters: Optional[Dict[str, dict]] = None):
        if scheduler == "continuous":
            raise ValueError(f"scheduler 'continuous' is {NOT_PORTED}")
        if scheduler != "window":
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if lora_adapters:
            raise ValueError(f"LoRA voices are {NOT_PORTED}")
        self.worker = BatchingWorker(pipeline, max_batch, batch_window_s,
                                     max_queue=max_queue)
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(self.worker))
        self._thread: Optional[threading.Thread] = None

    def warmup(self, max_tokens: int = 8, timeout_s: float = 1800.0) -> None:
        """One tiny request through the scheduler before traffic arrives
        (builds the kernels, warms the allocator and the codec)."""
        req = _Request({"text": "[S1]warm up.[S2]ready."}, max_tokens, 0,
                       False)
        try:
            self.worker.submit(req)
        except ServerBusy as e:
            raise RuntimeError(f"warmup rejected: {e}") from e
        if not req.event.wait(timeout_s):
            raise RuntimeError("warmup timed out")
        if req.error:
            raise RuntimeError(f"warmup failed: {req.error}")

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.worker.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Local OpenAI-compatible TTS server (PyTorch / CUDA port)")
    p.add_argument("--model_path", default=None)
    p.add_argument("--spt_config", default=None)
    p.add_argument("--spt_ckpt", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--batch_window_ms", type=float, default=50.0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models (smoke test); also the default "
                        "without --model_path")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA card; cpu = run on the CPU")
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="weight-only int8 serving (w8a16)")
    p.add_argument("--restricted_text_head", action="store_true",
                   help="channel-0 logits over the speech window only")
    p.add_argument("--restricted_audit_every", type=int, default=0,
                   metavar="N",
                   help="with --restricted_text_head: every N-th step count "
                        "the rows the full head would have sent outside the "
                        "window (restricted_audit_rows/_flagged on "
                        "/v1/metrics); 0 = off")
    p.add_argument("--scheduler", choices=["window", "continuous"],
                   default="window",
                   help="window = micro-batched static generate; "
                        "continuous is not ported yet")
    p.add_argument("--max_queue", type=int, default=64,
                   help="admission-queue bound; requests beyond it get 429")
    p.add_argument("--warmup", action="store_true",
                   help="one tiny request through the scheduler before "
                        "accepting traffic")
    # flags of the JAX server this port does not implement yet: accepted so
    # that they fail loudly instead of being ignored
    p.add_argument("--attn_impl", default=None)
    p.add_argument("--mesh", default=None)
    p.add_argument("--lora_adapter", action="append", default=[])
    p.add_argument("--jax_cache_dir", default=None)
    args = p.parse_args(argv)

    for flag, val in (("--mesh", args.mesh),
                      ("--lora_adapter", args.lora_adapter),
                      ("--jax_cache_dir", args.jax_cache_dir)):
        if val:
            p.error(f"{flag} is not yet ported to moss_ttsd_torch")
    if args.attn_impl not in (None, "mixed", "pallas"):
        p.error(f"--attn_impl {args.attn_impl} is not yet ported to "
                "moss_ttsd_torch")
    if args.scheduler == "continuous":
        p.error(f"--scheduler continuous is {NOT_PORTED}")
    if args.model_path and not args.tiny:
        raise SystemExit(
            "loading a real checkpoint is not yet ported: it needs the HF LM "
            f"directory ({args.model_path}), its Qwen tokenizer and the "
            f"XY-Tokenizer checkpoint ({args.spt_ckpt}); use --tiny")

    from ..cli.inference import build_tiny_pipeline
    pipeline = build_tiny_pipeline(
        device="cpu" if args.platform == "cpu" else "cuda", quant=args.quant,
        restricted_text_head=args.restricted_text_head,
        restricted_audit_every=args.restricted_audit_every or None)
    server = SpeechServer(pipeline, args.host, args.port, args.max_batch,
                          args.batch_window_ms / 1000.0,
                          max_queue=args.max_queue)
    if args.warmup:
        print("warming up...", flush=True)
        server.warmup()
    server.start()
    print(f"serving on {args.host}:{server.port} (scheduler=window, "
          f"max_batch={args.max_batch}, device={pipeline.device})",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

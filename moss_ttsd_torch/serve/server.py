"""OpenAI-compatible local TTS server, PyTorch port of
``moss_ttsd_tpu/serve/server.py`` (the window and the continuous
schedulers, LoRA voices):

  POST /v1/audio/speech   {"input": "...", "references": [{"audio": b64 wav,
                           "text": "..."}], "seed"?, "max_tokens"?,
                           "voice"?}
                          -> audio/wav bytes
                          with "stream": true -> raw 16-bit PCM chunks
                          (audio/L16) as generation progresses
  GET  /v1/metrics        -> pipeline and server metrics (utils/profiling)
  GET  /v1/models         -> the model and its voices (LoRA adapters)
  GET  /health            -> ok

``scheduler="window"``: a worker thread gathers requests for
``batch_window_s`` (or until ``max_batch``) and runs ONE batched
``process_batch`` per (seed, max_tokens, normalize) group, each row with
its own voice; ``stream: true`` requests run ``TTSPipeline.stream_item``
one at a time under a lock. ``scheduler="continuous"``: a slot pool
(``decode/continuous.py``) where each request, streamed or not, joins at
a segment boundary and leaves when it finishes, so streams decode
together and a long request holds no short one; requests the pool cannot
hold go to a lazy window-scheduler worker (``server_routed_overflow``).
The HTTP threads never touch tensors; the worker threads queue their
kernels on the card's one CUDA stream, in order; the host-side counters
they share (``metrics``, ``pipeline.timings``) update under locks.
Standard library only (http.server + threading). ``MOSS_TTSD_DEBUG=
host:port`` (or ``port``) makes ``main`` block at start until a debugpy
client attaches.

    python -m moss_ttsd_torch.serve.server --tiny --platform cpu --port 8000 \\
        --scheduler continuous --lora_adapter narrator=lora_factors.npz

``--model_path DIR --spt_config YAML --spt_ckpt CKPT`` serves a real
checkpoint (``TTSPipeline.load``; the tokenizer needs ``transformers``).
``--attn_impl xla`` attends with the dense einsums instead of the kernels;
``--jax_cache_dir DIR`` builds the kernels into DIR (a restart reuses
them; "" builds into a fresh temporary directory).

``--mesh DATAxMODEL`` serves over a mesh of processes (one a card;
``python -m torch.distributed.run --nproc_per_node N``, or the ``JAX_*``
variables of ``parallel/distributed.py``): rank 0 owns HTTP, the
scheduler and the codec, and its engine and pool calls are replayed in
order by the other ranks (``parallel/mirror.py``); a follower that fails
stops the server (exit 1) instead of hanging it.
"""

from __future__ import annotations

import base64
import io
import json
import queue
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


def _register_adapters(register, adapters: Optional[Dict[str, object]],
                       default_alpha: float) -> None:
    """Register --lora_adapter specs (a bare factor tree, or the loaders'
    (tree, alpha, use_rslora) tuple) through ONE place."""
    for name, spec in (adapters or {}).items():
        tree, alpha, rslora = (spec if isinstance(spec, tuple)
                               else (spec, default_alpha, True))
        register(name, tree, alpha=alpha, use_rslora=rslora)


class _Request:
    __slots__ = ("item", "max_new_tokens", "seed", "use_normalize", "event",
                 "wav_bytes", "error", "adapter", "stream_q", "cancelled",
                 "sv")

    def __init__(self, item, max_new_tokens, seed, use_normalize,
                 adapter=None):
        self.item = item
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.use_normalize = use_normalize
        self.adapter = adapter          # LoRA adapter name (the "voice")
        self.event = threading.Event()
        self.wav_bytes: Optional[bytes] = None
        self.error: Optional[str] = None
        # streamed requests of the continuous scheduler: PCM chunks flow
        # through stream_q (an np chunk, a str error, None at the end)
        self.stream_q: Optional[queue.Queue] = None
        # set by the handler when the client gave up (504, disconnect): the
        # window worker skips the request if it is still queued, the pool
        # frees its slot at the next segment boundary
        self.cancelled = False
        self.sv = None                  # the request's StreamVocoder

    def fail(self, msg: str) -> None:
        self.error = msg
        if self.stream_q is not None:
            self.stream_q.put(msg)
        self.event.set()


def _error_code(msg: str) -> int:
    return (400 if msg.startswith("bad request")
            else 429 if msg.startswith("server busy") else 500)


class BatchingWorker:
    """Collects concurrent requests into one batched generate call."""

    def __init__(self, pipeline, max_batch: int = 8,
                 batch_window_s: float = 0.05, max_queue: int = 64,
                 queue_gauge: str = "server_queue_depth"):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.max_queue = max_queue
        # one gauge per worker, so the pool's queue depth and its overflow
        # worker's do not overwrite each other in the shared registry
        self.queue_gauge = queue_gauge
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
            metrics.set(self.queue_gauge, len(self._queue))
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
            metrics.set(self.queue_gauge, len(self._queue))
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
                # per-row adapters, so voices do not split the batch
                groups: Dict[tuple, List[_Request]] = {}
                for r in batch:
                    groups.setdefault(
                        (r.seed, r.max_new_tokens, r.use_normalize),
                        []).append(r)
                for (seed, mnt, norm), reqs in groups.items():
                    texts, audio = self.pipeline.process_batch(
                        [r.item for r in reqs], use_normalize=norm,
                        max_new_tokens=mnt, seed=seed,
                        adapter=([r.adapter for r in reqs]
                                 if any(r.adapter for r in reqs) else None))
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


class ContinuousWorker:
    """Slot-pool continuous batching worker (``decode/continuous.py``).

    No batching window: a request joins the running pool at the next
    segment boundary (a queued burst prefills as one batch and splices
    into free slots), and leaves the pool the moment it finishes, so a
    long generation never blocks short ones. The finished requests of a
    segment are vocoded in one batched codec call; a streamed request
    feeds its own ``StreamVocoder`` each segment.

    Each slot draws from the request's own seed, so a sampled request
    reproduces an isolated ``GenerationEngine.generate(seed=...)`` whatever
    else shares the pool.

    ``kv_quant="auto"`` (the default) turns the int8 KV cache on when the
    per-slot cache (base + max_steps slots) reaches
    ``KV_QUANT_AUTO_THRESHOLD``; the default pool has 2560.

    The voices are the pipeline engine's registered adapters: the pool
    shares that ``LoraRegistry`` (one copy of the stacks on the card), so
    a voice registered there serves the pool, the overflow worker and
    the window scheduler alike.
    """

    # The JAX package's rule: the crossover where its int8 cache won,
    # measured on a TPU (v5e). It is not a measurement on the H100.
    KV_QUANT_AUTO_THRESHOLD = 512

    def __init__(self, pipeline, slots: int = 8, base: int = 512,
                 max_steps: int = 2048, segment_steps: int = 25,
                 kv_quant: Optional[str] = "auto", max_queue: int = 64):
        self.pipeline = pipeline
        eng = pipeline.engine
        if kv_quant == "auto":
            kv_quant = ("int8" if base + max_steps
                        >= self.KV_QUANT_AUTO_THRESHOLD else "none")
        elif kv_quant in (None, "none"):
            kv_quant = "none"
        elif kv_quant != "int8":
            raise ValueError(f"unknown pool kv_quant {kv_quant!r}")
        # the pool's engine wraps the pipeline engine's weights, voice
        # registry and mesh (no copy of either)
        self.cb = eng.make_pool(
            slots=slots, base=base, max_steps=max_steps, kv_quant=kv_quant)
        self.segment_steps = segment_steps
        self.max_queue = max_queue
        self._queue: List[_Request] = []
        self._live: Dict[int, _Request] = {}        # slot -> request
        # per-stream host token mirrors (slot -> (rows read, C)): each
        # segment reads back only the rows written since the last peek
        self._stream_mirror: Dict[int, np.ndarray] = {}
        self._cv = threading.Condition()
        self._stop = False
        # over-capacity fallback, made at the first request that needs it
        self._overflow: Optional[BatchingWorker] = None
        self._overflow_lock = threading.Lock()
        self._overflow_closed = False   # set under _overflow_lock at shutdown
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _route_overflow(self, req: _Request) -> bool:
        """Serve a request the pool cannot hold (budget over max_steps, or
        a prompt over the pool bucket) through a window-scheduler worker in
        the same server instead of refusing it. It shares the card with the
        pool, so pool segments slow while it runs; counted in
        ``server_routed_overflow``. A streamed request cannot ride the
        batched fallback: returns False, and the caller refuses it."""
        if req.stream_q is not None:
            return False
        with self._overflow_lock:
            if self._overflow_closed:   # racing with shutdown(): a worker
                # made now would never be joined, so shed the request
                raise ServerBusy("server shutting down")
            if self._overflow is None:
                self._overflow = BatchingWorker(
                    self.pipeline, max_batch=2, batch_window_s=0.2,
                    max_queue=max(2, self.max_queue // 4),
                    queue_gauge="server_overflow_queue_depth")
            overflow = self._overflow
        overflow.submit(req)            # ServerBusy propagates (-> 429)
        # count only the requests the fallback admitted
        metrics.add("server_routed_overflow", 1)
        return True

    def submit(self, req: _Request) -> None:
        if (req.max_new_tokens is not None
                and req.max_new_tokens > self.cb.max_steps):
            if self._route_overflow(req):
                return
            req.fail(f"bad request: stream max_tokens "
                     f"({req.max_new_tokens}) exceeds the pool capacity "
                     f"({self.cb.max_steps}); drop stream, lower max_tokens, "
                     f"or raise --pool_max_steps")
            return
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
        with self._overflow_lock:       # close the lazy-creation window
            self._overflow_closed = True
            overflow = self._overflow
        if overflow is not None:
            overflow.shutdown()

    # -- pool plumbing --------------------------------------------------

    def _prepare(self, burst: List[_Request]) -> List[tuple]:
        """[(req, shifted prompt)] of the burst's requests that the pool
        takes; the others are failed or routed to the overflow worker."""
        prepared = []
        for req in burst:
            if req.cancelled:           # the client gave up while queued
                req.event.set()
                continue
            try:
                shifted, _ = self.pipeline.prepare_item(
                    req.item, use_normalize=req.use_normalize)
                if shifted.shape[0] > self.cb.L:
                    # over the pool's prompt bucket: the fallback serves it
                    # (known only once the prompt is tokenized)
                    if not self._route_overflow(req):
                        req.fail(f"bad request: stream prompt "
                                 f"({shifted.shape[0]} rows) exceeds the "
                                 f"pool bucket ({self.cb.L}); raise "
                                 f"--pool_base or drop stream")
                    continue
                prepared.append((req, shifted))
            except ValueError as e:
                req.fail(f"bad request: {e}")
            except ServerBusy as e:
                req.fail(f"server busy: {e}")
            except Exception as e:              # noqa: BLE001
                req.fail(f"server error: {e}")
        return prepared

    def _admit(self) -> None:
        """Move queued requests into free slots: a burst through ONE
        batched prefill (``submit_many``); if it holds a bad request (the
        burst is validated before any device work) fall back to one-by-one
        admission, so only the offending request fails."""
        while self.cb.free_slots:
            with self._cv:
                if not self._queue:
                    return
                burst = self._queue[:self.cb.free_slots]
                del self._queue[:len(burst)]
                metrics.set("server_queue_depth", len(self._queue))
            prepared = self._prepare(burst)
            if not prepared:
                continue
            try:
                slots = self.cb.submit_many(
                    [(shifted, req.max_new_tokens, req.seed, req.adapter)
                     for req, shifted in prepared])
                for (req, _), slot in zip(prepared, slots):
                    self._join(req, slot)
                continue
            except ValueError:
                pass                    # isolate the bad request below
            except Exception as e:                  # noqa: BLE001
                # device or runtime failures are not the client's fault
                for req, _ in prepared:
                    req.fail(f"server error: {e}")
                continue
            for req, shifted in prepared:
                try:
                    slot = self.cb.submit(shifted,
                                          max_new_tokens=req.max_new_tokens,
                                          seed=req.seed, adapter=req.adapter)
                except ValueError as e:
                    req.fail(f"bad request: {e}")
                    continue
                except Exception as e:              # noqa: BLE001
                    req.fail(f"server error: {e}")
                    continue
                self._join(req, slot)

    def _join(self, req: _Request, slot: int) -> None:
        """Book an admitted request; a streamed one gets its own
        incremental vocoder (``StreamVocoder``), fed each segment."""
        self._live[slot] = req
        if req.stream_q is not None and req.sv is None:
            from ..pipeline.batch import StreamVocoder
            spt = self.pipeline.spt
            req.sv = StreamVocoder(
                spt, StreamVocoder.effective_context(
                    spt, self.pipeline.vocode_overlap_s, self.segment_steps),
                timings=self.pipeline.timings)
        metrics.add("server_continuous_joins", 1)

    def _drop(self, slot: int) -> None:
        self.cb.release(slot)
        self._live.pop(slot, None)
        self._stream_mirror.pop(slot, None)

    def _service(self) -> None:
        """One progress readback a segment: feed the live streams, reclaim
        the cancelled requests, collect and vocode the finished ones."""
        finished, stream_rows = [], []
        for slot, steps, fin in self.cb.progress():
            req = self._live.get(slot)
            if req is None:                   # an orphan: reclaim it
                self._drop(slot)
                continue
            if req.cancelled:                 # the client went away
                self._drop(slot)
                metrics.add("server_cancelled", 1)
                continue
            if fin:
                finished.append((slot, steps))
            elif req.stream_q is not None and steps > 0:
                stream_rows.append((slot, steps))
        if stream_rows:
            # ONE readback of every live stream's new rows: from the
            # shortest mirror on; each slot appends its own slice
            have = [self._stream_mirror.get(slot) for slot, _ in stream_rows]
            frm = min((m.shape[0] if m is not None else 0) for m in have)
            toks = self.cb.peek_tokens([j for j, _ in stream_rows],
                                       [s for _, s in stream_rows], frm=frm)
            for (slot, steps), row, m in zip(stream_rows, toks, have):
                req = self._live[slot]
                try:
                    rows_read = m.shape[0] if m is not None else 0
                    new = row[rows_read - frm:self.cb.base + steps - frm]
                    full = (np.concatenate([m, new]) if m is not None
                            else np.ascontiguousarray(new))
                    self._stream_mirror[slot] = full
                    ids, ends = self.pipeline.unshift_end(full[None],
                                                          self.cb.base)
                    for chunk in req.sv.feed(ids, int(ends[0])):
                        req.stream_q.put(chunk)
                except Exception as e:              # noqa: BLE001
                    req.fail(f"vocode error: {e}")
                    self._drop(slot)
        self._drain_finished(finished)

    def _drain_finished(self, done: List[tuple]) -> None:
        if not done:
            return
        from ..decode.engine import GenerateResult
        spt = self.pipeline.spt
        # every finished slot's token copy is queued first (collect_async
        # frees the slot), so the host work below overlaps the readbacks
        pending = []
        for slot, steps in done:
            req = self._live.pop(slot, None)
            if req is None:
                self._drop(slot)
                continue
            pending.append((slot, req) + self.cb.collect_async(slot, steps))
        reqs, codes_list = [], []
        for slot, req, steps, tokens_dev in pending:
            mirror = self._stream_mirror.pop(slot, None)
            if mirror is not None:
                # a stream: only the tail its mirror lacks is read back
                tail = tokens_dev[mirror.shape[0]:].cpu().numpy()
                toks = (np.concatenate([mirror, tail])
                        if tail.size else mirror)[None]
            else:
                toks = tokens_dev.cpu().numpy()[None]
            res = GenerateResult(tokens=toks, steps=steps, base=self.cb.base)
            if req.stream_q is not None:
                try:
                    ids, ends = self.pipeline.unshift_end(res.tokens,
                                                          res.base)
                    for chunk in req.sv.finish(ids, int(ends[0])):
                        req.stream_q.put(chunk)
                    req.stream_q.put(None)          # the end of the stream
                    metrics.add("server_streamed", 1)
                    req.event.set()
                except Exception as e:              # noqa: BLE001
                    req.fail(f"vocode error: {e}")
                continue
            codes = self.pipeline.extract_codes(res)[0]
            if codes is None:
                req.fail("generation produced no speech tokens")
                continue
            reqs.append(req)
            codes_list.append(codes)
        if not codes_list:
            return
        try:
            wavs = spt.decode(codes_list,
                              overlap_seconds=self.pipeline.vocode_overlap_s,
                              pcm16=True,
                              rows_per_call=self.pipeline.vocode_rows_per_call
                              )["syn_wav_list"]
            for req, wav in zip(reqs, wavs):
                req.wav_bytes = wav_array_to_bytes(
                    np.asarray(wav, np.float32), spt.output_sample_rate)
                req.event.set()
        except Exception as e:                      # noqa: BLE001
            for req in reqs:
                req.fail(f"vocode error: {e}")

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._live and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for r in self._queue:
                        r.fail("server shutting down")
                    for r in self._live.values():
                        r.fail("server shutting down")
                    return
            try:
                if self._live:
                    # the segment first: its last step is still on the card
                    # when run returns, and the host side of admission
                    # (tokenize, prompt encode) overlaps it; the joins land
                    # at this boundary
                    self.cb.run(steps=self.segment_steps)
                    metrics.add("server_continuous_segments", 1)
                    self._admit()
                    self._service()
                else:
                    self._admit()
                metrics.set("server_pool_active_slots", len(self._live))
            except Exception as e:                  # noqa: BLE001
                # fail every in-flight request AND reclaim its slot (live
                # rows without an owner would block the pool for good)
                for slot, r in list(self._live.items()):
                    r.fail(f"server error: {e}")
                    self.cb.release(slot)
                self._live.clear()
                self._stream_mirror.clear()


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


def make_handler(worker, request_timeout_s: float = 600.0):
    """The HTTP handler over a ``BatchingWorker`` or a ``ContinuousWorker``
    (streams then ride the pool, with no stream lock)."""
    stream_lock = threading.Lock()      # window: one stream at a time
    # bound the number of streams waiting for the lock by max_queue, as
    # non-stream admission is bounded, so stream requests cannot each pin
    # an HTTP thread forever
    stream_gate = threading.Condition()
    stream_waiting = [0]
    lora = worker.pipeline.engine.lora   # the voices: registered adapters

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
                              "voices": lora.names}],
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
            if voice in ("default", "base"):
                voice = None
            if voice is not None and voice not in lora.ids:
                return self._json_error(
                    400, f"unknown voice {voice!r}; available: "
                         f"{lora.names}")
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
                if isinstance(worker, ContinuousWorker):
                    return self._stream_pool(item, max_tokens, seed,
                                             normalize, voice)
                return self._stream_speech(item, max_tokens, seed, normalize,
                                           voice)

            req = _Request(item, max_tokens, seed, normalize, adapter=voice)
            t0 = time.perf_counter()
            try:
                worker.submit(req)
            except ServerBusy as e:
                return self._json_error(429, f"server busy: {e}")
            if not req.event.wait(request_timeout_s):
                # nobody waits for the result any more: the window worker
                # skips it if it is still queued, the pool frees its slot
                # at the next segment boundary
                req.cancelled = True
                return self._json_error(504, "generation timed out")
            if req.error:
                return self._json_error(_error_code(req.error), req.error)
            metrics.observe("server_request_latency_s",
                            time.perf_counter() - t0)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(req.wav_bytes)))
            self.end_headers()
            self.wfile.write(req.wav_bytes)

        def _stream_pool(self, item, max_tokens, seed, normalize,
                         voice=None) -> None:
            """Stream raw PCM out of the continuous pool: each stream holds
            a slot, so streams decode together (no stream lock) while other
            requests join around them. A client that disconnects or times
            out cancels the request; the worker frees its slot at the next
            segment boundary."""
            req = _Request(item, max_tokens, seed, normalize, adapter=voice)
            req.stream_q = queue.Queue()
            t0 = time.perf_counter()
            try:
                worker.submit(req)
            except ServerBusy as e:
                return self._json_error(429, f"server busy: {e}")
            try:
                first = req.stream_q.get(timeout=request_timeout_s)
            except queue.Empty:
                req.cancelled = True
                return self._json_error(504, "generation timed out")
            if isinstance(first, str):
                return self._json_error(_error_code(first), first)
            if first is None:
                return self._json_error(
                    500, "generation produced no speech tokens")
            metrics.observe("server_ttfa_s", time.perf_counter() - t0)
            sr = worker.pipeline.spt.output_sample_rate
            self.send_response(200)
            self.send_header("Content-Type",
                             f"audio/L16; rate={sr}; channels=1")
            self.send_header("Connection", "close")
            self.end_headers()
            chunk = first
            try:
                while chunk is not None:
                    if isinstance(chunk, str):
                        # an error mid-stream: the body is already partial,
                        # so an early close is the only signal left
                        break
                    self.wfile.write(_pcm16(chunk))
                    self.wfile.flush()
                    chunk = req.stream_q.get(timeout=request_timeout_s)
            except (queue.Empty, BrokenPipeError, ConnectionResetError):
                req.cancelled = True    # the worker frees the slot

        def _stream_speech(self, item, max_tokens, seed, normalize,
                           voice=None) -> None:
            """Stream raw 16-bit PCM as generation progresses: the first
            audio leaves the socket about one time-to-first-audio after the
            request (prefill + a short first segment + one small vocode,
            ``TTSPipeline.stream_item``). The response has no
            Content-Length; the connection closes at the end of the audio.
            Window scheduler: streams bypass the batching worker and run one
            at a time (``--scheduler continuous`` streams concurrently)."""
            pipe = worker.pipeline
            t0 = time.perf_counter()
            with stream_gate:
                if stream_waiting[0] >= max(1, worker.max_queue):
                    metrics.add("server_rejected_busy", 1)
                    return self._json_error(
                        429, "busy: too many streams waiting (the window "
                             "scheduler streams one at a time; run "
                             "--scheduler continuous for concurrent "
                             "streams)")
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
                                       max_new_tokens=max_tokens, seed=seed,
                                       adapter=voice)
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
    """Owns the HTTP server and the scheduling worker; start()/stop().

    scheduler="window" micro-batches concurrent requests into one static
    generate call; scheduler="continuous" runs the slot pool
    (``ContinuousWorker``: ``max_batch`` slots, prompt bucket
    ``pool_base``, ``pool_max_steps`` steps a slot, joins every
    ``segment_steps``, the int8 KV cache by ``pool_kv_quant``).
    ``lora_adapters``: {name: factor tree or (tree, alpha, use_rslora)},
    the voices a request selects by name; they are registered on
    ``pipeline.engine`` and stay there after ``stop()`` (base-model
    batches pay nothing for them)."""

    def __init__(self, pipeline, host: str = "0.0.0.0", port: int = 8000,
                 max_batch: int = 8, batch_window_s: float = 0.05,
                 scheduler: str = "window", pool_base: int = 512,
                 pool_max_steps: int = 2048, segment_steps: int = 25,
                 pool_kv_quant: Optional[str] = "auto",
                 lora_adapters: Optional[Dict[str, object]] = None,
                 adapter_alpha: float = 32.0, max_queue: int = 64):
        if scheduler not in ("window", "continuous"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        # voices register once, on the pipeline's engine, before traffic:
        # the window scheduler, the overflow worker and the pool (which
        # shares its registry) all serve them
        _register_adapters(pipeline.engine.register_adapter, lora_adapters,
                           adapter_alpha)
        if scheduler == "continuous":
            self.worker = ContinuousWorker(
                pipeline, slots=max_batch, base=pool_base,
                max_steps=pool_max_steps, segment_steps=segment_steps,
                kv_quant=pool_kv_quant, max_queue=max_queue)
        else:
            self.worker = BatchingWorker(pipeline, max_batch, batch_window_s,
                                         max_queue=max_queue)
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(self.worker))
        self._thread: Optional[threading.Thread] = None

    def warmup(self, max_tokens: int = 8, timeout_s: float = 1800.0) -> None:
        """One tiny request through the scheduler before traffic arrives
        (builds the kernels, warms the allocator and the codec; on the
        continuous scheduler it runs the pool)."""
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
    import sys
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
                   help="window = micro-batched static generate; continuous "
                        "= slot pool with per-request join/leave")
    p.add_argument("--pool_base", type=int, default=512,
                   help="continuous: prompt bucket (rows)")
    p.add_argument("--pool_max_steps", type=int, default=2048,
                   help="continuous: per-slot decode capacity")
    p.add_argument("--segment_steps", type=int, default=25,
                   help="continuous: decode steps between join/evict points")
    p.add_argument("--pool_kv_quant", choices=["int8", "none", "auto"],
                   default="auto",
                   help="continuous: int8 KV cache; auto (default) turns it "
                        "on when the pool cache has >= 512 slots (the JAX "
                        "package's rule, set on a TPU)")
    p.add_argument("--lora_adapter", action="append", default=[],
                   metavar="NAME=PATH",
                   help="register a LoRA voice for per-request selection "
                        "(payload \"voice\"); PATH is a lora_factors.npz "
                        "from the finetune CLI or a peft adapter directory "
                        "(with its own adapter_config.json scale). "
                        "Repeatable")
    p.add_argument("--adapter_alpha", type=float, default=32.0,
                   help="LoRA alpha of lora_factors.npz adapters")
    p.add_argument("--max_queue", type=int, default=64,
                   help="admission-queue bound; requests beyond it get 429")
    p.add_argument("--warmup", action="store_true",
                   help="one tiny request through the scheduler before "
                        "accepting traffic")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="serve over a (data, model) mesh of processes, e.g. "
                        "1x2 under torch.distributed.run --nproc_per_node 2"
                        ": rank 0 serves HTTP, the others follow")
    p.add_argument("--attn_impl", choices=["mixed", "pallas", "xla"],
                   default=None,
                   help="attention backend (reference "
                        "--attn_implementation): mixed and pallas = the "
                        "CUDA kernels (default), xla = dense einsum "
                        "attention")
    p.add_argument("--jax_cache_dir", default=None, metavar="DIR",
                   help="where the CUDA kernels are built and loaded from "
                        "(DIR/<source hash>/; a restart reuses them); "
                        "default <repo>/build/moss_ttsd_torch, empty "
                        "string = a fresh temporary directory")
    args = p.parse_args(argv)

    from ..utils.helpers import maybe_debug_attach
    maybe_debug_attach()

    if args.jax_cache_dir is not None:
        # before any kernel is built: the pipeline builds them at first use
        from ..ops.flash_attention import set_build_root
        set_build_root(args.jax_cache_dir)
    from ..utils.convert_lora import parse_adapter_specs
    lora_adapters = parse_adapter_specs(args.lora_adapter,
                                        args.adapter_alpha, p.error)
    device = "cpu" if args.platform == "cpu" else "cuda"
    mesh = None
    if args.mesh:
        from ..cli.inference import join_mesh
        mesh = join_mesh(args.mesh, device, p.error)
    if args.tiny or not args.model_path:
        from ..cli.inference import build_tiny_pipeline
        pipeline = build_tiny_pipeline(
            device=device, quant=args.quant,
            restricted_text_head=args.restricted_text_head,
            restricted_audit_every=args.restricted_audit_every or None,
            mesh=mesh, attn_impl=args.attn_impl)
    else:
        from ..pipeline.batch import TTSPipeline
        pipeline = TTSPipeline.load(
            args.model_path, args.spt_config, args.spt_ckpt, quant=args.quant,
            restricted_text_head=args.restricted_text_head or None,
            attn_impl=args.attn_impl,
            restricted_audit_every=args.restricted_audit_every or None,
            device=device, mesh=mesh)
    channel = None
    if mesh is not None:
        import torch.distributed as dist
        from ..parallel.mirror import Channel
        channel = Channel()
        if channel.rank != 0:
            # a follower: replay the lead's engine calls until it stops
            code = channel.follow(pipeline.engine)
            dist.destroy_process_group()
            return code
        # the lead: its engine calls go through the channel, and its
        # pipeline runs alone (no lockstep codec broadcast)
        pipeline.engine = channel.lead(pipeline.engine)
        pipeline.lockstep = False
    if args.restricted_audit_every and args.scheduler == "continuous":
        print("note: --restricted_audit_every audits only the requests the "
              "window scheduler or the overflow worker serves; the pool "
              "does not run the audit", file=sys.stderr)
    server = SpeechServer(pipeline, args.host, args.port, args.max_batch,
                          args.batch_window_ms / 1000.0,
                          scheduler=args.scheduler, pool_base=args.pool_base,
                          pool_max_steps=args.pool_max_steps,
                          segment_steps=args.segment_steps,
                          pool_kv_quant=args.pool_kv_quant,
                          lora_adapters=lora_adapters or None,
                          adapter_alpha=args.adapter_alpha,
                          max_queue=args.max_queue)
    if args.warmup:
        print("warming up...", flush=True)
        server.warmup()
    server.start()
    print(f"serving on {args.host}:{server.port} (scheduler="
          f"{args.scheduler}, max_batch={args.max_batch}, "
          f"device={pipeline.device}"
          f"{'' if mesh is None else f', mesh={mesh}'})", flush=True)
    try:
        if channel is None:
            threading.Event().wait()
        while channel.failed is None:
            time.sleep(0.5)
    except KeyboardInterrupt:
        server.stop()
        if channel is not None:
            channel.stop()
            dist.destroy_process_group()
        return 0
    # a follower failed: stop serving rather than hang
    print(f"mesh failure: {channel.failed!r}", file=sys.stderr, flush=True)
    server.stop()
    return 1



if __name__ == "__main__":
    import sys
    sys.exit(main())

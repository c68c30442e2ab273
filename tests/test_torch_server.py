"""The port's speech server, end to end over real HTTP on 127.0.0.1
against the tiny pipeline on the CPU (the cases of the JAX server's
tests): the window scheduler (wav, reference-wav and streamed PCM
requests, micro-batching of concurrent requests, 400/429 where the JAX
server gives them, /v1/metrics with the pipeline's and the server's
counters, the port's client); the continuous scheduler (concurrent
requests joining the pool, the overflow worker for prompts and budgets
the pool cannot hold, concurrent streams in the pool, a pool stream equal
to stream_item, cancelled requests freeing their slots); LoRA voices on
both schedulers and on the streaming path, /v1/models listing them; the
refusals that still hold; the server CLI on the CPU; each request's spans
under its ``server.request`` root, its queue wait caused by the burst that
admitted it, and the ``server_queue_wait_s`` window."""
import base64
import json
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_torch.cli.inference import build_tiny_pipeline  # noqa: E402
from moss_ttsd_torch.serve.api_client import (SpeechAPIClient,  # noqa: E402
                                              wav_bytes_to_array)
from moss_ttsd_torch.serve.server import (BatchingWorker,  # noqa: E402
                                          ContinuousWorker, ServerBusy,
                                          SpeechServer, _Request, main,
                                          wav_array_to_bytes)
from moss_ttsd_torch.utils.profiling import metrics  # noqa: E402
from tests.test_torch_continuous import rand_adapter  # noqa: E402

LSB = 1.0 / 32768
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def server():
    pipe = build_tiny_pipeline(device="cpu")
    srv = SpeechServer(pipe, host="127.0.0.1", port=0, max_batch=4,
                       batch_window_s=0.2)
    srv.start()
    yield srv
    srv.stop()


def _base(server):
    return f"http://127.0.0.1:{server.port}"


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _status(server, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{_base(server)}/v1/audio/speech", payload)
    return e.value.code, json.loads(e.value.read())["error"]["message"]


def test_health_metrics_and_models(server):
    base = _base(server)
    assert urllib.request.urlopen(f"{base}/health").read() == b"ok"
    assert isinstance(json.loads(urllib.request.urlopen(
        f"{base}/v1/metrics").read()), dict)
    m = json.loads(urllib.request.urlopen(f"{base}/v1/models").read())
    assert m["data"] == [{"id": "moss-ttsd", "object": "model",
                          "voices": []}]


def test_speech_endpoint_returns_wav(server):
    r = _post(f"{_base(server)}/v1/audio/speech",
              {"input": "[S1]hi[S2]hello", "max_tokens": 8, "seed": 1})
    assert r.headers["Content-Type"] == "audio/wav"
    wav, sr = wav_bytes_to_array(r.read())
    assert sr == 24000
    assert len(wav) > 0 and np.isfinite(wav).all()


def test_lone_request_equals_process_batch(server):
    """A batch of one: the wav equals process_batch on the same pipeline
    within one int16 step (the server re-quantizes the pipeline's PCM16)."""
    item = {"text": "[S1]a lone request[S2]answered"}
    r = _post(f"{_base(server)}/v1/audio/speech",
              {"input": item["text"], "max_tokens": 16, "seed": 4})
    wav, _ = wav_bytes_to_array(r.read())
    _, audio = server.worker.pipeline.process_batch([item],
                                                    max_new_tokens=16, seed=4)
    ref = audio[0]["audio_data"][0]
    assert wav.shape == ref.shape
    assert float(np.abs(wav - ref).max()) <= LSB * 1.01


def test_speech_endpoint_with_reference(server):
    ref = np.sin(np.linspace(0, 440 * 2 * np.pi, 16000)).astype(
        np.float32) * 0.4
    ref_b64 = base64.b64encode(wav_array_to_bytes(ref, 16000)).decode()
    r = _post(f"{_base(server)}/v1/audio/speech",
              {"input": "[S1]one[S2]two", "max_tokens": 8,
               "references": [{"audio": ref_b64, "text": "[S1]ref"}]})
    wav, _ = wav_bytes_to_array(r.read())
    assert len(wav) > 0


def test_concurrent_requests_are_microbatched(server):
    metrics.reset()
    results = [None] * 4

    def work(i):
        r = _post(f"{_base(server)}/v1/audio/speech",
                  {"input": f"[S1]item {i}[S2]ok", "max_tokens": 8, "seed": 0})
        results[i] = r.read()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r and len(r) > 44 for r in results)
    snap = metrics.snapshot()
    assert snap.get("server_batched_requests", 0) >= 4
    assert snap.get("server_batches", 0) < 4
    # the pipeline's phases report into the same registry
    for name in ("prefill_decode_s", "vocode_s", "generated_steps"):
        assert snap.get(name, 0) > 0, name


def test_reference_client_against_local_server(server):
    client = SpeechAPIClient(f"{_base(server)}/v1", model="tiny",
                             max_retries=1)
    wav, _ = wav_bytes_to_array(client.generate_speech(
        "[S1]hello[S2]world", extra={"max_tokens": 8}))
    assert len(wav) > 0


def test_client_does_not_retry_a_400(server):
    client = SpeechAPIClient(f"{_base(server)}/v1", max_retries=3)
    with pytest.raises(RuntimeError, match="400"):
        client.generate_speech("[S1]x", extra={"max_tokens": 0})


@pytest.mark.parametrize("payload", [
    {"not_input": 1},
    {"input": "[S1]x", "max_tokens": 0},
    {"input": "[S1]x", "max_tokens": 16385},
    {"input": "[S1]x", "response_format": "mp3"},
    {"input": "[S1]x", "stream": True, "response_format": "wav"},
    {"input": "[S1]x", "references": [{"audio": "not base64 wav"}]},
])
def test_bad_request_is_400(server, payload):
    assert _status(server, payload)[0] == 400


def test_voice_without_registered_adapters_is_400(server):
    """No LoRA registry: any voice but default/base is unknown, as the JAX
    server answers with no adapter registered."""
    code, msg = _status(server, {"input": "[S1]x", "voice": "any",
                                 "max_tokens": 4})
    assert code == 400 and msg == "unknown voice 'any'; available: []"
    for voice in ("default", "base"):
        r = _post(f"{_base(server)}/v1/audio/speech",
                  {"input": "[S1]x[S2]y", "voice": voice, "max_tokens": 8})
        assert r.status == 200


def test_continuous_scheduler_and_lora_voices_are_refused():
    """Since the continuous scheduler and LoRA voices are ported, what is
    still refused: an unknown scheduler, an empty or missing adapter, a
    malformed --lora_adapter, an unknown --pool_kv_quant, a --mesh larger
    than the process group, an unknown --attn_impl and a checkpoint
    directory that is not there."""
    pipe = build_tiny_pipeline(device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        SpeechServer(pipe, host="127.0.0.1", port=0, scheduler="round")
    with pytest.raises(ValueError, match="no LoRA factors"):
        SpeechServer(pipe, host="127.0.0.1", port=0,
                     lora_adapters={"narrator": {}})
    for argv in (["--lora_adapter", "a=b"], ["--lora_adapter", "noequals"],
                 ["--scheduler", "continuous", "--pool_kv_quant", "int4"],
                 ["--mesh", "1x4"], ["--attn_impl", "flash"]):
        with pytest.raises(SystemExit):
            main(["--tiny", "--platform", "cpu", *argv])
    # --model_path loads the checkpoint (TTSPipeline.load): none is there
    with pytest.raises(FileNotFoundError, match="some/dir"):
        main(["--model_path", "some/dir", "--platform", "cpu"])


def test_submit_after_shutdown_sheds():
    worker = BatchingWorker(pipeline=None, max_batch=2, max_queue=4)
    worker.shutdown()
    req = _Request({"text": "[S1]hi[S2]ok"}, 4, 0, False)
    with pytest.raises(ServerBusy, match="shutting down"):
        worker.submit(req)
    assert not worker._queue


def _stream(server, payload):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=300)
    conn.request("POST", "/v1/audio/speech", json.dumps(payload),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    ct = r.headers["Content-Type"]
    reads = []
    while True:
        b = r.read(8192)
        if not b:
            break
        reads.append(b)
    conn.close()
    return ct, b"".join(reads)


def test_streaming_endpoint_emits_pcm_chunks(server):
    """stream=true: raw PCM16 over a close-delimited response, equal to
    stream_item's chunks within one int16 step; the TTFA is observed."""
    before = metrics.get("server_ttfa_s_observed")
    ct, pcm = _stream(server, {"input": "[S1]streaming hello[S2]indeed",
                               "stream": True, "max_tokens": 24, "seed": 3})
    assert ct == "audio/L16; rate=24000; channels=1"
    assert len(pcm) > 0 and len(pcm) % 2 == 0
    wav = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0
    ref = np.concatenate([c for c, _ in server.worker.pipeline.stream_item(
        {"text": "[S1]streaming hello[S2]indeed"}, max_new_tokens=24,
        seed=3)])
    assert wav.shape == ref.shape and np.isfinite(wav).all()
    assert float(np.abs(wav - ref).max()) <= LSB * 1.01
    assert metrics.get("server_ttfa_s_observed") == before + 1


def test_streaming_client_helper(server):
    client = SpeechAPIClient(f"{_base(server)}/v1", model="tiny",
                             max_retries=1)
    got = list(client.stream_speech("[S1]chunk me[S2]ok",
                                    extra={"max_tokens": 16, "seed": 2},
                                    chunk_samples=512))
    assert got, "no chunks streamed"
    total = np.concatenate([c for c, _ in got])
    assert total.size > 0 and np.isfinite(total).all()
    assert all(sr == 24000 for _, sr in got)


def test_queue_bound_returns_429(server):
    old = server.worker.max_queue
    server.worker.max_queue = 0
    try:
        assert _status(server, {"input": "[S1]busy[S2]ok",
                                "max_tokens": 8})[0] == 429
    finally:
        server.worker.max_queue = old
    r = _post(f"{_base(server)}/v1/audio/speech",
              {"input": "[S1]ok now[S2]yes", "max_tokens": 8})
    assert r.status == 200


def test_request_latency_percentiles_exported(server):
    base = _base(server)
    _post(f"{base}/v1/audio/speech",
          {"input": "[S1]latency sample[S2]ok", "max_tokens": 8}).read()
    m = json.loads(urllib.request.urlopen(f"{base}/v1/metrics").read())
    assert m.get("server_request_latency_s_observed", 0) >= 1
    assert m.get("server_request_latency_s_p50", 0) > 0
    assert m["server_request_latency_s_p95"] >= \
        m["server_request_latency_s_p50"]
    assert "server_queue_depth" in m


def test_window_cancel_skips_queued_request(server):
    worker = BatchingWorker(server.worker.pipeline, max_batch=2,
                            batch_window_s=0.5)
    try:
        dead = _Request({"text": "[S1]never run[S2]ok"}, 8, 0, False)
        dead.cancelled = True
        live = _Request({"text": "[S1]do run[S2]ok"}, 8, 0, False)
        worker.submit(dead)
        worker.submit(live)
        assert live.event.wait(300)
        assert live.error is None and live.wav_bytes
        assert not dead.event.is_set()
    finally:
        worker.shutdown()


def test_warmup_roundtrip(server):
    server.warmup(max_tokens=8, timeout_s=300)


def test_server_cli_serves_on_the_cpu():
    """``python -m moss_ttsd_torch.serve.server --tiny --platform cpu``:
    the process prints its port and answers /health."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "moss_ttsd_torch.serve.server", "--tiny",
         "--platform", "cpu", "--host", "127.0.0.1", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on 127.0.0.1:"), line
        port = int(line.split(":")[1].split()[0])
        assert urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=60).read() == b"ok"
    finally:
        proc.kill()
        proc.wait(timeout=30)


# -- the continuous scheduler ------------------------------------------------

POOL = dict(max_batch=2, scheduler="continuous", pool_base=192,
            pool_max_steps=32, segment_steps=4)


@pytest.fixture(scope="module")
def continuous_server():
    pipe = build_tiny_pipeline(device="cpu")
    srv = SpeechServer(pipe, host="127.0.0.1", port=0, **POOL)
    srv.start()
    yield srv
    srv.stop()


def _adapter(pipe, seed):
    return rand_adapter(pipe.lm_cfg, seed, rank=2)


def _pcm(server, payload):
    ct, pcm = _stream(server, payload)
    assert ct == "audio/L16; rate=24000; channels=1"
    assert len(pcm) > 0 and len(pcm) % 2 == 0
    return np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0


def test_continuous_scheduler_serves_requests(continuous_server):
    """Three concurrent requests with different budgets each get a finite
    wav through the pool (the auto KV policy turns the int8 cache off
    below 512 slots)."""
    assert continuous_server.worker.cb.cfg.kv_quant == "none"
    metrics.reset()
    results = [None] * 3

    def work(i, max_tokens):
        results[i] = _post(f"{_base(continuous_server)}/v1/audio/speech",
                           {"input": f"[S1]req {i}[S2]ok",
                            "max_tokens": max_tokens}).read()

    threads = [threading.Thread(target=work, args=(i, mt))
               for i, mt in enumerate([10, 24, 16])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for body in results:
        wav, _ = wav_bytes_to_array(body)
        assert len(wav) > 0 and np.isfinite(wav).all()
    snap = metrics.snapshot()
    assert snap.get("server_continuous_joins", 0) >= 3
    assert snap.get("server_continuous_segments", 0) >= 1
    assert "server_pool_active_slots" in snap


def test_continuous_request_equals_pool_and_process_batch(continuous_server):
    """A lone pool request's wav equals process_batch over the same item
    (the pool row's tokens are the static engine's; the codec is the
    same) within one int16 step."""
    item = {"text": "[S1]a pooled request[S2]answered"}
    r = _post(f"{_base(continuous_server)}/v1/audio/speech",
              {"input": item["text"], "max_tokens": 16, "seed": 4})
    wav, _ = wav_bytes_to_array(r.read())
    pipe = continuous_server.worker.pipeline
    _, audio = pipe.process_batch([item], max_new_tokens=16, seed=4)
    ref = audio[0]["audio_data"][0]
    assert wav.shape == ref.shape
    assert float(np.abs(wav - ref).max()) <= LSB * 1.01


def test_continuous_scheduler_routes_oversized_prompt(continuous_server):
    """A prompt over the pool bucket rides the overflow worker."""
    before = metrics.snapshot().get("server_routed_overflow", 0)
    r = _post(f"{_base(continuous_server)}/v1/audio/speech",
              {"input": "[S1]" + "long words here " * 40 + "[S2]ok",
               "max_tokens": 16})
    wav, _ = wav_bytes_to_array(r.read())
    assert len(wav) > 0 and np.isfinite(wav).all()
    assert metrics.snapshot().get("server_routed_overflow", 0) == before + 1


def test_continuous_scheduler_routes_over_budget_request(continuous_server):
    """max_tokens over the pool's per-slot budget goes to the overflow
    worker, which reports on its own queue gauge."""
    before = metrics.snapshot().get("server_routed_overflow", 0)
    r = _post(f"{_base(continuous_server)}/v1/audio/speech",
              {"input": "[S1]long request[S2]ok", "max_tokens": 48})
    wav, _ = wav_bytes_to_array(r.read())
    assert len(wav) > 0 and np.isfinite(wav).all()
    assert metrics.snapshot().get("server_routed_overflow", 0) == before + 1
    assert "server_overflow_queue_depth" in metrics.snapshot()
    assert continuous_server.worker._overflow.queue_gauge == \
        "server_overflow_queue_depth"


def test_overflow_busy_rejection_not_counted_as_routed(continuous_server):
    worker = continuous_server.worker
    saved = worker._overflow

    class _Busy:
        queue_gauge = "server_overflow_queue_depth"

        def submit(self, req):
            raise ServerBusy("queue full (0 waiting)")

        def shutdown(self):
            pass

    worker._overflow = _Busy()
    try:
        before = metrics.snapshot().get("server_routed_overflow", 0)
        req = _Request({"text": "[S1]hi[S2]ok"}, 999, 0, False)
        with pytest.raises(ServerBusy):
            worker._route_overflow(req)
        assert metrics.snapshot().get("server_routed_overflow", 0) == before
    finally:
        worker._overflow = saved


def test_route_overflow_rejects_after_shutdown_flag(continuous_server):
    worker = continuous_server.worker
    saved_worker, saved_flag = worker._overflow, worker._overflow_closed
    worker._overflow, worker._overflow_closed = None, True
    try:
        req = _Request({"text": "[S1]hi[S2]ok"}, 999, 0, False)
        with pytest.raises(ServerBusy):
            worker._route_overflow(req)
        assert worker._overflow is None
    finally:
        worker._overflow, worker._overflow_closed = saved_worker, saved_flag


def test_continuous_stream_over_budget_is_400(continuous_server):
    """A stream cannot ride the batched fallback: 400, with the reason."""
    code, msg = _status(continuous_server, {"input": "[S1]hi[S2]ok",
                                            "max_tokens": 48,
                                            "stream": True})
    assert code == 400 and "pool capacity" in msg


def test_continuous_streaming_pcm(continuous_server):
    wav = _pcm(continuous_server, {"input": "[S1]pool stream[S2]ok",
                                   "stream": True, "max_tokens": 20,
                                   "seed": 2})
    assert wav.size > 100 and np.isfinite(wav).all()


def test_continuous_concurrent_streams(continuous_server):
    """Two streams decode in the pool at once while a non-streamed request
    joins around them."""
    metrics.reset()
    out = [None] * 3

    def stream(i):
        out[i] = _pcm(continuous_server, {"input": f"[S1]stream {i}[S2]go",
                                          "stream": True, "max_tokens": 20,
                                          "seed": i})

    def plain():
        out[2] = _post(f"{_base(continuous_server)}/v1/audio/speech",
                       {"input": "[S1]plain rider[S2]ok",
                        "max_tokens": 12}).read()

    threads = [threading.Thread(target=stream, args=(0,)),
               threading.Thread(target=stream, args=(1,)),
               threading.Thread(target=plain)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None and len(o) for o in out)
    assert len(wav_bytes_to_array(out[2])[0]) > 0
    snap = metrics.snapshot()
    assert snap.get("server_streamed", 0) == 2
    assert snap.get("server_ttfa_s_observed", 0) == 2


def test_warmup_roundtrip_continuous(continuous_server):
    continuous_server.warmup(max_tokens=8, timeout_s=300)


def _worker(**kw):
    return ContinuousWorker(build_tiny_pipeline(device="cpu"), slots=2,
                            base=192, segment_steps=4, **kw)


def _drain(req):
    chunks = []
    while True:
        c = req.stream_q.get(timeout=300)
        if c is None:
            return chunks
        assert not isinstance(c, str), c
        chunks.append(c)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_pool_stream_matches_stream_item(kv_quant):
    """Pool streaming is byte-identical to stream_item fed at the same
    boundaries: the pool row repeats the isolated engine's tokens and both
    vocode through StreamVocoder (with the int8 KV cache the reference is
    an int8-KV pipeline engine)."""
    import queue
    worker = _worker(max_steps=32, kv_quant=kv_quant)
    try:
        item = {"text": "[S1]pool stream parity[S2]ok"}
        req = _Request(item, 20, 5, False)
        req.stream_q = queue.Queue()
        worker.submit(req)
        chunks = _drain(req)
    finally:
        worker.shutdown()
    pipe = worker.pipeline
    if kv_quant == "int8":
        import dataclasses
        from moss_ttsd_torch.decode.engine import GenerationEngine
        eng = pipe.engine
        pipe.engine = GenerationEngine(
            dataclasses.replace(eng.cfg, kv_quant="int8"), eng.model,
            eng.sampling, bucket=eng.bucket, device="cpu")
    ref = [c for c, _ in pipe.stream_item(item, max_new_tokens=20, seed=5,
                                          chunk_steps=4,
                                          first_chunk_steps=4)]
    assert chunks and ref
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  np.concatenate(ref))


@pytest.mark.parametrize("stream", [True, False])
def test_pool_cancel_frees_slot(stream):
    """A cancelled request (a stream whose client left, or a request whose
    handler timed out) frees its slot at the next segment boundary, and the
    pool keeps serving."""
    import queue
    import time
    worker = _worker(max_steps=64)
    try:
        req = _Request({"text": "[S1]cancel me please[S2]ok"}, 60, 0, False)
        if stream:
            req.stream_q = queue.Queue()
        else:
            # the handler gives up once the request holds its slot: cancel
            # from the worker thread as it joins, since the tiny request
            # can run to its end between two polls of this thread
            join, joined = worker._join, threading.Event()

            def join_then_cancel(r, slot):
                join(r, slot)
                if r is req:
                    r.cancelled = True
                    joined.set()

            worker._join = join_then_cancel
        before = metrics.get("server_cancelled")
        worker.submit(req)
        if stream:
            assert not isinstance(req.stream_q.get(timeout=300), str)
        else:
            assert joined.wait(120)
        req.cancelled = True
        deadline = time.time() + 120
        while time.time() < deadline and worker.cb.free_slots < 2:
            time.sleep(0.05)
        assert worker.cb.free_slots == 2
        assert metrics.get("server_cancelled") == before + 1
        req2 = _Request({"text": "[S1]after cancel[S2]ok"}, 8, 0, False)
        worker.submit(req2)
        assert req2.event.wait(300)
        assert req2.error is None and req2.wav_bytes
    finally:
        worker.shutdown()


# -- LoRA voices ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lora_server():
    """Continuous server with one registered LoRA voice."""
    pipe = build_tiny_pipeline(device="cpu")
    srv = SpeechServer(pipe, host="127.0.0.1", port=0,
                       lora_adapters={"narrator": _adapter(pipe, 3)}, **POOL)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def lora_server_window():
    pipe = build_tiny_pipeline(device="cpu")
    srv = SpeechServer(pipe, host="127.0.0.1", port=0, max_batch=2,
                       batch_window_s=0.1,
                       lora_adapters={"narrator": (_adapter(pipe, 4), 16.0,
                                                   False)})
    srv.start()
    yield srv
    srv.stop()


def test_voice_adapter_request(lora_server):
    """A voice reaches its adapter: the pool's wav equals process_batch
    with that adapter (and differs from the base model's); "default"
    serves the base model."""
    item = {"text": "[S1]voice test[S2]ok"}
    pipe = lora_server.worker.pipeline
    r = _post(f"{_base(lora_server)}/v1/audio/speech",
              {"input": item["text"], "max_tokens": 10, "seed": 1,
               "voice": "narrator"})
    wav, _ = wav_bytes_to_array(r.read())
    _, voiced = pipe.process_batch([item], max_new_tokens=10, seed=1,
                                   adapter="narrator")
    _, plain = pipe.process_batch([item], max_new_tokens=10, seed=1)
    ref = voiced[0]["audio_data"][0]
    assert wav.shape == ref.shape
    assert float(np.abs(wav - ref).max()) <= LSB * 1.01
    base = plain[0]["audio_data"][0]
    assert base.shape != ref.shape or not np.array_equal(base, ref)
    r = _post(f"{_base(lora_server)}/v1/audio/speech",
              {"input": "[S1]plain[S2]ok", "max_tokens": 10,
               "voice": "default"})
    assert len(wav_bytes_to_array(r.read())[0]) > 0


def test_voice_unknown_is_400(lora_server):
    code, msg = _status(lora_server, {"input": "[S1]x", "voice": "whoami",
                                      "max_tokens": 4})
    assert code == 400 and msg == ("unknown voice 'whoami'; available: "
                                   "['narrator']")


def test_models_endpoint_lists_voices(lora_server):
    m = json.loads(urllib.request.urlopen(
        f"{_base(lora_server)}/v1/models").read())
    assert m["data"] == [{"id": "moss-ttsd", "object": "model",
                          "voices": ["narrator"]}]
    # one registry: the pool serves the pipeline engine's voices
    worker = lora_server.worker
    assert worker.cb.lora is worker.pipeline.engine.lora


def test_voice_on_window_scheduler_and_streaming(lora_server_window):
    """Voices on the window scheduler (per-row adapters in one batch, the
    peft-style (tree, alpha, rslora) spec) and on its streaming path; the
    port's client sends voice=."""
    r = _post(f"{_base(lora_server_window)}/v1/audio/speech",
              {"input": "[S1]windowed voice[S2]yes", "max_tokens": 10,
               "voice": "narrator"})
    wav, _ = wav_bytes_to_array(r.read())
    assert len(wav) > 0 and np.isfinite(wav).all()
    pipe = lora_server_window.worker.pipeline
    got = _pcm(lora_server_window, {"input": "[S1]stream with voice[S2]go",
                                    "stream": True, "max_tokens": 20,
                                    "voice": "narrator", "seed": 3})
    ref = np.concatenate([c for c, _ in pipe.stream_item(
        {"text": "[S1]stream with voice[S2]go"}, max_new_tokens=20, seed=3,
        adapter="narrator")])
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= LSB * 1.01
    client = SpeechAPIClient(f"{_base(lora_server_window)}/v1",
                             max_retries=1)
    w, _ = wav_bytes_to_array(client.generate_speech(
        "[S1]client voice[S2]ok", extra={"max_tokens": 8},
        voice="narrator"))
    assert len(w) > 0
    with pytest.raises(RuntimeError, match="400"):
        client.generate_speech("[S1]x", extra={"max_tokens": 8},
                               voice="nobody")


def test_continuous_server_cli_serves_a_voice(tmp_path):
    """``--scheduler continuous --lora_adapter narrator=<npz>`` on the CPU:
    the process prints its scheduler and port and lists the voice."""
    from moss_ttsd_tpu.core.checkpoint import save_pytree
    pipe = build_tiny_pipeline(device="cpu")
    tree = {"params": {"layers": {"block": {
        t.split("/")[-2]: {"lora_a": ab["a"], "lora_b": ab["b"]}
        for t, ab in _adapter(pipe, 5).items()}}}}
    npz = str(tmp_path / "lora_factors.npz")
    save_pytree(npz, tree)
    proc = subprocess.Popen(
        [sys.executable, "-m", "moss_ttsd_torch.serve.server", "--tiny",
         "--platform", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--scheduler", "continuous", "--pool_base", "192",
         "--pool_max_steps", "32", "--lora_adapter", f"narrator={npz}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on 127.0.0.1:"), line
        assert "scheduler=continuous" in line
        port = int(line.split(":")[1].split()[0])
        m = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/models", timeout=60).read())
        assert m["data"][0]["voices"] == ["narrator"]
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_server_main_attn_impl_xla_and_kernel_build_root(monkeypatch,
                                                         tmp_path):
    """``serve.server main --tiny --platform cpu --attn_impl xla
    --jax_cache_dir DIR`` in this process: the engine it serves runs the
    dense backend and answers a request with the wav of the same tiny
    pipeline's ``process_batch``; DIR became the kernels' build root before
    the pipeline was built, and nothing was built into it on the CPU."""
    import types
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.serve import server as srv
    started, replies, roots = [], [], []
    orig_start = srv.SpeechServer.start

    def start(self):
        orig_start(self)
        started.append(self)

    from moss_ttsd_torch.cli import inference as inf
    real_build = inf.build_tiny_pipeline

    def build(**kw):
        roots.append(fa.build_root())
        return real_build(**kw)

    test_thread = threading.get_ident()

    class OneRequest(threading.Event):
        """main's wait (in this thread): one request, then a ^C."""
        def wait(self, timeout=None):
            if threading.get_ident() != test_thread:
                return super().wait(timeout)
            replies.append(_post(
                f"http://127.0.0.1:{started[0].port}/v1/audio/speech",
                {"input": "[S1]hello there[S2]hi", "seed": 0,
                 "max_tokens": 16}).read())
            raise KeyboardInterrupt

    monkeypatch.setattr(inf, "build_tiny_pipeline", build)
    monkeypatch.setattr(srv.SpeechServer, "start", start)
    monkeypatch.setattr(srv, "threading", types.SimpleNamespace(
        **{**vars(threading), "Event": OneRequest}))
    root = tmp_path / "kernels"
    try:
        assert main(["--tiny", "--platform", "cpu", "--host", "127.0.0.1",
                     "--port", "0", "--attn_impl", "xla",
                     "--jax_cache_dir", str(root)]) == 0
        assert roots == [root.resolve()] and fa.build_root() == roots[0]
    finally:
        fa.set_build_root(None)
    assert not root.exists()
    pipe = started[0].worker.pipeline
    assert pipe.lm_cfg.attn_impl == pipe.engine.cfg.attn_impl == "xla"
    wav, sr = wav_bytes_to_array(replies[0])
    _, audio = real_build(device="cpu", attn_impl="xla").process_batch(
        [{"text": "[S1]hello there[S2]hi"}], max_new_tokens=16, seed=0)
    ref = audio[0]["audio_data"][0]
    assert sr == audio[0]["sample_rate"] and wav.shape == ref.shape
    assert float(np.abs(wav - ref).max()) <= LSB * 1.01


def _request_roots():
    return [r for r in metrics.span_roots("server.request")
            if "server.queue" in r["spans"]]


def test_window_request_spans_and_queue_wait(server):
    """A window-scheduler request: one ``server.request`` root holding its
    ``server.queue`` span; the wait is a sample of ``server_queue_wait_s``
    on /v1/metrics, beside the latency window."""
    metrics.reset()
    base = _base(server)
    _post(f"{base}/v1/audio/speech",
          {"input": "[S1]queue sample[S2]ok", "max_tokens": 8}).read()
    m = json.loads(urllib.request.urlopen(f"{base}/v1/metrics").read())
    assert m["server_queue_wait_s_observed"] == 1
    assert 0 <= m["server_queue_wait_s_p50"] <= \
        m["server_request_latency_s_p50"]
    (root,) = _request_roots()
    assert root["attrs"] == {"stream": 0}
    assert root["spans"]["server.queue"]["s"] == pytest.approx(
        m["server_queue_wait_s_p50"])
    assert m["pipeline.batch_calls"] == 1 and m["engine.step_calls"] >= 1


def test_continuous_request_spans_name_their_admitting_burst(
        continuous_server):
    """A pool request's ``server.queue`` span is caused by the
    ``pool.admit`` of the burst that took it, and lies under the request's
    root with its ``server.prepare``; a stream's chunks lie there too."""
    metrics.reset()
    base = _base(continuous_server)
    _post(f"{base}/v1/audio/speech",
          {"input": "[S1]pool spans[S2]ok", "max_tokens": 12}).read()
    _pcm(continuous_server, {"input": "[S1]pool stream spans[S2]ok",
                             "stream": True, "max_tokens": 20, "seed": 2})
    m = json.loads(urllib.request.urlopen(f"{base}/v1/metrics").read())
    assert m["server_queue_wait_s_observed"] == 2
    roots = _request_roots()
    assert sorted(r["attrs"]["stream"] for r in roots) == [0, 1]
    ring = metrics.recent_spans()
    admits = {s["id"]: s for s in ring if s["name"] == "pool.admit"}
    queues = [s for s in ring if s["name"] == "server.queue"]
    assert len(queues) == 2
    for q in queues:
        assert q["parent"] in admits
        assert admits[q["parent"]]["attrs"]["rows"] >= 1
        assert q["t1_ns"] <= admits[q["parent"]]["t0_ns"]
    for r in roots:
        assert r["spans"]["server.prepare"]["calls"] == 1
    stream = next(r for r in roots if r["attrs"]["stream"])
    assert stream["spans"]["stream.chunk"]["calls"] >= 1
    assert m["pool.step_calls"] >= 1 and m["pool.segment_calls"] >= 1
    assert m["pool.sync_calls"] >= m["pool.step_calls"]
    assert m["pool.progress_calls"] >= 1

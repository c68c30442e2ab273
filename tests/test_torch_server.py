"""The port's window-scheduler speech server, end to end over real HTTP on
127.0.0.1 against the tiny pipeline on the CPU (the cases of the JAX
server's tests for this scheduler): wav, reference-wav and streamed PCM
requests, micro-batching of concurrent requests, 400/429 where the JAX
server gives them, /v1/metrics with the pipeline's and the server's
counters, the port's client; the continuous scheduler and LoRA voices are
refused; the server CLI on the CPU."""
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
                                          ServerBusy, SpeechServer, _Request,
                                          main, wav_array_to_bytes)
from moss_ttsd_torch.utils.profiling import metrics  # noqa: E402

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
    pipe = build_tiny_pipeline(device="cpu")
    with pytest.raises(ValueError, match="A10b"):
        SpeechServer(pipe, host="127.0.0.1", port=0, scheduler="continuous")
    with pytest.raises(ValueError, match="A10b"):
        SpeechServer(pipe, host="127.0.0.1", port=0,
                     lora_adapters={"narrator": {}})
    with pytest.raises(ValueError, match="unknown scheduler"):
        SpeechServer(pipe, host="127.0.0.1", port=0, scheduler="round")
    for argv in (["--scheduler", "continuous"], ["--lora_adapter", "a=b"],
                 ["--mesh", "1x4"], ["--attn_impl", "xla"],
                 ["--jax_cache_dir", "x"]):
        with pytest.raises(SystemExit):
            main(["--tiny", "--platform", "cpu", *argv])
    with pytest.raises(SystemExit, match="not yet ported"):
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

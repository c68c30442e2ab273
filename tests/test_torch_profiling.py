"""The port's profiling utilities (``moss_ttsd_torch/utils/profiling.py``):
the ``Metrics`` cases of the JAX package's tests, the pipeline reporting
into the process-wide registry as the JAX pipeline does, the sanitizer,
``trace`` writing a Chrome trace, and the inference CLI's --profile_dir on
the CPU."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_torch.utils.profiling import (Metrics, annotate,  # noqa: E402
                                             assert_finite, metrics,
                                             sanitize, start_profiler_server,
                                             trace)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_metrics_counters_and_timers():
    m = Metrics()
    m.add("x", 2)
    m.add("x", 3)
    with m.timer("phase"):
        pass
    snap = m.snapshot()
    assert snap["x"] == 5
    assert snap["phase_calls"] == 1
    assert snap["phase_s"] >= 0
    m.set("gauge", 4)
    m.set("gauge", 2)
    assert m.get("gauge") == 2 and m.get("absent") == 0.0
    assert json.loads(m.dump_json())["x"] == 5
    m.reset()
    assert m.snapshot() == {}


def test_metrics_observe_percentiles():
    m = Metrics()
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        m.observe("lat", v)
    snap = m.snapshot()
    assert snap["lat_observed"] == 5
    assert snap["lat_p50"] == 3.0
    assert snap["lat_p95"] == 100.0
    m.reset()
    assert "lat_p50" not in m.snapshot()


def test_metrics_observe_window_bound():
    m = Metrics()
    for v in range(2000):
        m.observe("x", float(v), window=100)
    snap = m.snapshot()
    assert snap["x_observed"] == 2000
    assert snap["x_p50"] >= 1900


def test_metrics_match_jax_registry():
    """The same calls on both registries give the same snapshot."""
    from moss_ttsd_tpu.utils.profiling import Metrics as JMetrics
    values = np.random.default_rng(0).random(37)
    ours, theirs = Metrics(), JMetrics()
    for m in (ours, theirs):
        for v in values:
            m.observe("lat", float(v), window=16)
        m.add("n", 3)
        m.set("g", 1.5)
    assert ours.snapshot() == theirs.snapshot()


def test_pipeline_reports_into_metrics():
    """process_batch adds the phase times and step counts the JAX pipeline
    adds (tokenize_s with a prompt voice; tokenize_cache_hits on a repeat),
    and the restricted-head audit counters."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline
    pipe = build_tiny_pipeline(device="cpu", restricted_text_head=True,
                               restricted_audit_every=2)
    item = json.loads((ROOT / "examples" / "examples_single_reference.jsonl")
                      .read_text().splitlines()[0])
    metrics.reset()
    pipe.process_batch([item], max_new_tokens=12)
    snap = metrics.snapshot()
    assert snap["generated_steps"] == pipe.timings.generated_steps > 0
    for phase in ("tokenize_s", "prefill_decode_s", "vocode_s"):
        assert snap[phase] == pytest.approx(getattr(pipe.timings, phase))
        assert snap[phase] > 0
    assert snap["restricted_audit_rows"] > 0
    assert "restricted_audit_flagged" in snap
    pipe.process_batch([item], max_new_tokens=4)
    assert metrics.get("tokenize_cache_hits") == 1


def test_sanitize_removes_nan_inf():
    y = sanitize(torch.tensor([1.0, float("nan"), float("inf"),
                               -float("inf")]))
    assert bool(torch.isfinite(y).all()) and y[0] == 1.0 and y[1] == 0.0
    assert float(y[2]) == pytest.approx(0.9 * torch.finfo(torch.float32).max)
    z = sanitize(torch.tensor([5.0, -7.0]), clamp=2.0)
    assert z.tolist() == [2.0, -2.0]
    assert sanitize(torch.tensor([3, -9])).tolist() == [3, -9]


def test_assert_finite_raises_at_once():
    x = torch.ones(4)
    assert assert_finite(x, "x") is x
    with pytest.raises(FloatingPointError, match="non-finite values in h"):
        assert_finite(torch.tensor([1.0, float("nan")]), "h")


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with trace(str(d)):
        with annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(d.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)


def test_start_profiler_server_has_no_counterpart():
    with pytest.raises(NotImplementedError, match="no PyTorch counterpart"):
        start_profiler_server(9999)


def test_cli_profile_dir_writes_trace_and_wav(tmp_path):
    from moss_ttsd_torch.cli.inference import main
    prof = tmp_path / "prof"
    rc = main(["--jsonl", str(ROOT / "examples" / "examples_only_text.jsonl"),
               "--tiny", "--platform", "cpu", "--max_new_tokens", "8",
               "--output_dir", str(tmp_path), "--profile_dir", str(prof)])
    assert rc == 0
    assert len(list(prof.glob("*.json"))) == 1
    assert sorted(p.name for p in tmp_path.glob("*.wav")) == [
        "output_0.wav", "output_1.wav"]
    with pytest.raises(SystemExit):
        main(["--tiny", "--platform", "cpu", "--profiler_port", "9999"])


def test_metrics_under_concurrent_writers():
    """The server's HTTP threads, its worker and the pipeline share one
    registry: 16 threads adding and observing at a tiny switch interval
    lose no update."""
    import sys
    import threading
    m = Metrics()
    n, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for k in range(per):
                m.add("count", 1)
                m.observe("lat", float(k), window=64)
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = m.snapshot()
    assert snap["count"] == n * per
    assert snap["lat_observed"] == n * per

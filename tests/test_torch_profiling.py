"""The port's profiling utilities (``moss_ttsd_torch/utils/profiling.py``):
the ``Metrics`` cases of the JAX package's tests, the pipeline reporting
into the process-wide registry as the JAX pipeline does, the sanitizer,
``trace`` writing a Chrome trace, and the inference CLI's --profile_dir on
the CPU; the spans (ids, parents, causes and roots, self time, the bounded
roots and ring, concurrent writers, the profiler labels only inside a
session), where the engine and the stream vocoder open them, and the
benchmark's readers of them (``ttsd_bench/spans.py``)."""
import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_torch.utils import profiling  # noqa: E402
from moss_ttsd_torch.utils.profiling import (Metrics,  # noqa: E402
                                             assert_finite, metrics,
                                             sanitize, trace)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_metrics_counters_and_timers():
    m = Metrics()
    m.add("x", 2)
    m.add("x", 3)
    with m.span("phase"):
        with m.span("inner"):
            time.sleep(0.01)
    snap = m.snapshot()
    assert snap["x"] == 5
    assert snap["phase_calls"] == snap["inner_calls"] == 1
    assert snap["phase_s"] >= snap["inner_s"] >= 0.01
    assert snap["phase_self_s"] == pytest.approx(
        snap["phase_s"] - snap["inner_s"])
    assert m.get("phase_calls") == 1
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
    """A span inside ``trace`` is a labelled interval of the Chrome trace,
    over the operations it issued."""
    d = tmp_path / "trace"
    with trace(str(d)):
        with metrics.span("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(d.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    label = [e for e in events if e.get("name") == "matmul"]
    assert len(label) == 1 and label[0]["cat"] == "user_annotation"
    mm = [e for e in events if e.get("name") == "aten::matmul"]
    assert mm and label[0]["ts"] <= mm[0]["ts"] and (
        mm[0]["ts"] + mm[0]["dur"] <= label[0]["ts"] + label[0]["dur"])


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


# -- spans -------------------------------------------------------------------

def _ring(m):
    return {s["name"]: s for s in m.recent_spans()}


def test_span_ids_parents_causes_and_roots():
    """A span's parent is the enclosing span on its thread, or the cause
    given; its root is the parent's root, or the root given; one with
    neither is a root. A decorator opens a fresh span each call."""
    m = Metrics()
    with m.span("batch", rows=2) as batch:
        with m.span("step") as step:
            with m.span("sample"):
                pass
        m.record_span("chunk", 10, 30, feeds_late=1)
    with m.span("admit") as admit:             # a root of its own
        pass
    caused = {}

    def other_thread():
        # on another thread: no enclosing span there; the cause and the
        # root are named
        with m.span("prepare", parent=batch):
            pass
        m.record_span("queue", 5, 25, parent=admit, root=batch)
        with m.span("lone") as lone:
            caused["lone"] = lone
    t = threading.Thread(target=other_thread)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()

    @m.span("call", k=3)
    def f(x):
        return x + 1
    assert f(1) == 2 and f(2) == 3

    r = _ring(m)
    assert batch.root == batch.id and batch.parent == 0
    assert r["step"]["parent"] == batch.id
    assert r["sample"]["parent"] == step.id
    assert {r[n]["root"] for n in ("step", "sample", "chunk", "prepare",
                                   "queue")} == {batch.id}
    assert r["chunk"]["parent"] == batch.id
    assert (r["chunk"]["t0_ns"], r["chunk"]["t1_ns"]) == (10, 30)
    assert r["chunk"]["attrs"] == {"feeds_late": 1}
    assert admit.root == admit.id and admit.parent == 0
    assert r["queue"]["parent"] == admit.id
    assert r["prepare"]["parent"] == batch.id
    assert caused["lone"].root == caused["lone"].id
    calls = [s for s in m.recent_spans() if s["name"] == "call"]
    assert len(calls) == 2 and calls[0]["id"] != calls[1]["id"]
    assert all(s["attrs"] == {"k": 3} and s["root"] == s["id"]
               for s in calls)
    roots = m.span_roots()
    assert [x["name"] for x in roots] == ["batch", "admit", "lone", "call",
                                          "call"]
    assert roots[0]["attrs"] == {"rows": 2}
    assert set(roots[0]["spans"]) == {"batch", "step", "sample", "chunk",
                                      "prepare", "queue"}
    assert roots[0]["spans"]["queue"] == {"calls": 1, "s": 20e-9,
                                          "self_s": 20e-9}
    assert m.span_roots("admit")[0]["spans"]["admit"]["calls"] == 1


def test_span_self_time_and_totals():
    """Self time is a span's time less its children's on the thread; the
    per-name counters and the root's totals agree with the ring."""
    m = Metrics()
    with m.span("root"):
        for _ in range(3):
            with m.span("step"):
                time.sleep(0.002)
                with m.span("sync"):
                    time.sleep(0.004)
    snap = m.snapshot()
    ring = m.recent_spans()
    dur = {n: sum(s["t1_ns"] - s["t0_ns"] for s in ring if s["name"] == n)
           * 1e-9 for n in ("root", "step", "sync")}
    assert snap["step_calls"] == snap["sync_calls"] == 3
    assert snap["step_s"] == pytest.approx(dur["step"], abs=1e-12)
    assert snap["step_self_s"] == pytest.approx(dur["step"] - dur["sync"],
                                                abs=1e-12)
    assert snap["root_self_s"] == pytest.approx(dur["root"] - dur["step"],
                                                abs=1e-12)
    assert snap["sync_self_s"] == snap["sync_s"] >= 0.012
    tot = m.span_roots("root")[0]["spans"]
    assert tot["step"]["s"] == pytest.approx(snap["step_s"])
    assert tot["sync"]["calls"] == 3
    m.reset()
    assert m.snapshot() == {} and m.span_roots() == [] \
        and m.recent_spans() == []


def test_span_roots_and_ring_are_bounded(monkeypatch):
    monkeypatch.setattr(Metrics, "SPAN_RING", 8)
    monkeypatch.setattr(Metrics, "SPAN_ROOTS", 3)
    m = Metrics()
    for i in range(5):
        with m.span("batch", i=i):
            for _ in range(4):
                with m.span("step"):
                    pass
    roots = m.span_roots("batch")
    assert [r["attrs"]["i"] for r in roots] == [2, 3, 4]
    assert all(r["spans"]["step"]["calls"] == 4 for r in roots)
    ring = m.recent_spans()
    assert len(ring) == 8 and ring[-1]["name"] == "batch"
    assert m.get("step_calls") == 20 and m.get("batch_calls") == 5


def test_spans_under_concurrent_writers():
    """16 threads open nested spans at a tiny switch interval: no call is
    lost from the per-name totals or from any root's totals."""
    m = Metrics()
    n, per = 16, 300
    roots = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with m.span("root") as r:
                roots[i] = r.id
                for _ in range(per):
                    with m.span("step"):
                        with m.span("sync"):
                            pass
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = m.snapshot()
    assert snap["step_calls"] == snap["sync_calls"] == n * per
    assert snap["root_calls"] == n
    got = {r["id"]: r["spans"] for r in m.span_roots("root")}
    assert set(got) == set(roots)
    for spans in got.values():
        assert spans["step"]["calls"] == spans["sync"]["calls"] == per
    parents = {s["id"]: s["parent"] for s in m.recent_spans()}
    for s in m.recent_spans():
        if s["name"] == "sync":
            assert parents[s["parent"]] == s["root"]


def test_span_labels_the_profiler_only_inside_a_session(tmp_path):
    """Outside a session a span makes no profiler label; inside, each
    span is one, nested as the spans are. A span opened before the
    session began is not in its trace. ``label`` is the profiler label
    alone: nothing outside a session, no span inside one."""
    m = Metrics()
    with m.span("before") as sp:
        assert sp._rf is None
        with trace(str(tmp_path)):
            with m.span("outer") as o:
                assert o._rf is not None
                with m.span("inner"):
                    torch.ones(8) + 1
                    with profiling.label("lab"):
                        torch.ones(8) * 2
    with m.span("after") as sp:
        assert sp._rf is None
    assert profiling.label("lab") is profiling._NO_LABEL
    events = json.loads(next(tmp_path.glob("*.json")).read_text())[
        "traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert set(ann) == {"outer", "inner", "lab"}
    o, i, lab = ann["outer"], ann["inner"], ann["lab"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert i["ts"] <= lab["ts"]
    assert lab["ts"] + lab["dur"] <= i["ts"] + i["dur"]
    assert m.get("before_calls") == m.get("outer_calls") == 1
    assert m.get("lab_calls") == 0          # a label is no span


def _engine_counts(monkeypatch, eng):
    """Count the loop's tests of the engine (its ``_any`` calls)."""
    tests = [0]
    orig = eng._any

    def any_(flags):
        tests[0] += 1
        return orig(flags)
    monkeypatch.setattr(eng, "_any", any_)
    return tests


@pytest.mark.parametrize("stream", [False, True])
def test_engine_spans_one_step_a_step_and_one_sync_a_loop_test(
        monkeypatch, stream):
    """``engine.step`` (with ``engine.sample`` and ``engine.forward``
    under it) once a decode step, ``engine.sync`` once a loop test,
    ``engine.prefill`` once, ``engine.readback`` once a segment (or once
    in ``generate``), all under one root."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline
    pipe = build_tiny_pipeline(device="cpu")
    eng = pipe.engine
    tests = _engine_counts(monkeypatch, eng)
    ids, mask = _tiny_prompt(pipe)
    metrics.reset()
    with metrics.span("call"):
        if stream:
            results = list(eng.generate_stream(ids, mask, 20, seed=3,
                                               chunk_steps=6))
            res, segments = results[-1], len(results)
        else:
            res, segments = eng.generate(ids, mask, 20, seed=3), 1
    (root,) = metrics.span_roots("call")
    s = root["spans"]
    assert res.steps > 6
    for name in ("engine.step", "engine.sample", "engine.forward"):
        assert s[name]["calls"] == res.steps, name
    assert s["engine.sync"]["calls"] == tests[0] >= res.steps
    assert s["engine.prefill"]["calls"] == 1
    assert s["engine.readback"]["calls"] == segments
    assert s["engine.step"]["s"] >= (s["engine.sample"]["s"]
                                     + s["engine.forward"]["s"])
    assert metrics.get("engine.step_calls") == res.steps


def _tiny_prompt(pipe):
    from moss_ttsd_torch.pipeline import prompt as pp
    shifted = [pipe.prepare_item({"text": t})[0] for t in
               ("[S1]span check one.[S2]a reply.", "[S1]and two[S2]ok")]
    return pp.left_pad_batch(shifted, pipe.tokenizer.pad_token_id,
                             pipe.lm_cfg.speech_pad_token)


def test_stream_chunks_are_spans_with_their_feed_lag():
    """Each streamed chunk is a ``stream.chunk`` span from its dispatch to
    its read: the first read at once, every later one a feed late."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline
    pipe = build_tiny_pipeline(device="cpu")
    metrics.reset()
    chunks = list(pipe.stream_item({"text": "[S1]stream spans[S2]ok"},
                                   max_new_tokens=40, seed=1,
                                   chunk_steps=10, first_chunk_steps=5))
    spans = [s for s in metrics.recent_spans() if s["name"] == "stream.chunk"]
    assert len(spans) >= 2 and len(chunks) >= 2
    assert spans[0]["attrs"]["feeds_late"] == 0
    assert all(s["attrs"]["feeds_late"] >= 1 for s in spans[1:])
    assert all(s["t1_ns"] > s["t0_ns"] for s in spans)


# -- the benchmark's readers of the spans ---------------------------------

def _synthetic_store():
    """Three pipeline.batch roots (the first the profiled batch the
    window leaves out) with known span seconds, and the set-up spans."""
    m = Metrics()
    ms = 1_000_000
    for b, (steps, host, wait, rb, feed) in enumerate(
            [(4, 9, 9, 9, 9), (10, 40, 5, 2, 6), (20, 70, 8, 4, 0)]):
        with m.span("pipeline.batch") as root:
            t = 0
            for _ in range(steps):
                m.record_span("engine.sync", t, t + wait * ms // steps)
                m.record_span("engine.step", t, t + host * ms // steps)
            m.record_span("engine.readback", t, t + rb * ms)
            if feed:
                m.record_span("pipeline.vocode_feed", t, t + feed * ms)
            m.record_span("engine.sample", t, t + ms, root=root)
    for name, s in (("setup.codec", 2), ("setup.lm", 3), ("setup.kernels", 5)):
        m.record_span(name, 0, s * 1_000_000_000)
    return m


def _layer():
    return {"batches": [{"audio_s": 100.0, "steps": 10},
                        {"audio_s": 300.0, "steps": 20}]}


@pytest.mark.parametrize("name,want", [
    ("step_host_ms.batch", (40 + 70) / 30),
    ("step_wait_ms.batch", (5 + 2 + 8 + 4) / 30),
    ("overlap_feed_ms_per_audio_s.batch", 6 / 400),
    ("setup_program_s.batch", 10.0),
])
def test_span_readers_on_a_synthetic_store(monkeypatch, name, want):
    from ttsd_bench import readers
    read = readers.load(name)
    monkeypatch.setattr(profiling, "metrics", _synthetic_store())
    assert read(_layer(), {}) == pytest.approx(want)
    # a registry with no spans, one without the span store (an older
    # program), and a window with no batches read nothing
    monkeypatch.setattr(profiling, "metrics", Metrics())
    assert read(_layer(), {}) is None
    monkeypatch.setattr(profiling, "metrics", object())
    assert read(_layer(), {}) is None
    monkeypatch.setattr(profiling, "metrics", _synthetic_store())
    if name != "setup_program_s.batch":
        assert read({"batches": []}, {}) is None

"""The port's decode/vocode overlap in ``process_batch`` (CPU, tiny fp32
models, the codec window shrunk to 4 s with a 2 s overlap so that a short
generation spans several windows; the chunking contract is the same):
byte-identical to the port's serial branch, with and without
``rows_per_call``; a batch with a row that made no speech re-vocodes the
valid rows serially; a generation inside one window takes the serial
branch; the overlap output within 1e-4 of JAX ``process_batch`` on the same
weights (greedy); the pipeline's spans (``pipeline.vocode_feed`` only in
the overlap branch, the tokens the same with every span a profiler label
under a session)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY  # noqa: E402
from moss_ttsd_torch.cli.inference import build_tiny_pipeline  # noqa: E402
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.utils.profiling import metrics, trace  # noqa: E402
from tests.test_torch_pipeline import pipes  # noqa: E402,F401

PCM_TOL = 1e-4        # the codec's stated fp32 gap
ITEMS = [{"text": "[S1]Overlap parity check one.[S2]And a reply."},
         {"text": "[S1]Second item with different text so row lengths "
                  "differ across the batch."}]


def _window4(pipe, xy_cls, params, **kw):
    """A 4 s codec window (50 codes) with a 2 s overlap (25-code stride)."""
    pipe.spt = xy_cls(pipe.spt.cfg, params, chunk_seconds=4, **kw)
    pipe.vocode_overlap_s = 2
    return pipe


def _segments(engine):
    """Record the steps of every result generate_stream yields."""
    seen = []
    orig = engine.generate_stream

    def generate_stream(*a, **kw):
        for r in orig(*a, **kw):
            seen.append(r.steps)
            yield r

    engine.generate_stream = generate_stream
    return seen


@pytest.fixture(scope="module")
def pipe():
    p = build_tiny_pipeline(seed=0, bucket=32, device="cpu")
    return _window4(p, XYTokenizer, p.spt.module, device="cpu")


def run(pipe, overlap, steps=120, rows=None, seed=2):
    pipe.overlap_vocode = overlap
    pipe.vocode_rows_per_call = rows
    return pipe.process_batch(list(ITEMS), max_new_tokens=steps, seed=seed)


@pytest.mark.parametrize("rows", [None, 1])
def test_overlap_matches_serial(pipe, rows):
    """Sampled, seed 2: both rows decode past three window boundaries
    (57, 82, 107), so the overlap branch vocodes windows while decoding;
    the audio is byte-identical to the serial branch's."""
    seen = _segments(pipe.engine)
    texts_a, audio_a = run(pipe, overlap=False, rows=rows)
    assert seen == []
    texts_b, audio_b = run(pipe, overlap=True, rows=rows)
    assert seen == [57, 82, 107, 120]
    assert [t["final_text"] for t in texts_a] == \
        [t["final_text"] for t in texts_b]
    for a, b in zip(audio_a, audio_b):
        assert a is not None and b is not None
        np.testing.assert_array_equal(a["audio_data"], b["audio_data"])
        assert a["sample_rate"] == b["sample_rate"]


def test_mixed_none_row_matches_serial(pipe, monkeypatch):
    """A row with no speech: the serial contract vocodes only the valid
    rows, so the overlap branch re-vocodes them serially and stays
    byte-identical."""
    orig = type(pipe).extract_codes

    def drop_last_row(self, result):
        out = orig(self, result)
        out[-1] = None
        return out

    monkeypatch.setattr(type(pipe), "extract_codes", drop_last_row)
    audio_a = run(pipe, overlap=False)[1]
    audio_b = run(pipe, overlap=True)[1]
    assert audio_a[-1] is None and audio_b[-1] is None
    assert audio_a[0] is not None
    np.testing.assert_array_equal(audio_a[0]["audio_data"],
                                  audio_b[0]["audio_data"])


def test_single_window_takes_serial_path(pipe):
    """A budget inside one codec window has nothing to overlap: the
    one-shot generate runs, and the audio comes out."""
    seen = _segments(pipe.engine)
    _, audio = run(pipe, overlap=True, steps=20)
    assert seen == []
    assert any(a is not None for a in audio)


def test_overlap_matches_jax_process_batch(pipes):
    """Greedy on the same weights, both with the 4 s window and overlap on:
    identical codes, wavs within 1e-4."""
    jpipe, pipe = pipes
    _window4(jpipe, JXY, jpipe.spt.params)
    _window4(pipe, XYTokenizer, pipe.spt.module, device="cpu")
    seen = _segments(pipe.engine)
    jt, ja = jpipe.process_batch(list(ITEMS), max_new_tokens=120)
    pt, pa = pipe.process_batch(list(ITEMS), max_new_tokens=120)
    assert seen, "the overlap branch did not run"
    assert [t["final_text"] for t in pt] == [t["final_text"] for t in jt]
    for a, b in zip(pa, ja):
        assert (a is None) == (b is None)
        if a is not None:
            assert a["audio_data"].shape == b["audio_data"].shape
            assert float(np.abs(a["audio_data"] - b["audio_data"]).max()) \
                < PCM_TOL


@pytest.mark.parametrize("overlap", [False, True])
def test_batch_spans_and_tokens_under_a_session(pipe, overlap, tmp_path):
    """One ``pipeline.batch`` root a call; ``pipeline.vocode_feed`` once a
    segment the overlap branch feeds, and never in the serial branch;
    ``pipeline.prepare`` and ``pipeline.vocode`` once. Under a profiler
    session (each span then also a ``record_function``) the tokens and the
    audio are those of a run without one."""
    seen = _segments(pipe.engine)
    tokens = []
    orig = pipe.extract_codes

    def extract(result):
        tokens.append(result.tokens)
        return orig(result)
    pipe.extract_codes = extract
    try:
        metrics.reset()
        audio_a = run(pipe, overlap=overlap)[1]
        n_a = len(tokens)
        with trace(str(tmp_path)):
            audio_b = run(pipe, overlap=overlap)[1]
    finally:
        del pipe.extract_codes
    roots = metrics.span_roots("pipeline.batch")
    assert len(roots) == 2
    for r in roots:
        s = r["spans"]
        assert s["pipeline.batch"]["calls"] == 1
        assert s["pipeline.prepare"]["calls"] == 1
        assert s["pipeline.vocode"]["calls"] == 1
        feeds = s.get("pipeline.vocode_feed", {}).get("calls", 0)
        assert feeds == (4 if overlap else 0)
        assert s["engine.step"]["calls"] == 120
    assert len(seen) == (8 if overlap else 0)
    # under the session every decoder layer of the prefill and of each
    # step is a profiler label
    events = json.loads(next(tmp_path.glob("*.json")).read_text())[
        "traceEvents"]
    layers = sum(e.get("name") == "lm.layer" for e in events)
    assert layers == pipe.lm_cfg.num_hidden_layers * (1 + 120)
    np.testing.assert_array_equal(tokens[n_a - 1], tokens[-1])
    for a, b in zip(audio_a, audio_b):
        np.testing.assert_array_equal(a["audio_data"], b["audio_data"])

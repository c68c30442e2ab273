"""The port's podcast generator and gradio synthesis paths against the JAX
package (CPU): the strings, templates, fallback scripts, voices and UI
labels equal JAX's exactly; the source readers, the language detection,
the example loader and the language toggle give JAX's results; the script
generator against a stub chat-completions server on 127.0.0.1; the
placeholder voices synthesized sample for sample as JAX's; the gradio gate
and the localized status strings; end to end on the same tiny greedy
weights (fp32), ``process_input_to_audio`` and the three gradio callbacks
give JAX's scripts, statuses and audio (wavs within one LSB, int16 within
one step), with a LoRA voice too; the podcast CLI on the CPU."""
import http.server
import json
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_tpu.serve import gradio_app as jga  # noqa: E402
from moss_ttsd_tpu.serve import podcast as jpod  # noqa: E402
from moss_ttsd_torch.serve import gradio_app as ga  # noqa: E402
from moss_ttsd_torch.serve import podcast as pod  # noqa: E402
from tests.test_torch_continuous import rand_adapter  # noqa: E402
from tests.test_torch_pipeline import LSB, pipes  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ("Large language models turn text into speech tokens. This note "
          "explains how a codec turns those tokens back into audio.")


@pytest.mark.parametrize("name", ["SCRIPT_PROMPT_ZH", "SCRIPT_PROMPT_EN",
                                  "FALLBACK_SCRIPT_ZH", "FALLBACK_SCRIPT_EN",
                                  "DEFAULT_VOICES", "ASSET_BASE"])
def test_podcast_constants_equal_jax(name):
    assert getattr(pod, name) == getattr(jpod, name)


@pytest.mark.parametrize("name", ["UI_STRINGS", "LABELED_COMPONENTS",
                                  "DEFAULT_EXAMPLE_JSONLS"])
def test_gradio_constants_equal_jax(name):
    assert getattr(ga, name) == getattr(jga, name)


def test_parse_input_content_matches_jax(tmp_path):
    p = tmp_path / "doc.txt"
    p.write_text("some source material\n第二行\n", encoding="utf-8")
    for src in (str(p), "raw text input", str(tmp_path / "missing.txt"),
                str(tmp_path / "missing.pdf")):
        assert pod.parse_input_content(src) == jpod.parse_input_content(src)
    assert pod.parse_input_content(str(p)) == "some source material\n第二行\n"


@pytest.mark.parametrize("text", [
    "这是一段中文材料，讲人工智能。", "This is English material about AI.",
    "MOSS-TTSD 是一个对话语音合成模型", "An English note with 一个 word.",
    "一" + "x" * 9, "一" + "x" * 10, "", "12345 !!!"])
def test_detect_language_matches_jax(text):
    assert pod.detect_language(text) == jpod.detect_language(text)


@pytest.mark.parametrize("lang", ["en", "zh", "中文", "English", "fr"])
def test_language_updates_match_jax(lang):
    assert ga.language_updates(lang) == jga.language_updates(lang)
    assert ga.ui_strings(lang) == jga.ui_strings(lang)


def test_bilingual_labels_match_jax():
    for key in ga.UI_STRINGS["en"]:
        assert ga.bilingual_label(key) == jga.bilingual_label(key)


def test_load_examples_matches_jax(tmp_path):
    paths = [str(ROOT / p) for p in ga.DEFAULT_EXAMPLE_JSONLS]
    got = ga.load_examples_from_jsonl(paths)
    assert got == jga.load_examples_from_jsonl(paths)
    role, single = got
    assert role and single
    # a row whose wav is missing is dropped; a text-only row is kept
    p = tmp_path / "ex.jsonl"
    rows = [{"text": "[S1]a", "prompt_audio": "nowhere.wav",
             "prompt_text": "x"},
            {"text": "[S1]b", "base_path": str(ROOT / "examples"),
             "prompt_audio": "voice_both.wav", "prompt_text": "y",
             "use_normalize": False},
            {"text": "[S1]c", "prompt_audio_speaker1": "voice_s1.wav",
             "prompt_audio_speaker2": "gone.wav"},
            {"text": "[S1]d"}]
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    for limit in (20, 1):
        got = ga.load_examples_from_jsonl(str(p), limit=limit)
        assert got == jga.load_examples_from_jsonl(str(p), limit=limit)
    assert ga.load_examples_from_jsonl(str(p)) == (
        [], [["[S1]b", str(ROOT / "examples" / "voice_both.wav"), "y", False],
             ["[S1]d", None, "", True]])


@pytest.mark.parametrize("language", ["zh", "en"])
def test_fallback_script_matches_jax(language, monkeypatch, capsys):
    monkeypatch.delenv("PODCAST_LLM_BASE", raising=False)
    got = pod.generate_podcast_script("material", language=language)
    said = capsys.readouterr().out
    assert got == jpod.generate_podcast_script("material", language=language)
    assert said == capsys.readouterr().out
    assert "IGNORES your source material" in said


class _Stub(http.server.BaseHTTPRequestHandler):
    """A chat-completions endpoint answering ``server.answer``, and an HTML
    page at /page.html."""

    def log_message(self, *a):
        pass

    def _send(self, body: bytes, ctype: str):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.server.seen.append((self.path, req,
                                 self.headers.get("Authorization")))
        self._send(json.dumps({"choices": [{"message": {
            "content": self.server.answer}}]}).encode(), "application/json")

    def do_GET(self):
        self._send(PAGE.encode(), "text/html; charset=utf-8")


PAGE = ("<html><head><style>p{}</style><script>var x=1;</script></head>"
        "<body><nav>menu</nav><header>top</header><h1>Title</h1>"
        "<p>First  paragraph.</p>\n\n<p>第二段。</p><footer>foot</footer>"
        "</body></html>")


@pytest.fixture
def stub_server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    srv.seen, srv.answer = [], ""
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_script_from_endpoint_matches_jax(stub_server, monkeypatch, capsys):
    pytest.importorskip("requests")
    srv, url = stub_server
    monkeypatch.delenv("PODCAST_LLM_KEY", raising=False)
    srv.answer = "  [S1]Hello there,\nfriend.[S2]Hi!\r\n[S1]Bye.  "
    monkeypatch.setenv("PODCAST_LLM_BASE", url + "/v1/")
    got = pod.generate_podcast_script(SOURCE, language="en", api_key="k")
    assert got == jpod.generate_podcast_script(SOURCE, language="en",
                                               api_key="k")
    assert got == "[S1]Hello there,friend.[S2]Hi![S1]Bye."
    (path, req, auth), (jpath, jreq, jauth) = srv.seen
    assert (path, req, auth) == (jpath, jreq, jauth)
    assert path == "/v1/chat/completions" and auth == "Bearer k"
    assert req["messages"][0]["content"] == pod.SCRIPT_PROMPT_EN.format(
        content=SOURCE)
    # an answer without [S1] falls back, with the same notice
    srv.answer = "Speaker one: hello"
    capsys.readouterr()
    got = pod.generate_podcast_script(SOURCE, language="zh", base_url=url)
    said = capsys.readouterr().out
    assert got == jpod.generate_podcast_script(SOURCE, language="zh",
                                               base_url=url)
    assert got == pod.FALLBACK_SCRIPT_ZH
    assert said == capsys.readouterr().out and "missing [S1]" in said


def test_extract_web_content_matches_jax(stub_server):
    pytest.importorskip("requests")
    pytest.importorskip("bs4")
    _, url = stub_server
    got = pod.parse_input_content(url + "/page.html")
    assert got == jpod.parse_input_content(url + "/page.html")
    assert got == "Title\nFirst  paragraph.\n第二段。"


def test_default_asset_base_matches_jax(tmp_path, monkeypatch):
    """Without the source checkout's examples/, both packages synthesize
    the two placeholder voices into their own cache: the same samples."""
    from scipy.io import wavfile
    monkeypatch.setattr(pod, "ASSET_BASE", str(tmp_path / "nowhere"))
    monkeypatch.setattr(jpod, "ASSET_BASE", str(tmp_path / "nowhere"))
    monkeypatch.setenv("HOME", str(tmp_path))
    base, jbase = pod.default_asset_base(), jpod.default_asset_base()
    assert base == str(tmp_path / ".cache" / "moss_ttsd_torch" / "assets")
    for name in ("voice_s1.wav", "voice_s2.wav"):
        sr, a = wavfile.read(pathlib.Path(base) / "examples" / name)
        jsr, b = wavfile.read(pathlib.Path(jbase) / "examples" / name)
        assert sr == jsr == 16000 and a.shape == (48000,)
        np.testing.assert_array_equal(a, b)
    assert sorted(p.name for p in (pathlib.Path(base) / "examples")
                  .iterdir()) == [".voices_ready", "voice_s1.wav",
                                  "voice_s2.wav"]
    assert pod.default_asset_base() == base        # the sentinel holds
    monkeypatch.undo()
    assert pod.default_asset_base() == str(ROOT)


def test_gradio_interface_gated():
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="gradio"):
            ga.create_gradio_interface()
    else:
        ga.create_gradio_interface(loader=lambda: None)


class _NoSpeech:
    def process_batch(self, items, **kw):
        return [{"final_text": ""}], [None]

    def stream_item(self, item, **kw):
        return iter(())


@pytest.mark.parametrize("lang", ["中文", "English", "zh", "en"])
def test_status_strings_localized(lang, monkeypatch):
    for mod in (ga, jga):
        monkeypatch.setattr(mod, "_PIPELINE", _NoSpeech())
    want = ga.ui_strings(lang)["status_no_speech"]
    for mod in (ga, jga):
        assert mod.synthesize_single("", "", None, lang=lang) == (None, want)
        assert mod.synthesize_role("", "", None, "", None,
                                   lang=lang) == (None, want)
    assert list(ga.synthesize_single_stream("", "", None, lang=lang)) == [
        (None, want)]


def test_pipeline_and_podcast_cli_need_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ga, "_PIPELINE", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ga.get_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pod.main(["--input", "hello", "--output", str(tmp_path / "x.wav")])


# ---------------------------------------------------------------------------
# end to end on the same tiny greedy weights
# ---------------------------------------------------------------------------

def _int16_close(a, b):
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape
    assert int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) <= 1


def test_process_input_to_audio_matches_jax(pipes, tmp_path, monkeypatch):
    from scipy.io import wavfile
    monkeypatch.delenv("PODCAST_LLM_BASE", raising=False)
    jpipe, pipe = pipes
    src = tmp_path / "notes.txt"
    src.write_text(SOURCE)
    out, jout = tmp_path / "port.wav", tmp_path / "jax.wav"
    info = pod.process_input_to_audio(str(src), pipe, str(out))
    jinfo = jpod.process_input_to_audio(str(src), jpipe, str(jout))
    assert info["script"] == jinfo["script"] == pod.FALLBACK_SCRIPT_EN
    assert info["language"] == jinfo["language"] == "en"
    assert info["output"] == str(out)
    assert info["duration_s"] == jinfo["duration_s"] > 0
    sr, a = wavfile.read(out)
    jsr, b = wavfile.read(jout)
    assert sr == jsr == 24000 and a.shape == b.shape
    assert len(a) / sr == info["duration_s"]
    np.testing.assert_allclose(a / 32768.0, b / 32768.0, atol=LSB * 1.01)


def _loaders(pipes, monkeypatch):
    jpipe, pipe = pipes
    monkeypatch.setattr(ga, "_PIPELINE", None)
    monkeypatch.setattr(jga, "_PIPELINE", None)
    return (lambda: pipe), (lambda: jpipe)


def test_gradio_callbacks_match_jax(pipes, monkeypatch):
    loader, jloader = _loaders(pipes, monkeypatch)
    ex = ROOT / "examples"
    args = ("[S1]Hello there.[S2]Hi, how are you?", "[S1]ref one[S2]ref two",
            str(ex / "voice_both.wav"), True, 0)
    (sr, a), status = ga.synthesize_single(*args, loader=loader)
    (jsr, b), jstatus = jga.synthesize_single(*args, loader=jloader)
    assert sr == jsr == 24000 and status == jstatus
    assert status.startswith("Generated ") and "| final text: " in status
    _int16_close(a, b)

    rargs = ("[S1]Hello there.[S2]Hi!", "first voice", str(ex / "voice_s1.wav"),
             "second voice", str(ex / "voice_s2.wav"), False, 3)
    (sr, a), status = ga.synthesize_role(*rargs, loader=loader, lang="zh")
    (jsr, b), jstatus = jga.synthesize_role(*rargs, loader=jloader, lang="zh")
    assert sr == jsr == 24000 and status == jstatus
    assert status.startswith("已生成 ")
    _int16_close(a, b)

    chunks = list(ga.synthesize_single_stream(*args, loader=loader))
    jchunks = list(jga.synthesize_single_stream(*args, loader=jloader))
    assert len(chunks) == len(jchunks) > 1
    assert [s for _, s in chunks] == [s for _, s in jchunks]
    assert all(c[0] == 24000 for c, _ in chunks)
    _int16_close(np.concatenate([c[1] for c, _ in chunks]),
                 np.concatenate([c[1] for c, _ in jchunks]))


def test_gradio_voice_matches_jax(pipes, monkeypatch):
    """A LoRA voice registered in both pipelines from the same factors goes
    through synthesize_single(voice=...); an unknown voice raises."""
    jpipe, pipe = pipes
    loader, jloader = _loaders(pipes, monkeypatch)
    ad = rand_adapter(pipe.lm_cfg, 5)
    pipe.engine.register_adapter("v1", ad, alpha=8.0)
    jpipe.engine.register_adapter("v1", ad, alpha=8.0)
    args = ("[S1]hello[S2]hi", "", None, True, 0)
    (sr, a), status = ga.synthesize_single(*args, loader=loader, voice="v1")
    (_, b), jstatus = jga.synthesize_single(*args, loader=jloader, voice="v1")
    assert status == jstatus
    _int16_close(a, b)
    (_, base), _ = ga.synthesize_single(*args, loader=loader)
    assert base.shape != a.shape or not np.array_equal(base, a)
    with pytest.raises(ValueError):
        ga.synthesize_single("[S1]x", "", None, True, 0, voice="ghost")
    with pytest.raises(ValueError):
        jga.synthesize_single("[S1]x", "", None, True, 0, voice="ghost")


def test_podcast_cli_tiny_cpu_writes_a_wav(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("PODCAST_LLM_BASE", raising=False)
    src = tmp_path / "notes.txt"
    src.write_text(SOURCE)
    out = tmp_path / "podcast.wav"
    assert pod.main(["--input", str(src), "--output", str(out), "--tiny",
                     "--platform", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(info) == ["duration_s", "language", "output"]
    assert info["language"] == "en" and info["output"] == str(out)
    assert out.exists() and info["duration_s"] > 0

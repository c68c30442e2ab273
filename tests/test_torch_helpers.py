"""The port's ``utils/helpers.py`` and ``utils/memory.py`` against the JAX
package (CPU): audio-file discovery, ASR normalization, parameter counts
and their report on the same tiny LM weights, ``lm_param_count`` and every
``serving_memory`` field exactly; and the remote-debug hooks, with a stub
``debugpy`` (a real one would listen): ``MOSS_TTSD_DEBUG`` reaches
``debugpy.listen`` at the start of the inference CLI's and the server's
``main``, and the codec CLI's ``--debug 1`` does, before any model is
built; without debugpy the hook warns and returns."""
import logging
import pathlib
import sys
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from moss_ttsd_tpu.core.config import LMConfig as JLMConfig  # noqa: E402
from moss_ttsd_tpu.utils import helpers as jhelpers  # noqa: E402
from moss_ttsd_tpu.utils import memory as jmemory  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.utils import helpers  # noqa: E402
from moss_ttsd_torch.utils import memory  # noqa: E402
from tests.test_torch_lm import jax_tiny, port_model  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_find_audio_files_matches_jax(tmp_path):
    for name in ("b.wav", "a.FLAC", "c.txt", "sub/z.mp3", "sub/y.ogg",
                 "sub/deeper/x.m4a", "sub/deeper/w.wav.bak", "top.Wav"):
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"")
    got = helpers.find_audio_files(str(tmp_path))
    assert got == jhelpers.find_audio_files(str(tmp_path))
    assert len(got) == 6
    assert helpers.find_audio_files(str(ROOT / "examples")) == \
        jhelpers.find_audio_files(str(ROOT / "examples"))


@pytest.mark.parametrize("text", [
    "Hello, World!  你好。", "MOSS-TTSD v0.5: it's here...", "  ", "",
    "第一句，第二句！Third—fourth?", "tabs\tand\nnewlines", "ÀÉÎ őű çà"])
def test_asr_normalize_text_matches_jax(text):
    assert helpers.asr_normalize_text(text) == jhelpers.asr_normalize_text(text)


def test_param_counts_match_jax():
    jcfg, params = jax_tiny(0)
    _, model = port_model(jcfg, params)
    counts = helpers.count_params_by_module(model)
    jcounts = jhelpers.count_params_by_module(params)
    assert counts == jcounts
    assert counts["__total__"] == memory.lm_param_count(
        LMConfig.from_dict(jcfg.to_dict()))
    assert helpers.count_params_by_module(model.state_dict()) == jcounts
    report = helpers.format_param_report(model)
    assert report == jhelpers.format_param_report(params)
    assert report.splitlines()[-1] == (
        jhelpers.format_param_report(params).splitlines()[-1])
    assert report.splitlines()[-1].startswith("TOTAL")


@pytest.mark.parametrize("tiny", [False, True])
def test_lm_param_count_matches_jax(tiny):
    cfg, jcfg = LMConfig(), JLMConfig()
    if tiny:
        cfg, jcfg = cfg.tiny(), jcfg.tiny()
    n = memory.lm_param_count(cfg)
    assert isinstance(n, int) and n == jmemory.lm_param_count(jcfg)


@pytest.mark.parametrize("cache_bytes", [1, 2])
@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("seconds", [60, 600])
@pytest.mark.parametrize("batch", [1, 8])
def test_serving_memory_matches_jax(batch, seconds, quant, cache_bytes):
    got = memory.serving_memory(LMConfig(), batch, seconds, quant=quant,
                                cache_bytes=cache_bytes)
    want = jmemory.serving_memory(JLMConfig(), batch, seconds, quant=quant,
                                  cache_bytes=cache_bytes)
    assert (got.weights_gb, got.kv_cache_gb, got.buffers_gb) == (
        want.weights_gb, want.kv_cache_gb, want.buffers_gb)
    assert got.total_gb == want.total_gb


def test_serving_memory_bounds():
    """The bounds tests/test_profiling.py holds the JAX estimate to."""
    cfg = LMConfig()
    assert 1.5e9 < memory.lm_param_count(cfg) < 2.5e9
    bf16 = memory.serving_memory(cfg, batch=1, max_audio_seconds=600)
    int8 = memory.serving_memory(cfg, batch=1, max_audio_seconds=600,
                                 quant="int8")
    assert bf16.total_gb < 7.0
    assert int8.total_gb < bf16.total_gb - 1.0
    short = memory.serving_memory(cfg, batch=1, max_audio_seconds=120)
    assert bf16.kv_cache_gb > short.kv_cache_gb * 4


def test_set_logging_tags_rank_zero():
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        helpers.set_logging(logging.DEBUG)
        assert root.level == logging.DEBUG
        fmt = root.handlers[0].formatter._fmt
        assert fmt == ("[proc 0] %(asctime)s %(levelname)s %(name)s: "
                       "%(message)s")
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


# ---------------------------------------------------------------------------
# the remote-debug hooks
# ---------------------------------------------------------------------------

class Attached(Exception):
    """Raised by the stub's wait_for_client: the entry point blocked."""


@pytest.fixture
def debugpy_stub(monkeypatch):
    stub = types.ModuleType("debugpy")
    stub.listened = []
    stub.listen = stub.listened.append

    def wait_for_client():
        raise Attached

    stub.wait_for_client = wait_for_client
    monkeypatch.setitem(sys.modules, "debugpy", stub)
    return stub


@pytest.fixture
def no_model(monkeypatch):
    """Building a model or a pipeline fails the test: the hook must block
    before any of them."""
    from moss_ttsd_torch.cli import inference
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.pipeline.batch import TTSPipeline

    def built(*a, **kw):
        raise AssertionError("a model was built before the debug hook")

    monkeypatch.setattr(inference, "build_tiny_pipeline", built)
    monkeypatch.setattr(TTSPipeline, "load", built)
    monkeypatch.setattr(XYTokenizer, "init_random", built)
    monkeypatch.setattr(XYTokenizer, "load_from_checkpoint", built)


@pytest.mark.parametrize("spec,addr", [("10.1.2.3:7000", ("10.1.2.3", 7000)),
                                       ("7001", ("localhost", 7001))])
@pytest.mark.parametrize("entry", ["inference", "server"])
def test_env_debug_blocks_before_the_model(entry, spec, addr, debugpy_stub,
                                           no_model, monkeypatch, tmp_path):
    monkeypatch.setenv("MOSS_TTSD_DEBUG", spec)
    if entry == "inference":
        from moss_ttsd_torch.cli.inference import main
        argv = ["--jsonl", str(ROOT / "examples" / "examples_only_text.jsonl"),
                "--tiny", "--platform", "cpu", "--output_dir", str(tmp_path)]
    else:
        from moss_ttsd_torch.serve.server import main
        argv = ["--tiny", "--platform", "cpu", "--host", "127.0.0.1",
                "--port", "0"]
    with pytest.raises(Attached):
        main(argv)
    assert debugpy_stub.listened == [addr]
    assert not list(tmp_path.iterdir())


def test_codec_cli_debug_blocks_before_the_model(debugpy_stub, no_model,
                                                 tmp_path):
    from moss_ttsd_torch.cli.codec_roundtrip import main
    base = ["--input_dir", str(ROOT / "examples"), "--output_dir",
            str(tmp_path), "--tiny", "--platform", "cpu"]
    with pytest.raises(Attached):
        main([*base, "--debug", "1", "--debug_port", "6123"])
    with pytest.raises(Attached):
        main([*base, "--debug", "1", "--debug_ip", "0.0.0.0"])
    assert debugpy_stub.listened == [("localhost", 6123), ("0.0.0.0", 5678)]
    # without --debug 1 (as in JAX, a bare --debug too) it goes on to the model
    for extra in ([], ["--debug"], ["--debug", "0"]):
        with pytest.raises(AssertionError, match="debug hook"):
            main([*base, *extra])
    assert len(debugpy_stub.listened) == 2


def test_debug_hook_without_debugpy_warns(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "debugpy", None)
    monkeypatch.setenv("MOSS_TTSD_DEBUG", "localhost:5679")
    with caplog.at_level(logging.WARNING):
        helpers.maybe_debug_attach()
    assert "debugpy not installed" in caplog.text
    with caplog.at_level(logging.WARNING):
        jhelpers.maybe_debug_attach()
    assert caplog.text.count("debugpy not installed") == 2


def test_debug_hook_unset_is_a_no_op(monkeypatch, debugpy_stub):
    monkeypatch.delenv("MOSS_TTSD_DEBUG", raising=False)
    helpers.maybe_debug_attach()
    monkeypatch.setenv("MOSS_TTSD_DEBUG", "")
    helpers.maybe_debug_attach()
    assert debugpy_stub.listened == []

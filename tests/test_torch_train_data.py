"""The port's training data path against the JAX package, exactly
(MockTokenizer, the tiny codec on the same weights, CPU):
``build_training_example``, ``process_data``'s shards and index from the
examples' voices, ``TrainingDataset`` (order and delay shift) and
``collate`` (truncate, then round up); and the host pieces: ``Prefetcher``
order, error and close, ``TrainLogger``'s sinks, and the YAML reader
against ``yaml.safe_load`` on the three configs."""
import json
import os
import pathlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import yaml  # noqa: E402

from moss_ttsd_tpu.core.config import CodecConfig as JCodecConfig  # noqa: E402
from moss_ttsd_tpu.models.codec.model import XYTokenizer as JXY  # noqa: E402
from moss_ttsd_tpu.train import data as jdata  # noqa: E402
from moss_ttsd_tpu.utils.mock_tokenizer import MockTokenizer as JTok  # noqa: E402
from moss_ttsd_torch.core.config import CodecConfig  # noqa: E402
from moss_ttsd_torch.models.codec.model import XYTokenizer  # noqa: E402
from moss_ttsd_torch.train import data as tdata  # noqa: E402
from moss_ttsd_torch.utils import config_yaml  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import codec_state_from_jax  # noqa: E402
from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def voice_training_jsonl(path):
    """A training JSONL over the examples' voices, in both of
    process_data's formats, plus one item with a missing file."""
    items = [
        {"file_path": str(EXAMPLES / "voice_both.wav"),
         "full_transcript": "[S1]This is the first speaker reference voice."
                            "[S2]And this is the second speaker reference "
                            "voice."},
        {"reference_audio": str(EXAMPLES / "voice_s1.wav"),
         "reference_text": "[S1]This is the first speaker reference voice.",
         "audio": str(EXAMPLES / "voice_s2.wav"),
         "text": "[S2]And this is the second speaker reference voice."},
        {"file_path": str(EXAMPLES / "missing.wav"),
         "full_transcript": "[S1]gone"},
    ]
    with open(path, "w") as f:
        for it in items:
            f.write(json.dumps(it) + "\n")
    return str(path)


@pytest.mark.parametrize("nq,text", [(8, "[S1]hello there[S2]hi"),
                                     (5, "short"), (10, "[S1]ten codes")])
def test_build_training_example_matches_jax(nq, text):
    rng = np.random.default_rng(nq)
    codes = rng.integers(0, 1024, (23, nq))
    got = tdata.build_training_example(MockTokenizer(), text, codes)
    want = jdata.build_training_example(JTok(), text, codes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ids, labels = got
    sup = labels[:, 0] != -100
    # audio rows and <|end_of_speech|> supervised, the text rows not
    assert sup.sum() == 23 + 1 and sup[-24:].all()


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """process_data of the voice JSONL through both packages' codecs on the
    same tiny weights."""
    d = tmp_path_factory.mktemp("data")
    jsonl = voice_training_jsonl(d / "train.jsonl")
    jspt = JXY.init_random(JCodecConfig().tiny(), seed=0)
    cfg = CodecConfig().tiny()
    spt = XYTokenizer(cfg, codec_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jspt.params), cfg), device="cpu")
    tdata.process_data(jsonl, MockTokenizer(), spt, str(d / "port"),
                       speech_offset=100, shard_size=1)
    jdata.process_data(jsonl, JTok(), jspt, str(d / "jax"),
                       speech_offset=100, shard_size=1)
    return d


def test_process_data_matches_jax(processed):
    """The same shard files, index and records, exactly (the port's codec
    encode gives JAX's codes on the CPU)."""
    port, jx = processed / "port", processed / "jax"
    assert sorted(os.listdir(port)) == sorted(os.listdir(jx))
    assert json.load(open(port / "processed_data_index.json")) == \
        json.load(open(jx / "processed_data_index.json")) == {
            "shards": [{"file": "processed_data_00000.npz", "count": 1},
                       {"file": "processed_data_00001.npz", "count": 1}],
            "total": 2}
    for name in sorted(os.listdir(port)):
        if name.endswith(".npz"):
            with np.load(port / name) as a, np.load(jx / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_and_collate_match_jax(processed):
    """TrainingDataset over the shards (either package's) and collate,
    which truncates at max_length before it rounds the padded length up:
    identical arrays for every max_length / pad_to_multiple case."""
    pad = MockTokenizer().pad_token_id
    ds = tdata.TrainingDataset(str(processed / "jax"), 8, pad, 64, seed=3)
    jds = jdata.TrainingDataset(str(processed / "port"), 8, pad, 64, seed=3)
    assert len(ds) == len(jds) == 2
    items = [ds[i] for i in range(2)]
    for a, b in zip(items, [jds[i] for i in range(2)]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n = max(x["input_ids"].shape[0] for x in items)
    for max_length, multiple in [(16000, None), (16000, 64), (n - 5, 64),
                                 (n - 5, None), (40, 16)]:
        got = tdata.collate(items, pad, max_length=max_length, pad_token=64,
                            pad_to_multiple=multiple)
        want = jdata.collate(items, pad, max_length=max_length, pad_token=64,
                             pad_to_multiple=multiple)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # content beyond max_length never escapes the truncation
        assert got["attention_mask"].sum(1).max() <= min(max_length, n)
        if multiple:
            assert got["input_ids"].shape[1] % multiple == 0


def test_delay_shift_of_labels(tmp_path):
    """Channel c of an item's labels is delayed by c rows, -100 filled."""
    d = {"input_ids": np.arange(24).reshape(3, 8),
         "labels": np.arange(24).reshape(3, 8) + 100}
    np.savez(tmp_path / "x_00000.npz", input_ids_0=d["input_ids"],
             labels_0=d["labels"])
    out = tdata.TrainingDataset(str(tmp_path), 8, 0, 64)[0]
    assert out["labels"].shape == (10, 8)
    for c in range(8):
        np.testing.assert_array_equal(out["labels"][c:c + 3, c],
                                      d["labels"][:, c])
        assert (out["labels"][:c, c] == -100).all()


def test_prefetcher_order_error_and_close():
    got = list(tdata.Prefetcher(lambda s: s * s, range(1, 6), depth=2))
    assert got == [(s, s * s) for s in range(1, 6)]

    def boom(s):
        if s == 3:
            raise RuntimeError("bad batch")
        return s

    it = iter(tdata.Prefetcher(boom, range(1, 6), depth=1))
    assert next(it) == (1, 1) and next(it) == (2, 2)
    with pytest.raises(RuntimeError, match="bad batch"):
        next(it)

    produced = []
    lock = threading.Lock()

    def make(s):
        with lock:
            produced.append(s)
        return s

    pf = tdata.Prefetcher(make, range(100), depth=1)
    it = iter(pf)
    next(it)
    time.sleep(0.3)                     # the worker refills and blocks
    pf.close()
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n < 100
    pf.close()                          # idempotent


@pytest.mark.parametrize("tensorboard", [False, True])
def test_train_logger_sinks(tmp_path, tensorboard):
    from moss_ttsd_torch.train.telemetry import TrainLogger
    from moss_ttsd_torch.utils.profiling import metrics
    with TrainLogger(str(tmp_path), use_tensorboard=tensorboard) as lg:
        lg.log(1, {"loss": 2.5, "grad_norm": 0.7})
        lg.log(2, {"loss": 2.0, "grad_norm": 0.6})
    lines = [json.loads(l) for l in
             (tmp_path / "train_log.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines] == [1, 2]
    assert lines[1]["loss"] == 2.0 and lines[0]["grad_norm"] == 0.7
    assert metrics.get("train_loss") == 2.0
    assert metrics.get("train_step") == 2
    try:
        import torch.utils.tensorboard  # noqa: F401
        has_tb = True
    except ImportError:
        has_tb = False
    assert (tmp_path / "tb").is_dir() == (tensorboard and has_tb)


@pytest.mark.parametrize("name", ["training_config.yaml", "lora_config.yaml",
                                  "finetune_workflow.yaml"])
def test_yaml_reader_matches_safe_load(name):
    path = ROOT / "configs" / name
    assert config_yaml.load(str(path)) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("text", [
    "a: 1\nb: -2\nc: 0.1\nd: 1.0e-4\ne: .5\nf: true\ng: False\nh: null\n"
    "i: ~\nj: path/to/x.jsonl # note\nk: 'q p'\nl: \"x\"\nm: []\n"
    "n: [q_proj, 3, 2.5]\no:\n  p: 1\n  q: [a, b]\nr:\n# c\n",
    "a:\n  b:\n    c: 1\n    d:\n  e: x\nf:\n  g:\n      h: 0.5\n",
    "# only comments\n\n"])
def test_yaml_reader_subset_equals_safe_load(text):
    assert config_yaml.loads(text) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize("text", [
    "a: 1e-4", "a: yes", "a: 0x1f", "a: 012", "a: 1:30", "a: 2020-01-01",
    "a: 1_000", "a: .inf", "a: &x 1", "a: |", "a:\n  b:\n    c: 1\n   d: 2",
    "a: {b: 1}", "- x", "a: x: y", "a: [a, [b]]", "a: 1\na: 2",
    "  a: 1", "a:\n  b: 1\n   c: 2", "a: 'unterminated"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        config_yaml.loads(text)

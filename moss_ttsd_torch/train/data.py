"""Training data: preprocessing, the dataset, the collator and the host
prefetcher, PyTorch port of ``moss_ttsd_tpu/train/data.py`` (numpy on the
host; the shards and their index are the JAX package's format, so either
package reads the other's).

  * ``build_training_example`` — the five-segment training prompt: style,
    text and speech-begin rows labelled -100, audio rows (channel 0 offset
    into the speech range) and ``<|end_of_speech|>`` supervised;
  * ``process_data`` — JSONL (two formats) -> the port's codec ``encode`` ->
    ``<name>_<shard>.npz`` shards + ``<name>_index.json``;
  * ``TrainingDataset`` / ``collate`` — the delay shift per example, then
    right padding to the batch maximum, truncated at ``max_length`` before
    the padded length is rounded up to ``pad_to_multiple``;
  * ``Prefetcher`` — one worker thread assembling batch i + 1 while the
    device runs step i.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..pipeline.prompt import shift_delay_pattern
from ..pipeline.text import normalize_text, rewrite_speaker_tags

IGNORE = -100
SYSTEM_PROMPT = ("You are a speech synthesizer that generates natural, "
                 "realistic, and human-like conversational audio from dialogue "
                 "text.")


def build_training_example(tokenizer, text: str, audio_codes: np.ndarray,
                           system_prompt: str = SYSTEM_PROMPT,
                           channels: int = 8, pad_token: int = 1024,
                           speech_offset: int = 151665):
    """-> (input_ids (T, C), labels (T, C)) int64.

    Segments (reference data_preprocess.py:26-147):
      1. style prompt + text-begin  (labels -100)
      2. text, encoded without special tokens (labels -100)
      3. text-end + speech-begin    (labels -100)
      4. audio codes (T_audio, nq), channel 0 + ``speech_offset`` (labels =
         ids)
      5. <|end_of_speech|>          (label kept on channel 0)
    """
    def text_seg(s, add_special_tokens=True):
        ids = np.asarray(
            tokenizer.encode(s, add_special_tokens=add_special_tokens),
            np.int64)
        seg = np.full((len(ids), channels), pad_token, np.int64)
        seg[:, 0] = ids
        return seg, np.full_like(seg, IGNORE)

    seg1, lab1 = text_seg(f"<|begin_of_style|>{system_prompt}<|end_of_style|>\n"
                          f"<|begin_of_text|>")
    seg2, lab2 = text_seg(text, add_special_tokens=False)
    seg3, lab3 = text_seg("<|end_of_text|>\n<|begin_of_speech|>")

    codes = np.asarray(audio_codes, np.int64).copy()       # (T_audio, nq)
    if codes.shape[1] > channels:
        codes = codes[:, :channels]
    elif codes.shape[1] < channels:
        padded = np.full((codes.shape[0], channels), pad_token, np.int64)
        padded[:, :codes.shape[1]] = codes
        codes = padded
    codes[:, 0] += speech_offset
    lab4 = codes.copy()

    seg5, lab5 = text_seg("<|end_of_speech|>")
    lab5[:, 0] = seg5[:, 0]

    return (np.concatenate([seg1, seg2, seg3, codes, seg5]),
            np.concatenate([lab1, lab2, lab3, lab4, lab5]))


def _encode(spt, wav: np.ndarray) -> np.ndarray:
    """One wav -> its codes (T_audio, nq) through the codec."""
    return np.asarray(spt.encode([wav])["codes_list"][0]).T


def process_data(jsonl_path: str, tokenizer, spt, output_dir: str,
                 data_name: str = "processed_data", use_normalize: bool = True,
                 channels: int = 8, speech_offset: int = 151665,
                 shard_size: int = 512) -> str:
    """JSONL -> sharded npz records; ``spt`` is the port's ``XYTokenizer``.
    Two item formats (reference data_preprocess.py:189-266):
    {"file_path", "full_transcript"}, or {"reference_audio",
    "reference_text", "audio", "text"} (the two encodings concatenated).
    An item that fails is reported and skipped."""
    from ..pipeline.jsonl import load_audio_data
    os.makedirs(output_dir, exist_ok=True)
    with open(jsonl_path) as f:
        items = [json.loads(l) for l in f if l.strip()]

    records: List[Dict] = []
    for idx, item in enumerate(items):
        try:
            if "file_path" in item and "full_transcript" in item:
                if not item["file_path"] or not os.path.exists(
                        item["file_path"]):
                    print(f"skip {idx}: missing audio {item.get('file_path')}")
                    continue
                text = item["full_transcript"]
                codes = _encode(spt, load_audio_data(item["file_path"]))
            elif all(k in item for k in ("reference_audio", "reference_text",
                                         "audio", "text")):
                if not (os.path.exists(item["reference_audio"])
                        and os.path.exists(item["audio"])):
                    print(f"skip {idx}: missing audio files")
                    continue
                text = item["reference_text"] + item["text"]
                codes = np.concatenate(
                    [_encode(spt, load_audio_data(item["reference_audio"])),
                     _encode(spt, load_audio_data(item["audio"]))], axis=0)
            else:
                print(f"skip {idx}: unknown format")
                continue
            if use_normalize:
                text = normalize_text(text)
            text = rewrite_speaker_tags(text)
            input_ids, labels = build_training_example(
                tokenizer, text, codes, channels=channels,
                speech_offset=speech_offset)
            records.append({"input_ids": input_ids, "labels": labels})
        except Exception as e:          # one bad item skips only itself
            print(f"skip {idx}: {e!r}")

    index = []
    for si in range(0, len(records), shard_size):
        shard = records[si:si + shard_size]
        path = os.path.join(output_dir,
                            f"{data_name}_{si // shard_size:05d}.npz")
        flat = {}
        for i, rec in enumerate(shard):
            flat[f"input_ids_{i}"] = rec["input_ids"]
            flat[f"labels_{i}"] = rec["labels"]
        np.savez(path, **flat)
        index.append({"file": os.path.basename(path), "count": len(shard)})
    with open(os.path.join(output_dir, f"{data_name}_index.json"), "w") as f:
        json.dump({"shards": index, "total": len(records)}, f)
    print(f"wrote {len(records)} records to {output_dir}")
    return output_dir


class TrainingDataset:
    """Every record of the ``.npz`` shards of ``data_dir``, shuffled once
    from ``seed``; item i is delay-shifted (channel c by c rows), its
    labels shifted alike with -100 fill (reference LazySupervisedDataset,
    finetune.py:24-76)."""

    def __init__(self, data_dir: str, channels: int, text_pad_id: int,
                 pad_token: int = 1024, seed: int = 0):
        self.channels = channels
        self.text_pad_id = text_pad_id
        self.pad_token = pad_token
        self.examples: List[Dict] = []
        for name in sorted(os.listdir(data_dir)):
            if not name.endswith(".npz"):
                continue
            with np.load(os.path.join(data_dir, name)) as z:
                n = len([k for k in z.files if k.startswith("input_ids_")])
                for i in range(n):
                    self.examples.append({"input_ids": z[f"input_ids_{i}"],
                                          "labels": z[f"labels_{i}"]})
        np.random.default_rng(seed).shuffle(self.examples)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        ex = self.examples[i]
        C = self.channels
        ids = ex["input_ids"][:, :C]
        labels = ex["labels"][:, :C]
        T = ids.shape[0]
        shifted = shift_delay_pattern(ids, self.text_pad_id, self.pad_token)
        shifted_labels = np.full((T + C - 1, C), IGNORE, np.int64)
        for c in range(C):
            shifted_labels[c:T + c, c] = labels[:, c]
        return {"input_ids": shifted, "labels": shifted_labels,
                "attention_mask": np.ones(T + C - 1, np.int64)}


def collate(instances: Sequence[Dict[str, np.ndarray]], text_pad_id: int,
            max_length: int = 16000, pad_token: int = 1024,
            pad_to_multiple: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Right-pad to min(batch max, ``max_length``); the content is cut at
    ``max_length`` first, and only then is the padded length rounded up to
    ``pad_to_multiple`` (reference DataCollatorForSupervisedDataset,
    finetune.py:78-116)."""
    C = instances[0]["input_ids"].shape[1]
    trunc = min(max(x["input_ids"].shape[0] for x in instances), max_length)
    L = (-(-trunc // pad_to_multiple) * pad_to_multiple
         if pad_to_multiple else trunc)
    B = len(instances)
    ids = np.full((B, L, C), pad_token, np.int64)
    ids[..., 0] = text_pad_id
    labels = np.full((B, L, C), IGNORE, np.int64)
    mask = np.zeros((B, L), np.int64)
    for b, inst in enumerate(instances):
        n = min(inst["input_ids"].shape[0], trunc)
        ids[b, :n] = inst["input_ids"][:n]
        labels[b, :n] = inst["labels"][:n]
        mask[b, :n] = inst["attention_mask"][:n]
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


class Prefetcher:
    """One worker thread calls ``make_batch(step)`` for each step of
    ``steps`` into a queue of ``depth``; iterating yields (step, batch) in
    order. A worker exception is raised again on the consumer. ``close()``
    (idempotent) stops the worker, even one blocked on a full queue, and
    drops what it buffered: call it when the consumer stops early."""

    _DONE = object()

    def __init__(self, make_batch, steps, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for s in steps:
                    if not put((s, make_batch(s))):
                        return
                put(self._DONE)
            except BaseException as e:          # raised again on next()
                put(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

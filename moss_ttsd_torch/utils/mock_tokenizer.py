"""A minimal byte-level tokenizer for tests and tiny-model demos.

Stands in for the Qwen BPE tokenizer (loaded via AutoTokenizer from the real
checkpoint, reference generation_utils.py:16) when no checkpoint is present.
Special tokens get dedicated ids; text bytes map into a small range.
"""

from __future__ import annotations

import re
from typing import List

SPECIAL_TOKENS = [
    "<|begin_of_style|>", "<|end_of_style|>", "<|begin_of_text|>",
    "<|end_of_text|>", "<|begin_of_speech|>", "<|end_of_speech|>",
    "<speaker1>", "<speaker2>",
]


class MockTokenizer:
    def __init__(self, byte_vocab: int = 64, pad_token_id: int = 0,
                 special_base: int = 80):
        self.byte_vocab = byte_vocab
        self.pad_token_id = pad_token_id
        self.special_base = special_base
        self.special = {tok: special_base + i for i, tok in enumerate(SPECIAL_TOKENS)}
        pattern = "|".join(re.escape(t) for t in SPECIAL_TOKENS)
        self._splitter = re.compile(f"({pattern})")

    @property
    def vocab_size(self) -> int:
        return self.special_base + len(SPECIAL_TOKENS)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for part in self._splitter.split(text):
            if not part:
                continue
            if part in self.special:
                ids.append(self.special[part])
            else:
                ids.extend(1 + (b % (self.byte_vocab - 1))
                           for b in part.encode("utf-8"))
        return ids

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.special.items()}
        return "".join(inv.get(int(i), f"<{int(i)}>") for i in ids)
